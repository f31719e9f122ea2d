"""Inference layer of the port: cache-backed decode engine, continuous
batching, the train/serve loop and decode on the (data, model) groups
(``src/repro/serving/``).

``engine`` owns the cache layout (period-major, ring-buffered windows)
and the prefill / decode_step / generate loop; ``batcher`` schedules
multi-tenant requests onto cache slots; ``loop`` runs the batcher as a
serve tick of the train loop and ingests finished traffic into the
store; ``sharded_decode`` is the sequence-sharded decode attention and
the model-group serving builders."""
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.engine import (ServeState, decode_step, generate,
                                        init_serve_state, prefill)
from repro_torch.serving.loop import (ServeLoop, TrafficIngest,
                                      make_synthetic_traffic)
from repro_torch.serving.sharded_decode import (decode_cache_specs,
                                                make_mesh_serving,
                                                sharded_decode_attention)

__all__ = ["ServeState", "init_serve_state", "prefill", "decode_step",
           "generate", "sharded_decode_attention", "ContinuousBatcher",
           "Request", "ServeLoop", "TrafficIngest", "make_synthetic_traffic",
           "decode_cache_specs", "make_mesh_serving"]
