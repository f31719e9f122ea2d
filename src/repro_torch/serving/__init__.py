"""Inference layer of the port: cache-backed decode engine, continuous
batching and the train/serve loop on one device (``src/repro/serving/``
without the mesh paths).

``engine`` owns the cache layout (period-major, ring-buffered windows)
and the prefill / decode_step / generate loop; ``batcher`` schedules
multi-tenant requests onto cache slots; ``loop`` runs the batcher as a
serve tick of the train loop and ingests finished traffic into the
store.  The model-parallel decode (``sharded_decode.py``) is not ported
yet."""
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.engine import (ServeState, decode_step, generate,
                                        init_serve_state, prefill)
from repro_torch.serving.loop import (ServeLoop, TrafficIngest,
                                      make_synthetic_traffic)

__all__ = ["ServeState", "init_serve_state", "prefill", "decode_step",
           "generate", "ContinuousBatcher", "Request", "ServeLoop",
           "TrafficIngest", "make_synthetic_traffic"]
