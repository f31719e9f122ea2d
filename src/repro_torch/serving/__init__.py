"""Inference layer of the port: cache-backed decode engine + continuous
batching on one device (``src/repro/serving/`` without the mesh paths).

``engine`` owns the cache layout (period-major, ring-buffered windows)
and the prefill / decode_step / generate loop; ``batcher`` schedules
multi-tenant requests onto cache slots.  The train/serve loop
(``loop.py``) and the model-parallel decode (``sharded_decode.py``) are
not ported yet."""
from repro_torch.serving.batcher import ContinuousBatcher, Request
from repro_torch.serving.engine import (ServeState, decode_step, generate,
                                        init_serve_state, prefill)

__all__ = ["ServeState", "init_serve_state", "prefill", "decode_step",
           "generate", "ContinuousBatcher", "Request"]
