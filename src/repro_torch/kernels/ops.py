"""Public dispatch of the port's kernels.

A CUDA tensor goes to the hand-written CUDA kernel, which launches or
raises; a CPU tensor goes to the plain PyTorch version of
``kernels/ref.py``.  The choice follows only from where the tensors lie:
nothing catches a kernel failure and falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import per_example_sqnorm as _pes
from repro_torch.kernels import ref


def _on_cuda(tensors) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels take all "
                     f"CUDA or all CPU tensors")


def per_example_sqnorm(x: torch.Tensor, d: torch.Tensor,
                       with_bias: bool = True) -> torch.Tensor:
    """Paper Prop. 1: (B,din),(B,dout) → f32[B] squared grad-norm."""
    if _on_cuda((x, d)):
        return _pes.per_example_sqnorm(x, d, with_bias=with_bias)
    return ref.per_example_sqnorm_ref(x, d, with_bias=with_bias)


def per_example_sqnorm_multi(xs, ds, with_bias: bool = True) -> torch.Tensor:
    """Σ_t Prop. 1 over T rank-1 taps; on CUDA one launch, bitwise equal to
    chained single-tap launches."""
    xs, ds = tuple(xs), tuple(ds)
    if _on_cuda(xs + ds):
        return _pes.per_example_sqnorm_multi(xs, ds, with_bias=with_bias)
    return ref.per_example_sqnorm_multi_ref(xs, ds, with_bias=with_bias)
