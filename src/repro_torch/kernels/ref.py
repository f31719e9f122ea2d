"""Plain PyTorch versions of the port's kernels.

``*_ref`` mirror ``src/repro/kernels/ref.py``: the CPU path of
``kernels/ops.py`` and the oracle the CUDA kernels are held against.
``*_blocked`` repeat the CUDA kernel's own reduction order (thread
layout, shuffle trees, no FMA) with plain f32 tensor operations, so on
the card a kernel must equal its emulator bitwise.
"""
from __future__ import annotations

import torch

# threads per block of kernels/csrc/per_example_sqnorm.cu (kThreads)
SQNORM_THREADS = 256


# ----------------------------------------------------- per-example sq-norms
def per_example_sqnorm_ref(x: torch.Tensor, d: torch.Tensor,
                           with_bias: bool = True) -> torch.Tensor:
    """Paper Proposition 1 (rank-1 / MLP case).

    x: (B, d_in) layer inputs, d: (B, d_out) = dL/dY.  Returns (B,) f32:
    ||x_n||² ||d_n||² (+ ||d_n||² for the bias)."""
    xs = torch.sum(torch.square(x.float()), dim=-1)
    ds = torch.sum(torch.square(d.float()), dim=-1)
    out = xs * ds
    if with_bias:
        out = out + ds
    return out


def per_example_sqnorm_multi_ref(xs, ds, with_bias: bool = True
                                 ) -> torch.Tensor:
    """Multi-tap oracle: Σ_t per_example_sqnorm_ref(xs[t], ds[t]), chained
    in tap order."""
    out = torch.zeros(xs[0].shape[0], dtype=torch.float32,
                      device=xs[0].device)
    for x, d in zip(xs, ds):
        out = out + per_example_sqnorm_ref(x, d, with_bias=with_bias)
    return out


def _blocked_sumsq(a: torch.Tensor) -> torch.Tensor:
    """(B, n) → (B,) Σa² in the CUDA kernel's order: thread t sums
    elements t, t+T, ... in sequence (zero padding adds exact +0), then a
    shuffle-down tree inside each warp and one over the warps."""
    b, n = a.shape
    a = torch.nn.functional.pad(a.float(), (0, (-n) % SQNORM_THREADS))
    a = a.reshape(b, -1, SQNORM_THREADS)
    acc = torch.zeros(b, SQNORM_THREADS, dtype=torch.float32, device=a.device)
    for j in range(a.shape[1]):
        v = a[:, j]
        acc = acc + v * v
    v = acc.reshape(b, SQNORM_THREADS // 32, 32)
    while v.shape[-1] > 1:               # lanes: off = 16, 8, 4, 2, 1
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    v = v[..., 0]                        # (B, warps)
    while v.shape[-1] > 1:               # warps: off = 4, 2, 1
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def per_example_sqnorm_blocked(x: torch.Tensor, d: torch.Tensor,
                               with_bias: bool = True) -> torch.Tensor:
    """``per_example_sqnorm_ref`` in the CUDA kernel's exact order."""
    xs, ds = _blocked_sumsq(x), _blocked_sumsq(d)
    out = xs * ds
    if with_bias:
        out = out + ds
    return out


def per_example_sqnorm_multi_blocked(xs, ds, with_bias: bool = True
                                     ) -> torch.Tensor:
    """The multi-tap kernel plus its wrapper's chained adds, emulated:
    res = row_0, then res = res + row_t in tap order."""
    res = per_example_sqnorm_blocked(xs[0], ds[0], with_bias)
    for x, d in zip(xs[1:], ds[1:]):
        res = res + per_example_sqnorm_blocked(x, d, with_bias)
    return res
