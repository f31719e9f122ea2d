"""Public dispatch of the port's kernels.

A CUDA tensor goes to the hand-written CUDA kernel, which launches or
raises; a CPU tensor goes to the plain PyTorch version of
``kernels/ref.py``.  The choice follows only from where the tensors lie:
nothing catches a kernel failure and falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ghost_norm as _gn
from repro_torch.kernels import per_example_sqnorm as _pes
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss


# the CUDA wrappers and their launch counters (``launches``, and
# ``tc_launches`` / ``scored`` / ``side_launches`` where a wrapper keeps
# them).  Every counter counts launches on any stream; ``side_launches``
# counts those off the device's default stream (the async pipeline's
# scoring stream).
_COUNTED = (_pes.per_example_sqnorm, _pes.per_example_sqnorm_multi,
            _gn.ghost_norm, _fa.flash_attention, _da.decode_attention,
            _fab.flash_attention_bwd, _fab.attn_score_sweep,
            _ss.selective_scan)
_COUNTERS = ("launches", "tc_launches", "scored", "side_launches")


def launch_counts() -> dict:
    """(wrapper, counter name) → value, for every launch counter of the
    CUDA wrappers."""
    return {(fn, name): getattr(fn, name) for fn in _COUNTED
            for name in _COUNTERS if hasattr(fn, name)}


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` ((wrapper, counter name) → n) to the counters: a CUDA
    graph replays its launches without running the wrappers."""
    for (fn, name), n in delta.items():
        setattr(fn, name, getattr(fn, name) + n)


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


# --------------------------------------------------------------- ghost norm
def ghost_cost(s: int, din: int, dout: int) -> float:
    """FLOPs of the Gram path per example."""
    return float(s) * s * (din + dout)


def direct_cost(s: int, din: int, dout: int) -> float:
    """FLOPs of the materialized per-example gradient path."""
    return float(s) * din * dout


def ghost_norm(x: torch.Tensor, d: torch.Tensor, symmetric: bool = True,
               force: str | None = None) -> torch.Tensor:
    """||X_nᵀD_n||²_F per example, x:(B,S,din) d:(B,S,dout) → f32[B].

    Takes the cheaper of the Gram path and the direct path by the
    reference's FLOP rule (``src/repro/kernels/ops.py::ghost_norm``): Gram
    when S·(din+dout) ≤ din·dout.  ``force`` in {"gram", "direct"} pins
    either path on either device.

    * Gram path: on CUDA tensors the CUDA kernel, which launches or raises;
      on CPU tensors ``ref.ghost_norm_ref``.  The reference's CPU branch
      always takes the direct path, because there the Gram kernel runs in
      Pallas interpret mode; the port's plain Gram is not an interpreter,
      so the same cost rule holds on both devices.  (The direct path at an
      LM's unembed would materialize din·dout f32 per example.)
    * Direct path: ``ref.ghost_norm_direct_ref``, a plain einsum on both
      devices, as the reference computes it outside any Pallas kernel.
    """
    if force not in (None, "gram", "direct"):
        raise ValueError(f"force must be None, 'gram' or 'direct', got "
                         f"{force!r}")
    _, s, din = x.shape
    dout = d.shape[2]
    use_gram = ghost_cost(s, din, dout) <= direct_cost(s, din, dout)
    if force is not None:
        use_gram = force == "gram"
    on_cuda = _on_cuda((x, d))
    if not use_gram:
        return ref.ghost_norm_direct_ref(x, d)
    if on_cuda:
        return _gn.ghost_norm(x, d, symmetric=symmetric)
    return ref.ghost_norm_ref(x, d)


# ----------------------------------------------------------- selective scan
def selective_scan(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """Mamba-1 selective scan (``src/repro/kernels/ops.py::selective_scan``).
    u, delta: (B, S, d_inner); a: (d_inner, d_state); b, c:
    (B, S, d_state); d: (d_inner,) → y (B, S, d_inner) in u's dtype.

    Forward-only, like the TPU kernel: with grad mode on, an input that
    requires grad raises on either device.  Any S and d_inner: the
    reference's padding to its tiles (Δ padded with 1) changes no real
    output, since padded steps follow every real step and channels are
    independent, so neither the CUDA kernel (which bounds-checks) nor the
    plain version on CPU tensors pads."""
    _ss.refuse_grad(u, delta, a, b, c, d)
    if _on_cuda((u, delta, a, b, c, d)):
        return _ss.selective_scan(u, delta, a, b, c, d)
    return ref.selective_scan_kernel_ref(u, delta, a, b, c, d)


# ---------------------------------------------------------------- attention
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, return_lse: bool = False):
    """Causal GQA flash attention forward (the prefill hot path).
    q:(B,S,H,hd) k,v:(B,S,Hkv,hd) → (B,S,H,hd) in q's dtype, plus the
    (B,H,S) f32 logsumexp with ``return_lse``."""
    if _on_cuda((q, k, v)):
        return _fa.flash_attention(q, k, v, window=window,
                                   return_lse=return_lse)
    return ref.flash_attention_kernel_ref(q, k, v, window=window,
                                          return_lse=return_lse)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Flash-decode GQA attention over a (possibly partial) KV cache.
    q:(B,H,hd) k,v:(B,S,Hkv,hd) lengths:(B,) → (B,H,hd); zeros for a row
    of length 0."""
    if _on_cuda((q, k, v, lengths)):
        return _da.decode_attention(q, k, v, lengths.to(torch.int32))
    return ref.decode_attention_kernel_ref(q, k, v, lengths)


# ------------------------------------------------- trainable flash attention
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        window: int = 0, with_scores: bool = False):
    """FlashAttention-2 backward from the forward's lse: (dq, dk, dv) and,
    with ``with_scores``, the (B,) f32 ||dQ_n||²+||dK_n||²+||dV_n||²."""
    if _on_cuda((q, k, v, o, lse, do)):
        return _fab.flash_attention_bwd(q, k, v, o, lse, do, window=window,
                                        with_scores=with_scores)
    return ref.flash_attention_bwd_kernel_ref(q, k, v, o, lse, do,
                                              window=window,
                                              with_scores=with_scores)


def attn_grad_sqnorm(dq: torch.Tensor, dk: torch.Tensor,
                     dv: torch.Tensor) -> torch.Tensor:
    """(B,) per-example ||dQ||²+||dK||²+||dV||² through the score sweep:
    for f32 gradients bitwise equal to the fused ``with_scores`` score."""
    if _on_cuda((dq, dk, dv)):
        return _fab.attn_score_sweep(dq, dk, dv)
    return ref.attn_score_sweep_kernel_ref(dq, dk, dv)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel (saving its lse), backward kernel.  ``score_tap`` is
    None or a (B,) tap the primal ignores; when it needs a gradient, that
    gradient is the fused score of the backward's epilogue."""

    @staticmethod
    def forward(ctx, q, k, v, score_tap, window):
        o, lse = flash_attention(q, k, v, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        with_scores = ctx.needs_input_grad[3]
        out = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                  window=ctx.window, with_scores=with_scores)
        return (*out, None) if with_scores else (*out, None, None)


def make_flash_attention_trainable(window: int = 0,
                                   with_scores: bool = False):
    """Differentiable flash attention: the forward kernel and the
    FlashAttention-2 backward kernel as one ``torch.autograd.Function``,
    the forward's lse the residual; no S×S tensor in either direction.

    With ``with_scores`` the op takes a fourth (B,) f32 ``score_tap``
    argument, ignored by the primal, whose gradient is the per-example
    score ||dQ_n||²+||dK_n||²+||dV_n||² of the backward's epilogue."""
    if with_scores:
        return lambda q, k, v, score_tap: _FlashAttention.apply(
            q, k, v, score_tap, window)
    return lambda q, k, v: _FlashAttention.apply(q, k, v, None, window)


class _QKVScoreProbe(torch.autograd.Function):
    """Identity on (q, k, v); the backward sweeps the cotangents."""

    @staticmethod
    def forward(ctx, q, k, v, score_tap):
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        scores = None
        if ctx.needs_input_grad[3]:
            scores = attn_grad_sqnorm(dq.contiguous(), dk.contiguous(),
                                      dv.contiguous())
        return dq, dk, dv, scores


def make_qkv_score_probe():
    """Identity op (q, k, v, score_tap) → (q, k, v) whose backward runs
    the score sweep on the gradients and returns it as the tap's gradient.
    Placed before the plain trainable flash attention it is the separate
    twin of ``with_scores=True``: the same score, re-read from the
    materialized dQ, dK, dV."""
    return _QKVScoreProbe.apply
