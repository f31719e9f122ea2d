"""Wrappers of the CUDA flash-attention backward and score-sweep kernels.

The kernels (``csrc/flash_attention_bwd.cu``) replace the Pallas TPU
kernels ``src/repro/kernels/flash_attention_bwd.py::flash_attention_bwd``
and ``::attn_score_sweep``.  The wrappers take CUDA tensors only: they
check devices, dtypes, shapes and contiguity, compute D = rowsum(dO ∘ O)
with PyTorch (the reference computes it outside its Pallas calls too),
allocate the outputs and the (B, parts) scratch of score partials,
launch on the current stream without synchronising, and raise if a
launch is refused.

The dtype alone picks the kernels: bf16 runs the tensor-core instances
(wgmma on TMA-fed tiles) of the backward and the flat-span instance of
the sweep, f32 the SIMT ones, whose sweep repeats the fused epilogue's
tiles.
``flash_attention_bwd.launches`` counts calls (the dK/dV and dQ kernels,
and with scores the row reducer: two or three kernel launches a call),
``flash_attention_bwd.scored`` those with scores,
``flash_attention_bwd.tc_launches`` those of the tensor-core instances;
``attn_score_sweep.launches`` counts calls (the sweep and the reducer).
CPU tensors go to the plain versions through ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_attention_operands

MAX_REP = 64                  # query heads per KV head (fab_max_rep)


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' library once;
    every pointer and the stream are c_void_p."""
    lib = _build.load("flash_attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fab_launch.argtypes = [p] * 11 + [i] * 7 + [ctypes.c_float, i, p]
    lib.fab_launch.restype = i
    lib.fab_sweep_launch.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.fab_sweep_launch.restype = i
    lib.fab_parts.argtypes = [i, i, i]
    lib.fab_parts.restype = i
    lib.fab_sweep_parts.argtypes = [i] * 5
    lib.fab_sweep_parts.restype = i
    lib.fab_sweep16_chunk.restype = i
    lib.fab_max_rep.restype = i
    lib.fab_error_string.argtypes = [i]
    lib.fab_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, a: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if a.device != device or a.dtype != dtype or \
            tuple(a.shape) != tuple(shape) or not a.is_contiguous():
        raise ValueError(f"{name} is {a.dtype} {tuple(a.shape)} on "
                         f"{a.device}; need it contiguous, {dtype} "
                         f"{tuple(shape)} on {device}")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_lib().fab_error_string(code).decode()}")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, window: int = 0,
                        with_scores: bool = False):
    """(dq, dk, dv) of causal (sliding-window when ``window`` > 0) GQA
    attention, shaped and typed as q, k, v; with ``with_scores`` also the
    (B,) f32 score ||dQ_b||² + ||dK_b||² + ||dV_b||² of the f32 gradients
    before the cast.  o and do like q; lse (B, H, S) f32 from the forward."""
    check_attention_operands(q, k, v, 4, MAX_REP)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"q has S={q.shape[1]}, k has S={k.shape[1]}")
    bsz, s, h, hd = q.shape
    hkv = k.shape[2]
    dev = q.device
    _check("o", o, q.dtype, q.shape, dev)
    _check("do", do, q.dtype, q.shape, dev)
    _check("lse", lse, torch.float32, (bsz, h, s), dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scores = torch.empty(bsz, dtype=torch.float32, device=dev) \
        if with_scores else None
    if bsz == 0 or s == 0:
        return (dq, dk, dv, scores.zero_()) if with_scores else (dq, dk, dv)
    lib = _lib()
    dvec = torch.sum(do.float() * o.float(), dim=-1).transpose(1, 2)
    dvec = dvec.contiguous()                                    # (B, H, S)
    partial = torch.empty(bsz, lib.fab_parts(s, h, hkv), dtype=torch.float32,
                          device=dev) if with_scores else None
    code = lib.fab_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), partial.data_ptr() if with_scores else None,
        scores.data_ptr() if with_scores else None,
        int(q.dtype == torch.bfloat16), bsz, s, h, hkv, hd, int(window),
        hd ** -0.5, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.scored += int(with_scores)
    flash_attention_bwd.tc_launches += int(q.dtype == torch.bfloat16)
    return (dq, dk, dv, scores) if with_scores else (dq, dk, dv)


flash_attention_bwd.launches = 0
flash_attention_bwd.scored = 0         # of those, calls with scores
flash_attention_bwd.tc_launches = 0    # of those, the bf16 tensor-core kernels


def attn_score_sweep(dq: torch.Tensor, dk: torch.Tensor,
                     dv: torch.Tensor) -> torch.Tensor:
    """(B,) f32 ||dQ_b||² + ||dK_b||² + ||dV_b||² from materialized
    gradients.  f32 gradients take the fused epilogue's tiles and order,
    so the score is bitwise equal to ``flash_attention_bwd(with_scores=
    True)``; bf16 gradients are read as three flat spans an example in
    16-byte pieces, in the order of ``ref.attn_score_sweep_bf16_blocked``
    (a base off 16 bytes takes the same order in scalar loads)."""
    check_attention_operands(dq, dk, dv, 4, MAX_REP, aligned=False)
    if dq.shape[1] != dk.shape[1]:
        raise ValueError(f"dq has S={dq.shape[1]}, dk has S={dk.shape[1]}")
    bsz, s, h, hd = dq.shape
    hkv = dk.shape[2]
    dev = dq.device
    scores = torch.empty(bsz, dtype=torch.float32, device=dev)
    if bsz == 0 or s == 0:
        return scores.zero_()
    lib = _lib()
    bf16 = int(dq.dtype == torch.bfloat16)
    partial = torch.empty(bsz, lib.fab_sweep_parts(bf16, s, h, hkv, hd),
                          dtype=torch.float32, device=dev)
    code = lib.fab_sweep_launch(
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partial.data_ptr(),
        scores.data_ptr(), bf16, bsz, s, h, hkv, hd, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "attn_score_sweep")
    attn_score_sweep.launches += 1
    return scores


attn_score_sweep.launches = 0
