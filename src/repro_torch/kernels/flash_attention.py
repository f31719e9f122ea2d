"""Wrapper of the CUDA flash-attention forward kernel (prefill).

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention``.  The wrapper
takes CUDA tensors only: it checks devices, dtypes, shapes, contiguity and
alignment, allocates the output (and the lse), launches on the current
stream without synchronising, and raises if a launch is refused.  The
dtype alone picks the kernel: bf16 runs the tensor-core instance (wgmma on
TMA-fed tiles), f32 the SIMT one.  ``flash_attention.launches`` counts
calls, one kernel launch each, and ``flash_attention.tc_launches`` those of
the tensor-core instance.  CPU tensors go to the plain version through
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)     # the head dims the build instantiates
MAX_REP = 64                  # query heads per KV head (fa_max_rep)


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernel's library once;
    every pointer and the stream are c_void_p."""
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fa_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                              ctypes.c_float, i, p]
    lib.fa_launch.restype = i
    lib.fa_max_rep.restype = i
    lib.fa_error_string.argtypes = [i]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def check_attention_operands(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_dims: int,
                             max_rep: int, aligned: bool = True) -> None:
    """Raise unless q, k, v are contiguous (and, with ``aligned``, 16-byte
    aligned) f32 or bf16 CUDA tensors of one dtype and device, k and v
    (B, S, Hkv, hd), q ``q_dims``-D with its heads a multiple of Hkv, at
    most ``max_rep`` query heads a KV head, and hd one of ``HEAD_DIMS``."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.device.type != "cuda" or a.device != q.device:
            raise ValueError(f"{name} is on {a.device}; the CUDA kernel needs "
                             f"q, k and v on one CUDA device")
        if a.dtype not in _DTYPES or a.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {a.dtype}; the kernel takes "
                            f"q, k, v all float32 or all bfloat16")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if aligned and a.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if k.ndim != 4 or k.shape != v.shape or q.ndim != q_dims:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; need k = v (B, S, Hkv, hd)")
    hkv, hd = k.shape[2], k.shape[3]
    h = q.shape[-2]
    if q.shape[0] != k.shape[0] or q.shape[-1] != hd or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}: batch, head dim, or heads not a "
                         f"multiple of the KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if h // hkv > max_rep:
        raise ValueError(f"{h // hkv} query heads per KV head; the kernel "
                         f"takes at most {max_rep}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, return_lse: bool = False):
    """Causal (sliding-window when ``window`` > 0) GQA attention forward.
    q:(B,S,H,hd) k,v:(B,S,Hkv,hd) → (B,S,H,hd) in q's dtype, and with
    ``return_lse`` the (B,H,S) f32 logsumexp."""
    check_attention_operands(q, k, v, 4, MAX_REP)
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"q has S={q.shape[1]}, k has S={k.shape[1]}")
    bsz, s, h, hd = q.shape
    hkv = k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    lse = (torch.empty(bsz, h, s, dtype=torch.float32, device=dev)
           if return_lse else None)
    if bsz and s:
        lib = _lib()
        code = lib.fa_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            int(q.dtype == torch.bfloat16), bsz, s, h, hkv, hd, int(window),
            hd ** -0.5, dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"flash_attention launch failed: "
                               f"{lib.fa_error_string(code).decode()}")
        flash_attention.launches += 1
        flash_attention.tc_launches += int(q.dtype == torch.bfloat16)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.tc_launches = 0        # of those, the bf16 tensor-core kernel
