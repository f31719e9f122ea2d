"""Wrapper of the CUDA selective-scan kernel (the mamba mixer's recurrence).

The kernel (``csrc/selective_scan.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/selective_scan.py::selective_scan``.  The wrapper
takes CUDA tensors only: it checks devices, dtypes, shapes and layouts,
allocates the output, launches on the current stream without
synchronising, and raises if a launch is refused.  Like the TPU kernel it
is forward-only: with grad mode on, an input that requires grad is
refused, since a ctypes launch would drop the gradient without a word.
``selective_scan.launches`` counts calls, one kernel launch each.  CPU
tensors go to the plain version through ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
STATE_SIZES = (4, 8, 16)   # the d_state values the build instantiates
# threads that share one (b, channel) in each d_state instance, as the
# build exports them (ss_lanes): one thread owns all of a channel's states
LANES = {4: 1, 8: 1, 16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernel's library once;
    every pointer and the stream are c_void_p."""
    lib = _build.load("selective_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ss_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.ss_launch.restype = i
    lib.ss_supports.argtypes = [i]
    lib.ss_supports.restype = i
    lib.ss_lanes.argtypes = [i]
    lib.ss_lanes.restype = i
    lib.ss_error_string.argtypes = [i]
    lib.ss_error_string.restype = ctypes.c_char_p
    return lib


def refuse_grad(*tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through the scan: the
    kernel, like the reference's, has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "selective_scan is forward-only (the TPU kernel it ports has no "
            "backward): call it under torch.no_grad(), or use the model's "
            "ssm_mode='ref' path, which autograd differentiates")


def _row_stride(name: str, t: torch.Tensor, s: int, ds: int) -> int:
    """The stride between (b, t) rows of a (B, S, d_state) operand whose
    states are contiguous, e.g. a column slice of the x_proj output."""
    st = t.stride()
    if st[2] != 1 or st[1] < ds or (t.shape[0] > 1 and st[0] != s * st[1]):
        raise ValueError(f"{name} has strides {st}; the kernel needs "
                         f"contiguous states and rows of one stride")
    return st[1]


def _check(u, delta, a, b, c, d) -> tuple[int, int]:
    refuse_grad(u, delta, a, b, c, d)
    named = (("u", u), ("delta", delta), ("a", a), ("b", b), ("c", c),
             ("d", d))
    for name, t in named:
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"{name} is on {t.device}; the CUDA kernel needs "
                             f"every operand on one CUDA device")
    for name, t in named[:2] + named[3:5]:
        if t.dtype not in _DTYPES or t.dtype != u.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes u, "
                            f"delta, b and c all float32 or all bfloat16")
    for name, t in (("a", a), ("d", d)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"float32 A and D")
    if u.ndim != 3 or delta.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and delta "
                         f"{tuple(delta.shape)}: need both (B, S, d_inner)")
    bsz, s, di = u.shape
    if a.ndim != 2 or a.shape[0] != di or d.shape != (di,):
        raise ValueError(f"a {tuple(a.shape)}, d {tuple(d.shape)}: need "
                         f"({di}, d_state) and ({di},)")
    ds = a.shape[1]
    if b.shape != (bsz, s, ds) or c.shape != (bsz, s, ds):
        raise ValueError(f"b {tuple(b.shape)}, c {tuple(c.shape)}: need "
                         f"{(bsz, s, ds)}")
    if ds not in STATE_SIZES:
        raise ValueError(f"d_state {ds}: the kernel is built for "
                         f"{STATE_SIZES}")
    for name, t in (("u", u), ("delta", delta), ("a", a), ("d", d)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return _row_stride("b", b, s, ds), _row_stride("c", c, s, ds)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """The mamba-1 scan.  u, delta: (B, S, d_inner); a: (d_inner, d_state)
    f32; b, c: (B, S, d_state); d: (d_inner,) f32 → y (B, S, d_inner) in
    u's dtype, the state kept in f32."""
    ld_b, ld_c = _check(u, delta, a, b, c, d)
    bsz, s, di = u.shape
    dev = u.device
    y = torch.empty_like(u)
    if bsz and s and di:
        lib = _lib()
        code = lib.ss_launch(
            u.data_ptr(), delta.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), y.data_ptr(),
            int(u.dtype == torch.bfloat16), bsz, s, di, a.shape[1], ld_b,
            ld_c, dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"selective_scan launch failed: "
                               f"{lib.ss_error_string(code).decode()}")
        selective_scan.launches += 1
    return y


selective_scan.launches = 0
