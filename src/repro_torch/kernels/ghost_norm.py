"""Wrapper of the CUDA ghost-norm Gram kernel (sequence-shared linears).

The kernel (``csrc/ghost_norm.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/ghost_norm.py::ghost_norm``.  The wrapper takes CUDA
tensors only: it checks devices, dtypes, shapes and contiguity, allocates
the output and the scratch, launches on the current stream without
synchronising, and raises if a launch is refused.  Nothing falls back.

Two instances; ``uses_tensor_cores`` states the rule.  A bf16 x whose
tensors TMA can map (x and d base addresses and row pitches, din·2 and
dout·(d's element size) bytes, multiples of 16) runs the tensor-core
instance (``wgmma`` on TMA-fed tiles, f32 d split into two bf16 parts):
three kernel launches a call (the x Gram tiles into a (rows, n_pairs,
4096) f32 scratch; the d Gram over feature splits, one scalar a (row,
split, pair) into a (rows, splits, n_pairs) scratch; the fixed-order row
sums).  Every other call (f32 x, or a pitch TMA cannot take) runs the SIMT
instance: two launches (the Gram partials into (rows, n_pairs), the row
sums).  ``ghost_norm.launches`` counts calls of the op and
``ghost_norm.tc_launches`` those of the tensor-core instance.  CPU tensors
go to the plain versions through ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernel's library once;
    every pointer and the stream are c_void_p."""
    lib = _build.load("ghost_norm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gn_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, p, p, p]
    lib.gn_launch.restype = i
    lib.gn_pairs.argtypes = [i, i]
    lib.gn_pairs.restype = i
    lib.gn_tile.restype = i
    lib.gn_max_pairs.restype = i
    lib.gn_tc_tile_elems.restype = i
    lib.gn_tc_splits.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
    lib.gn_tc_splits.restype = i
    lib.gn_tc_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.gn_tc_launch.restype = i
    lib.gn_error_string.argtypes = [i]
    lib.gn_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, d: torch.Tensor) -> None:
    for name, a in (("x", x), ("d", d)):
        if a.device.type != "cuda" or a.device != x.device:
            raise ValueError(f"{name} is on {a.device}; the CUDA kernel needs "
                             f"x and d on one CUDA device")
        if a.dtype not in _DTYPES:
            raise TypeError(f"{name} has dtype {a.dtype}; the kernel takes "
                            f"float32 or bfloat16")
        if a.ndim != 3:
            raise ValueError(f"{name} has shape {tuple(a.shape)}; need "
                             f"(rows, S, width)")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x.shape[:2] != d.shape[:2]:
        raise ValueError(f"x {tuple(x.shape)} and d {tuple(d.shape)} differ "
                         f"in (rows, S)")


def uses_tensor_cores(x: torch.Tensor, d: torch.Tensor) -> bool:
    """Whether a call on x and d takes the tensor-core instance: x bf16
    (d f32 or bf16), both widths ≥ 1, and what TMA needs, namely both base
    addresses and both row pitches multiples of 16 bytes."""
    din, dout = x.shape[-1], d.shape[-1]
    return (x.dtype == torch.bfloat16 and din > 0 and dout > 0
            and din * x.element_size() % 16 == 0
            and dout * d.element_size() % 16 == 0
            and x.data_ptr() % 16 == 0 and d.data_ptr() % 16 == 0)


def _raise_on(lib: ctypes.CDLL, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"ghost_norm launch failed: "
                           f"{lib.gn_error_string(code).decode()}")


def ghost_norm(x: torch.Tensor, d: torch.Tensor, *,
               symmetric: bool = False) -> torch.Tensor:
    """||X_nᵀD_n||²_F per row. x:(R,S,din) d:(R,S,dout) → f32[R].

    ``symmetric`` computes only the tile pairs j ≥ i and counts j > i
    twice (the reference kernel's option, and its default False)."""
    _check(x, d)
    rows, s, din = x.shape
    dout = d.shape[2]
    dev = x.device
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0 or s == 0:
        return out.zero_()
    lib = _lib()
    n_pairs = lib.gn_pairs(s, int(symmetric))
    if n_pairs > lib.gn_max_pairs():
        raise ValueError(f"S={s} gives {n_pairs} tile pairs a row; the "
                         f"kernel's grid takes at most {lib.gn_max_pairs()}")
    current = torch.cuda.current_stream(dev)
    stream = current.cuda_stream
    d_bf16 = int(d.dtype == torch.bfloat16)
    tc = uses_tensor_cores(x, d)
    if tc:
        splits = ctypes.c_int(0)
        _raise_on(lib, lib.gn_tc_splits(rows, s, dout, int(symmetric),
                                        d_bf16, dev.index,
                                        ctypes.byref(splits)))
        gx = torch.empty(rows, n_pairs, lib.gn_tc_tile_elems(),
                         dtype=torch.float32, device=dev)
        partial = torch.empty(rows, splits.value, n_pairs,
                              dtype=torch.float32, device=dev)
        _raise_on(lib, lib.gn_tc_launch(
            x.data_ptr(), d.data_ptr(), d_bf16, rows, s, din, dout,
            int(symmetric), splits.value, dev.index, gx.data_ptr(),
            partial.data_ptr(), out.data_ptr(), stream))
    else:
        partial = torch.empty(rows, n_pairs, dtype=torch.float32, device=dev)
        _raise_on(lib, lib.gn_launch(
            x.data_ptr(), d.data_ptr(), int(x.dtype == torch.bfloat16),
            d_bf16, rows, s, din, dout, int(symmetric), dev.index,
            partial.data_ptr(), out.data_ptr(), stream))
    ghost_norm.launches += 1
    ghost_norm.tc_launches += int(tc)
    ghost_norm.side_launches += int(current != torch.cuda.default_stream(dev))
    return out


ghost_norm.launches = 0
ghost_norm.tc_launches = 0        # of those, the tensor-core instance
ghost_norm.side_launches = 0      # of those, off the default stream
