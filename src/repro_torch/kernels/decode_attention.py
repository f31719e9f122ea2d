"""Wrapper of the CUDA flash-decode kernel (one query token vs a KV cache).

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/decode_attention.py::decode_attention``.  The wrapper
takes CUDA tensors only: it checks devices, dtypes, shapes, contiguity and
alignment, picks the split of the cache axis, allocates the output and the
f32 scratch of per-split partials, launches on the current stream without
synchronising, and raises if a launch is refused.  The dtype alone picks
the kernel: bf16 runs the tensor-core instance (``mma.sync`` with the rep
query heads of a KV group as M, bf16 tiles in a ``cp.async`` ring), f32
the SIMT one.  ``decode_attention.launches`` counts calls, each two kernel
launches (the splits, then their fixed-order merge), and
``decode_attention.tc_launches`` those of the tensor-core instance.  CPU
tensors go to the plain version through ``kernels/ops.py``.

Every allocation is a ``torch.empty`` on the current stream, so the call
can be captured in a CUDA graph (the scratch then comes from the graph's
pool).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_attention_operands

BLOCKS_PER_SM = 1     # split blocks an SM the split aims at
SLOTS = 32            # a block's slot range is a multiple of this (da_slots)
MAX_REP = 16          # query heads per KV head (da_max_rep)


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernel's library once;
    every pointer and the stream are c_void_p."""
    lib = _build.load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.da_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                              ctypes.c_float, i, p, p, p, p]
    lib.da_launch.restype = i
    lib.da_slots.restype = i
    lib.da_max_rep.restype = i
    lib.da_error_string.argtypes = [i]
    lib.da_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(bsz: int, hkv: int, s: int,
               num_sms: int) -> tuple[int, int]:
    """(chunk, n_split): the cache axis of S slots cut into n_split ranges
    of ``chunk`` slots (a multiple of SLOTS), as many as S allows up to
    BLOCKS_PER_SM blocks an SM over the grid (n_split, Hkv, B): one wave of
    resident blocks, no tail."""
    units = math.ceil(s / SLOTS)
    want = max(1, BLOCKS_PER_SM * num_sms // (bsz * hkv))
    n_split = max(1, min(units, want))
    chunk = math.ceil(units / n_split) * SLOTS
    return chunk, math.ceil(s / chunk)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q:(B,H,hd) k,v:(B,S,Hkv,hd) lengths:(B,) int32 → (B,H,hd) in q's
    dtype: attention over cache slots [0, lengths[b]); zeros for length 0."""
    check_attention_operands(q, k, v, 3, MAX_REP)
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (q.shape[0],) or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a contiguous int32 ({q.shape[0]},) "
                         f"tensor on {q.device}; got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    bsz, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if bsz == 0 or s == 0:
        return torch.zeros_like(q)
    chunk, n_split = split_plan(bsz, hkv, s, _num_sms(dev.index))
    rep = h // hkv
    bf16 = q.dtype == torch.bfloat16
    part_o = torch.empty(bsz, hkv, n_split, rep, hd, dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty(bsz, hkv, n_split, rep, 2, dtype=torch.float32,
                          device=dev)
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.da_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        int(bf16), bsz, s, h, hkv, hd, chunk, n_split, 1.0 / (hd ** 0.5),
        dev.index, part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"decode_attention launch failed: "
                           f"{lib.da_error_string(code).decode()}")
    decode_attention.launches += 1
    decode_attention.tc_launches += int(bf16)
    return out


decode_attention.launches = 0
decode_attention.tc_launches = 0       # of those, the bf16 tensor-core kernel
