"""Wrappers of the CUDA per-example squared-norm kernels (paper Prop. 1).

The kernels (``csrc/per_example_sqnorm.cu``) replace the Pallas TPU
kernels of ``src/repro/kernels/per_example_sqnorm.py``.  These wrappers
take CUDA tensors only: they check devices, dtypes, shapes and
contiguity, allocate the outputs, launch on the current stream without
synchronising, and raise if the launch is refused.  ``launches`` on each
wrapper counts its kernel launches.  CPU tensors go to the plain
versions through ``kernels/ops.py``, never through here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


class _Tap(ctypes.Structure):
    """Mirror of ``struct PesTap`` in the CUDA source."""
    _fields_ = [("x", ctypes.c_void_p), ("d", ctypes.c_void_p),
                ("din", ctypes.c_int), ("dout", ctypes.c_int),
                ("x_bf16", ctypes.c_int), ("d_bf16", ctypes.c_int)]


@functools.cache
def _lib() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' library once.
    Every pointer and the stream are c_void_p: an untyped Python int
    would be passed as a 32-bit int and cut."""
    lib = _build.load("per_example_sqnorm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pes_launch.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
    lib.pes_launch.restype = i
    lib.pes_multi_launch.argtypes = [ctypes.POINTER(_Tap), i, i, i, i, i, p,
                                     p]
    lib.pes_multi_launch.restype = i
    lib.pes_threads.restype = i
    lib.pes_max_taps.restype = i
    lib.pes_error_string.argtypes = [i]
    lib.pes_error_string.restype = ctypes.c_char_p
    return lib


def _check(xs, ds) -> tuple[int, torch.device]:
    """Validate the taps; returns (batch, device)."""
    if len(xs) != len(ds) or not xs:
        raise ValueError(f"need matching non-empty tap lists, got "
                         f"{len(xs)} x and {len(ds)} d")
    b = xs[0].shape[0] if xs[0].ndim == 2 else -1
    dev = xs[0].device
    for t, (x, d) in enumerate(zip(xs, ds)):
        for name, a in (("x", x), ("d", d)):
            if a.device.type != "cuda" or a.device != dev:
                raise ValueError(f"tap {t} {name} is on {a.device}; the "
                                 f"CUDA kernel needs every tap on {dev} "
                                 f"(a CUDA device)")
            if a.dtype not in _DTYPES:
                raise TypeError(f"tap {t} {name} has dtype {a.dtype}; the "
                                f"kernel takes float32 or bfloat16")
            if a.ndim != 2 or a.shape[0] != b:
                raise ValueError(f"tap {t} {name} has shape "
                                 f"{tuple(a.shape)}; need (B={b}, width)")
            if not a.is_contiguous():
                raise ValueError(f"tap {t} {name} is not contiguous")
    return b, dev


def _raise_on(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.pes_error_string(code).decode()}")


def _tap(x: torch.Tensor, d: torch.Tensor) -> _Tap:
    return _Tap(x.data_ptr(), d.data_ptr(), x.shape[1], d.shape[1],
                int(x.dtype == torch.bfloat16), int(d.dtype == torch.bfloat16))


def per_example_sqnorm(x: torch.Tensor, d: torch.Tensor, *,
                       with_bias: bool = True) -> torch.Tensor:
    """out[n] = ||x[n]||²·||d[n]||² (+||d[n]||²). x:(B,din) d:(B,dout) →
    f32[B], one CUDA launch."""
    b, dev = _check([x], [d])
    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _lib()
    tap = _tap(x, d)
    code = lib.pes_launch(tap.x, tap.d, tap.x_bf16, tap.d_bf16, b, tap.din,
                          tap.dout, int(with_bias), dev.index,
                          out.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, code, "per_example_sqnorm")
    per_example_sqnorm.launches += 1
    return out


per_example_sqnorm.launches = 0


def per_example_sqnorm_multi(xs, ds, *, with_bias: bool = True
                             ) -> torch.Tensor:
    """Σ_t ||xs[t][n]||²·||ds[t][n]||² (+||ds[t][n]||²) → f32[B].

    One launch computes every tap's row with the single-tap kernel's row
    code and chains the rows in tap order, so the result equals chained
    ``per_example_sqnorm`` launches bitwise.  More than the kernel's table
    size of taps take one launch per table, each adding its rows onto the
    running sum in order."""
    xs, ds = list(xs), list(ds)
    b, dev = _check(xs, ds)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _lib()
    current = torch.cuda.current_stream(dev)
    stream = current.cuda_stream
    cap = lib.pes_max_taps()
    for lo in range(0, len(xs), cap):
        chunk = [_tap(x, d) for x, d in zip(xs[lo:lo + cap], ds[lo:lo + cap])]
        table = (_Tap * len(chunk))(*chunk)
        code = lib.pes_multi_launch(table, len(chunk), b, int(with_bias),
                                    int(lo > 0), dev.index, out.data_ptr(),
                                    stream)
        _raise_on(lib, code, "per_example_sqnorm_multi")
        per_example_sqnorm_multi.launches += 1
        per_example_sqnorm_multi.side_launches += int(
            current != torch.cuda.default_stream(dev))
    return out


per_example_sqnorm_multi.launches = 0
# of those, launched on a stream other than the device's default one (the
# async pipeline's scoring stream)
per_example_sqnorm_multi.side_launches = 0
