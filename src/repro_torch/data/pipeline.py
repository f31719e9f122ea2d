"""Index-addressable datasets.

ISSGD draws examples by index from the proposal, so a dataset is a dict
of tensors with a common leading example axis, resident on the device.

`make_svhn_like` builds the synthetic stand-in for the paper's SVHN-2
experiment (the recipe of ``src/repro/data/pipeline.py``, drawn from a
``torch.Generator``): a permutation-invariant classification problem
whose examples have *heterogeneous* gradient norms (cluster structure +
noisy slices + label noise), the property ISSGD exploits.
`make_token_dataset` is the synthetic LM corpus of the same module.
"""
from __future__ import annotations

import dataclasses
import math

import torch


#: Gather modes of ``take_rows`` (``src/repro/data/pipeline.py``): the
#: hot paths build their indices in bounds and promise it; "clip" clamps
#: for callers that mask clamped rows afterwards; "fill" poisons
#: out-of-range rows so that a schedule bug shows instead of repeating a
#: row silently.
GATHER_MODES = ("promise_in_bounds", "clip", "fill")


def _fill_value(dtype: torch.dtype):
    """JAX's ``mode="fill"`` value: NaN for floats, the minimum of a
    signed and the maximum of an unsigned integer, True for bool."""
    if dtype == torch.bool:
        return True
    if dtype.is_floating_point or dtype.is_complex:
        return math.nan
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def take_rows(array: torch.Tensor, indices: torch.Tensor,
              mode: str = "promise_in_bounds") -> torch.Tensor:
    """Row gather with an explicit out-of-bounds mode, as JAX's
    ``array.at[indices].get(mode=...)``: negative indices count from the
    end; then "promise_in_bounds" is a plain index, "clip" clamps to the
    first or last row and "fill" gives ``_fill_value`` rows."""
    if mode not in GATHER_MODES:
        raise ValueError(f"mode={mode!r} not in {GATHER_MODES}")
    if mode == "promise_in_bounds":
        return array[indices]
    n = array.shape[0]
    idx = torch.where(indices < 0, indices + n, indices)
    safe = torch.clamp(idx, 0, max(n - 1, 0))
    rows = array.index_select(0, safe)
    if mode == "clip":
        return rows
    oob = ((idx < 0) | (idx >= n)).reshape((-1,) + (1,) * (array.dim() - 1))
    return torch.where(oob, torch.full_like(rows, _fill_value(array.dtype)),
                       rows)


@dataclasses.dataclass
class ArrayDataset:
    """A dict of tensors with a common leading example axis."""
    arrays: dict

    @property
    def size(self) -> int:
        """Number of examples (the common leading-axis length)."""
        return next(iter(self.arrays.values())).shape[0]

    def batch(self, indices: torch.Tensor,
              mode: str = "promise_in_bounds") -> dict:
        """The rows at ``indices`` of every tensor (``take_rows``)."""
        return gather_batch(self.arrays, indices, mode=mode)

    def slice(self, start: int, count: int) -> dict:
        """``count`` contiguous rows from ``start``, placed as
        ``lax.dynamic_slice_in_dim`` places them: a negative start counts
        from the end, then the start is clamped so the slice fits."""
        n = self.size
        start = start + n if start < 0 else start
        start = min(max(start, 0), max(n - count, 0))
        return {k: v[start:start + count] for k, v in self.arrays.items()}


def gather_batch(arrays: dict, indices: torch.Tensor,
                 mode: str = "promise_in_bounds") -> dict:
    """Row-gather every tensor of a dataset dict at `indices`
    (``take_rows`` per tensor)."""
    return {k: take_rows(v, indices, mode=mode) for k, v in arrays.items()}


def make_svhn_like(generator: torch.Generator, n: int = 65_536,
                   dim: int = 3072, classes: int = 10,
                   noisy_frac: float = 0.15, label_noise: float = 0.05,
                   dtype: torch.dtype = torch.float32
                   ) -> tuple[ArrayDataset, ArrayDataset]:
    """Synthetic permutation-invariant SVHN clone on the generator's
    device. Returns (train, test)."""
    device = generator.device
    n_test = max(n // 10, classes)

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    def uniform(m):
        return torch.rand(m, generator=generator, device=device)

    means = normal(classes, dim) * 1.2

    def sample(m):
        y = torch.randint(0, classes, (m,), generator=generator,
                          device=device)
        # heteroscedastic noise: a noisy slice of examples is much harder
        noisy = uniform(m) < noisy_frac
        scale = torch.where(noisy, 3.0, 0.7)[:, None]
        x = means[y] + normal(m, dim) * scale
        # label noise on a sub-slice: persistent high-gradient examples
        flip = uniform(m) < label_noise
        y_obs = torch.where(flip, (y + 1) % classes, y)
        return x.to(dtype), y_obs.to(torch.int32)

    x_tr, y_tr = sample(n)
    x_te, y_te = sample(n_test)
    # standardize like pixel preprocessing (population std, as the reference)
    mu = x_tr.mean(dim=0, keepdim=True)
    sd = x_tr.std(dim=0, keepdim=True, correction=0) + 1e-6
    return (ArrayDataset({"x": (x_tr - mu) / sd, "y": y_tr}),
            ArrayDataset({"x": (x_te - mu) / sd, "y": y_te}))


def make_token_dataset(generator: torch.Generator, n: int = 4096,
                       seq: int = 128, vocab: int = 512,
                       num_patterns: int = 32) -> ArrayDataset:
    """Synthetic LM corpus on the generator's device (the recipe of
    ``src/repro/data/pipeline.py::make_token_dataset``): each example
    repeats one of ``num_patterns`` 16-token motifs, a per-example share
    in [0, 0.5) of its tokens replaced by noise, so examples genuinely
    differ in difficulty."""
    device = generator.device

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=device)

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    motif_len = 16
    motifs = randint(vocab, (num_patterns, motif_len))
    which = randint(num_patterns, (n,))
    reps = -(-seq // motif_len)
    base = motifs[which].repeat(1, reps)[:, :seq]
    rate = uniform(n, 1) * 0.5
    noise = randint(vocab, (n, seq))
    corrupt = uniform(n, seq) < rate
    tokens = torch.where(corrupt, noise, base)
    return ArrayDataset({"tokens": tokens.to(torch.int32)})
