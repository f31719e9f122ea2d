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

import torch


@dataclasses.dataclass
class ArrayDataset:
    """A dict of tensors with a common leading example axis."""
    arrays: dict

    @property
    def size(self) -> int:
        """Number of examples (the common leading-axis length)."""
        return next(iter(self.arrays.values())).shape[0]


def gather_batch(arrays: dict, indices: torch.Tensor) -> dict:
    """Row-gather every tensor of a dataset dict at `indices`."""
    return {k: v.index_select(0, indices) for k, v in arrays.items()}


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
