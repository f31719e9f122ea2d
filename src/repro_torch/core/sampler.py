"""Two-stage multinomial (with replacement) draw from the ω̃ table.

The table is divided into W contiguous *logical scoring shards*.  Each
uniform draw picks a shard through the W-entry CDF of shard totals, then
resolves within that shard against the shard's own CDF.  W, not the
device count, fixes the arithmetic, so this single-device form draws
what the reference's sharded draw draws from the same uniforms
(``src/repro/core/sampler.py::two_stage_sample`` with ``axes=()``).
"""
from __future__ import annotations

from typing import Optional

import torch


def two_stage_sample(weights: torch.Tensor, num_samples: int,
                     num_shards: int = 1,
                     generator: Optional[torch.Generator] = None,
                     uniforms: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Draw ``num_samples`` indices ∝ ``weights`` (unnormalized, ≥ 0).

    The uniforms in [0, 1) come from ``generator`` or are injected through
    ``uniforms`` (shape (num_samples,)), so tests can replay the
    reference's draws.  Returns int64 indices on the weights' device."""
    n = weights.shape[0]
    if n % num_shards:
        raise ValueError(f"table size {n} not divisible by {num_shards} "
                         f"logical shards")
    n_w = n // num_shards
    # f64 tables keep their precision through the CDFs
    ctype = torch.float64 if weights.dtype == torch.float64 else torch.float32
    blocks = weights.to(ctype).reshape(num_shards, n_w)
    sums = torch.sum(blocks, dim=1)                          # (W,)
    shard_cdf = torch.cumsum(sums, dim=0)
    total = shard_cdf[-1]
    shard_starts = shard_cdf - sums

    if uniforms is None:
        uniforms = torch.rand(num_samples, generator=generator,
                              device=weights.device, dtype=ctype)
    elif uniforms.shape != (num_samples,):
        raise ValueError(f"uniforms shape {tuple(uniforms.shape)} != "
                         f"({num_samples},)")
    u = uniforms.to(device=weights.device, dtype=ctype) * total

    owner = torch.clamp(torch.searchsorted(shard_cdf, u, right=True),
                        0, num_shards - 1)
    # resolve within the winning shard: search every shard's CDF for every
    # draw (W·M·log n_w work, no (M, n_w) gather) and keep the owner's row
    block_cdf = torch.cumsum(blocks, dim=1)                  # (W, n_w)
    local_u = u - shard_starts[owner]
    pos_all = torch.searchsorted(block_cdf,
                                 local_u.expand(num_shards, -1).contiguous(),
                                 right=True)                 # (W, M)
    pos = pos_all.gather(0, owner[None])[0]
    pos = torch.clamp(pos, 0, n_w - 1)
    return owner * n_w + pos


def sample_indices(weights: torch.Tensor, num_samples: int,
                   num_shards: int = 1,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The host-path multinomial (``src/repro/core/sampler.py::
    sample_indices``): the two-stage draw over ``num_shards`` logical
    blocks, which must match the run it is compared against."""
    return two_stage_sample(weights, num_samples, num_shards=num_shards,
                            generator=generator, uniforms=uniforms)
