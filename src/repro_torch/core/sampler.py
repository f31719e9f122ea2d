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


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` with the same bits run to run on every device.

    On CUDA, PyTorch scans a tensor that is a single row along ``dim``
    with CUB's decoupled look-back scan, whose float sums depend on the
    order its tiles finish (``chip_smoke.py`` phase 29 counts the repeats
    that differ); in its deterministic mode it takes a deterministic scan
    of the same speed.  The draws' CDFs are scanned in that mode."""
    if x.device.type != "cuda" or torch.are_deterministic_algorithms_enabled():
        return torch.cumsum(x, dim)
    torch.use_deterministic_algorithms(True)
    try:
        return torch.cumsum(x, dim)
    finally:
        torch.use_deterministic_algorithms(False)


def two_stage_sample(weights: torch.Tensor, num_samples: int,
                     num_shards: int = 1,
                     generator: Optional[torch.Generator] = None,
                     uniforms: Optional[torch.Tensor] = None,
                     block_sums: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Draw ``num_samples`` indices ∝ ``weights`` (unnormalized, ≥ 0).

    The uniforms in [0, 1) come from ``generator`` or are injected through
    ``uniforms`` (shape (num_samples,)), so tests can replay the
    reference's draws.  ``block_sums`` supplies the W stage-1 masses from
    the mass index (``--index tree``): ``mass_index.block_masses`` is the
    same reduction as the in-draw one, so the draws stay bitwise equal.
    Returns int64 indices on the weights' device."""
    n = weights.shape[0]
    if n % num_shards:
        raise ValueError(f"table size {n} not divisible by {num_shards} "
                         f"logical shards")
    n_w = n // num_shards
    # f64 tables keep their precision through the CDFs
    ctype = torch.float64 if weights.dtype == torch.float64 else torch.float32
    blocks = weights.to(ctype).reshape(num_shards, n_w)
    if block_sums is None:
        sums = torch.sum(blocks, dim=1)                      # (W,)
    elif block_sums.shape != (num_shards,):
        raise ValueError(f"block_sums shape {tuple(block_sums.shape)} != "
                         f"({num_shards},)")
    else:
        sums = block_sums.to(ctype)
    shard_cdf = cumsum(sums, dim=0)
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
    block_cdf = cumsum(blocks, dim=1)                        # (W, n_w)
    local_u = u - shard_starts[owner]
    pos_all = torch.searchsorted(block_cdf,
                                 local_u.expand(num_shards, -1).contiguous(),
                                 right=True)                 # (W, M)
    pos = pos_all.gather(0, owner[None])[0]
    pos = torch.clamp(pos, 0, n_w - 1)
    return owner * n_w + pos


def index_to_chunk(idx, chunk_size: int):
    """(chunk, offset) of example indices in a store of ``chunk_size``-row
    chunks; works on tensors and numpy arrays alike."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return idx // chunk_size, idx % chunk_size


def chunk_proposal_mass(proposal: torch.Tensor,
                        chunk_size: int) -> torch.Tensor:
    """Per-chunk mass of the proposal, f32[ceil(N / chunk_size)]: the
    mass index's leaf reduction itself (``mass_index.chunk_masses``), so
    the two agree bitwise.  A trailing partial chunk contributes exactly
    its partial mass."""
    from repro_torch.core.mass_index import chunk_masses
    return chunk_masses(proposal, chunk_size)


def sample_indices(weights: torch.Tensor, num_samples: int,
                   num_shards: int = 1,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The host-path multinomial (``src/repro/core/sampler.py::
    sample_indices``): the two-stage draw over ``num_shards`` logical
    blocks, which must match the run it is compared against."""
    return two_stage_sample(weights, num_samples, num_shards=num_shards,
                            generator=generator, uniforms=uniforms)
