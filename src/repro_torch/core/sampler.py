"""Two-stage multinomial (with replacement) draw from the ω̃ table.

The table is divided into W contiguous *logical scoring shards*.  Each
uniform draw picks a shard through the W-entry CDF of shard totals, then
resolves within that shard against the shard's own CDF.  W, not the
device count, fixes the arithmetic: with a data group
(``repro_torch.dist.DataGroup``) each rank holds W / ranks of the shards,
shares its shard totals with one all-reduce of W floats, resolves only
the draws that land in its own shards and one all-reduce of the M
indices combines them, so no rank ever holds the whole table.  Every
per-shard reduction and scan is one whose bits do not depend on how many
shards a rank holds, so a sharded draw equals the one-device draw from
the same uniforms, and that equals the reference's
(``src/repro/core/sampler.py::two_stage_sample``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.collectives import axis_info, psum
from repro_torch.dist import DataGroup


def cumsum(x: torch.Tensor, dim: int,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.cumsum`` with the same bits run to run on every device.

    On CUDA, PyTorch scans a tensor that is a single row along ``dim``
    with CUB's decoupled look-back scan, whose float sums depend on the
    order its tiles finish (``chip_smoke.py`` phase 29 counts the repeats
    that differ); in its deterministic mode it takes a deterministic scan
    of the same speed.  The draws' CDFs are scanned in that mode."""
    if x.device.type != "cuda" or torch.are_deterministic_algorithms_enabled():
        return torch.cumsum(x, dim, out=out)
    torch.use_deterministic_algorithms(True)
    try:
        return torch.cumsum(x, dim, out=out)
    finally:
        torch.use_deterministic_algorithms(False)


def row_sums(rows: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis of (R, k) rows by a fixed pairwise halving:
    column j adds column j + ⌊k/2⌋, an odd last column carries over.
    Every add is elementwise, so a row's sum does not depend on R (a
    library reduction may split its work by the row count): a shard's
    total has the same bits on a rank that holds it alone as among all
    W shards."""
    while rows.shape[1] > 1:
        k = rows.shape[1]
        h = k // 2
        s = rows[:, :h] + rows[:, h:2 * h]
        rows = s if k % 2 == 0 else torch.cat([s, rows[:, 2 * h:]], dim=1)
    return rows[:, 0]


def _block_cdfs(blocks: torch.Tensor) -> torch.Tensor:
    """Each shard's CDF, scanned one shard at a time: a scan of several
    rows may take another kernel than a scan of one, so one shard's CDF
    has the same bits whatever number of shards a rank holds."""
    out = torch.empty_like(blocks)
    for b in range(blocks.shape[0]):
        cumsum(blocks[b], 0, out=out[b])
    return out


def shard_totals(weights: torch.Tensor, num_shards: int = 1,
                 block_sums: Optional[torch.Tensor] = None,
                 group: Optional[DataGroup] = None) -> torch.Tensor:
    """The W stage-1 masses of the table, the same on every rank: this
    rank's ``num_shards`` shard totals (``row_sums``, or ``block_sums``
    from the mass index) in its slots of a W vector, one all-reduce over
    the group.  ``torch.sum`` of it is the table's total with the same
    bits on any number of ranks."""
    n_local = weights.shape[0]
    if n_local % num_shards:
        raise ValueError(f"table size {n_local} not divisible by "
                         f"{num_shards} logical shards")
    ctype = torch.float64 if weights.dtype == torch.float64 else torch.float32
    if block_sums is None:
        local = row_sums(weights.to(ctype).reshape(num_shards, -1))
    elif block_sums.shape != (num_shards,):
        raise ValueError(f"block_sums shape {tuple(block_sums.shape)} != "
                         f"({num_shards},)")
    else:
        local = block_sums.to(ctype)
    if group is None:
        return local
    rank, n_dev = axis_info(group)
    sums = local.new_zeros(num_shards * n_dev)
    sums[rank * num_shards:(rank + 1) * num_shards] = local
    return psum(sums, group)


def two_stage_sample(weights: torch.Tensor, num_samples: int,
                     num_shards: int = 1,
                     generator: Optional[torch.Generator] = None,
                     uniforms: Optional[torch.Tensor] = None,
                     block_sums: Optional[torch.Tensor] = None,
                     group: Optional[DataGroup] = None,
                     totals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw ``num_samples`` global indices ∝ ``weights`` (unnormalized,
    ≥ 0), this rank's slice of the table viewed as ``num_shards``
    contiguous logical shards (all of it for one device).

    The uniforms in [0, 1) come from ``generator`` or are injected through
    ``uniforms`` (shape (num_samples,)), so tests can replay the
    reference's draws; every rank must draw the same ones (a generator
    seeded alike on every rank).  ``block_sums`` supplies this rank's
    stage-1 masses from the mass index (``--index tree``):
    ``mass_index.block_masses`` is the same reduction as the in-draw one,
    so the draws stay bitwise equal.  ``totals`` passes the W masses
    ``shard_totals`` already gave (the master pass shares them with its
    Σw).  Returns int64 indices on the weights' device, the same on every
    rank."""
    if totals is None:
        totals = shard_totals(weights, num_shards, block_sums, group)
    n_local = weights.shape[0]
    n_w = n_local // num_shards
    rank, n_dev = axis_info(group)
    total_shards = num_shards * n_dev
    if totals.shape != (total_shards,):
        raise ValueError(f"totals shape {tuple(totals.shape)} != "
                         f"({total_shards},)")
    first = rank * num_shards
    ctype = totals.dtype      # f64 tables keep their precision
    blocks = weights.to(ctype).reshape(num_shards, n_w)
    shard_cdf = cumsum(totals, dim=0)
    total = shard_cdf[-1]
    shard_starts = shard_cdf - totals

    if uniforms is None:
        uniforms = torch.rand(num_samples, generator=generator,
                              device=weights.device, dtype=ctype)
    elif uniforms.shape != (num_samples,):
        raise ValueError(f"uniforms shape {tuple(uniforms.shape)} != "
                         f"({num_samples},)")
    u = uniforms.to(device=weights.device, dtype=ctype) * total

    owner = torch.clamp(torch.searchsorted(shard_cdf, u, right=True),
                        0, total_shards - 1)
    lb = torch.clamp(owner - first, 0, num_shards - 1)
    # resolve within the winning shard: search each of this rank's shard
    # CDFs for every draw (w_loc·M·log n_w work, no (M, n_w) gather) and
    # keep the owner's row
    local_u = u - shard_starts[owner]
    pos_all = torch.searchsorted(_block_cdfs(blocks),
                                 local_u.expand(num_shards, -1).contiguous(),
                                 right=True)                 # (w_loc, M)
    pos = torch.clamp(pos_all.gather(0, lb[None])[0], 0, n_w - 1)
    gidx = rank * n_local + lb * n_w + pos
    if group is None:
        return gidx
    mine = (owner >= first) & (owner < first + num_shards)
    return psum(torch.where(mine, gidx, torch.zeros_like(gidx)), group)


def index_to_chunk(idx, chunk_size: int):
    """(chunk, offset) of example indices in a store of ``chunk_size``-row
    chunks; works on tensors and numpy arrays alike."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return idx // chunk_size, idx % chunk_size


def chunk_proposal_mass(proposal: torch.Tensor, chunk_size: int,
                        group: Optional[DataGroup] = None) -> torch.Tensor:
    """Per-chunk mass of the (rank-local) proposal, f32[ceil(N /
    chunk_size)], the same on every rank: the mass index's leaf reduction
    itself (``mass_index.chunk_masses``), so the two agree bitwise.  Rank
    r's chunks sit in the block starting at r · local chunks, and one
    all-reduce of that vector shares them.  A trailing partial chunk
    contributes exactly its partial mass."""
    from repro_torch.core.mass_index import chunk_masses
    local = chunk_masses(proposal, chunk_size)
    if group is None:
        return local
    rank, n_dev = axis_info(group)
    mass = local.new_zeros(local.shape[0] * n_dev)
    mass[rank * local.shape[0]:(rank + 1) * local.shape[0]] = local
    return psum(mass, group)


def sample_indices(weights: torch.Tensor, num_samples: int,
                   num_shards: int = 1,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The host-path multinomial (``src/repro/core/sampler.py::
    sample_indices``): the two-stage draw over ``num_shards`` logical
    blocks, which must match the run it is compared against."""
    return two_stage_sample(weights, num_samples, num_shards=num_shards,
                            generator=generator, uniforms=uniforms)
