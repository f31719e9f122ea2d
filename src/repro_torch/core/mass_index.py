"""Chunk-level mass index: the stage-1 masses of the two-stage draw kept
incrementally, for tables of a billion rows.

  * ``chunk_masses`` — the canonical leaf reduction: the mass of each
    fixed-size chunk of the table, by a fixed pairwise halving over the
    chunk axis (``_row_sums``).  Its adds are elementwise, so a chunk's
    mass has the same bits whether it is summed alone, in a gathered
    block of B chunks or among all C chunks; a library reduction may
    split its work by the row count.  ``sampler.chunk_proposal_mass`` is
    this function.
  * ``block_masses`` — the W stage-1 masses of ``two_stage_sample``,
    the same ``sampler.row_sums`` call on the same (W, n_w) view as the
    draw's own reduction, so tree-mode draws equal dense draws bitwise.
  * ``MassIndex`` — the leaves and a perfect binary segment tree of
    pairwise sums.  ``refresh_chunks`` recomputes only the touched leaves
    and their O(log C) ancestors, each from its children, so the result
    equals ``build_index`` of the updated table bitwise.
  * ``sample_chunks`` — an O(log C) root-to-leaf descent per draw;
    ``indexed_sample`` adds the within-chunk stage-2 over the M winning
    chunks' rows only.  No table-sized CDF or copy is made: the chunk
    rows are a view of the table (or, for a partial tail chunk, a
    gather padded with zeros).

The reference is ``src/repro/core/mass_index.py``; its leaf reduction is
one XLA ``sum``.  In the train step ``--index tree`` routes the W block
masses through ``block_masses`` (``issgd.stage1_block_sums``); the
incremental machinery serves a host-side index maintainer and is what
``chip_smoke.py`` measures at 2^30 rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.sampler import cumsum, row_sums as _row_sums


def _num_chunks(n: int, chunk_size: int) -> int:
    """Chunk count covering n rows, trailing partial chunk included."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return -(-n // chunk_size)


def _chunk_rows(table: torch.Tensor, chunk_size: int,
                chunk_ids: torch.Tensor) -> torch.Tensor:
    """(len(chunk_ids), chunk_size) rows of the given chunks, the part of
    a trailing partial chunk past the table's end read as 0.  A view
    gather when the chunk size divides the table; never a padded copy of
    the whole table."""
    n = table.shape[0]
    if n % chunk_size == 0:
        return table.view(-1, chunk_size)[chunk_ids]
    pos = chunk_ids[:, None] * chunk_size + torch.arange(
        chunk_size, device=table.device)[None, :]
    vals = table[torch.clamp(pos, max=n - 1)]
    return torch.where(pos < n, vals, torch.zeros_like(vals))


def chunk_masses(table: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """Per-chunk mass of a table: the canonical leaf reduction
    (``_row_sums`` over each chunk; the trailing partial chunk summed
    with zeros for its missing rows, as a gather of it would be)."""
    n = table.shape[0]
    chunks = _num_chunks(n, chunk_size)
    full = n // chunk_size
    mass = _row_sums(table[:full * chunk_size].view(full, chunk_size))
    if chunks == full:
        return mass
    tail = _chunk_rows(table, chunk_size, torch.tensor(
        [full], device=table.device))
    return torch.cat([mass, _row_sums(tail)])


def block_masses(table: torch.Tensor, num_blocks: int) -> torch.Tensor:
    """Stage-1 masses of ``num_blocks`` equal contiguous blocks: the
    same reduction ``two_stage_sample`` computes in the draw, so feeding
    them back as ``block_sums`` gives its draws bitwise."""
    n = table.shape[0]
    if n % num_blocks:
        raise ValueError(f"table size {n} not divisible by "
                         f"{num_blocks} blocks")
    ctype = torch.float64 if table.dtype == torch.float64 else torch.float32
    return _row_sums(table.to(ctype).reshape(num_blocks, -1))


class MassIndex(NamedTuple):
    """Chunk-mass leaves and a perfect binary segment tree over them, in
    the 1-indexed layout over P = next_pow2(C) leaves: node i has
    children 2i and 2i+1, the leaves sit at P .. P+C-1, ``tree[1]`` is
    the total mass and ``tree[0]`` is unused."""
    mass: torch.Tensor   # f32[C] leaf chunk masses (trailing chunk partial)
    tree: torch.Tensor   # f32[2P]


def _leaf_base(num_chunks: int) -> int:
    """P: the power-of-two leaf span of the tree for C chunks."""
    return 1 << max(num_chunks - 1, 1).bit_length() if num_chunks > 1 else 1


def tree_from_masses(mass: torch.Tensor) -> torch.Tensor:
    """The segment tree, bottom-up from the leaf masses: log C levels of
    pairwise sums."""
    c = mass.shape[0]
    p = _leaf_base(c)
    leaves = mass.new_zeros(p)
    leaves[:c] = mass
    levels = [leaves]
    while levels[-1].shape[0] > 1:
        lvl = levels[-1].view(-1, 2)
        levels.append(lvl[:, 0] + lvl[:, 1])
    return torch.cat([mass.new_zeros(1)] + levels[::-1])


def build_index(table: torch.Tensor, chunk_size: int) -> MassIndex:
    """Index a table from scratch: the leaf reduction and the tree."""
    mass = chunk_masses(table.float(), chunk_size)
    return MassIndex(mass=mass, tree=tree_from_masses(mass))


def total_mass(index: MassIndex) -> torch.Tensor:
    """The root: the total mass of all chunks."""
    return index.tree[1]


def refresh_chunks(index: MassIndex, table: torch.Tensor, chunk_size: int,
                   chunk_ids: torch.Tensor) -> MassIndex:
    """The index of the (already updated) table, recomputing the leaves
    of ``chunk_ids`` and their ancestors only: O(B·chunk_size + B·log C).

    Leaves come from the canonical reduction (never a delta), and each
    touched ancestor from its two children, so the result is bitwise
    ``build_index(table)``.  Repeated chunk ids write the same value."""
    c = index.mass.shape[0]
    p = _leaf_base(c)
    ids = torch.clamp(chunk_ids.long(), 0, c - 1)
    fresh = _row_sums(_chunk_rows(table.float(), chunk_size, ids))
    mass = index.mass.index_put((ids,), fresh)
    tree = index.tree.clone()
    tree[p + ids] = fresh
    depth = p.bit_length() - 1
    if depth:
        # every level's touched ancestors at once, bottom-up; row n of
        # the (P, 2) view holds node n's children 2n and 2n+1
        shifts = torch.arange(1, depth + 1, device=ids.device)
        ancestors = (p + ids)[None, :] >> shifts[:, None]
        children = tree.view(-1, 2)
        for node in ancestors:
            pair = children[node]
            tree[node] = pair[:, 0] + pair[:, 1]
    return MassIndex(mass=mass, tree=tree)


def sample_chunks(index: MassIndex, u: torch.Tensor) -> torch.Tensor:
    """Chunk ids of draws ``u`` in [0, total) by root-to-leaf descent: go
    left while the draw lands in the left child's mass, else subtract it
    and go right.  The tree is the CDF; no cumsum over chunks is made."""
    c = index.mass.shape[0]
    p = _leaf_base(c)
    node = torch.ones(u.shape, dtype=torch.long, device=u.device)
    rem = u
    while p > 1:
        left = index.tree[2 * node]
        go_right = rem >= left
        rem = torch.where(go_right, rem - left, rem)
        node = 2 * node + go_right.long()
        p //= 2
    return torch.clamp(node - _leaf_base(c), 0, c - 1)


def _prefix_mass(index: MassIndex, chunk: torch.Tensor) -> torch.Tensor:
    """Mass of all chunks before ``chunk``: the left-child masses along
    its root-to-leaf path wherever the path goes right, O(log C)."""
    p = _leaf_base(index.mass.shape[0])
    target = chunk + p
    node = torch.ones(chunk.shape, dtype=torch.long, device=chunk.device)
    acc = torch.zeros(chunk.shape, dtype=torch.float32, device=chunk.device)
    depth = p
    while depth > 1:
        depth //= 2
        went_right = (target // depth) % 2 == 1
        acc = acc + torch.where(went_right, index.tree[2 * node],
                                torch.zeros_like(acc))
        node = 2 * node + went_right.long()
    return acc


def indexed_sample(table: torch.Tensor, index: MassIndex, chunk_size: int,
                   num_samples: int,
                   generator: Optional[torch.Generator] = None,
                   uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A two-stage draw through the index: O(log C) descent to a chunk,
    then the within-chunk stage-2 over the M winning chunks' rows (an f32
    cumsum of (M, chunk_size)).  Uniforms in [0, 1) come from
    ``generator`` or are injected through ``uniforms``.  Returns int64
    indices on the table's device."""
    total = total_mass(index)
    if uniforms is None:
        uniforms = torch.rand(num_samples, generator=generator,
                              device=table.device, dtype=torch.float32)
    elif uniforms.shape != (num_samples,):
        raise ValueError(f"uniforms shape {tuple(uniforms.shape)} != "
                         f"({num_samples},)")
    u = uniforms.to(device=table.device, dtype=torch.float32) * total
    chunk = sample_chunks(index, u)
    rem = u - _prefix_mass(index, chunk)
    cdf = cumsum(_chunk_rows(table.float(), chunk_size, chunk), dim=1)
    pos = torch.sum((cdf <= rem[:, None]).long(), dim=1)
    pos = torch.clamp(pos, 0, chunk_size - 1)
    return torch.clamp(chunk * chunk_size + pos, 0, table.shape[0] - 1)
