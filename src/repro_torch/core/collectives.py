"""Group-polymorphic collectives (``src/repro/core/collectives.py``).

Every step helper of the sharded ISSGD step takes a data group
(``repro_torch.dist.DataGroup``), ``None`` for one device, where these
helpers are exact local arithmetic.  Every collective the step needs is
a sum or a max over the group: ``torch.distributed.all_reduce`` with
SUM or MAX (NCCL on the card, one card a rank; gloo on the CPU, and on
CUDA tensors when two ranks share a card).

The example axis is laid out contiguously: global row ``g`` lives on
rank ``g // n_local`` at offset ``g % n_local``.  A cross-rank read is a
one-owner masked sum: the other ranks add exact zeros, so the result is
the owner's row bit for bit, which keeps a sharded run on the draws of
the one-device run.

``COUNTS`` counts the all-reduces made and the elements they carried;
``chip_smoke.py`` reads it to report a step's traffic.  The model-axis
operators of the reference (``psum_backward``, ``psum_forward``,
``scatter_seq``, ``all_gather_replicated``) belong to model
parallelism, which this port does not carry yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import DataGroup, axis_info

COUNTS = {"all_reduce": 0, "elements": 0}


def reset_counts() -> None:
    """Zero ``COUNTS``."""
    COUNTS.update(all_reduce=0, elements=0)


def _all_reduce(x: torch.Tensor, group: DataGroup, op) -> torch.Tensor:
    import torch.distributed as dist
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group.pg)
    COUNTS["all_reduce"] += 1
    COUNTS["elements"] += out.numel()
    return out


def psum(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks (a fresh tensor); ``x`` itself
    for one device."""
    if group is None:
        return x
    import torch.distributed as dist
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Elementwise max of ``x`` over the group's ranks; ``x`` itself for
    one device."""
    if group is None:
        return x
    import torch.distributed as dist
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def gather_rows(arrays, idx: torch.Tensor, group: Optional[DataGroup]):
    """Rows at *global* indices ``idx`` of example-axis-sharded tensors
    (one tensor, or a dict of them with a common leading axis), the same
    on every rank.  Each rank takes the rows it owns, clamps the foreign
    ones into its shard and zeroes them, and one all-reduce a tensor
    combines them.  For one device this is ``a[idx]``."""
    if isinstance(arrays, dict):
        return {k: gather_rows(v, idx, group) for k, v in arrays.items()}
    if group is None:
        return arrays[idx]
    rank, _ = axis_info(group)
    n_local = arrays.shape[0]
    lidx = idx - rank * n_local
    mine = (lidx >= 0) & (lidx < n_local)
    return owner_sum(arrays[torch.clamp(lidx, 0, n_local - 1)], mine, group)


def owner_sum(rows: torch.Tensor, mine: torch.Tensor,
              group: Optional[DataGroup]) -> torch.Tensor:
    """The one-owner combine of ``gather_rows`` for rows a rank has
    already taken: the rows where ``mine`` (B,) is False become exact
    zeros and one all-reduce sums them, so each row comes out as its
    owner's bits on every rank.  ``rows`` itself for one device."""
    if group is None:
        return rows
    mask = mine.reshape((-1,) + (1,) * (rows.dim() - 1))
    return psum(torch.where(mask, rows, torch.zeros_like(rows)), group)


def scatter_rows(array: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor,
                 group: Optional[DataGroup] = None) -> torch.Tensor:
    """``array`` (this rank's shard) with ``values`` written at *global*
    indices ``idx``: a rank applies only the writes it owns, and of the
    positions that name one row only the last is written (last write
    wins; a (B, B) upper-triangular equality mask), so the result never
    depends on the order in which the device applies colliding writes.
    The dropped positions go to one scratch row past the end, so the
    write is defined on every device without a host synchronisation."""
    rank, _ = axis_info(group)
    n_local = array.shape[0]
    lidx = idx - rank * n_local
    keep = (lidx >= 0) & (lidx < n_local)
    dup_later = torch.triu(idx[:, None] == idx[None, :], diagonal=1)
    keep = keep & ~dup_later.any(dim=1)
    safe = torch.where(keep, lidx, n_local)
    out = torch.cat([array, array.new_zeros((1,) + array.shape[1:])])
    out.index_put_((safe,), values.to(array.dtype))
    return out[:n_local]
