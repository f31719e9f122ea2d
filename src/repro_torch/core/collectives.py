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

The model-axis operators of the reference (``psum_backward``,
``psum_forward``, ``scatter_seq``, ``all_gather_replicated``) are
``torch.autograd.Function``s over the model group (``None`` for M = 1,
where each is the identity both ways).  Each is an all-reduce too:
the gather writes this rank's chunk at its offset in zeros and sums,
which is exact (one owner a position) and runs on every backend (gloo
takes all-reduce on the CUDA tensors of ranks that share one card).

``COUNTS`` counts the all-reduces made and the elements and bytes they
carried, the data axis's (``all_reduce``, ``elements``, ``bytes``) apart
from the model axis's (``model_all_reduce``, ``model_elements``,
``model_bytes`` and the largest message, ``model_max_elements``);
``chip_smoke.py`` reads it to report a step's traffic, and
``launch/op_cost.py`` a dry run's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import DataGroup, axis_info

COUNTS = {"all_reduce": 0, "elements": 0, "bytes": 0,
          "model_all_reduce": 0, "model_elements": 0, "model_bytes": 0,
          "model_max_elements": 0}


def reset_counts() -> None:
    """Zero ``COUNTS``."""
    for k in COUNTS:
        COUNTS[k] = 0


def _all_reduce(x: torch.Tensor, group: DataGroup, op,
                model: bool = False) -> torch.Tensor:
    import torch.distributed as dist
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group.pg)
    nbytes = out.numel() * out.element_size()
    if model:
        COUNTS["model_all_reduce"] += 1
        COUNTS["model_elements"] += out.numel()
        COUNTS["model_bytes"] += nbytes
        COUNTS["model_max_elements"] = max(COUNTS["model_max_elements"],
                                           out.numel())
    else:
        COUNTS["all_reduce"] += 1
        COUNTS["elements"] += out.numel()
        COUNTS["bytes"] += nbytes
    return out


def model_sum(x: torch.Tensor, model_group: Optional[DataGroup]
              ) -> torch.Tensor:
    """Sum of ``x`` over the model group, outside autograd (a scorer's
    partial per-example norms, a gradient's partial square-sums); ``x``
    itself for M = 1."""
    if model_group is None:
        return x
    import torch.distributed as dist
    return _all_reduce(x, model_group, dist.ReduceOp.SUM, model=True)


class _PsumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return model_sum(ct, ctx.group), None


class _PsumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return model_sum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def _chunk_in_zeros(x: torch.Tensor, group: DataGroup, dim: int,
                    full: int) -> torch.Tensor:
    """``x`` (this rank's chunk of ``dim``) at its offset in zeros of the
    full length."""
    shape = list(x.shape)
    shape[dim] = full
    z = x.new_zeros(shape)
    z.narrow(dim, group.rank * x.shape[dim], x.shape[dim]).copy_(x)
    return z


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.full = group, dim, x.shape[dim]
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, ct):
        z = _chunk_in_zeros(ct, ctx.group, ctx.dim, ctx.full)
        return model_sum(z, ctx.group), None, None


class _AllGatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.local = group, dim, x.shape[dim]
        z = _chunk_in_zeros(x, group, dim, x.shape[dim] * group.size)
        return model_sum(z, group)

    @staticmethod
    def backward(ctx, ct):
        local = ctx.local
        return (ct.narrow(ctx.dim, ctx.group.rank * local, local)
                .contiguous(), None, None)


def psum_backward(x: torch.Tensor, model_group: Optional[DataGroup]
                  ) -> torch.Tensor:
    """Identity forward, sum over the model group backward (Megatron's
    "f"): the replicated input of a column-sharded linear, whose
    cotangent on each rank is only its columns' part."""
    if model_group is None:
        return x
    return _PsumBackward.apply(x, model_group)


def psum_forward(x: torch.Tensor, model_group: Optional[DataGroup]
                 ) -> torch.Tensor:
    """Sum over the model group forward, identity backward: the partial
    output of a row-sharded linear, for consumers that are replicated
    over the group (their cotangent is each partial's exact one)."""
    if model_group is None:
        return x
    return _PsumForward.apply(x, model_group)


def scatter_seq(x: torch.Tensor, model_group: Optional[DataGroup],
                dim: int = 1) -> torch.Tensor:
    """This rank's contiguous chunk of ``dim`` of a replicated tensor,
    the entry of a sequence-parallel segment.  Backward: each chunk's
    cotangent at its offset in zeros, summed over the group, so the
    replicated input gets the replicated full cotangent (one owner a
    position: exact)."""
    if model_group is None:
        return x
    dim = dim % x.dim()
    if x.shape[dim] % model_group.size:
        raise ValueError(f"dim {dim} of length {x.shape[dim]} does not "
                         f"split over {model_group.size} model ranks")
    return _ScatterSeq.apply(x, model_group, dim)


def all_gather_replicated(x: torch.Tensor, model_group: Optional[DataGroup],
                          dim: int = -1) -> torch.Tensor:
    """The ranks' chunks of ``dim`` concatenated in rank order, for a
    consumer replicated over the group (Megatron's "g", the transpose of
    ``psum_backward``): the backward keeps this rank's chunk of the
    cotangent, which every rank holds whole."""
    if model_group is None:
        return x
    return _AllGatherReplicated.apply(x, model_group, dim % x.dim())


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
