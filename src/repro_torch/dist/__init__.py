"""The mesh axes of the port: ``torch.distributed`` process groups.

The reference writes its step against a tuple of mesh axis names
(``src/repro/dist/sharding.py::data_axes``, ``model_axes``); inside
``shard_map`` they name real axes, and ``()`` is one device.  The port
writes it against groups: a ``DataGroup`` is the process group the
collectives of one axis run over, this process's rank in it and its
size, with one rank a device.  ``None`` stands for one device, where
every collective is exact local arithmetic (``core/collectives.py``).

A world of N·M ranks (``--mesh N --model-parallel M``) is the
reference's ``(data, model)`` mesh with the model axis innermost: rank
r = d·M + m.  Its data group holds the N ranks that share m, its model
group the M ranks that share d (``launch/mesh.py`` makes both); M = 1
has no model group.

The example axis is laid out contiguously over the data group: global
row ``g`` lives on data rank ``g // n_local``.  Parameters are split
over the model group by the logical→mesh rules of ``dist/sharding.py``.
The reference's ``dist/context.py::constrain_batch_dim`` is a hint to
XLA's partitioner; a rank of the port holds only its own batch, so it
has no counterpart here.  Its one use, the batch-split master
(``make_train_step(..., constrain_batch=)``), is the port's
``split_batch``: a rank takes its ``batch_block`` of the minibatch's
rows, and a ``BatchSplit`` tells a mixture-of-experts layer that its
tokens are one block of a larger batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class DataGroup(NamedTuple):
    """One mesh axis (the data axis, or the model axis): the process
    group (``None`` for the default group), this process's rank in it
    and the number of ranks."""
    pg: object
    rank: int
    size: int


def data_axes(pg=None) -> Optional[DataGroup]:
    """The data group over ``pg`` (default: the default process group),
    or ``None`` when ``torch.distributed`` is not initialised: one
    device."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return DataGroup(pg, dist.get_rank(pg), dist.get_world_size(pg))


def axis_info(group: Optional[DataGroup]) -> tuple[int, int]:
    """(this rank, the number of ranks); (0, 1) for one device."""
    return (0, 1) if group is None else (group.rank, group.size)


class BatchSplit(NamedTuple):
    """A minibatch of ``rows`` rows whose ``batch_block``s are spread over
    the ranks of ``group``, one a rank: what a layer that mixes rows (the
    MoE router's capacity) needs to act on the whole minibatch."""
    group: DataGroup
    rows: int


def batch_block(rows: int, group: Optional[DataGroup]) -> tuple[int, int]:
    """[lo, hi): this rank's contiguous block of ``rows`` rows, as
    ``torch.tensor_split(·, size)[rank]`` cuts it (the first ``rows %
    size`` ranks take one row more); (0, rows) for one device."""
    rank, size = axis_info(group)
    q, r = divmod(rows, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


__all__ = ["BatchSplit", "DataGroup", "axis_info", "batch_block",
           "data_axes"]
