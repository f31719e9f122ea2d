"""The data axis of the port: one ``torch.distributed`` process group.

The reference writes its step against a tuple of mesh axis names
(``src/repro/dist/sharding.py::data_axes``); inside ``shard_map`` they
name real axes, and ``()`` is one device.  The port writes it against a
``DataGroup``: the process group the collectives run over, this
process's rank in it and its size, with one rank a device.  ``None``
stands for one device, where every collective is exact local
arithmetic (``core/collectives.py``).

The example axis is laid out contiguously: global row ``g`` lives on
rank ``g // n_local``.  The model axis (the logical→mesh rules of
``dist/sharding.py`` and the activation context of ``dist/context.py``)
belongs to model parallelism, which this port does not carry yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional


class DataGroup(NamedTuple):
    """One data axis: the process group (``None`` for the default group),
    this process's rank in it and the number of ranks."""
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


__all__ = ["DataGroup", "axis_info", "data_axes"]
