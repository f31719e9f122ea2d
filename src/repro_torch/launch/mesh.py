"""Local ranks for the sharded step (``launch/train.py --mesh N``).

The reference builds a JAX mesh over devices (``src/repro/launch/mesh.py``);
the port runs one process a rank and joins them in a ``torch.distributed``
process group over a TCP store on localhost (``run_world`` holds the
store itself, on a port the system picks, so that no other process can
take the port between its choice and the rendezvous):

  * ``backend="nccl"`` on the card, rank r on ``cuda:r`` (one card a
    rank; NCCL refuses two ranks on one device);
  * ``backend="gloo"`` on the CPU, and on CUDA tensors when ranks share
    one card (every collective of the step is an all-reduce, which gloo
    takes on CUDA tensors).

A world of one runs in the calling process; a larger one spawns its
ranks and waits for them.  With ``model_parallel`` M > 1 the world is
N·M ranks, rank r = d·M + m (the model axis innermost, as in the
reference's ``(data, model)`` mesh): every rank makes every data group
(the ranks that share m) and every model group (the ranks that share d)
with ``dist.new_group``, in one order, and keeps its own two.  Nothing
here touches a device at import.
"""
from __future__ import annotations

import socket
from typing import Callable, Optional

import torch

from repro_torch.dist import DataGroup, data_axes


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device: str) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device: str, rank: int, backend: str) -> str:
    """The device rank ``rank`` runs on: ``cuda:rank`` under NCCL, else
    ``device`` itself (the CPU, or one card its ranks share)."""
    if backend == "nccl" and torch.device(device).type == "cuda":
        return f"cuda:{rank}"
    return device


def check_world(world: int, device: str, backend: str) -> None:
    """Refuse a world that the devices cannot hold, naming the count."""
    if world < 1:
        raise ValueError(f"--mesh {world}: need at least one rank")
    if backend == "nccl" and torch.device(device).type == "cuda":
        count = torch.cuda.device_count()
        if world > count:
            raise ValueError(f"--mesh {world} runs one rank a card over "
                             f"NCCL, and this machine has {count} CUDA "
                             f"device(s)")


def mesh_groups(rank: int, world: int, model_parallel: int
                ) -> tuple[DataGroup, DataGroup]:
    """(data group, model group) of ``rank`` in an initialised world of
    N·M ranks, M = ``model_parallel``: every data group is made first,
    then every model group, on every rank in this order (``new_group``
    is collective over the whole world)."""
    import torch.distributed as dist
    m_size = model_parallel
    if world % m_size:
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"model groups of {m_size}")
    n_size = world // m_size
    data_pgs = [dist.new_group([d * m_size + m for d in range(n_size)])
                for m in range(m_size)]
    model_pgs = [dist.new_group([d * m_size + m for m in range(m_size)])
                 for d in range(n_size)]
    d, m = divmod(rank, m_size)
    return (DataGroup(data_pgs[m], d, n_size),
            DataGroup(model_pgs[d], m, m_size))


def init_rank(rank: int, world: int, port: int, backend: str,
              device: str, model_parallel: int = 1, store=None):
    """Join this process to the world as ``rank``: its data group, or,
    with ``model_parallel`` > 1, its (data group, model group).  The
    rendezvous is at ``tcp://localhost:<port>``, or through ``store``, a
    ``TCPStore`` (or its port, as an int, to connect to one that
    another process holds)."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if isinstance(store, int):
        store = dist.TCPStore("localhost", store, world, is_master=False)
    if store is None:
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
    else:
        dist.init_process_group(backend, store=store, world_size=world,
                                rank=rank)
    if model_parallel > 1:
        return mesh_groups(rank, world, model_parallel)
    return data_axes()


def _entry(rank: int, fn: Callable, world: int, store, backend: str,
           device: str, args: tuple, model_parallel: int = 1):
    import torch.distributed as dist
    if world > 1:
        # the ranks share the host's cores: oversubscribed intra-op
        # threads would spin against each other at every collective
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dev = rank_device(device, rank, backend)
    groups = init_rank(rank, world, 0, backend, dev, model_parallel,
                       store=store)
    try:
        if model_parallel > 1:
            group, model_group = groups
            return fn(group, dev, *args, model_group=model_group)
        return fn(groups, dev, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, device: str,
              backend: Optional[str] = None, args: tuple = (),
              model_parallel: int = 1):
    """Run ``fn(group, device, *args)`` on each of ``world`` ranks and
    wait for all of them: a world of one in this process (returning what
    ``fn`` returns), a larger one in spawned processes (``fn`` and
    ``args`` must pickle; returns None).  With ``model_parallel`` M > 1
    the world holds ``world`` // M data ranks of M model ranks each, and
    ``fn`` also takes its model group, ``fn(group, device, *args,
    model_group=...)``.  A rank that fails makes this raise.  This
    process holds the world's TCP store for as long as the ranks run."""
    import torch.distributed as dist
    backend = backend or default_backend(device)
    check_world(world, device, backend)
    store = dist.TCPStore("localhost", 0, world, is_master=True,
                          wait_for_workers=False)
    if world == 1:
        return _entry(0, fn, 1, store, backend, device, args)
    import torch.multiprocessing as mp
    mp.spawn(_entry, args=(fn, world, store.port, backend, device, args,
                           model_parallel),
             nprocs=world, join=True)
    return None
