"""Local ranks for the sharded step (``launch/train.py --mesh N``).

The reference builds a JAX mesh over devices (``src/repro/launch/mesh.py``);
the port runs one process a rank and joins them in a ``torch.distributed``
process group at ``tcp://localhost:<free port>``:

  * ``backend="nccl"`` on the card, rank r on ``cuda:r`` (one card a
    rank; NCCL refuses two ranks on one device);
  * ``backend="gloo"`` on the CPU, and on CUDA tensors when ranks share
    one card (every collective of the step is an all-reduce, which gloo
    takes on CUDA tensors).

A world of one runs in the calling process; a larger one spawns its
ranks and waits for them.  Nothing here touches a device at import.
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


def init_rank(rank: int, world: int, port: int, backend: str,
              device: str) -> DataGroup:
    """Join this process to the world as ``rank``; its data group."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return data_axes()


def _entry(rank: int, fn: Callable, world: int, port: int, backend: str,
           device: str, args: tuple):
    import torch.distributed as dist
    if world > 1:
        # the ranks share the host's cores: oversubscribed intra-op
        # threads would spin against each other at every collective
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dev = rank_device(device, rank, backend)
    group = init_rank(rank, world, port, backend, dev)
    try:
        return fn(group, dev, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, device: str,
              backend: Optional[str] = None, args: tuple = ()):
    """Run ``fn(group, device, *args)`` on each of ``world`` ranks and
    wait for all of them: a world of one in this process (returning what
    ``fn`` returns), a larger one in spawned processes (``fn`` and
    ``args`` must pickle; returns None).  A rank that fails makes this
    raise."""
    backend = backend or default_backend(device)
    check_world(world, device, backend)
    port = free_port()
    if world == 1:
        return _entry(0, fn, 1, port, backend, device, args)
    import torch.multiprocessing as mp
    mp.spawn(_entry, args=(fn, world, port, backend, device, args),
             nprocs=world, join=True)
    return None
