"""Cost of one rank's work, measured on a run of it (the port's
counterpart of ``src/repro/launch/hlo_cost.py``).

The reference walks the optimized HLO text of a compiled program: XLA's
``cost_analysis`` counts a while-loop body once, so its walker multiplies
every called computation by the loop's trip count.  The port has no
compiled program to read.  ``analyze`` runs the function itself, eagerly,
usually on fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``:
shapes and dtypes, no storage, no arithmetic) and with the collectives on
the ``fake`` process-group backend (no message is sent), and counts what
the run dispatched:

  flops             ``torch.utils.flop_counter.FlopCounterMode``: 2·M·N·K
                    for every matmul, bmm, baddbmm and convolution, as the
                    walker counts dots and convolutions.  An eager run
                    executes every loop trip, so no trip count is needed.
  io_bytes          the output bytes of every op that materialises a
                    tensor (every op but the views; an in-place op counts
                    the tensor it writes), the walker's post-fusion
                    buffer-write proxy for memory traffic, before fusion.
  collective_bytes  the bytes of every all-reduce message, read from
                    ``core/collectives.COUNTS``: every collective the port
                    issues is an all-reduce, so ``collective_by_op`` has
                    the one key ``"all-reduce"``.
  argument_bytes    the storages of the arguments, alive from the start.
  peak_bytes        the most bytes of storage alive at once over the run,
                    arguments included: each op's new storages are added
                    when they appear and taken off when the last tensor
                    that holds them dies.

A step that remats (``ModelConfig.remat``, ``models/remat.py``) re-runs
each checkpointed region inside its backward, under the same modes, so
the recompute's FLOPs, written bytes and allocations are counted, as
XLA's analyses count the recompute of the reference's ``jax.checkpoint``.

The HLO-text parser (the symbol table, the loop-condition trip counts)
has no counterpart here: nothing is parsed.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import collectives


@dataclasses.dataclass
class Cost:
    """What ``analyze`` counted over one run."""
    flops: float = 0.0
    io_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0


def _storage(t: torch.Tensor) -> tuple[int, int]:
    """(identity, bytes) of a tensor's storage."""
    s = t.untyped_storage()
    return s._cdata, s.nbytes()


class LiveBytes(TorchDispatchMode):
    """A dispatch mode that keeps the bytes of storage alive (``live``),
    their most (``peak``) and the output bytes of the materialising ops
    (``io_bytes``).  A storage counts from the op that returned it until
    the last tensor this mode saw holding it is freed."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.io_bytes = 0
        self._held: dict[int, list] = {}     # storage → [holders, bytes]

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage alive until ``t`` is freed."""
        key, nbytes = _storage(t)
        ref = self._held.get(key)
        if ref is None:
            self._held[key] = ref = [0, nbytes]
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        ref[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._held[key]
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._held[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        view = getattr(func, "is_view", False)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                if not view:
                    self.io_bytes += t.numel() * t.element_size()
                self.hold(t)
        return out


def tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            key, nbytes = _storage(t)
            seen[key] = nbytes
    return sum(seen.values())


def analyze(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once and count its cost (module
    docstring).  ``args`` hold fake or real tensors alike; the caller
    enters the ``FakeTensorMode`` (and the fake process group) that made
    them.  The counters of ``core/collectives.COUNTS`` are restored
    afterwards."""
    saved = dict(collectives.COUNTS)
    collectives.reset_counts()
    live = LiveBytes()
    for t in tree_leaves((args, kwargs)):
        if isinstance(t, torch.Tensor):
            live.hold(t)
    arg_bytes = live.live
    try:
        with FlopCounterMode(display=False) as flops, live:
            out = fn(*args, **kwargs)
            del out
        coll = collectives.COUNTS["bytes"] + collectives.COUNTS["model_bytes"]
    finally:
        collectives.COUNTS.update(saved)
    return Cost(flops=float(flops.get_total_flops()),
                io_bytes=float(live.io_bytes),
                collective_bytes=float(coll),
                collective_by_op={"all-reduce": float(coll)} if coll else {},
                argument_bytes=arg_bytes, peak_bytes=live.peak)


__all__ = ["Cost", "LiveBytes", "analyze", "tensor_bytes"]
