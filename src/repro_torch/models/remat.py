"""Rematerialisation: ``torch.utils.checkpoint`` in the places where the
reference applies ``jax.checkpoint``.

``checkpointed(fn, *args)`` runs ``fn(*args)`` so that autograd keeps
none of its intermediates: the backward runs ``fn`` again on the same
arguments and takes the tensors it needs from that run.  It is the
non-reentrant checkpoint, so ``torch.autograd.grad`` to any subset of
the leaves works (the scorers differentiate to the taps alone) and
regions nest (an attention query chunk inside a layer period).  The
recompute replays the same eager operations at the same shapes, so a
rematerialised backward is bitwise the kept one wherever the forward's
kernels are bitwise run to run.  ``fn`` must be pure: its results are
its return values, and it writes into nothing it closes over, since the
recompute would write a second time.  Under ``no_grad``, and inside a
``torch.func`` transform (the ``full`` scorer's per-example
``vmap(grad)``, which takes no saved-tensor hooks), it is a plain call:
the values are the same either way.

A rematerialised region runs its forward twice, and so does every
host-side effect inside it.  What each one does:

  * the kernel wrappers' launch counters (``launches``,
    ``tc_launches``, ``scored``, ``side_launches``): counted, since the
    recompute launches the kernel again (a flash-attention forward
    runs once more in the backward of its period);
  * ``core/collectives.COUNTS``: counted, since the recompute sends its
    model-axis messages again, in the same order on every rank (each
    rank walks the same backward graph);
  * ``launch/op_cost``'s FLOPs, written bytes and live bytes: counted,
    since the recompute's work and allocations are real;
  * the MoE layers' dropped share (``MoEOut.dropped_frac``): a return
    value the stack discards; a caller that records it per call guards
    on ``recomputing()``;
  * ``Tape.records`` and the serving prefill's collector: never written
    inside a region (a period returns its records; ``collect_cache``
    runs unwrapped);
  * telemetry spans and profiler labels: none is opened inside a
    forward.

``recomputing()`` is True while the backward re-runs a region on the
calling thread.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_STATE = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside the backward's re-run of a region."""
    return getattr(_STATE, "depth", 0) > 0


@contextlib.contextmanager
def _recompute_context():
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        yield
    finally:
        _STATE.depth -= 1


def _contexts():
    return contextlib.nullcontext(), _recompute_context()


def checkpointed(fn, *args):
    """``fn(*args)``, its intermediates recomputed in the backward; a
    plain call under ``no_grad`` or inside a ``torch.func`` transform
    (module docstring).  The forward draws no random numbers, so no RNG
    state is stashed."""
    if not torch.is_grad_enabled() or \
            torch._C._are_functorch_transforms_active():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=_contexts)
