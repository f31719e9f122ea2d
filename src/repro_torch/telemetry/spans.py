"""Phase timing spans, by default without a device synchronisation.

PyTorch returns from a CUDA call before the device has run it.  A span
that synchronised around every phase would serialise the work it
measures, so (as in ``src/repro/telemetry/spans.py``):

  * by default (``block=False``) a span times the host dispatch only:
    it closes when the call returns, the device work still in flight;
  * with ``block=True`` (``--telemetry-blocking``) it synchronises the
    device before it closes: the phase's wall clock on the card, at the
    cost of a host wait every step.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Optional

import torch


@contextmanager
def span(sink, name: str, step: Optional[int] = None):
    """Emit one ``kind="span"`` record with the host wall clock of the
    block; never waits for the device."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink.span(name, time.perf_counter() - t0, step=step)


def timed(sink, name: str, fn: Callable, *args,
          step: Optional[int] = None, block: bool = False):
    """``fn(*args)`` inside a span; with ``block`` the span also waits
    for the card to finish the work queued so far."""
    t0 = time.perf_counter()
    out = fn(*args)
    if block and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    sink.span(name, time.perf_counter() - t0, step=step)
    return out
