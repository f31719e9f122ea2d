"""Ghost tape for the tap trick (linear taps only).

A tap is a zero tensor with ``requires_grad=True`` added to a linear's
output: the gradient of the loss with respect to it is dL/dY, and the
tape records the linear's input X.  With both, ``core/scorer.py`` gets
exact per-example gradient norms without per-example gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

Params = Any   # {"fc{i}": {"w": (din, dout), "b": (dout,)}}


@dataclasses.dataclass
class Tape:
    """Mutable container threaded through one forward for ghost scoring."""
    taps: Optional[dict] = None         # name -> tensor to ADD at the output
    records: Optional[dict] = None      # name -> linear INPUT (if not None)

    def linear(self, name: str, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
        if self.records is not None:
            self.records[name] = x
        if self.taps is not None and name in self.taps:
            y = y + self.taps[name].to(y.dtype)
        return y
