"""Proposal-health monitors, computed in the master pass.

The failure modes of importance sampling are shapes of the proposal: a
peaked proposal (B.3's "time bomb"), a starved store, runaway staleness.
These monitors read them off tensors the master pass already holds (the
store it sampled from and the proposal it read), as in
``src/repro/telemetry/monitors.py``:

    ess               Kish effective sample size of the proposal / N
    entropy           Shannon entropy of the normalized proposal (nats)
    max_weight_frac   the largest proposal weight / the total mass
    empty_rows        rows still reserved (EMPTY)
    staleness         step − max(scored_at) of the store sampled from

Each is a 0-dim tensor on the store's device; the launcher reads them
with the step's metrics in one transfer, at its logging cadence.  With
no monitors the master pass runs the operations it runs without this
module, and with monitors it only reads, so the trajectory is the same
bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.collectives import pmax, psum
from repro_torch.core.importance import proposal_entropy
from repro_torch.core.weight_store import EMPTY, WeightStore
from repro_torch.dist import DataGroup

MONITOR_NAMES = ("ess", "entropy", "max_weight_frac", "empty_rows",
                 "staleness")


@dataclasses.dataclass(frozen=True)
class MonitorSet:
    """Which monitors the master pass computes; falsy when empty, so
    ``monitors or None`` folds "none" and "empty" into one path."""
    names: tuple[str, ...] = ()

    def __post_init__(self):
        unknown = [n for n in self.names if n not in MONITOR_NAMES]
        if unknown:
            raise ValueError(f"unknown monitor(s) {unknown}; available: "
                             f"{', '.join(MONITOR_NAMES)}")

    def __bool__(self) -> bool:
        return bool(self.names)

    @classmethod
    def all(cls) -> "MonitorSet":
        """Every monitor."""
        return cls(MONITOR_NAMES)

    @classmethod
    def parse(cls, spec: str) -> "MonitorSet":
        """The CLI form: "all", "none"/"off"/"", or a comma list of names
        (put in MONITOR_NAMES order)."""
        spec = (spec or "").strip().lower()
        if spec in ("", "none", "off"):
            return cls(())
        if spec == "all":
            return cls.all()
        asked = {s.strip() for s in spec.split(",") if s.strip()}
        unknown = asked - set(MONITOR_NAMES)
        if unknown:
            raise ValueError(f"unknown monitor(s) {sorted(unknown)}; "
                             f"available: {', '.join(MONITOR_NAMES)} "
                             f"(or 'all'/'none')")
        return cls(tuple(n for n in MONITOR_NAMES if n in asked))


def proposal_monitors(store: WeightStore, proposal: torch.Tensor,
                      step: int, num_examples: int, monitors: MonitorSet,
                      sum_w: Optional[torch.Tensor] = None,
                      sum_w2: Optional[torch.Tensor] = None,
                      group: Optional[DataGroup] = None
                      ) -> dict[str, torch.Tensor]:
    """The enabled monitors as ``{name: 0-dim tensor}``.  ``store`` and
    ``proposal`` are what the master pass sampled from (EMPTY rows
    already at zero mass); ``sum_w``/``sum_w2`` are its Σw and Σw²,
    shared instead of reduced again.  Over a data group they are this
    rank's rows, and each monitor is summed or maxed over the group, the
    same on every rank."""
    out: dict[str, torch.Tensor] = {}
    names = monitors.names
    if any(n in names for n in ("ess", "entropy", "max_weight_frac")):
        if sum_w is None:
            sum_w = psum(torch.sum(proposal), group)
        sum_w = torch.clamp(sum_w, min=1e-30)
    if "ess" in names:
        if sum_w2 is None:
            sum_w2 = psum(torch.sum(torch.square(proposal)), group)
        out["ess"] = (torch.square(sum_w) / torch.clamp(sum_w2, min=1e-30)
                      / num_examples)
    if "entropy" in names:
        out["entropy"] = proposal_entropy(proposal, sum_w, group)
    if "max_weight_frac" in names:
        out["max_weight_frac"] = pmax(torch.max(proposal), group) / sum_w
    if "empty_rows" in names:
        out["empty_rows"] = psum(torch.sum(
            (store.scored_at <= EMPTY).to(torch.int32)), group)
    if "staleness" in names:
        out["staleness"] = step - pmax(torch.max(store.scored_at), group)
    return out
