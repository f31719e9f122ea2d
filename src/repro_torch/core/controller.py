"""Adaptive IS controller: decides when importance sampling pays, and how
often to swap, from the telemetry stream alone
(``src/repro/core/controller.py``, ported nearly verbatim).

The controller taps the run's ``EventSink`` (``attach`` wraps it; every
record still reaches the file) and folds exactly the values the JSONL
carries:

* ``metrics`` records → the variance-ratio gate.  The in-step traces give
  √TrΣ under the uniform estimator (``trace_unif``) and under the current
  stale proposal (``trace_stale``); when their ratio clears
  ``var_margin`` (and ``ess_frac`` stays above ``ess_floor``), sampling
  by importance is predicted to lower the gradient variance.  The gate
  starts closed (uniform).
* ``span`` records → the swap cadence: the scoring/master dispatch-time
  ratio, K = clip(round(ratio), kmin, kmax).

The gate is a host bool (``gate()``), taken by a step built with
``gated=True`` (``core/issgd.py``), which branches on it on the host: a
closed gate runs the uniform step, an open gate the relaxed step, and a
decision costs no device synchronisation.  (The reference passes a
device scalar so that flipping it does not recompile.)

The controller sees the values after serialization (span durations
after their 6-digit rounding, fields after JSON normalization), so
``replay_decisions`` re-derives the run's decisions exactly from the
JSONL alone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, NamedTuple, Optional

from repro_torch.telemetry.events import _jsonable

#: Event kinds the controller emits into the stream it taps.
CONFIG_KIND = "controller.config"
DECISION_KIND = "controller.decision"


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Decision-rule parameters (all serialized into the
    ``controller.config`` record so offline replay is self-contained).

    ``adapt_every``: steps between decisions.  ``var_margin``: the gate
    opens when mean(trace_unif)/mean(trace_stale) over the window
    exceeds this (1.0 = any predicted reduction; >1 demands margin).
    ``ess_floor``: with a positive floor, an observed ``ess_frac`` below
    it vetoes the gate (a collapsed proposal makes the IS estimate
    high-variance even when the trace ratio looks good).
    ``hysteresis``: consecutive disagreeing decisions required before
    the gate actually flips.  ``adapt_swap`` + ``swap_min``/``swap_max``
    control cadence selection from the dispatch-time ratio.
    """
    adapt_every: int = 25
    var_margin: float = 1.0
    ess_floor: float = 0.0
    hysteresis: int = 1
    adapt_swap: bool = False
    swap_min: int = 1
    swap_max: int = 8


class Decision(NamedTuple):
    """One controller decision, mirroring the ``controller.decision``
    record field-for-field (None ↔ JSON null for unobserved inputs)."""
    step: int
    use_is: bool
    swap_every: int
    var_ratio: Optional[float]
    dispatch_ratio: Optional[float]
    ess: Optional[float]
    reason: str


def _is_finite_number(x) -> bool:
    """True for real finite int/float (rejects None, NaN, bool, str)."""
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and x == x and x not in (float("inf"), float("-inf")))


class ProposalController:
    """Online uniform↔IS gate + swap-cadence selector over a tapped sink.

    Usage::

        ctl = ProposalController(ControllerConfig(...), swap_every=K)
        sink = ctl.attach(EventSink(path))     # wrap the run's sink
        step = make_train_step(..., gated=True)
        ...
        st, m = step(st, data, ctl.gate())     # the gate, a host bool
        ...                                    # emit metrics as usual
        d = ctl.maybe_decide(i)                # decision cadence
        if d is not None: pipe.swap_every = d.swap_every

    State folds only values that went through the tap, so
    :func:`replay_decisions` over the resulting JSONL reproduces
    ``self.decisions`` exactly.

    ``agree`` (with ``adapt_swap``) maps the cadence this controller
    chose to the one the run applies, before the decision is recorded:
    over a data group each rank times its own dispatches, and the ranks
    must publish at the same steps (``launch/train.py`` gives them rank
    0's cadence, so rank 0's JSONL still replays exactly).  Every rank
    calls it at every decision.
    """

    def __init__(self, cfg: ControllerConfig = ControllerConfig(), *,
                 swap_every: int = 1, use_is: bool = False,
                 agree: Optional[Callable[[int], int]] = None):
        if cfg.adapt_every < 1:
            raise ValueError("adapt_every must be >= 1")
        self.cfg = cfg
        self.agree = agree
        self.use_is = bool(use_is)
        self.swap_every = int(swap_every)
        self.decisions: List[Decision] = []
        self._sink = None
        self._streak = 0
        self._reset_window()

    # ----------------------------------------------------------- plumbing
    def _reset_window(self) -> None:
        self._stale_sum = 0.0
        self._unif_sum = 0.0
        self._pairs = 0
        self._ess = None
        self._score_s = 0.0
        self._score_n = 0
        self._master_s = 0.0
        self._master_n = 0

    def attach(self, sink):
        """Wrap ``sink`` in a :class:`ControllerTap` and emit the
        ``controller.config`` record.  Returns the tap — use it as the
        run's sink from here on."""
        tap = ControllerTap(sink, self)
        self._sink = tap
        tap.emit(CONFIG_KIND, **dataclasses.asdict(self.cfg),
                 swap_every=self.swap_every, use_is=self.use_is)
        return tap

    def gate(self) -> bool:
        """The current gate, a host bool."""
        return self.use_is

    # -------------------------------------------------------- observation
    def observe_event(self, kind: str, step, fields: dict) -> None:
        """Fold one event record into the decision window.  Only
        ``metrics`` (traces + ess) and ``span`` (dispatch times) move
        state; everything else — including the controller's own
        records — is ignored."""
        if kind == "metrics":
            s, u = fields.get("trace_stale"), fields.get("trace_unif")
            if (_is_finite_number(s) and _is_finite_number(u)
                    and s > 0.0 and u > 0.0):
                self._stale_sum += s
                self._unif_sum += u
                self._pairs += 1
            e = fields.get("ess_frac")
            if _is_finite_number(e):
                self._ess = float(e)
        elif kind == "span":
            name, d = fields.get("name"), fields.get("dur_s")
            if not _is_finite_number(d):
                return
            if name == "scoring.dispatch":
                self._score_s += d
                self._score_n += 1
            elif name == "master.dispatch":
                self._master_s += d
                self._master_n += 1

    # ----------------------------------------------------------- decision
    def maybe_decide(self, step: int) -> Optional[Decision]:
        """Decide at the configured cadence: a decision fires when
        ``(step + 1) % adapt_every == 0`` (i.e. after the window's last
        step has emitted), else returns None."""
        if (step + 1) % self.cfg.adapt_every != 0:
            return None
        return self._decide(step)

    def _decide(self, step: int) -> Decision:
        cfg = self.cfg
        var_ratio = (self._unif_sum / self._stale_sum
                     if self._pairs else None)
        dispatch_ratio = (self._score_s / self._master_s
                          if self._score_n and self._master_n
                          and self._master_s > 0.0 else None)
        ess = self._ess

        if var_ratio is None:
            want, reason = self.use_is, "no-signal"
        elif cfg.ess_floor > 0.0 and ess is not None and ess < cfg.ess_floor:
            want, reason = False, "ess-floor"
        elif var_ratio > cfg.var_margin:
            want, reason = True, "is-pays"
        else:
            want, reason = False, "uniform-pays"

        if want != self.use_is:
            self._streak += 1
            if self._streak >= cfg.hysteresis:
                self.use_is = want
                self._streak = 0
            else:
                reason += "-pending"
        else:
            self._streak = 0

        if cfg.adapt_swap and dispatch_ratio is not None:
            self.swap_every = min(max(int(round(dispatch_ratio)),
                                      cfg.swap_min), cfg.swap_max)
        if cfg.adapt_swap and self.agree is not None:
            self.swap_every = int(self.agree(self.swap_every))

        d = Decision(step=int(step), use_is=self.use_is,
                     swap_every=self.swap_every, var_ratio=var_ratio,
                     dispatch_ratio=dispatch_ratio, ess=ess, reason=reason)
        self.decisions.append(d)
        self._reset_window()
        if self._sink is not None:
            self._sink.emit(DECISION_KIND, step=d.step,
                            **{k: v for k, v in d._asdict().items()
                               if k != "step"})
        return d


class ControllerTap:
    """Sink wrapper feeding the controller the exact serialized values.

    Every record is JSON-normalized *first* (``_jsonable`` on fields,
    span durations after their 6-digit rounding), observed by the
    controller, then forwarded to the wrapped sink — so the controller's
    in-run inputs are bit-for-bit the JSONL contents, the contract
    behind :func:`replay_decisions`.  Always truthy, even over a
    :class:`~repro_torch.telemetry.events.NullSink`, so the launcher keeps
    emitting the metrics/spans the controller feeds on.
    """

    def __init__(self, inner, controller: ProposalController):
        self._inner = inner
        self._ctl = controller

    @property
    def path(self):
        """Pass-through to the wrapped sink's output path."""
        return self._inner.path

    def emit(self, kind: str, step=None, **fields) -> None:
        """Normalize, observe, forward."""
        norm = {k: _jsonable(v) for k, v in fields.items()}
        self._ctl.observe_event(kind, step, norm)
        self._inner.emit(kind, step=step, **norm)

    def span(self, name: str, dur_s: float, step=None) -> None:
        """Span shorthand, rounding like ``EventSink.span`` before the
        controller sees the duration."""
        self.emit("span", step=step, name=name, dur_s=round(dur_s, 6))

    def counter(self, name: str, value, step=None) -> None:
        """Counter shorthand mirroring ``EventSink.counter``."""
        self.emit("counter", step=step, name=name, value=value)

    def flush(self) -> None:
        """Pass-through flush."""
        self._inner.flush()

    def close(self) -> None:
        """Pass-through close."""
        self._inner.close()

    def __bool__(self) -> bool:
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def replay_decisions(events: Iterable[dict], *,
                     strict: bool = True) -> List[Decision]:
    """Recompute controller decisions offline from an event stream.

    Feed it :func:`repro_torch.telemetry.events.read_events` output: the
    ``controller.config`` record seeds a fresh controller, every other
    record is folded through the same ``observe_event``, and at each
    recorded ``controller.decision`` the rule is re-run.  With
    ``strict`` (default) any disagreement between a recomputed decision
    and the recorded one raises — the exact-replay contract pinned in
    tests/test_torch_controller.py.
    """
    ctl: Optional[ProposalController] = None
    out: List[Decision] = []
    cfg_fields = {f.name for f in dataclasses.fields(ControllerConfig)}
    for rec in events:
        kind = rec.get("kind")
        if kind == CONFIG_KIND:
            cfg = ControllerConfig(**{k: rec[k] for k in cfg_fields
                                      if k in rec})
            ctl = ProposalController(cfg, swap_every=rec.get("swap_every", 1),
                                     use_is=rec.get("use_is", False))
        elif kind == DECISION_KIND:
            if ctl is None:
                raise ValueError("controller.decision before "
                                 "controller.config in event stream")
            d = ctl._decide(rec["step"])
            if strict:
                recorded = Decision(
                    step=rec["step"], use_is=rec["use_is"],
                    swap_every=rec["swap_every"],
                    var_ratio=rec.get("var_ratio"),
                    dispatch_ratio=rec.get("dispatch_ratio"),
                    ess=rec.get("ess"), reason=rec["reason"])
                if d != recorded:
                    raise ValueError(
                        f"replay mismatch at step {rec['step']}: "
                        f"recomputed {d} != recorded {recorded}")
            out.append(d)
        elif ctl is not None:
            ctl.observe_event(kind, rec.get("step"), rec)
    return out
