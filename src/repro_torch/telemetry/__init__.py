"""Telemetry of the port: in-step proposal monitors (``monitors.py``),
a schema-v1 JSONL event sink (``events.py``) and phase spans
(``spans.py``), as in ``src/repro/telemetry/``.

``Telemetry`` is what the launcher carries: the sink, span timing and
the cadence of periodic records.  ``Telemetry.null()`` is the no-op
instance, so a run without telemetry keeps one code path.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.telemetry import spans as _spans
from repro_torch.telemetry.events import SCHEMA_VERSION, EventSink, NullSink
from repro_torch.telemetry.monitors import MONITOR_NAMES, MonitorSet

__all__ = ["EventSink", "NullSink", "MonitorSet", "MONITOR_NAMES",
           "SCHEMA_VERSION", "Telemetry"]


class Telemetry:
    """An event sink, span timing and the cadence of periodic records.
    ``blocking=False`` (default) keeps every span dispatch-only;
    ``blocking=True`` synchronises the card before a timed span closes."""

    _null = None

    def __init__(self, sink, every: int = 10, blocking: bool = False):
        if every < 1:
            raise ValueError(f"telemetry cadence must be >= 1, got {every}")
        self.sink = sink
        self.every = int(every)
        self.blocking = bool(blocking)

    @classmethod
    def null(cls) -> "Telemetry":
        """The shared no-op instance (a NullSink)."""
        if cls._null is None:
            cls._null = cls(NullSink())
        return cls._null

    def __bool__(self) -> bool:
        return bool(self.sink)

    def timed(self, name: str, fn: Callable, *args,
              step: Optional[int] = None):
        """``fn(*args)`` inside a span named ``name`` (``spans.timed``)."""
        if not self.sink:
            return fn(*args)
        return _spans.timed(self.sink, name, fn, *args, step=step,
                            block=self.blocking)

    def span(self, name: str, step: Optional[int] = None):
        """Context manager: a host wall-clock span around the block."""
        return _spans.span(self.sink, name, step=step)

    def counter(self, name: str, value, step: Optional[int] = None) -> None:
        """Emit one counter sample."""
        self.sink.counter(name, value, step=step)

    def emit(self, kind: str, step: Optional[int] = None, **fields) -> None:
        """Emit a raw record through the sink."""
        self.sink.emit(kind, step=step, **fields)

    def due(self, t: int) -> bool:
        """Whether periodic records fire at host step ``t``."""
        return bool(self.sink) and t % self.every == 0
