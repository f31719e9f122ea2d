"""Streaming JSONL event sink: the host side of the telemetry plane.

One record per line, in the reference's schema v1
(``src/repro/telemetry/events.py``), so ``tools/metrics_report.py`` reads
the port's files as they are.  Every record carries:

    v       int     schema version (SCHEMA_VERSION)
    kind    str     "run" | "span" | "counter" | "metrics" | "monitors"
                    | "profile" | "run_end" | "controller.config"
                    | "controller.decision"
    t       float   host wall clock (time.time()) at emit
    step    int?    the train step the record belongs to, when one applies

plus the kind's fields ("span": name, dur_s; "counter": name, value;
"metrics"/"monitors": the scalars).  Writes are host-side and buffered
(``flush_every``); a record takes host values, so emitting never waits
for the device.
"""
from __future__ import annotations

import json
import time
from typing import IO, Optional

SCHEMA_VERSION = 1


def _jsonable(v):
    """Plain Python of a host scalar or array (numpy, 0-dim tensor)."""
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class EventSink:
    """Append schema-versioned JSONL records to ``path``.

    The file is opened at once and a ``kind="run"`` header (the schema
    version and the caller's run metadata) written first, so a truncated
    file still says what it is.  ``emit`` stringifies what JSON cannot
    hold instead of raising: telemetry must not stop a training run."""

    def __init__(self, path: str, run: Optional[dict] = None,
                 flush_every: int = 32):
        self.path = path
        self._f: Optional[IO] = open(path, "w")
        self._since_flush = 0
        self.flush_every = max(int(flush_every), 1)
        self.emitted = 0
        self.emit("run", **(run or {}))
        self.flush()

    def emit(self, kind: str, step: Optional[int] = None, **fields) -> None:
        """Write one record: the envelope (v/kind/t/step) and ``fields``."""
        if self._f is None:
            return
        rec = {"v": SCHEMA_VERSION, "kind": kind, "t": time.time()}
        if step is not None:
            rec["step"] = int(step)
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        try:
            line = json.dumps(rec)
        except TypeError:
            rec = {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                       else str(v)) for k, v in rec.items()}
            line = json.dumps(rec)
        self._f.write(line + "\n")
        self.emitted += 1
        self._since_flush += 1
        if self._since_flush >= self.flush_every:
            self.flush()

    def span(self, name: str, dur_s: float,
             step: Optional[int] = None) -> None:
        """A timing record: phase ``name`` took ``dur_s`` seconds."""
        self.emit("span", step=step, name=name, dur_s=round(dur_s, 6))

    def counter(self, name: str, value, step: Optional[int] = None) -> None:
        """A named counter or gauge sample."""
        self.emit("counter", step=step, name=name, value=_jsonable(value))

    def flush(self) -> None:
        """Flush the buffered lines to the file."""
        if self._f is not None:
            self._f.flush()
            self._since_flush = 0

    def close(self) -> None:
        """Flush and close; later emits are no-ops."""
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullSink:
    """The no-op sink: a run without telemetry keeps the same calls and
    writes nothing.  Falsy, so ``if sink:`` gates optional work."""

    path = None
    emitted = 0

    def emit(self, kind, step=None, **fields):
        """Discard the record."""

    def span(self, name, dur_s, step=None):
        """Discard the span."""

    def counter(self, name, value, step=None):
        """Discard the counter."""

    def flush(self):
        """Nothing to flush."""

    def close(self):
        """Nothing to close."""

    def __bool__(self):
        return False


def read_events(path: str) -> list[dict]:
    """The records of a telemetry JSONL file; lines that do not parse are
    skipped (a crashed run may leave a torn last line)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
