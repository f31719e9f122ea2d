"""The train/serve loop: decode beside training, traffic back into the
store (the port of ``src/repro/serving/loop.py``).

  * **ServeLoop**: a serve tick hooked between the scoring and master
    dispatches of each train step (the ``serve_tick`` of
    ``AsyncPipeline``/``StreamedISSGD``).  It decodes through a
    ``ContinuousBatcher`` against a ``PublishedParams`` snapshot, the
    weights' counterpart of the proposal's ``read_buf``: under publish
    cadence K it is at most K train steps stale, and a decode against it
    equals a decode against the params of the step it was taken at
    (``tests/test_torch_async.py``, ``chip_smoke.py`` phase 40).
  * **TrafficIngest**: finished requests (prompt + generated tokens)
    become store rows, written on the host into capacity chunks reserved
    up front, then flipped live in the WeightStore (``mark_live``: EMPTY →
    -1).  The round-robin scoring then stamps and weights them like any
    other row, and they enter the proposal.
  * **make_synthetic_traffic**: a seeded request source (numpy's
    generator, the reference's stream) for smokes and tests.

Over a data group every rank serves the same seeded traffic through its
model group's batcher (``ContinuousBatcher(model_group=)``), so every
rank finishes the same requests at the same watermark.  The store is
the rank's ``ChunkedExampleStore`` (its chunk range, the reserved
chunks laid out before the store was split), and the weight store the
rank's rows: a rank writes and marks live only the ingested rows it
holds.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.weight_store import (BufferedWeightStore, mark_live,
                                           mark_live_buffered,
                                           publish_params)
from repro_torch.serving.batcher import ContinuousBatcher, Request


class TrafficIngest:
    """Turn finished requests into store rows at a reserved-capacity
    watermark.

    A row is ``prompt + generated`` zero-padded (or truncated) to
    ``seq_len``, written through ``ChunkedExampleStore.write_rows`` into
    ``[start_row, start_row + capacity_rows)``.  ``flush`` returns the
    global indices of the new rows, for ``mark_live``; traffic past the
    capacity counts in ``dropped``.  A store that holds one rank's chunk
    range (``ChunkedExampleStore(shard=)``) gets only the rows of its
    chunks; ``local_rows`` gives them as indices into the rank's shard of
    the weight store."""

    def __init__(self, store, seq_len: int, start_row: int,
                 capacity_rows: int, label_key: Optional[str] = None):
        self.store = store
        self.seq_len = int(seq_len)
        self.start_row = int(start_row)
        self.capacity_rows = int(capacity_rows)
        self.label_key = label_key
        self.ingested = 0
        self.dropped = 0
        self._pending: list[torch.Tensor] = []

    def _tokens_key(self) -> str:
        keys = self.store.keys
        if "tokens" in keys:
            return "tokens"
        if len(keys) == 1:
            return keys[0]
        raise ValueError(f"cannot pick a token key from {keys}; expected a "
                         "'tokens' array in the store schema")

    def add(self, prompt, generated) -> None:
        """Queue one finished request (prompt tokens + generated tokens)."""
        toks = torch.cat([torch.as_tensor(np.asarray(prompt)).reshape(-1)
                          .to(torch.int64),
                          torch.as_tensor(list(generated),
                                          dtype=torch.int64).reshape(-1)])
        row = torch.zeros((self.seq_len,),
                          dtype=self.store.dtype(self._tokens_key()))
        toks = toks[:self.seq_len]
        row[:toks.numel()] = toks.to(row.dtype)
        self._pending.append(row)

    def _held(self, idx: np.ndarray) -> np.ndarray:
        """Which of the global indices ``idx`` lie in the store's chunks."""
        held = self.store.held_chunks
        c = idx // self.store.chunk_size
        return (c >= held.start) & (c < held.stop)

    def local_rows(self, idx: np.ndarray) -> np.ndarray:
        """The global indices ``idx`` of the rows this store holds, as
        offsets into the rank's rows (its chunk range's first row is 0)."""
        first = self.store.held_chunks.start * self.store.chunk_size
        return idx[self._held(idx)] - first

    def flush(self) -> np.ndarray:
        """Write the queued rows at the watermark (those of the chunks the
        store holds); return the global indices of all of them (empty when
        nothing fit).  A ``label_key`` array gets the row shifted by one
        (next-token labels)."""
        if not self._pending:
            return np.zeros((0,), np.int64)
        room = max(0, self.capacity_rows - self.ingested)
        rows, overflow = self._pending[:room], self._pending[room:]
        self._pending = []
        self.dropped += len(overflow)
        if not rows:
            return np.zeros((0,), np.int64)
        idx = self.start_row + self.ingested + np.arange(len(rows))
        tok = torch.stack(rows)
        payload = {self._tokens_key(): tok}
        if self.label_key is not None and self.label_key in self.store.keys:
            lab = torch.zeros_like(tok)
            lab[:, :-1] = tok[:, 1:]
            payload[self.label_key] = lab.to(self.store.dtype(self.label_key))
        for k in self.store.keys:
            if k not in payload:
                payload[k] = torch.zeros(
                    (tok.shape[0],) + self.store.row_shape(k),
                    dtype=self.store.dtype(k))
        own = self._held(idx)
        if own.any():
            sel = torch.from_numpy(np.flatnonzero(own))
            self.store.write_rows(idx[own],
                                  {k: v[sel] for k, v in payload.items()})
        self.ingested += len(rows)
        return idx


def make_synthetic_traffic(vocab: int, prompt_len: int, rate: int = 1,
                           max_new_tokens: int = 8, seed: int = 0
                           ) -> Callable:
    """A seeded request source: ``traffic(tick) -> [Request, ...]`` with
    ``rate`` random-token prompts a tick (numpy int32 prompts, the
    reference's draws for the same seed)."""
    rng = np.random.default_rng(seed)
    uids = itertools.count()

    def traffic(tick: int) -> list[Request]:
        return [Request(uid=next(uids),
                        prompt=rng.integers(0, vocab, size=(prompt_len,),
                                            dtype=np.int32),
                        max_new_tokens=max_new_tokens)
                for _ in range(rate)]

    return traffic


class ServeLoop:
    """Drive a ContinuousBatcher as a serve tick inside the train loop.

    ``on_train_step(state)`` (the pipeline's ``serve_tick``) refreshes the
    batcher's ``PublishedParams`` snapshot every ``publish_every`` serve
    ticks, admits new traffic and runs ``decode_steps`` lock-step decodes,
    all on the current stream.  ``ingest_into(state)``, called between
    steps, drains finished requests into the store through
    ``TrafficIngest`` and flips their rows live (on ``write_buf`` for a
    BufferedWeightStore, so that they reach the master only through
    ``publish``).  ``join`` (e.g. the pipeline's) runs before a store
    written on the side stream is touched.

    ``telemetry`` emits serve.ingested, serve.dropped, serve.finished,
    serve.publishes and serve.pending at its cadence in ticks, and
    serve.ingest_watermark on every flush that wrote rows.  Over a data
    group the state's weight store is the rank's rows, and the rank marks
    live the ingested rows it holds (``TrafficIngest.local_rows``)."""

    def __init__(self, batcher: ContinuousBatcher, ingest: TrafficIngest,
                 traffic: Callable, publish_every: int = 1,
                 serve_every: int = 1, decode_steps: int = 1,
                 telemetry=None, join: Optional[Callable] = None):
        if publish_every < 1 or serve_every < 1:
            raise ValueError("publish_every and serve_every must be >= 1")
        self.batcher = batcher
        self.ingest = ingest
        self.traffic = traffic
        self.publish_every = int(publish_every)
        self.serve_every = int(serve_every)
        self.decode_steps = int(decode_steps)
        self.join = join
        self.published = None
        self.pending: list[Request] = []
        self._tick = 0
        if telemetry is None:
            from repro_torch.telemetry import Telemetry
            telemetry = Telemetry.null()
        self.telemetry = telemetry
        self.publishes = 0
        self.finished = 0

    def on_train_step(self, state) -> None:
        """The serve tick: snapshot params on cadence, admit, decode."""
        t = self._tick
        self._tick += 1
        if t % self.serve_every:
            return
        if self.published is None or \
                (t // self.serve_every) % self.publish_every == 0:
            self.published = publish_params(state.params, state.step)
            self.batcher.params = self.published.params
            self.publishes += 1
        self.pending.extend(self.traffic(t))
        while self.pending and self.batcher.try_insert(self.pending[0]):
            self.pending.pop(0)
        for _ in range(self.decode_steps):
            self.batcher.step()
        tel = self.telemetry
        if tel.due(t):
            tel.counter("serve.ingested", self.ingest.ingested, step=t)
            tel.counter("serve.dropped", self.ingest.dropped, step=t)
            tel.counter("serve.finished", self.finished, step=t)
            tel.counter("serve.publishes", self.publishes, step=t)
            tel.counter("serve.pending", len(self.pending), step=t)

    def ingest_into(self, state):
        """Drain finished requests into the example store and the
        WeightStore; the state with the new rows live (the same state
        when no traffic finished or none of the new rows is this
        rank's)."""
        for req, generated in self.batcher.drain_completed():
            self.ingest.add(req.prompt, generated)
            self.finished += 1
        idx = self.ingest.flush()
        if idx.size == 0:
            return state
        self.telemetry.counter("serve.ingest_watermark",
                               self.ingest.ingested, step=self._tick)
        idx = self.ingest.local_rows(idx)
        if idx.size == 0:
            return state
        if self.join is not None:
            self.join()
        store = state.store
        if isinstance(store, BufferedWeightStore):
            store = mark_live_buffered(store, idx)
        else:
            store = mark_live(store, idx)
        return state._replace(store=store)
