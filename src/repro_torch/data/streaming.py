"""Streaming data plane: a host-resident dataset and a proposal-driven
device window (the port of ``src/repro/data/streaming.py``).

The paper's training set is too large to sit next to the master: the
workers sweep it, the master touches only the sampled minibatch.  Here

  ChunkedExampleStore (``data/store.py``)
      holds the examples in host chunks (pinned on the card path);

  StreamingDataPlane
      keeps a bounded **window** of chunks on the device and resolves
      sampled indices with a two-level gather: window hits on the device,
      misses through one chunk-grouped host fetch.  ``prefetch`` builds
      the next window (the chunks with the most proposal mass) on a copy
      stream while the live one serves gathers; ``swap_window`` flips it
      in at a step boundary after the copies have landed;

  StreamedISSGD
      the host driver.  The step is three computations, none of which
      takes the dataset:

        scoring_step(θ_stale, store, t, score_rows)    the workers
        sample_step(store, t, generator) -> (idx, chunk_mass)
        master_step(..., store, t, generator, batch_rows, idx)

      The scoring rows stream from the host on ``issgd._score_slice``'s
      schedule, replayed in numpy (``host_score_slice``).  The sample
      step draws the minibatch **once**; its indices go to the host, the
      plane gathers their rows, and the master takes both
      (``sample_indices=``), so it draws nothing itself.

Bitwise invariant (``tests/test_torch_streaming.py``; ``chip_smoke.py``
phase 39 on the card): a streamed run equals the resident run of the
same seed, in relaxed, fused and async modes.  The rows and the draws
are the same bits whether they come from the resident dataset, the
window or a host fetch: the window's policy changes only where rows
come from.

The window is a snapshot, as the reference's: a chunk written on the
host (``ChunkedExampleStore.write_rows``, the serving loop's ingest)
after the window that holds it was built serves its old rows to the
master's gathers until a prefetch rebuilds that window; the scoring
stream always reads the host.  A rebuild serves every chunk as the host
holds it, as the reference's ``prefetch`` (which stacks every chunk from
the host): a resident chunk is copied on the device only while its
``write_count`` is the one it had when the live window was built.

Over a data group (``group=``, ``core/distributed.py``) each rank's
host store holds only its contiguous chunk range and its window holds
the top ``window_chunks`` chunks of that range by the rank's own
proposal mass (prefetch adds no collective); the scoring stream reads
the slices of the rank's own logical shards; ``gather_global`` has each
rank give the sampled rows it owns, from its window or its host chunks,
and one one-owner all-reduce (``collectives.owner_sum``) makes the
replicated minibatch.  The store cannot grow under a world larger than
one.  A sharded run equals the one-device run bit for bit.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.async_pipeline import (ScoringStream, SwapCadence,
                                             score_trace_metrics)
from repro_torch.core.collectives import owner_sum
from repro_torch.core.issgd import (ISSGDConfig, StepMetrics, TrainState,
                                    draw_minibatch, make_master_pass,
                                    make_scoring_pass,
                                    read_sampling_proposal, scoring_layout)
from repro_torch.core.sampler import chunk_proposal_mass, index_to_chunk
from repro_torch.core.weight_store import BufferedWeightStore, WeightStore
from repro_torch.data.pipeline import take_rows
from repro_torch.data.store import ChunkedExampleStore
from repro_torch.dist import DataGroup, axis_info


def host_score_slice(step: int, w_loc: int, n_w: int,
                     sb_w: int) -> np.ndarray:
    """Numpy twin of ``issgd._score_slice``: step ``step``'s round-robin
    scoring slice, so the streamed rows land where the pass writes."""
    base = (step * sb_w + np.arange(sb_w)) % n_w
    return (np.arange(w_loc)[:, None] * n_w + base[None, :]).reshape(-1)


# ---------------------------------------------------------------------------
# the three computations
# ---------------------------------------------------------------------------

def make_streamed_steps(per_example_loss: Callable, scorer: Callable,
                        optimizer, cfg: ISSGDConfig, num_examples: int,
                        chunk_size: int, aux_loss: Optional[Callable] = None,
                        fused_score: Optional[Callable] = None,
                        async_mode: bool = False, monitor_traces: bool = True,
                        monitors=None, gated: bool = False,
                        group: Optional[DataGroup] = None,
                        model_group: Optional[DataGroup] = None,
                        param_specs=None, split_batch: bool = False
                        ) -> tuple[Callable, Callable, Callable]:
    """``(scoring_step, sample_step, master_step)`` of the streamed step:

      scoring_step(score_params, store, step, score_rows)
          -> (store', fresh_scores, stale_slice, ScoreMetrics)
      sample_step(store, step, generator[, use_is]) -> (idx, chunk_mass)
      master_step(params, opt_state, stale_params, store, step, generator,
                  batch_rows[, fresh_scores, stale_slice][, use_is],
                  sample_indices=idx)
          -> (params', opt_state', stale_params', store', step + 1,
              generator, StepMetrics[, monitors])

    ``sample_step`` reads the proposal the master will read and draws from
    the generator as the master of the resident step would; it also sums
    the proposal into per-chunk masses, the prefetch signal.  In the sync
    composition the master takes the fresh scores for the fig-4 traces;
    in async mode (relaxed/uniform) the scoring step carries them
    (``monitor_traces``) and the master's are NaN.  ``gated`` (relaxed)
    gives both the sample and the master step a trailing ``use_is``.

    Over a data ``group`` the store is this rank's rows and
    ``score_rows`` the rows of its own shards' slices; the sample step
    draws with the hierarchical draw (the indices the same on every
    rank) and its chunk masses are those of the rank's own chunks, with
    no collective; ``batch_rows`` is the replicated minibatch.  A
    ``model_group`` and ``param_specs`` go to the master pass
    (``issgd.make_master_pass``): the rows and the draws are the same on
    every rank of a model group, which shares one data rank's chunks.
    ``split_batch`` splits the master over the data group
    (``issgd.make_master_pass``; the reference's ``constrain_batch``,
    ``src/repro/data/streaming.py:89``): a rank takes its block of the
    replicated ``batch_rows``."""
    if cfg.mode == "exact":
        raise ValueError(
            "mode='exact' rescores the full dataset every step, which "
            "requires it device-resident: streaming is pointless there; "
            "use the resident path")
    if async_mode and cfg.mode not in ("relaxed", "uniform"):
        raise ValueError(
            "async streaming supports mode='relaxed'/'uniform' (fused "
            f"already merges the passes), got {cfg.mode!r}")
    if num_examples % chunk_size:
        raise ValueError(f"chunk_size={chunk_size} must divide "
                         f"num_examples={num_examples}")
    monitors = monitors or None
    n = num_examples
    sb = cfg.score_batch_size
    w_loc, n_w, _ = scoring_layout(cfg, n, axis_info(group)[1])
    expect_scores = (not async_mode) and cfg.mode != "fused"
    traces_in_scoring = async_mode and monitor_traces
    scoring_pass = make_scoring_pass(scorer, cfg, n, streaming=True,
                                     group=group)
    master_pass = make_master_pass(per_example_loss, optimizer, cfg, n,
                                   aux_loss=aux_loss, fused_score=fused_score,
                                   monitors=monitors, gated=gated,
                                   streaming=True, group=group,
                                   model_group=model_group,
                                   param_specs=param_specs,
                                   split_batch=split_batch)

    def scoring_step(score_params, store: WeightStore, step: int,
                     score_rows):
        store, fresh, stale_slice = scoring_pass(score_params, store, step,
                                                 score_rows)
        return store, fresh, stale_slice, score_trace_metrics(
            fresh, stale_slice, n_total=sb, monitor=traces_in_scoring,
            group=group)

    def _sample(store: WeightStore, step: int, generator, use_is):
        with torch.no_grad():
            proposal = read_sampling_proposal(store, step, cfg, n_w)
            uniform = cfg.mode == "uniform" or (gated and not use_is)
            idx = draw_minibatch(proposal, cfg, w_loc, generator, uniform,
                                 group)
            # the masses of this rank's own chunks: no collective
            return idx, chunk_proposal_mass(proposal, chunk_size)

    if gated:
        def sample_step(store, step, generator, use_is):
            return _sample(store, step, generator, use_is)
    else:
        def sample_step(store, step, generator):
            return _sample(store, step, generator, None)

    def master_step(params, opt_state, stale_params, store, step, generator,
                    batch_rows, *rest, sample_indices):
        rest = list(rest)
        fresh = stale = use_is = None
        if expect_scores:
            fresh, stale = rest.pop(0), rest.pop(0)
        if gated:
            use_is = rest.pop(0)
        if rest:
            raise TypeError(f"master_step got {len(rest)} extra arguments")
        params, opt_state, stale_params, store, metrics, *mon = master_pass(
            params, opt_state, stale_params, store, step, generator,
            batch_rows, fresh, stale, sample_indices, use_is)
        return (params, opt_state, stale_params, store, step + 1, generator,
                metrics, *mon)

    master_step.expect_scores = expect_scores
    master_step.with_monitors = bool(monitors)
    master_step.gated = bool(gated)
    sample_step.gated = bool(gated)
    return scoring_step, sample_step, master_step


# ---------------------------------------------------------------------------
# the data plane
# ---------------------------------------------------------------------------

class WindowStats(NamedTuple):
    """Cumulative two-level-gather counters."""
    hits: int
    misses: int
    streamed_rows: int     # rows host-fetched for the scoring stream
    swaps: int
    prefetches: int

    @property
    def hit_rate(self) -> float:
        """Fraction of sampled rows served from the device window."""
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


class StreamingDataPlane:
    """A bounded device window over a ChunkedExampleStore: one device's,
    or with ``group=`` one rank's over the chunk range its store holds.

    * ``gather_global(idx)``: the two-level gather; window hits gathered
      on the device, misses fetched from the host grouped by chunk and
      copied in once.  Over a group each rank serves the rows it owns
      and one one-owner all-reduce a key replicates them.
    * ``fetch_sharded(idx_per_shard)``: the scoring stream, (shards, rows)
      global indices of the rank's own logical shards' slices, read from
      its host chunks; never the window.
    * ``prefetch(chunk_mass)`` / ``swap_window()``: the next window is the
      top ``window_chunks`` chunks of the held range by proposal mass
      (``chunk_mass``: one entry a held chunk), ties toward lower chunk
      ids, built into a pending buffer (chunks already resident by a
      device copy unless written since the live window was built, the
      others from their pinned host chunks) on a copy stream; the swap
      makes the current stream wait for those copies.

    Every path gives a row's exact bits.  The hit, miss and streamed-row
    counts are this rank's."""

    def __init__(self, store: ChunkedExampleStore, window_chunks: int,
                 device="cuda", group: Optional[DataGroup] = None):
        if store.shard != axis_info(group):
            raise ValueError(f"the store holds the chunks of shard "
                             f"{store.shard}, the group is rank/size "
                             f"{axis_info(group)}")
        self.store = store
        self.group = group
        self.device = torch.device(device)
        self.on_cuda = self.device.type == "cuda"
        held = store.held_chunks
        if not 1 <= window_chunks <= len(held):
            raise ValueError(f"window_chunks={window_chunks} must be in "
                             f"[1, {len(held)}] (chunks per shard)")
        self.window_chunks = int(window_chunks)
        self.chunk_size = store.chunk_size
        self._copy = (torch.cuda.Stream(device=self.device)
                      if self.on_cuda else None)
        self._hits = self._misses = self._streamed = 0
        self._swaps = self._prefetches = 0
        self._pending: Optional[tuple] = None
        cold = held.start + np.arange(self.window_chunks)[None, :]
        self._install_window(cold, {
            k: v.to(self.device)
            for k, v in store.stack_chunks(cold.reshape(-1)).items()},
            self._write_counts(cold))

    # ---- the two-level gather ---------------------------------------------

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        return host.to(self.device, non_blocking=self.on_cuda)

    def _sync_store_growth(self) -> None:
        """Chunks appended to the store since the plane was built join the
        chunk→slot table as not resident (-1): their rows take the host
        path until a prefetch admits them."""
        grown = self.store.num_chunks - self._chunk_slot.size
        if grown > 0:
            self._chunk_slot = np.concatenate(
                [self._chunk_slot, np.full((grown,), -1, np.int64)])

    def gather_global(self, idx) -> dict:
        """Global example indices → their rows on the device: hits from
        the window, misses through one batched host fetch; over a group
        each rank takes the rows it owns and ``owner_sum`` replicates
        them."""
        self._sync_store_growth()
        idx = np.asarray(idx).reshape(-1).astype(np.int64)
        cidx, off = index_to_chunk(idx, self.chunk_size)
        held = self.store.held_chunks
        own = (cidx >= held.start) & (cidx < held.stop)
        rows = self._own_rows(idx, cidx, off, own)
        if self.group is None:
            return rows
        mine = self._to_device(torch.from_numpy(own))
        return {k: owner_sum(r, mine, self.group) for k, r in rows.items()}

    def _own_rows(self, idx, cidx, off, own) -> dict:
        """The rows of the owned positions ``own`` on the device (the
        others' rows are unspecified): window hits, misses fetched."""
        slot = self._chunk_slot[cidx]
        hit = slot >= 0
        miss_at = own & ~hit
        n_miss = int(miss_at.sum())
        self._hits += int(hit.sum())
        self._misses += n_miss
        miss = None
        if n_miss:
            fetched = self.store.fetch_rows(idx[miss_at])
            if n_miss == idx.size:
                return {k: self._to_device(v) for k, v in fetched.items()}
            at = torch.from_numpy(np.flatnonzero(miss_at))
            miss = {}
            for k, v in fetched.items():
                full = torch.zeros((idx.size,) + tuple(v.shape[1:]),
                                   dtype=v.dtype,
                                   pin_memory=self.store.pin_memory)
                full[at] = v
                miss[k] = self._to_device(full)
        pos = self._to_device(torch.from_numpy(
            np.where(hit, slot * self.chunk_size + off, 0)))
        rows = {k: take_rows(w, pos) for k, w in self._window.items()}
        if miss is None:
            return rows
        mask = self._to_device(torch.from_numpy(hit))
        return {k: torch.where(
            mask.reshape((-1,) + (1,) * (r.dim() - 1)), r, miss[k])
            for k, r in rows.items()}

    def fetch_sharded(self, idx_per_shard) -> dict:
        """The scoring stream: (shards, rows) global indices of the rank's
        own logical shards' slices → those rows on the device, shard-major,
        read from the host chunks (a foreign row raises
        ``ForeignChunkError``)."""
        idx_per_shard = np.asarray(idx_per_shard)
        if idx_per_shard.ndim != 2:
            raise ValueError(f"expected (shards, rows) indices, got shape "
                             f"{idx_per_shard.shape}")
        self._streamed += idx_per_shard.size
        return {k: self._to_device(v) for k, v in
                self.store.fetch_rows(idx_per_shard.reshape(-1)).items()}

    # ---- proposal-aware window refresh ------------------------------------

    def _write_counts(self, ids: np.ndarray) -> np.ndarray:
        return np.asarray([self.store.write_count(int(c))
                           for c in ids.reshape(-1)], np.int64)

    def _install_window(self, ids: np.ndarray, arrays: dict,
                        writes: np.ndarray) -> None:
        self._window_ids = ids
        self._window = arrays
        self._window_writes = writes   # each slot's write count at build
        if self.on_cuda:
            cur = torch.cuda.current_stream(self.device)
            for t in arrays.values():
                t.record_stream(cur)   # the gathers read it on this stream
        slot = np.full((self.store.num_chunks,), -1, np.int64)
        slot[ids.reshape(-1)] = np.arange(ids.size)
        self._chunk_slot = slot

    def _build(self, ids: np.ndarray) -> tuple[dict, np.ndarray, list]:
        """The window of chunks ``ids``, its write counts and the chunks
        read from the host: a resident chunk not written since the live
        window was built is copied on the device, every other chunk from
        its host chunk."""
        cs = self.chunk_size
        out = {k: torch.empty((ids.size * cs,) + self.store.row_shape(k),
                              dtype=self.store.dtype(k), device=self.device)
               for k in self.store.keys}
        writes = self._write_counts(ids)
        from_host = []
        for j, c in enumerate(ids.tolist()):
            s = int(self._chunk_slot[c]) if c < self._chunk_slot.size else -1
            if s >= 0 and self._window_writes[s] != writes[j]:
                s = -1
            if s < 0:
                from_host.append(c)
            for k, dst in out.items():
                part = dst[j * cs:(j + 1) * cs]
                if s >= 0:
                    part.copy_(self._window[k][s * cs:(s + 1) * cs])
                else:
                    part.copy_(self.store.chunk(c)[k],
                               non_blocking=self.on_cuda)
        return out, writes, from_host

    def prefetch(self, chunk_mass) -> bool:
        """Stage the next window off the held chunks' proposal masses into
        the pending buffer (the live window keeps serving until
        ``swap_window``).  Returns whether a new buffer was staged."""
        self._prefetches += 1
        self._sync_store_growth()
        held = self.store.held_chunks
        if isinstance(chunk_mass, torch.Tensor):
            chunk_mass = chunk_mass.cpu().numpy()
        mass = np.asarray(chunk_mass).reshape(-1)
        if mass.size < len(held):
            # the store grew after the mass was read: unseen chunks carry
            # no proposal mass until they are scored
            mass = np.concatenate([mass, np.zeros(
                (len(held) - mass.size,), mass.dtype)])
        if mass.size != len(held):
            raise ValueError(f"chunk_mass has {mass.size} entries, store "
                             f"holds {len(held)} chunks")
        order = np.argsort(-mass, kind="stable")
        new_ids = held.start + np.sort(order[:self.window_chunks])[None, :]
        if np.array_equal(new_ids, self._window_ids):
            self._pending = None
            return False
        if not self.on_cuda:
            self._pending = (new_ids, *self._build(new_ids.reshape(-1))[:2],
                             None)
            return True
        self._copy.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy):
            arrays, writes, from_host = self._build(new_ids.reshape(-1))
            done = torch.cuda.Event()
            done.record(self._copy)
        for t in self._window.values():
            t.record_stream(self._copy)
        self.store.guard_reads(from_host, done)
        self._pending = (new_ids, arrays, writes, done)
        return True

    def swap_window(self) -> bool:
        """Flip in the staged window (at a step boundary, before the step's
        gathers) once its copies have landed.  No-op when none is staged."""
        if self._pending is None:
            return False
        ids, arrays, writes, done = self._pending
        self._pending = None
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        self._install_window(ids, arrays, writes)
        self._swaps += 1
        return True

    @property
    def window_ids(self) -> np.ndarray:
        """Copy of the live window's chunk ids, (1, window_chunks)."""
        return self._window_ids.copy()

    @property
    def stats(self) -> WindowStats:
        """Cumulative hit/miss/stream/swap counters since reset."""
        return WindowStats(self._hits, self._misses, self._streamed,
                           self._swaps, self._prefetches)

    def reset_stats(self) -> None:
        """Zero the counters."""
        self._hits = self._misses = self._streamed = 0
        self._swaps = self._prefetches = 0


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

class StreamedISSGD(SwapCadence):
    """The streamed step's driver: host schedule, window lifecycle, swap
    cadence.  ``step(state)`` takes no dataset; the plane owns it.

    A step: fetch this step's scoring rows from the host → flip in the
    window staged last step → scoring (sync: into the store the master
    reads; async: into ``write_buf`` on the side stream, as
    ``AsyncPipeline``) → serve tick → the draw, its indices to the host →
    the two-level gather → master → stage the next window off the step's
    chunk masses every ``prefetch_every`` steps.  An instance is per run
    (its cadences ride on a host counter set from the first state).

    ``telemetry`` spans: stream.fetch, scoring.dispatch, serve.tick,
    sample.dispatch, stream.gather, master.dispatch, store.publish,
    stream.prefetch; counters stream.hit_rate, .hits, .misses,
    .streamed_rows, .window_swaps, .prefetches (and, async, store.swaps,
    with the publishes in ``swaps``) at its cadence.  Gated
    steps take the ``controller``'s gate in both the sample and the
    master step; ``swap_every`` is read fresh each step.

    Over the plane's data group (``plane.group``; the steps from
    ``distributed.make_sharded_streamed_steps`` over the same group)
    every rank drives the same schedule on its own rows: its shards'
    scoring slices, the replicated draw and minibatch, its own window."""

    def __init__(self, plane: StreamingDataPlane, scoring_step: Callable,
                 sample_step: Callable, master_step: Callable,
                 cfg: ISSGDConfig, num_examples: int, *,
                 async_mode: bool = False, swap_every: int = 1,
                 prefetch_every: int = 1,
                 serve_tick: Optional[Callable] = None, telemetry=None,
                 controller=None):
        if swap_every < 1 or prefetch_every < 1:
            raise ValueError("swap_every and prefetch_every must be >= 1")
        self.plane = plane
        self.serve_tick = serve_tick
        self.cfg = cfg
        self.async_mode = bool(async_mode)
        self.swap_every = int(swap_every)
        self.prefetch_every = int(prefetch_every)
        self._expect_scores = getattr(master_step, "expect_scores",
                                      (not async_mode) and cfg.mode != "fused")
        self._with_monitors = bool(getattr(master_step, "with_monitors",
                                           False))
        self._gated = bool(getattr(master_step, "gated", False))
        self.controller = controller
        if self._gated and controller is None:
            raise ValueError("master_step was built gated=True; pass the "
                             "controller= that owns its use_is gate")
        if telemetry is None:
            from repro_torch.telemetry import Telemetry
            telemetry = Telemetry.null()
        self.telemetry = telemetry
        self.last_monitors: Optional[dict] = None
        self._scoring = scoring_step
        self._sample = sample_step
        self._master = master_step
        rank, n_dev = axis_info(plane.group)
        self._layout = scoring_layout(cfg, num_examples, n_dev)
        self._first = rank * (num_examples // n_dev)
        self._side = ScoringStream(plane.device) if self.async_mode else None
        self.swaps = 0
        self._t: Optional[int] = None

    def _score_indices(self, t: int) -> np.ndarray:
        """(shards, rows) global indices of step t's scoring slices of
        this rank's logical shards."""
        w_loc, _, sb_w = self._layout
        return self._first + host_score_slice(t, *self._layout).reshape(
            w_loc, sb_w)

    def step(self, state: TrainState, data: Optional[dict] = None
             ) -> tuple[TrainState, StepMetrics]:
        """One streamed step.  ``data`` is accepted and ignored, for the
        resident step's signature."""
        if self._t is None:
            self._t = int(state.step)
        t = self._t
        tel = self.telemetry
        score_rows = None
        if self.cfg.mode != "fused":
            with tel.span("stream.fetch", step=t):
                score_rows = self.plane.fetch_sharded(self._score_indices(t))
        self.plane.swap_window()
        out = (self._step_async(state, score_rows) if self.async_mode
               else self._step_sync(state, score_rows))
        if tel.due(self._t):
            s = self.plane.stats
            for name, v in (("hit_rate", s.hit_rate), ("hits", s.hits),
                            ("misses", s.misses),
                            ("streamed_rows", s.streamed_rows),
                            ("window_swaps", s.swaps),
                            ("prefetches", s.prefetches)):
                tel.counter(f"stream.{name}", v, step=self._t)
        return out

    def _draw(self, store, state, gate):
        """The step's one draw, its indices on the host, their rows."""
        tel = self.telemetry
        idx, mass = tel.timed("sample.dispatch", self._sample, store,
                              state.step, state.rng, *gate, step=self._t)
        with tel.span("stream.gather", step=self._t):
            batch = self.plane.gather_global(idx.cpu().numpy())
        return idx, mass, batch

    def _master_out(self, out):
        if self._with_monitors:
            self.last_monitors = out[7]
        return out[:7]

    def _step_sync(self, state, score_rows):
        tel = self.telemetry
        t = self._t
        if self.cfg.mode == "fused":
            store, fresh, stale = state.store, None, None
        else:
            store, fresh, stale, _ = tel.timed(
                "scoring.dispatch", self._scoring, state.stale_params,
                state.store, state.step, score_rows, step=t)
        if self.serve_tick is not None:
            with tel.span("serve.tick", step=t):
                self.serve_tick(state)
        gate = (self.controller.gate(),) if self._gated else ()
        idx, mass, batch = self._draw(store, state, gate)
        margs = (state.params, state.opt_state, state.stale_params, store,
                 state.step, state.rng, batch)
        if self._expect_scores:
            margs += (fresh, stale)
        params, opt_state, stale_params, store, step, rng, metrics = \
            self._master_out(tel.timed(
                "master.dispatch", lambda *a: self._master(
                    *a, sample_indices=idx), *margs, *gate, step=t))
        self._advance(mass)
        return (TrainState(params, opt_state, stale_params, store, step,
                           rng), metrics)

    def _step_async(self, state, score_rows):
        tel = self.telemetry
        t = self._t
        bs: BufferedWeightStore = state.store
        write_buf, _, _, smetrics = tel.timed(
            "scoring.dispatch", self._side.dispatch, self._scoring,
            state.stale_params, bs.write_buf, state.step, score_rows, step=t)
        if self.serve_tick is not None:
            with tel.span("serve.tick", step=t):
                self.serve_tick(state)
        gate = (self.controller.gate(),) if self._gated else ()
        idx, mass, batch = self._draw(bs.read_buf, state, gate)
        params, opt_state, stale_params, _, step, rng, metrics = \
            self._master_out(tel.timed(
                "master.dispatch", lambda *a: self._master(
                    *a, sample_indices=idx), state.params, state.opt_state,
                state.stale_params, bs.read_buf, state.step, state.rng,
                batch, *gate, step=t))
        self._advance(mass)
        bs, metrics = self._close_async(bs, write_buf, metrics, smetrics,
                                        state.step)
        return (TrainState(params, opt_state, stale_params, bs, step, rng),
                metrics)

    def _advance(self, mass) -> None:
        if self._t % self.prefetch_every == 0:
            with self.telemetry.span("stream.prefetch", step=self._t):
                self.plane.prefetch(mass)
        self._t += 1

    def probe(self, state: TrainState, data: Optional[dict] = None
              ) -> TrainState:
        """Fused mode's coverage probe (the streamed ``make_score_step``):
        rescore the current round-robin slice with θ_stale."""
        score_rows = self.plane.fetch_sharded(
            self._score_indices(int(state.step)))
        store, _, _, _ = self._scoring(state.stale_params, state.store,
                                       state.step, score_rows)
        return state._replace(store=store)


def make_streamed_issgd(per_example_loss: Callable, scorer: Callable,
                        optimizer, cfg: ISSGDConfig, dataset_arrays: dict,
                        chunk_size: int, window_chunks: int,
                        device="cuda", aux_loss: Optional[Callable] = None,
                        fused_score: Optional[Callable] = None,
                        async_mode: bool = False, swap_every: int = 1,
                        prefetch_every: int = 1, monitor_traces: bool = True
                        ) -> StreamedISSGD:
    """Single-call constructor of the one-device streamed loop: chunk the
    arrays into a host store (pinned for a card), stand up the plane,
    build the three steps."""
    device = torch.device(device)
    store = ChunkedExampleStore.from_arrays(
        dataset_arrays, chunk_size, pin_memory=device.type == "cuda")
    plane = StreamingDataPlane(store, window_chunks, device=device)
    n = store.num_examples
    steps = make_streamed_steps(
        per_example_loss, scorer, optimizer, cfg, n, chunk_size,
        aux_loss=aux_loss, fused_score=fused_score, async_mode=async_mode,
        monitor_traces=monitor_traces)
    return StreamedISSGD(plane, *steps, cfg, n, async_mode=async_mode,
                         swap_every=swap_every, prefetch_every=prefetch_every)
