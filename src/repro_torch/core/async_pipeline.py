"""Async scoring: the workers' pass overlaps the master's update.

The paper's workers are "fire and forget" (§4, fig. 1): they push scores
at their own cadence while the master updates without waiting.  The
synchronous step of ``core/issgd.py`` serializes the two: step t's master
samples from a proposal that already holds step t's writes.  This module
splits it into two computations over the double-buffered store
(``weight_store.BufferedWeightStore``), as ``src/repro/core/
async_pipeline.py`` does:

  scoring_step  rescore this step's round-robin slice with θ_stale and
                write it into ``write_buf``;
  master_step   proposal read from ``read_buf`` → two-stage draw →
                IS-scaled unbiased update (§4.1).  Never touches
                ``write_buf``.

On the card the scoring step runs on a side CUDA stream of its own and the
master on the current stream (``ScoringStream``).  Events order them:

  * the side stream waits for the current stream before each scoring
    dispatch, since step t's scoring reads ``stale_params``, an output of
    master t−1; scoring t and master t share no tensor and run at once;
  * the current stream waits for the side stream only at ``publish``,
    before it copies ``write_buf`` (and wherever a caller reads what the
    scoring wrote, through ``join``); over a data group with the trace
    monitors on, also at the end of each step, before it sums the
    ranks' trace sums (``TraceSums``).  No collective runs on the side
    stream.

Tensors that one stream allocated and the other reads are marked with
``Tensor.record_stream``, so the caching allocator never hands their
memory to a new tensor while the other stream may still read it.  On the
CPU there is no stream: the two steps run in program order, with the same
results.

Invariant (``tests/test_torch_async.py``; ``chip_smoke.py`` phase 38 on
the card): an async run with swap cadence K is bitwise a relaxed run
whose master at step t samples from the table as written through step
K·⌊t/K⌋ − 1, i.e. with a proposal L(t) = t − K·⌊t/K⌋ + 1 steps staler.
The IS scales come from the same lagged proposal the draw used, so §4.1's
unbiasedness holds; the lag shows in ``read_buf.scored_at``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import variance
from repro_torch.core.issgd import (ISSGDConfig, StepMetrics, TrainState,
                                    init_train_state, make_master_pass,
                                    make_scoring_pass)
from repro_torch.core.weight_store import (BufferedWeightStore, publish,
                                           to_buffered)
from repro_torch.core.collectives import psum
from repro_torch.dist import DataGroup
from repro_torch.optim import Optimizer


class ScoreMetrics(NamedTuple):
    """Fig-4 trace monitors (√TrΣ), emitted by the scoring step: in async
    mode the master cannot compute them without waiting on the fresh
    scores."""
    trace_ideal: torch.Tensor
    trace_stale: torch.Tensor
    trace_unif: torch.Tensor


class TraceSums(NamedTuple):
    """A rank's part of the fig-4 monitors, as the scoring step of a data
    group returns it: the partial sums of its part of the slice
    (``variance.trace_sums``), the slice's global length and the group.
    The scoring step issues no collective: ``finish`` sums them over the
    group on the current stream, after the pipeline has joined the
    scoring stream (``SwapCadence._close_async``)."""
    sums: torch.Tensor
    n_total: int
    group: DataGroup

    def finish(self) -> ScoreMetrics:
        return _score_metrics(variance.traces_from_sums(
            psum(self.sums, self.group), self.n_total))


def _score_metrics(traces: variance.TraceSigma) -> ScoreMetrics:
    return ScoreMetrics(
        trace_ideal=torch.sqrt(torch.clamp(traces.ideal, min=0.0)),
        trace_stale=torch.sqrt(torch.clamp(traces.stale, min=0.0)),
        trace_unif=torch.sqrt(torch.clamp(traces.unif, min=0.0)))


def score_trace_metrics(fresh_scores: torch.Tensor,
                        stale_slice: torch.Tensor, n_total: int,
                        monitor: bool = True,
                        group: Optional[DataGroup] = None):
    """The scoring step's fig-4 monitors, shared by the async pipeline and
    the streamed scoring step (``data/streaming.py``).  With
    ``monitor=False`` they are NaN and cost nothing.  Over a data group
    the slice is this rank's part, and they are its ``TraceSums``: the
    side stream never issues a collective, so it never has to agree with
    the master's on an order of collectives across ranks."""
    if not monitor:
        nan = torch.full((), math.nan, device=fresh_scores.device)
        return ScoreMetrics(nan, nan, nan)
    with torch.no_grad():
        sums = variance.trace_sums(fresh_scores, stale_slice)
        if group is not None:
            return TraceSums(sums, n_total, group)
        return _score_metrics(variance.traces_from_sums(sums, n_total))


def tensors_of(tree) -> list:
    """Every tensor of a tree of dicts, NamedTuples, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return []


class ScoringStream:
    """The workers' side of the stream contract.

    ``dispatch(fn, *args)`` runs ``fn`` on a side CUDA stream after
    everything queued so far on the current stream, marks its tensor
    inputs as used by the side stream and its tensor outputs as used by
    the current stream (``record_stream``), and records an event after
    it.  ``join()`` makes the current stream wait for that event.  CPU
    tensors take neither streams nor events: ``fn`` runs in program
    order.  A device without streams is never emulated on the current
    stream: ``torch.cuda.Stream`` raises there."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_cuda = self.device.type == "cuda"
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.on_cuda else None)
        self._done = None

    def dispatch(self, fn: Callable, *args):
        if not self.on_cuda:
            return fn(*args)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        for t in tensors_of(args):
            if t.is_cuda:
                t.record_stream(self.stream)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
            self._done = torch.cuda.Event()
            self._done.record(self.stream)
        for t in tensors_of(out):
            if t.is_cuda:
                t.record_stream(cur)
        return out

    def join(self) -> None:
        """The current stream waits for the scoring dispatched so far."""
        if self._done is not None:
            torch.cuda.current_stream(self.device).wait_event(self._done)


def make_async_steps(per_example_loss: Callable, scorer: Callable,
                     optimizer: Optimizer, cfg: ISSGDConfig,
                     num_examples: int, aux_loss: Optional[Callable] = None,
                     monitor_traces: bool = True, monitors=None,
                     gated: bool = False,
                     group: Optional[DataGroup] = None,
                     model_group: Optional[DataGroup] = None,
                     param_specs=None, split_batch: bool = False
                     ) -> tuple[Callable, Callable]:
    """The two computations of the async pipeline:

      scoring_step(stale_params, write_buf, step, data)
          -> (write_buf', ScoreMetrics)
      master_step(params, opt_state, stale_params, read_buf, step,
                  generator, data[, use_is], sample_indices=None)
          -> (params', opt_state', stale_params', step + 1, generator,
              StepMetrics[, monitors])

    The master's traces are NaN (``AsyncPipeline`` merges the scoring
    step's in); with ``monitor_traces=False`` those are NaN too.  A
    non-empty ``monitors`` adds the proposal-health monitors over
    ``read_buf``, the lagged table the draw used, so ``staleness``
    observes L(t); ``gated`` (relaxed only) takes the controller's host
    bool ``use_is``.  The generator is the port's stateful one: the
    master draws from it once and returns it.

    Over a data ``group`` (``core/distributed.py``) both steps take this
    rank's rows of the buffers and the data.  The scoring step rescores
    the round-robin slices of the rank's logical shards and writes its
    rows of ``write_buf`` with no collective; with ``monitor_traces`` its
    metrics are the rank's ``TraceSums``, which the pipeline sums over
    the group after it joins the scoring stream.  The master is the
    sharded master pass (the hierarchical draw from ``read_buf``, the
    one-owner row reads), the same on every rank.  With a
    ``model_group`` the params are this rank's shards under
    ``param_specs`` and the scorer and loss are model-axis-aware; the
    scoring step's model-axis sums run on the scoring stream, as its
    kernels do, and the master's on the current one.  ``split_batch``
    splits the master's minibatch over the data group
    (``issgd.make_master_pass``; the reference's ``constrain_batch``,
    ``src/repro/core/async_pipeline.py:76``); its all-reduces run on the
    current stream with the master's."""
    if cfg.mode not in ("relaxed", "uniform"):
        raise ValueError(
            "async scoring supports mode='relaxed'/'uniform' (exact needs "
            "the fig-1 sync barrier; fused already merges the passes), got "
            f"{cfg.mode!r}")
    monitors = monitors or None
    scoring_pass = make_scoring_pass(scorer, cfg, num_examples, group=group)
    master_pass = make_master_pass(per_example_loss, optimizer, cfg,
                                   num_examples, aux_loss=aux_loss,
                                   monitors=monitors, gated=gated,
                                   group=group, model_group=model_group,
                                   param_specs=param_specs,
                                   split_batch=split_batch)
    sb = cfg.score_batch_size

    def scoring_step(stale_params, write_buf, step: int, data):
        store, fresh, stale_slice = scoring_pass(stale_params, write_buf,
                                                 step, data)
        return store, score_trace_metrics(fresh, stale_slice, n_total=sb,
                                          monitor=monitor_traces,
                                          group=group)

    def _master(params, opt_state, stale_params, read_buf, step, generator,
                data, use_is, sample_indices):
        params, opt_state, stale_params, _, metrics, *mon = master_pass(
            params, opt_state, stale_params, read_buf, step, generator,
            data, None, None, sample_indices, use_is)
        return (params, opt_state, stale_params, step + 1, generator,
                metrics, *mon)

    if gated:
        def master_step(params, opt_state, stale_params, read_buf, step,
                        generator, data, use_is, sample_indices=None):
            return _master(params, opt_state, stale_params, read_buf, step,
                           generator, data, use_is, sample_indices)
    else:
        def master_step(params, opt_state, stale_params, read_buf, step,
                        generator, data, sample_indices=None):
            return _master(params, opt_state, stale_params, read_buf, step,
                           generator, data, None, sample_indices)

    master_step.with_monitors = bool(monitors)
    master_step.gated = bool(gated)
    return scoring_step, master_step


class SwapCadence:
    """The tail of an async step, shared by ``AsyncPipeline`` and the
    streamed driver (``data/streaming.py``).  A driver sets
    ``telemetry``, ``swap_every``, ``swaps``, its ``ScoringStream`` as
    ``_side`` and its host step counter ``_t``, and after advancing
    ``_t`` past the step calls ``_close_async``."""

    def join(self) -> None:
        """The current stream waits for the scoring dispatched so far."""
        if self._side is not None:
            self._side.join()

    def _close_async(self, bs: BufferedWeightStore, write_buf,
                     metrics: StepMetrics, smetrics: ScoreMetrics,
                     step) -> tuple[BufferedWeightStore, StepMetrics]:
        """The store with the scoring's ``write_buf``, published (after the
        current stream joins the side stream) every ``swap_every`` host
        steps, ``store.swaps`` at the telemetry's cadence, and the
        scoring's fig-4 traces in the master's metrics: a data group's
        ``TraceSums`` summed on the current stream once it has joined
        the side stream, every step on every rank."""
        tel = self.telemetry
        bs = BufferedWeightStore(bs.read_buf, write_buf, bs.synced_at)
        if isinstance(smetrics, TraceSums):
            self._side.join()
            smetrics = smetrics.finish()
        if self._t % self.swap_every == 0:
            with tel.span("store.publish", step=self._t):
                self._side.join()
                bs = publish(bs, step)
            self.swaps += 1
        if tel.due(self._t):
            tel.counter("store.swaps", self.swaps, step=self._t)
        return bs, metrics._replace(trace_ideal=smetrics.trace_ideal,
                                    trace_stale=smetrics.trace_stale,
                                    trace_unif=smetrics.trace_unif)


class AsyncPipeline(SwapCadence):
    """The host driver: the scoring step on the side stream, the master on
    the current stream, and the swap cadence.

    ``step(state, data)`` takes a TrainState whose store is a
    BufferedWeightStore (``init_async_state``, ``to_buffered``).  Every
    ``swap_every`` steps (a host int read fresh each step, so a
    controller may change it) the written table is published to
    ``read_buf``.  An instance is per run: the cadence rides on a host
    counter set from the first state's step.

    ``serve_tick(state)`` runs between the two dispatches (the serving
    loop decodes against its published snapshot while the side stream
    scores).  ``telemetry`` times each phase as a dispatch span (blocking
    spans synchronise the card and so serialise the overlap) and emits
    ``store.swaps`` at its cadence; monitors land on ``last_monitors``.
    A gated master needs the ``controller`` whose ``gate()`` it takes.
    ``join()`` makes the current stream wait for the scoring dispatched
    so far: call it before reading the step's traces or ``write_buf``
    outside the pipeline."""

    def __init__(self, scoring_step: Callable, master_step: Callable,
                 swap_every: int = 1, *,
                 serve_tick: Optional[Callable] = None, telemetry=None,
                 controller=None):
        if swap_every < 1:
            raise ValueError(f"swap_every must be >= 1, got {swap_every}")
        self.serve_tick = serve_tick
        self._with_monitors = bool(getattr(master_step, "with_monitors",
                                           False))
        self._gated = bool(getattr(master_step, "gated", False))
        self.controller = controller
        if self._gated and controller is None:
            raise ValueError("master_step was built gated=True; pass the "
                             "controller= that owns its use_is gate")
        self._scoring = scoring_step
        self._master = master_step
        self.swap_every = int(swap_every)
        self._t: Optional[int] = None
        if telemetry is None:
            from repro_torch.telemetry import Telemetry
            telemetry = Telemetry.null()
        self.telemetry = telemetry
        self.swaps = 0
        self.last_monitors: Optional[dict] = None
        self._side: Optional[ScoringStream] = None

    def step(self, state: TrainState, data: dict
             ) -> tuple[TrainState, StepMetrics]:
        """One async step: scoring into ``write_buf`` on the side stream,
        the master from ``read_buf`` on the current one, then the swap
        every ``swap_every`` steps."""
        bs: BufferedWeightStore = state.store
        if self._t is None:
            self._t = int(state.step)
        if self._side is None:
            self._side = ScoringStream(bs.write_buf.weights.device)
        tel = self.telemetry
        write_buf, smetrics = tel.timed(
            "scoring.dispatch", self._side.dispatch, self._scoring,
            state.stale_params, bs.write_buf, state.step, data, step=self._t)
        if self.serve_tick is not None:
            with tel.span("serve.tick", step=self._t):
                self.serve_tick(state)
        margs = (state.params, state.opt_state, state.stale_params,
                 bs.read_buf, state.step, state.rng, data)
        if self._gated:
            margs += (self.controller.gate(),)
        out = tel.timed("master.dispatch", self._master, *margs,
                        step=self._t)
        params, opt_state, stale_params, step, rng, metrics = out[:6]
        if self._with_monitors:
            self.last_monitors = out[6]
        self._t += 1
        bs, metrics = self._close_async(bs, write_buf, metrics, smetrics,
                                        state.step)
        return TrainState(params, opt_state, stale_params, bs, step,
                          rng), metrics


def make_async_pipeline(per_example_loss: Callable, scorer: Callable,
                        optimizer: Optimizer, cfg: ISSGDConfig,
                        num_examples: int, swap_every: int = 1,
                        aux_loss: Optional[Callable] = None,
                        monitor_traces: bool = True) -> AsyncPipeline:
    """Single-call constructor of the one-device async pipeline."""
    scoring_step, master_step = make_async_steps(
        per_example_loss, scorer, optimizer, cfg, num_examples,
        aux_loss=aux_loss, monitor_traces=monitor_traces)
    return AsyncPipeline(scoring_step, master_step, swap_every)


def init_async_state(params, optimizer: Optimizer, num_examples: int,
                     device, seed: int = 0, table_dtype: str = "f32",
                     index_chunk_size: int = 0) -> TrainState:
    """TrainState for the async pipeline: the plain init with its store
    wrapped into a BufferedWeightStore (both buffers cold)."""
    state = init_train_state(params, optimizer, num_examples, device,
                             seed=seed, table_dtype=table_dtype,
                             index_chunk_size=index_chunk_size)
    return state._replace(store=to_buffered(state.store))
