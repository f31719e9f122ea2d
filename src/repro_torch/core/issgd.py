"""ISSGD — the paper's importance-sampling SGD (section 4).

One train step runs the paper's three actors in order:

  workers   → a scoring pass over a round-robin slice of the dataset with
              *stale* parameters θ_stale (pushed every `refresh_every`
              steps — the paper's parameter-push period);
  database  → the WeightStore (ω̃ + scored_at);
  master    → proposal read (B.1 staleness filter + B.3 smoothing),
              two-stage multinomial draw, IS-scaled unbiased loss (§4.1),
              gradient step.

Modes: ``relaxed`` (the paper's practical algorithm), ``exact`` (rescore
the whole dataset with fresh params every step, the §4.1 oracle),
``uniform`` (plain SGD; scoring still runs for the monitors) and
``fused`` (the paper's §6 suggestion: no scoring pass; the master's own
forward yields the closed-form logit-grad score of each example it
trains on, written back last-write-wins; ``make_score_step`` is the
probe that keeps the unsampled examples covered).  The step stays on the
device: no host synchronisation happens inside it.

Options of the master pass: ``monitors`` adds the proposal-health
monitors (``telemetry/monitors.py``) as one more output; ``gated`` (relaxed
mode) takes the adaptive controller's gate, a host bool, and runs the
uniform step when it is closed and the relaxed step when it is open.
The config's ``index``, ``table_dtype``, ``score_ttl`` and
``index_chunk_size`` select the billion-row structures: the stage-1
masses through the mass index, a bf16 or int8 table, and the TTL decay
of stale scores.

Distribution (``core/distributed.py`` builds the sharded step): every
half takes a data group (``repro_torch.dist.DataGroup``, ``None`` for one
device).  Sharded, a rank holds the contiguous rows of the dataset and
the store that its W / ranks logical scoring shards cover, scores their
round-robin slices with no communication, and the master draws with the
hierarchical two-stage draw and reads the B sampled rows through
one-owner all-reduces (``core/collectives.py``): no rank ever holds the
f32[N] table.  Parameters stay replicated and every rank computes the
same master update on the same gathered minibatch.  Because W, not the
number of ranks, fixes the decomposition, a sharded run draws the
indices of the one-device run.

The batch-split master (``split_batch``, the reference's
``constrain_batch``; off by default, as there): each data rank takes its
``batch_block`` of the gathered minibatch through the loss and the
backward, and one all-reduce a leaf sums the gradients before the
replicated update.  The sums run in another order than one device's, so
a split step is one device's within a tolerance, not bitwise.

Model parallelism: the master pass also takes a model group and the
parameters' spec tree (``dist/sharding.py``).  A rank then holds its
column or row shards of the parameters, its loss is model-axis-aware,
and the gradient norm is the global one (``grad_global_norm``); the
store, the draws and every replicated value are the same on each rank
of a model group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import variance
from repro_torch.core.collectives import (axis_info, gather_rows,
                                          model_sum, owner_sum, psum)
from repro_torch.core.importance import (ISConfig, effective_sample_size,
                                         is_loss_scale)
from repro_torch.core.mass_index import block_masses
from repro_torch.core.sampler import shard_totals, two_stage_sample
from repro_torch.core.weight_store import (EMPTY, WeightStore,
                                           decay_proposal, init_store,
                                           read_proposal, write_scores,
                                           write_scores_global)
from repro_torch.data.pipeline import gather_batch
from repro_torch.dist import DataGroup, batch_block
from repro_torch.dist.sharding import is_sharded
from repro_torch.optim import (Optimizer, clip_by_global_norm, global_norm,
                               tree_leaves, tree_map)
from repro_torch.telemetry.monitors import proposal_monitors

MODES = ("relaxed", "exact", "uniform", "fused")
INDEXES = ("dense", "tree")


@dataclasses.dataclass(frozen=True)
class ISSGDConfig:
    """Step-shape knobs: batch sizes, refresh cadence, mode, smoothing,
    and the logical scoring decomposition W."""
    batch_size: int = 64
    score_batch_size: int = 256        # examples rescored per step ("workers")
    refresh_every: int = 8             # θ_stale refresh period (param pushes)
    mode: str = "relaxed"              # relaxed | exact | uniform | fused
    is_cfg: ISConfig = ISConfig()
    grad_clip: float = 0.0
    score_shards: int = 1              # W: logical scoring shards
    # the billion-row sampling structures (all off by default):
    index: str = "dense"               # stage-1 masses: dense | tree
    table_dtype: str = "f32"           # weight table: f32 | bf16 | int8
    score_ttl: int = 0                 # TTL decay half-life in steps, 0 off
    index_chunk_size: int = 0          # chunk for int8 scales / TTL; 0 → n_w


class TrainState(NamedTuple):
    """Everything a step carries.  ``step`` is a host int; ``rng`` is the
    generator the master's draws come from (on the params' device)."""
    params: Any
    opt_state: Any
    stale_params: Any                  # the workers' parameter copy
    store: WeightStore
    step: int
    rng: torch.Generator


class StepMetrics(NamedTuple):
    """Per-step monitors (paper fig. 4 traces + sampling diagnostics), as
    device tensors; reading them is the caller's synchronisation."""
    loss: torch.Tensor
    grad_norm: torch.Tensor
    trace_ideal: torch.Tensor
    trace_stale: torch.Tensor
    trace_unif: torch.Tensor
    ess_frac: torch.Tensor
    mean_weight: torch.Tensor
    sample_indices: torch.Tensor


def init_train_state(params, optimizer: Optimizer, num_examples: int,
                     device: torch.device | str, seed: int = 0,
                     table_dtype: str = "f32",
                     index_chunk_size: int = 0,
                     store_device=None) -> TrainState:
    """Fresh state: stale params alias θ₀ (updates are functional), the
    store unscored (uniform proposal until the first sweep), in the
    storage dtype ``table_dtype`` (int8 scales per ``index_chunk_size``
    rows), on ``store_device`` (default ``device``, the generator's)."""
    return TrainState(
        params=params, opt_state=optimizer.init(params), stale_params=params,
        store=init_store(num_examples, store_device or device,
                         table_dtype=table_dtype,
                         chunk_size=index_chunk_size), step=0,
        rng=torch.Generator(device=device).manual_seed(seed))


def read_sampling_proposal(store: WeightStore, step: int,
                           cfg: ISSGDConfig, n_w: int) -> torch.Tensor:
    """The proposal the master draws from: ``read_proposal`` (B.1, B.3,
    the EMPTY mask, a quantized table's f32 view), then with
    ``score_ttl > 0`` the per-chunk decay toward the uniform floor
    (chunks of ``index_chunk_size`` rows, or of one logical shard)."""
    proposal = read_proposal(store, step, cfg.is_cfg)
    if cfg.score_ttl > 0:
        proposal = decay_proposal(proposal, store.scored_at, step,
                                  cfg.score_ttl, cfg.is_cfg,
                                  cfg.index_chunk_size or n_w)
    return proposal


def stage1_block_sums(proposal: torch.Tensor, w: int,
                      cfg: ISSGDConfig) -> Optional[torch.Tensor]:
    """The stage-1 masses for ``two_stage_sample``: None with the dense
    index (the draw reduces them itself), the mass index's
    ``block_masses`` with the tree index — the same reduction, so tree
    draws equal dense draws bitwise."""
    return None if cfg.index == "dense" else block_masses(proposal, w)


def proposal_totals(proposal: torch.Tensor, cfg: ISSGDConfig, w: int,
                    group: Optional[DataGroup] = None) -> torch.Tensor:
    """The W shard masses of the proposal (this rank's rows, ``w`` logical
    shards), the same on every rank: the draw's stage 1, and their sum
    the master's Σw, so both have the same bits on any number of ranks."""
    return shard_totals(proposal, w, stage1_block_sums(proposal, w, cfg),
                        group)


def draw_minibatch(proposal: torch.Tensor, cfg: ISSGDConfig, w: int,
                   generator: torch.Generator, uniform: bool,
                   group: Optional[DataGroup] = None,
                   totals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The master's draw of ``cfg.batch_size`` global indices: uniform
    over the N rows of the table, or two-stage ∝ ``proposal`` (this
    rank's rows) over its ``w`` logical shards, from ``totals``
    (``proposal_totals``) when the caller holds them.  The streamed
    sample step (``data/streaming.py``) draws with it too."""
    if uniform:
        n = proposal.shape[0] * axis_info(group)[1]
        return torch.randint(0, n, (cfg.batch_size,), generator=generator,
                             device=proposal.device)
    if totals is None:
        totals = proposal_totals(proposal, cfg, w, group)
    return two_stage_sample(proposal, cfg.batch_size, num_shards=w,
                            generator=generator, group=group, totals=totals)


def grad_global_norm(grads, model_group: Optional[DataGroup] = None,
                     param_specs=None) -> torch.Tensor:
    """The global gradient norm when the parameters may be model-sharded
    (``src/repro/core/issgd.py::_grad_global_norm``): a sharded leaf adds
    its square-sum, a replicated leaf (the same on every rank) adds it
    divided by M, and one all-reduce over the model group sums them
    before the sqrt.  For M = 1 it is ``optim.global_norm``."""
    if model_group is None:
        return global_norm(grads)
    if param_specs is None:
        raise ValueError("a model group but no param_specs: the grad norm "
                         "cannot tell sharded from replicated leaves")
    n_model = model_group.size

    def leaf(g, spec):
        s = torch.sum(torch.square(g.float()))
        return s if is_sharded(spec) else s / n_model

    sq = sum(_zip_leaves(grads, param_specs, leaf))
    return torch.sqrt(model_sum(sq, model_group))


def _zip_leaves(tree, specs, fn) -> list:
    if isinstance(tree, dict):
        return [v for k in tree for v in _zip_leaves(tree[k], specs[k], fn)]
    return [fn(tree, specs)]


def _check_mode(cfg: ISSGDConfig) -> None:
    if cfg.mode not in MODES:
        raise ValueError(f"mode {cfg.mode!r} is not ported; this port runs "
                         f"{', '.join(MODES)}")
    if cfg.index not in INDEXES:
        raise ValueError(f"unknown index {cfg.index!r}; available: "
                         f"{', '.join(INDEXES)}")


def _resolve_shards(cfg: ISSGDConfig, n: int, sb: int,
                    n_dev: int = 1) -> tuple[int, int, int]:
    """(w_loc, n_w, sb_w): the logical shards a rank holds, their length
    and each one's scoring slice a step."""
    w = max(cfg.score_shards, 1)
    if w % n_dev:
        raise ValueError(f"score_shards={w} must be divisible by the "
                         f"device count {n_dev}")
    if n % w:
        raise ValueError(f"num_examples={n} not divisible by "
                         f"score_shards={w}")
    if sb % w:
        raise ValueError(f"score_batch_size={sb} not divisible by "
                         f"score_shards={w}")
    return w // n_dev, n // w, sb // w


def _check_shard_rows(store: WeightStore, n: int, n_dev: int) -> None:
    if store.weights.shape[0] * n_dev != n:
        raise ValueError(f"store shard of {store.weights.shape[0]} rows × "
                         f"{n_dev} devices ≠ num_examples={n}")


def _score_slice(step: int, w: int, n_w: int, sb_w: int,
                 device) -> torch.Tensor:
    """Indices of this step's round-robin scoring slice: each of the `w`
    logical shards (a rank's own, at its local rows) contributes `sb_w`
    examples."""
    base = (step * sb_w + torch.arange(sb_w, device=device)) % n_w
    shard = torch.arange(w, device=device)[:, None] * n_w
    return (shard + base[None, :]).reshape(-1)


def scoring_layout(cfg: ISSGDConfig, num_examples: int,
                   n_dev: int = 1) -> tuple[int, int, int]:
    """(w_loc, n_w, sb_w): the logical shards each of ``n_dev`` devices
    scores, their length and each one's slice a step.  The streaming
    scheduler (``data/streaming.py``) replays ``_score_slice`` from it on
    the host."""
    if num_examples % n_dev:
        raise ValueError(f"num_examples={num_examples} not divisible by "
                         f"{n_dev} devices")
    sb = num_examples if cfg.mode == "exact" else cfg.score_batch_size
    return _resolve_shards(cfg, num_examples, sb, n_dev)


def make_scoring_pass(scorer: Callable, cfg: ISSGDConfig,
                      num_examples: int, streaming: bool = False,
                      group: Optional[DataGroup] = None) -> Callable:
    """The workers' half: ``scoring_pass(score_params, store, step, data)
    -> (store, fresh_scores, stale_slice)``.  Rescore this step's
    round-robin slice and write it; `stale_slice` is the proposal over
    the slice *before* the write (the eq. 9 monitor input).  With
    ``streaming`` ``data`` is the slice's rows themselves, gathered by
    the host (``data/streaming.py``); the writes land at the same
    indices, so the two forms are bitwise equal.  Over a data group
    ``store`` and ``data`` are this rank's rows and the pass scores its
    own shards' slices: no collective."""
    _check_mode(cfg)
    n = num_examples
    sb = n if cfg.mode == "exact" else cfg.score_batch_size
    n_dev = axis_info(group)[1]
    w_loc, n_w, sb_w = _resolve_shards(cfg, n, sb, n_dev)
    # a slice longer than its shard wraps around it: its indices repeat
    write = write_scores_global if sb_w > n_w else write_scores

    def scoring_pass(score_params, store: WeightStore, step: int, data):
        _check_shard_rows(store, n, n_dev)
        score_idx = _score_slice(step, w_loc, n_w, sb_w,
                                 store.weights.device)
        fresh = scorer(score_params,
                       data if streaming else gather_batch(data, score_idx))
        stale_slice = read_proposal(store, step, cfg.is_cfg)[score_idx]
        # reserved rows (scored_at == EMPTY) stay inert: score 0, stamp kept
        live = store.scored_at[score_idx] > EMPTY
        fresh = torch.where(live, fresh, torch.zeros_like(fresh))
        stamp = torch.where(live, torch.full_like(score_idx, step),
                            torch.full_like(score_idx, EMPTY))
        return write(store, score_idx, fresh, stamp), fresh, stale_slice

    return scoring_pass


def make_master_pass(per_example_loss: Callable, optimizer: Optimizer,
                     cfg: ISSGDConfig, num_examples: int,
                     aux_loss: Optional[Callable] = None,
                     fused_score: Optional[Callable] = None,
                     monitors=None, gated: bool = False,
                     streaming: bool = False,
                     group: Optional[DataGroup] = None,
                     model_group: Optional[DataGroup] = None,
                     param_specs=None, split_batch: bool = False
                     ) -> Callable:
    """The master's half: ``master_pass(params, opt_state, stale_params,
    store, step, generator, data, fresh_scores=None, stale_slice=None,
    sample_indices=None, use_is=None) -> (params, opt_state,
    stale_params, store, metrics)``.

    Proposal read → two-stage draw (or the injected ``sample_indices``)
    → IS-scaled unbiased update (§4.1) → parameter push.  The loss is
    ``mean(losses · scales)``, plus ``aux_loss(params, batch)`` (a 0-d
    tensor, e.g. an MoE load-balance loss) when given.  Without
    `fresh_scores` the fig-4 traces come back NaN.  In fused mode
    ``fused_score(params, batch) -> (losses, scores)`` replaces
    ``per_example_loss``: the detached scores are written at the sampled
    indices (last-write-wins) before the update, and the traces are taken
    over the sampled minibatch; the returned store holds those writes
    (otherwise it is ``store`` itself).

    With a non-empty ``monitors`` (``telemetry.MonitorSet``) the tuple
    grows one trailing ``{name: 0-dim tensor}`` of the proposal-health
    monitors, over the store and proposal the draw used.  With ``gated``
    (relaxed mode only) ``use_is`` is required, a host bool: False runs
    the uniform-mode draw and scales, True the relaxed ones, each the
    same operations as that mode's step.  With ``streaming`` ``data`` is
    the minibatch's rows themselves, gathered by the host at
    ``sample_indices`` (required then: the host drew them,
    ``data/streaming.py``).

    Over a data group ``store`` and ``data`` are this rank's rows: the
    draw is the hierarchical two-stage draw, the sampled proposal and
    minibatch rows come through ``gather_rows``, the sums through
    ``psum``, and the update is the same on every rank.  The gate is the
    controller's host bool, the same on every rank because it folds
    replicated metrics.

    With a ``model_group`` the params are this rank's shards under
    ``param_specs`` (the spec tree of ``dist/sharding.py``), the losses
    come from a model-axis-aware ``per_example_loss``/``fused_score``,
    and the grad norm (and ``grad_clip``) is the global one
    (``grad_global_norm``).

    ``split_batch`` (the reference's ``constrain_batch``,
    ``src/repro/core/issgd.py:315``, applied at ``:431``; its dry run
    passes one, ``src/repro/launch/dryrun.py:113-124``) splits the master
    over a data group of N > 1 ranks.  The proposal read, the draw, the
    scales and the one-owner gather of the minibatch are as above; then
    rank r takes its ``batch_block`` of the B rows and of the scales, its
    loss is Σ(losses·scales) over them divided by B, and its gradients
    are summed over the data group (one all-reduce a leaf; a
    model-sharded leaf stays this rank's shard), the reported loss too.
    The norm, the clip, the update, the push and the monitors then run
    on the same gradients on every rank.  In fused mode the rank's
    scores go back to the whole (B,) by a one-owner sum before the store
    write.  A mixture-of-experts loss must be built with
    ``batch_split=BatchSplit(group, cfg.batch_size)`` so that its
    capacity and drops are the whole minibatch's (``models/moe.py``).
    ``aux_loss`` is refused with it.  With ``split_batch`` False, or a
    data group of None or of one rank, the step is the one above."""
    _check_mode(cfg)
    if model_group is not None and param_specs is None:
        raise ValueError("a model group needs param_specs: the grad norm "
                         "must tell sharded from replicated leaves")
    if cfg.mode == "fused" and fused_score is None:
        raise ValueError("mode='fused' requires fused_score")
    if gated and cfg.mode != "relaxed":
        raise ValueError(f"gated=True switches between relaxed and uniform "
                         f"sampling; it requires mode='relaxed', got "
                         f"{cfg.mode!r}")
    monitors = monitors or None
    n = num_examples
    sb = n if cfg.mode == "exact" else cfg.score_batch_size
    n_dev = axis_info(group)[1]
    w_loc, n_w, _ = _resolve_shards(cfg, n, sb, n_dev)
    split = split_batch and n_dev > 1
    if split and aux_loss is not None:
        raise ValueError("split_batch with an aux_loss: the aux term sees "
                         "the whole batch and would count once a rank; "
                         "leave one of them out")
    if split and cfg.batch_size < n_dev:
        raise ValueError(f"split_batch: batch_size={cfg.batch_size} gives "
                         f"a rank of the {n_dev} data ranks no row")

    def split_loss_and_grads(live, batch, scales):
        """(loss, grads, fused scores or None) of the batch-split master:
        this rank's block through the loss and the backward, the loss and
        every gradient leaf summed over the data group."""
        b = scales.shape[0]
        lo, hi = batch_block(b, group)
        block = {k: v[lo:hi] for k, v in batch.items()}
        batch_scores = None
        if cfg.mode == "fused":
            losses, scores = fused_score(live, block)
            rows = scores.new_zeros((b,) + scores.shape[1:])
            rows[lo:hi] = scores.detach()
            at = torch.arange(b, device=rows.device)
            batch_scores = owner_sum(rows, (at >= lo) & (at < hi), group)
        else:
            losses = per_example_loss(live, block)
        loss = torch.sum(losses * scales[lo:hi]) / b
        flat = list(torch.autograd.grad(loss, tree_leaves(live)))
        for i in range(len(flat)):    # each raw gradient freed once summed
            flat[i] = psum(flat[i], group)
        flat = iter(flat)
        grads = tree_map(lambda _: next(flat), live)
        return psum(loss.detach(), group), grads, batch_scores

    def master_pass(params, opt_state, stale_params, store: WeightStore,
                    step: int, generator: torch.Generator, data,
                    fresh_scores=None, stale_slice=None,
                    sample_indices: Optional[torch.Tensor] = None,
                    use_is: Optional[bool] = None):
        if gated and not isinstance(use_is, bool):
            raise ValueError(f"a gated master pass needs use_is, a host "
                             f"bool; got {use_is!r}")
        if streaming and sample_indices is None:
            raise ValueError("a streaming master pass takes the rows of "
                             "the drawn indices: pass sample_indices")
        _check_shard_rows(store, n, n_dev)
        device = store.weights.device
        sampled_store = store
        proposal = read_sampling_proposal(store, step, cfg, n_w)
        totals = proposal_totals(proposal, cfg, w_loc, group)
        sum_w = torch.sum(totals)
        mean_weight = sum_w / n
        uniform = cfg.mode == "uniform" or (gated and not use_is)

        # ---- compose the minibatch ----------------------------------------
        if sample_indices is not None:
            idx = sample_indices.to(device=device, dtype=torch.long)
        else:
            idx = draw_minibatch(proposal, cfg, w_loc, generator, uniform,
                                 group, totals)
        sampled_w = None
        if uniform:
            scales = torch.ones(idx.shape[0], dtype=torch.float32,
                                device=device)
        else:
            sampled_w = gather_rows(proposal, idx, group)
            scales = is_loss_scale(sampled_w, mean_weight)
        batch = data if streaming else gather_rows(data, idx, group)

        # ---- unbiased IS-scaled update (§4.1) -------------------------------
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if split:
            loss, grads, batch_scores = split_loss_and_grads(live, batch,
                                                             scales)
        else:
            if cfg.mode == "fused":
                losses, batch_scores = fused_score(live, batch)
                batch_scores = batch_scores.detach()
            else:
                losses = per_example_loss(live, batch)
            loss = torch.mean(losses * scales)
            if aux_loss is not None:
                loss = loss + aux_loss(live, batch)
            leaves = tree_leaves(live)
            flat = iter(torch.autograd.grad(loss, leaves))
            grads = tree_map(lambda _: next(flat), live)
            loss = loss.detach()
        if cfg.mode == "fused":
            # the examples just trained on get their scores for free; the
            # monitors then read an importance-sampled slice (biased
            # upward), and the probe step's uniform slices stay the
            # faithful ones
            fresh_scores = batch_scores
            stale_slice = (gather_rows(proposal, idx, group)
                           if sampled_w is None else sampled_w)
            store = write_scores_global(store, idx, batch_scores, step,
                                        group)
        gnorm = grad_global_norm(grads, model_group, param_specs)
        if cfg.grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, cfg.grad_clip, norm=gnorm)
        new_params, opt_state = optimizer.update(grads, opt_state, params,
                                                 step)

        # ---- parameter push to the workers every K steps ------------------
        if cfg.mode == "exact" or (step + 1) % cfg.refresh_every == 0:
            stale_params = new_params

        # ---- paper fig. 4 monitors over the scored slice ------------------
        with torch.no_grad():
            if cfg.mode == "fused":
                traces = variance.trace_sigma_all(fresh_scores, stale_slice)
            elif fresh_scores is None:
                nan = torch.full((), math.nan, device=device)
                traces = variance.TraceSigma(ideal=nan, stale=nan, unif=nan)
            else:
                traces = variance.trace_sigma_all_dist(fresh_scores,
                                                       stale_slice,
                                                       n_total=sb,
                                                       group=group)
            sum_w2 = psum(torch.sum(torch.square(proposal)), group)
            ess = effective_sample_size(proposal, s1=sum_w, s2=sum_w2) / n
            metrics = StepMetrics(
                loss=loss, grad_norm=gnorm,
                trace_ideal=torch.sqrt(torch.clamp(traces.ideal, min=0.0)),
                trace_stale=torch.sqrt(torch.clamp(traces.stale, min=0.0)),
                trace_unif=torch.sqrt(torch.clamp(traces.unif, min=0.0)),
                ess_frac=ess, mean_weight=mean_weight, sample_indices=idx)
            if monitors:
                # the store and proposal the draw used, before this step's
                # writes; they only read, so the trajectory is unchanged
                mon = proposal_monitors(sampled_store, proposal, step, n,
                                        monitors, sum_w=sum_w,
                                        sum_w2=sum_w2, group=group)
                return (new_params, opt_state, stale_params, store, metrics,
                        mon)
        return new_params, opt_state, stale_params, store, metrics

    return master_pass


def make_train_step(per_example_loss: Callable, scorer: Callable,
                    optimizer: Optimizer, cfg: ISSGDConfig,
                    num_examples: int,
                    aux_loss: Optional[Callable] = None,
                    fused_score: Optional[Callable] = None,
                    monitors=None, gated: bool = False,
                    group: Optional[DataGroup] = None,
                    model_group: Optional[DataGroup] = None,
                    param_specs=None, split_batch: bool = False
                    ) -> Callable:
    """The synchronous step ``master_pass ∘ scoring_pass`` over one store:
    ``train_step(state, data, sample_indices=None) -> (state, metrics)``.
    Step t's master samples from a proposal that already holds step t's
    scoring writes (lag 0).  Fused mode has no scoring pass: the scores
    arrive from the master's forward (``fused_score``).  ``aux_loss``
    goes to the master pass (``make_master_pass``).

    With a non-empty ``monitors`` the step returns ``(state, metrics,
    monitors)``; with ``gated`` it is ``train_step(state, data, use_is,
    sample_indices=None)``, ``use_is`` the controller's host bool (see
    ``make_master_pass``).  With a data ``group`` the state's store and
    ``data`` are this rank's rows (``core/distributed.py``); with a
    ``model_group`` its params are this rank's shards under
    ``param_specs`` (``make_master_pass``).  ``split_batch`` splits the
    master's minibatch over the data group (``make_master_pass``; the
    reference's ``constrain_batch``, ``src/repro/core/issgd.py:517``)."""
    monitors = monitors or None
    # the reference constrains the score batch too (``issgd.py:282``): a
    # rank of the port already scores only its own shards' slices
    scoring = (None if cfg.mode == "fused"
               else make_scoring_pass(scorer, cfg, num_examples, group=group))
    master = make_master_pass(per_example_loss, optimizer, cfg, num_examples,
                              aux_loss=aux_loss, fused_score=fused_score,
                              monitors=monitors, gated=gated, group=group,
                              model_group=model_group,
                              param_specs=param_specs,
                              split_batch=split_batch)

    def _train_step(state: TrainState, data: dict, use_is,
                    sample_indices: Optional[torch.Tensor]):
        if scoring is None:
            store, fresh, stale_slice = state.store, None, None
        else:
            score_params = (state.params if cfg.mode == "exact"
                            else state.stale_params)
            store, fresh, stale_slice = scoring(score_params, state.store,
                                                state.step, data)
        params, opt_state, stale_params, store, metrics, *mon = master(
            state.params, state.opt_state, state.stale_params, store,
            state.step, state.rng, data, fresh, stale_slice, sample_indices,
            use_is)
        new_state = TrainState(params, opt_state, stale_params, store,
                               state.step + 1, state.rng)
        return (new_state, metrics, *mon)

    if gated:
        def train_step(state: TrainState, data: dict, use_is: bool,
                       sample_indices: Optional[torch.Tensor] = None):
            return _train_step(state, data, use_is, sample_indices)
    else:
        def train_step(state: TrainState, data: dict,
                       sample_indices: Optional[torch.Tensor] = None):
            return _train_step(state, data, None, sample_indices)

    train_step.with_monitors = bool(monitors)
    train_step.gated = bool(gated)
    return train_step


def make_score_step(scorer: Callable, cfg: ISSGDConfig,
                    num_examples: int,
                    group: Optional[DataGroup] = None) -> Callable:
    """The probe: ``score_step(state, data) -> state`` rescores this
    step's round-robin slice with the workers' stale params and writes it
    to the store.  Fused mode runs it every K steps to keep the examples
    it never samples covered.  Over a data group each rank scores its own
    shards' slices: no collective."""
    scoring = make_scoring_pass(scorer, cfg, num_examples, group=group)

    def score_step(state: TrainState, data: dict) -> TrainState:
        store, _, _ = scoring(state.stale_params, state.store, state.step,
                              data)
        return state._replace(store=store)

    return score_step
