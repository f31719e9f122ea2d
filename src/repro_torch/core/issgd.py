"""ISSGD — the paper's importance-sampling SGD (section 4), one device.

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import variance
from repro_torch.core.importance import (ISConfig, effective_sample_size,
                                         is_loss_scale)
from repro_torch.core.mass_index import block_masses
from repro_torch.core.sampler import two_stage_sample
from repro_torch.core.weight_store import (EMPTY, WeightStore,
                                           decay_proposal, init_store,
                                           read_proposal, write_scores,
                                           write_scores_global)
from repro_torch.data.pipeline import gather_batch
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
                     index_chunk_size: int = 0) -> TrainState:
    """Fresh state: stale params alias θ₀ (updates are functional), the
    store unscored (uniform proposal until the first sweep), in the
    storage dtype ``table_dtype`` (int8 scales per ``index_chunk_size``
    rows)."""
    return TrainState(
        params=params, opt_state=optimizer.init(params), stale_params=params,
        store=init_store(num_examples, device, table_dtype=table_dtype,
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


def _check_mode(cfg: ISSGDConfig) -> None:
    if cfg.mode not in MODES:
        raise ValueError(f"mode {cfg.mode!r} is not ported; this port runs "
                         f"{', '.join(MODES)}")
    if cfg.index not in INDEXES:
        raise ValueError(f"unknown index {cfg.index!r}; available: "
                         f"{', '.join(INDEXES)}")


def _resolve_shards(cfg: ISSGDConfig, n: int, sb: int) -> tuple[int, int]:
    """(n_w, sb_w): logical shard length and per-shard scoring slice."""
    w = max(cfg.score_shards, 1)
    if n % w:
        raise ValueError(f"num_examples={n} not divisible by "
                         f"score_shards={w}")
    if sb % w:
        raise ValueError(f"score_batch_size={sb} not divisible by "
                         f"score_shards={w}")
    return n // w, sb // w


def _score_slice(step: int, w: int, n_w: int, sb_w: int,
                 device) -> torch.Tensor:
    """Indices of this step's round-robin scoring slice: each of the W
    logical shards contributes `sb_w` examples."""
    base = (step * sb_w + torch.arange(sb_w, device=device)) % n_w
    shard = torch.arange(w, device=device)[:, None] * n_w
    return (shard + base[None, :]).reshape(-1)


def make_scoring_pass(scorer: Callable, cfg: ISSGDConfig,
                      num_examples: int) -> Callable:
    """The workers' half: ``scoring_pass(score_params, store, step, data)
    -> (store, fresh_scores, stale_slice)``.  Rescore this step's
    round-robin slice and write it; `stale_slice` is the proposal over
    the slice *before* the write (the eq. 9 monitor input)."""
    _check_mode(cfg)
    n = num_examples
    sb = n if cfg.mode == "exact" else cfg.score_batch_size
    w = max(cfg.score_shards, 1)
    n_w, sb_w = _resolve_shards(cfg, n, sb)
    # a slice longer than its shard wraps around it: its indices repeat
    write = write_scores_global if sb_w > n_w else write_scores

    def scoring_pass(score_params, store: WeightStore, step: int, data):
        score_idx = _score_slice(step, w, n_w, sb_w, store.weights.device)
        fresh = scorer(score_params, gather_batch(data, score_idx))
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
                     fused_score: Optional[Callable] = None,
                     monitors=None, gated: bool = False) -> Callable:
    """The master's half: ``master_pass(params, opt_state, stale_params,
    store, step, generator, data, fresh_scores=None, stale_slice=None,
    sample_indices=None, use_is=None) -> (params, opt_state,
    stale_params, store, metrics)``.

    Proposal read → two-stage draw (or the injected ``sample_indices``)
    → IS-scaled unbiased update (§4.1) → parameter push.  Without
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
    same operations as that mode's step."""
    _check_mode(cfg)
    if cfg.mode == "fused" and fused_score is None:
        raise ValueError("mode='fused' requires fused_score")
    if gated and cfg.mode != "relaxed":
        raise ValueError(f"gated=True switches between relaxed and uniform "
                         f"sampling; it requires mode='relaxed', got "
                         f"{cfg.mode!r}")
    monitors = monitors or None
    n = num_examples
    sb = n if cfg.mode == "exact" else cfg.score_batch_size
    w = max(cfg.score_shards, 1)
    n_w, _ = _resolve_shards(cfg, n, sb)

    def master_pass(params, opt_state, stale_params, store: WeightStore,
                    step: int, generator: torch.Generator, data,
                    fresh_scores=None, stale_slice=None,
                    sample_indices: Optional[torch.Tensor] = None,
                    use_is: Optional[bool] = None):
        if gated and not isinstance(use_is, bool):
            raise ValueError(f"a gated master pass needs use_is, a host "
                             f"bool; got {use_is!r}")
        device = store.weights.device
        sampled_store = store
        proposal = read_sampling_proposal(store, step, cfg, n_w)
        sum_w = torch.sum(proposal)
        mean_weight = sum_w / n
        uniform = cfg.mode == "uniform" or (gated and not use_is)

        # ---- compose the minibatch ----------------------------------------
        if sample_indices is not None:
            idx = sample_indices.to(device=device, dtype=torch.long)
        elif uniform:
            idx = torch.randint(0, n, (cfg.batch_size,), generator=generator,
                                device=device)
        else:
            idx = two_stage_sample(proposal, cfg.batch_size, num_shards=w,
                                   generator=generator,
                                   block_sums=stage1_block_sums(proposal, w,
                                                                cfg))
        if uniform:
            scales = torch.ones(idx.shape[0], dtype=torch.float32,
                                device=device)
        else:
            scales = is_loss_scale(proposal[idx], mean_weight)
        batch = gather_batch(data, idx)

        # ---- unbiased IS-scaled update (§4.1) -------------------------------
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if cfg.mode == "fused":
            losses, batch_scores = fused_score(live, batch)
            batch_scores = batch_scores.detach()
        else:
            losses = per_example_loss(live, batch)
        loss = torch.mean(losses * scales)
        leaves = tree_leaves(live)
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(flat), live)
        loss = loss.detach()
        if cfg.mode == "fused":
            # the examples just trained on get their scores for free; the
            # monitors then read an importance-sampled slice (biased
            # upward), and the probe step's uniform slices stay the
            # faithful ones
            fresh_scores, stale_slice = batch_scores, proposal[idx]
            store = write_scores_global(store, idx, batch_scores, step)
        gnorm = global_norm(grads)
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
                                                       n_total=sb)
            sum_w2 = torch.sum(torch.square(proposal))
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
                                        sum_w2=sum_w2)
                return (new_params, opt_state, stale_params, store, metrics,
                        mon)
        return new_params, opt_state, stale_params, store, metrics

    return master_pass


def make_train_step(per_example_loss: Callable, scorer: Callable,
                    optimizer: Optimizer, cfg: ISSGDConfig,
                    num_examples: int,
                    fused_score: Optional[Callable] = None,
                    monitors=None, gated: bool = False) -> Callable:
    """The synchronous step ``master_pass ∘ scoring_pass`` over one store:
    ``train_step(state, data, sample_indices=None) -> (state, metrics)``.
    Step t's master samples from a proposal that already holds step t's
    scoring writes (lag 0).  Fused mode has no scoring pass: the scores
    arrive from the master's forward (``fused_score``).

    With a non-empty ``monitors`` the step returns ``(state, metrics,
    monitors)``; with ``gated`` it is ``train_step(state, data, use_is,
    sample_indices=None)``, ``use_is`` the controller's host bool (see
    ``make_master_pass``)."""
    monitors = monitors or None
    scoring = (None if cfg.mode == "fused"
               else make_scoring_pass(scorer, cfg, num_examples))
    master = make_master_pass(per_example_loss, optimizer, cfg, num_examples,
                              fused_score=fused_score, monitors=monitors,
                              gated=gated)

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
                    num_examples: int) -> Callable:
    """The probe: ``score_step(state, data) -> state`` rescores this
    step's round-robin slice with the workers' stale params and writes it
    to the store.  Fused mode runs it every K steps to keep the examples
    it never samples covered."""
    scoring = make_scoring_pass(scorer, cfg, num_examples)

    def score_step(state: TrainState, data: dict) -> TrainState:
        store, _, _ = scoring(state.stale_params, state.store, state.step,
                              data)
        return state._replace(store=store)

    return score_step
