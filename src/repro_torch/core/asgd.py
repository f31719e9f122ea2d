"""Asynchronous SGD baseline and the paper's §6 combination, one device.

The reference (``src/repro/core/asgd.py``) emulates asynchrony with
deterministic staleness: the gradient applied at step t was computed on
the parameters of step t − delay, kept in a FIFO of parameter snapshots.
delay = 0 is synchronous SGD.

Modes:
  uniform     plain ASGD: uniform minibatches, stale gradients
  issgd       §6: minibatches drawn from the shared weight store, IS-scaled
              gradients at the stale params, and the peer's fused scores
              pushed back to the store (last-write-wins: the draw is with
              replacement, so indices repeat)

The draws come from the state's generator, or are injected through
``sample_indices`` so that tests replay the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.importance import ISConfig, is_loss_scale
from repro_torch.core.sampler import sample_indices as draw_indices
from repro_torch.core.weight_store import (WeightStore, init_store,
                                           read_proposal,
                                           write_scores_global)
from repro_torch.data.pipeline import gather_batch
from repro_torch.optim import Optimizer, global_norm, tree_leaves, tree_map

MODES = ("uniform", "issgd")


@dataclasses.dataclass(frozen=True)
class ASGDConfig:
    """Knobs of the delayed-gradient ASGD baseline (paper §6 comparison)."""
    batch_size: int = 64
    delay: int = 4                  # gradient staleness in steps
    mode: str = "uniform"           # uniform | issgd
    is_cfg: ISConfig = ISConfig()


class ASGDState(NamedTuple):
    """Train state with the FIFO of delayed parameter snapshots, oldest
    first (``delay + 1`` trees; updates are functional, so they share
    nothing a step writes).  ``step`` is a host int."""
    params: Any
    opt_state: Any
    fifo: tuple
    store: WeightStore
    step: int
    rng: torch.Generator


class ASGDMetrics(NamedTuple):
    """Per-step monitors: loss, grad norm, and the staleness gap."""
    loss: torch.Tensor
    grad_norm: torch.Tensor
    delay_gap: torch.Tensor         # ||θ_t − θ_{t−delay}||


def init_asgd_state(params, optimizer: Optimizer, cfg: ASGDConfig,
                    num_examples: int, device: torch.device | str,
                    seed: int = 0) -> ASGDState:
    """Fresh state: the FIFO holds delay + 1 references to θ₀."""
    return ASGDState(
        params=params, opt_state=optimizer.init(params),
        fifo=(params,) * (cfg.delay + 1),
        store=init_store(num_examples, device), step=0,
        rng=torch.Generator(device=device).manual_seed(seed))


def make_asgd_step(per_example_loss: Callable, optimizer: Optimizer,
                   cfg: ASGDConfig, num_examples: int,
                   fused_score: Optional[Callable] = None) -> Callable:
    """``asgd_step(state, data, sample_indices=None) -> (state, metrics)``:
    the update applied at step t is the gradient at the FIFO head, the
    parameters of step t − delay.  ``fused_score(params, batch) ->
    (losses, scores)`` is required by mode "issgd"."""
    if cfg.mode not in MODES:
        raise ValueError(f"mode {cfg.mode!r}; ASGD has {', '.join(MODES)}")
    if cfg.mode == "issgd" and fused_score is None:
        raise ValueError("mode='issgd' requires fused_score")
    n = num_examples

    def asgd_step(state: ASGDState, data: dict,
                  sample_indices: Optional[torch.Tensor] = None):
        device = state.store.weights.device
        delayed = state.fifo[0]     # the peer computes on stale params
        if cfg.mode == "issgd":
            proposal = read_proposal(state.store, state.step, cfg.is_cfg)
            idx = (draw_indices(proposal, cfg.batch_size,
                                generator=state.rng)
                   if sample_indices is None else sample_indices)
            idx = idx.to(device=device, dtype=torch.long)
            scales = is_loss_scale(proposal[idx], torch.mean(proposal))
        else:
            idx = (torch.randint(0, n, (cfg.batch_size,),
                                 generator=state.rng, device=device)
                   if sample_indices is None
                   else sample_indices.to(device=device, dtype=torch.long))
            scales = torch.ones(cfg.batch_size, dtype=torch.float32,
                                device=device)
        batch = gather_batch(data, idx)

        # the STALE gradient: evaluated at θ_{t−delay}, applied at θ_t
        live = tree_map(lambda p: p.detach().requires_grad_(True), delayed)
        if cfg.mode == "issgd":
            losses, scores = fused_score(live, batch)
            scores = scores.detach()
        else:
            losses = per_example_loss(live, batch)
        loss = torch.mean(losses * scales)
        flat = iter(torch.autograd.grad(loss, tree_leaves(live)))
        grads = tree_map(lambda _: next(flat), live)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, state.step)

        store = state.store
        if cfg.mode == "issgd":
            # the peer shares its importance weights like its gradients (§6)
            store = write_scores_global(store, idx, scores, state.step)

        with torch.no_grad():
            gap = global_norm(tree_map(lambda a, b: a - b, state.params,
                                       delayed))
            metrics = ASGDMetrics(loss=loss.detach(),
                                  grad_norm=global_norm(grads),
                                  delay_gap=gap)
        return ASGDState(params, opt_state, state.fifo[1:] + (params,),
                         store, state.step + 1, state.rng), metrics

    return asgd_step
