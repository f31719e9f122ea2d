"""Proposal strategies over the weight store.

``core/scorer.py`` owns the per-architecture score functions (loss,
logit_grad, ghost, ghost_rev, full).  This module resolves a proposal
strategy name into a ``(params, batch) -> (B,)`` scorer, handing the base
names to the architecture's factory unchanged and adding, as
``src/repro/core/strategies.py`` does:

``upper_bound``
    ω̃ = sqrt(2·L), forward only (Katharopoulos & Fleuret).  For softmax
    cross-entropy, Pinsker gives ‖p − y‖₁ ≤ sqrt(2·CE) and ‖p − y‖₂ ≤
    ‖p − y‖₁, so it bounds the ``logit_grad`` score at the cost of the
    loss forward.
``bandit_mixed``
    A convex mixture ω̃ = Σ_k λ_k·s_k of base scorers (Bouchard et al.);
    ``BanditMixer`` learns λ from observed rewards across rounds.
``null``
    Zero scores: every row smooths to the uniform floor, and the scoring
    pass launches no kernel.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.scorer import STRATEGIES

#: Every name ``make_proposal`` resolves.
PROPOSALS = STRATEGIES + ("upper_bound", "bandit_mixed", "null")


def upper_bound_scorer(loss_scorer: Callable) -> Callable:
    """ω̃ = sqrt(2·max(L, 0)) of a per-example loss scorer (the ``loss``
    strategy of either factory): one sqrt on top of the forward."""
    def score(params, batch):
        return torch.sqrt(2.0 * torch.clamp(loss_scorer(params, batch),
                                            min=0.0))
    return score


def mixed_scorer(scorers: Sequence[Callable],
                 weights: Optional[Sequence[float]] = None) -> Callable:
    """ω̃ = Σ_k λ_k · s_k(params, batch), λ normalized to sum to 1
    (uniform by default); build a new scorer to move λ."""
    scorers = tuple(scorers)
    if not scorers:
        raise ValueError("mixed_scorer needs at least one component")
    if weights is None:
        lam = (1.0 / len(scorers),) * len(scorers)
    else:
        lam = tuple(float(w) for w in weights)
        if len(lam) != len(scorers):
            raise ValueError(
                f"{len(lam)} mixture weights for {len(scorers)} scorers")
        if min(lam) < 0.0:
            raise ValueError("mixture weights must be non-negative")
        total = sum(lam)
        if total <= 0.0:
            raise ValueError("mixture weights must not all be zero")
        lam = tuple(w / total for w in lam)

    def score(params, batch):
        acc = lam[0] * scorers[0](params, batch)
        for l_k, s_k in zip(lam[1:], scorers[1:]):
            acc = acc + l_k * s_k(params, batch)
        return acc
    return score


def null_scorer() -> Callable:
    """Constant-zero scores on the batch's device: the uniform proposal."""
    def score(params, batch):
        first = next(iter(batch.values()))
        return torch.zeros(first.shape[0], dtype=torch.float32,
                           device=first.device)
    return score


def make_proposal(base_factory: Callable, cfg, strategy: str, *,
                  mix: Optional[Sequence[float]] = None,
                  mix_of: Sequence[str] = ("loss", "logit_grad"),
                  **factory_kw) -> Callable:
    """The scorer of ``strategy``: a name of ``scorer.STRATEGIES`` goes to
    ``base_factory(cfg, strategy, **factory_kw)`` (``make_mlp_scorer`` or
    ``make_lm_scorer``) unchanged; ``mix``/``mix_of`` set the
    ``bandit_mixed`` coefficients and component strategies."""
    if strategy in STRATEGIES:
        return base_factory(cfg, strategy, **factory_kw)
    if strategy == "upper_bound":
        return upper_bound_scorer(base_factory(cfg, "loss", **factory_kw))
    if strategy == "bandit_mixed":
        comps = tuple(base_factory(cfg, s, **factory_kw) for s in mix_of)
        return mixed_scorer(comps, mix)
    if strategy == "null":
        return null_scorer()
    raise ValueError(f"unknown proposal strategy {strategy!r}; "
                     f"available: {', '.join(PROPOSALS)}")


class BanditMixer:
    """EXP3-style multiplicative weights over mixture coefficients.

    One round per scalar reward (e.g. the √TrΣ_unif/√TrΣ_stale a run
    under the current mixture achieved): each arm's score grows by
    ``reward · λ_k`` and ``mix()`` is the softmax of the scores with a γ
    exploration floor.  No randomness inside."""

    def __init__(self, arms: Sequence[str], eta: float = 0.5,
                 explore: float = 0.1):
        self.arms = tuple(arms)
        if not self.arms:
            raise ValueError("BanditMixer needs at least one arm")
        self.eta = float(eta)
        self.explore = float(explore)
        self._scores = [0.0] * len(self.arms)
        self.rounds = 0

    def mix(self) -> tuple:
        """The current λ: the exploration-floored softmax of the scores."""
        m = max(self._scores)
        exps = [math.exp(self.eta * (s - m)) for s in self._scores]
        z = sum(exps)
        k = len(exps)
        return tuple((1.0 - self.explore) * e / z + self.explore / k
                     for e in exps)

    def update(self, reward: float) -> None:
        """Credit ``reward`` to each arm by its share of the mixture that
        earned it; one round."""
        lam = self.mix()
        for j, l_j in enumerate(lam):
            self._scores[j] += float(reward) * l_j
        self.rounds += 1
