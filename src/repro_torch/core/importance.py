"""Importance-sampling primitives from the paper.

  * additive smoothing of probability weights (appendix B.3),
  * staleness-threshold filtering (appendix B.1),
  * the unbiased IS-scaled minibatch loss of section 4.1:

        L(minibatch) = (1/N sum_n w_n) * 1/M sum_m  L(x_{i_m}) / w_{i_m}
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ISConfig:
    """Knobs of the ISSGD estimator (paper sections 4 and B.1/B.3)."""

    # Additive smoothing constant `c` (B.3): q ∝ (w + c).  c → ∞ recovers
    # plain uniform SGD; c = 0 is the raw (risky) optimal proposal.
    smoothing: float = 1.0
    # Staleness threshold in *steps* (B.1): weights whose `scored_at` is
    # older than `staleness_threshold` steps are replaced by the smoothing
    # floor (treated as "no information", not dropped — dropping examples
    # would bias p(x)).  <= 0 disables the filter.
    staleness_threshold: int = 0
    # Floor applied after smoothing to keep q(x) > 0 wherever p(x) > 0,
    # which Theorem 1 requires for unbiasedness.
    floor: float = 1e-8


def smooth_weights(raw: torch.Tensor, cfg: ISConfig) -> torch.Tensor:
    """Additive smoothing (B.3): w̃ = max(raw, 0) + c, floored to keep q>0."""
    w = torch.clamp(raw, min=0.0) + cfg.smoothing
    return torch.clamp(w, min=cfg.floor)


def apply_staleness_filter(weights: torch.Tensor, scored_at: torch.Tensor,
                           step: int, cfg: ISConfig) -> torch.Tensor:
    """B.1: weights scored more than `staleness_threshold` steps ago revert
    to the neutral raw value 0 — after smoothing they carry exactly the
    uniform belief `c`, like a never-scored entry (scored_at < 0)."""
    mask = scored_at < 0
    if cfg.staleness_threshold > 0:
        mask = mask | ((step - scored_at) > cfg.staleness_threshold)
    return torch.where(mask, torch.zeros_like(weights), weights)


def normalize(weights: torch.Tensor,
              total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ω_n = ω̃_n / Σω̃; ``total`` lets a caller pass a sum it holds."""
    if total is None:
        total = torch.sum(weights)
    return weights / total


def is_loss_scale(sampled_weights: torch.Tensor,
                  mean_weight: torch.Tensor) -> torch.Tensor:
    """Per-sample loss scale of section 4.1: mean(ω̃)/ω̃_{i_m}, exactly 1
    when all ω̃ are equal (plain SGD)."""
    return mean_weight / sampled_weights


def effective_sample_size(weights: torch.Tensor,
                          s1: Optional[torch.Tensor] = None,
                          s2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kish ESS = (Σw)² / Σw²: N for uniform weights, small when peaked."""
    s1 = torch.sum(weights) if s1 is None else s1
    s2 = torch.sum(torch.square(weights)) if s2 is None else s2
    return torch.square(s1) / torch.clamp(s2, min=1e-30)


def proposal_entropy(weights: torch.Tensor,
                     sum_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Entropy (nats) of ω = w/Σw, which B.3 suggests monitoring:

        H(ω) = log Σw − (Σ w·log w)/Σw,

    zero-mass rows contributing their limit 0.  ``sum_w`` lets the master
    pass share the total it already holds."""
    if sum_w is None:
        sum_w = torch.sum(weights)
    sum_w = torch.clamp(sum_w, min=1e-30)
    wlogw = torch.where(weights > 0,
                        weights * torch.log(torch.clamp(weights, min=1e-30)),
                        torch.zeros_like(weights))
    return torch.log(sum_w) - torch.sum(wlogw) / sum_w
