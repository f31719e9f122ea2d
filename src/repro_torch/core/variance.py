"""Trace-of-covariance monitors (paper eqs. 6-9 and appendix B.2).

Given per-example gradient norms g_n over a scored slice and the proposal
weights ω̃_n that were in force:

    Tr(Σ(q))       = (1/N Σ ω̃_n)(1/N Σ g_n²/ω̃_n) − ||g_TRUE||²     (eq. 6)
    Tr(Σ(q_IDEAL)) = (1/N Σ g_n)² − ||g_TRUE||²                      (eq. 7)
    Tr(Σ(q_UNIF))  = 1/N Σ g_n² − ||g_TRUE||²                        (eq. 8)

with eq. 9 being eq. 6 under the stale weights.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class TraceSigma(NamedTuple):
    """Tr Σ(q) under the ideal, stale, and uniform proposals (fig. 4)."""
    ideal: torch.Tensor
    stale: torch.Tensor
    unif: torch.Tensor


def _mean(x: torch.Tensor, n: Optional[float] = None) -> torch.Tensor:
    return torch.mean(x) if n is None else torch.sum(x) / n


def trace_sigma(grad_norms, weights, g_true_sq=0.0, n_total=None):
    """Eq. 6 / Corollary 1: Tr(Σ(q)) for q ∝ ω̃ (weights need not be fresh)."""
    w_mean = _mean(weights, n_total)
    ratio_mean = _mean(torch.square(grad_norms)
                       / torch.clamp(weights, min=1e-30), n_total)
    return w_mean * ratio_mean - g_true_sq


def trace_sigma_ideal(grad_norms, g_true_sq=0.0, n_total=None):
    """Eq. 7: the lower bound, achieved by ω̃_n = g_n (fresh oracle)."""
    return torch.square(_mean(grad_norms, n_total)) - g_true_sq


def trace_sigma_unif(grad_norms, g_true_sq=0.0, n_total=None):
    """Eq. 8: plain SGD (uniform proposal)."""
    return _mean(torch.square(grad_norms), n_total) - g_true_sq


def trace_sigma_all(grad_norms, stale_weights, g_true_sq=0.0,
                    n_total=None) -> TraceSigma:
    """The three monitors of figure 4, sharing one ||g_TRUE||² estimate."""
    return TraceSigma(
        ideal=trace_sigma_ideal(grad_norms, g_true_sq, n_total),
        stale=trace_sigma(grad_norms, stale_weights, g_true_sq, n_total),
        unif=trace_sigma_unif(grad_norms, g_true_sq, n_total))


def trace_sigma_all_dist(grad_norms: torch.Tensor,
                         stale_weights: torch.Tensor, n_total: int,
                         g_true_sq: float = 0.0) -> TraceSigma:
    """Single-device form of the reference's sharded monitors: the same
    partial sums (Σg, Σg², Σw, Σg²/w) the mesh would combine, over the
    whole scored slice."""
    g = grad_norms.float()
    w = stale_weights.float()
    n = float(n_total)
    sum_g = torch.sum(g)
    sum_g2 = torch.sum(torch.square(g))
    sum_w = torch.sum(w)
    sum_ratio = torch.sum(torch.square(g) / torch.clamp(w, min=1e-30))
    return TraceSigma(
        ideal=torch.square(sum_g / n) - g_true_sq,
        stale=(sum_w / n) * (sum_ratio / n) - g_true_sq,
        unif=sum_g2 / n - g_true_sq)


def g_true_sq_upper_bound(minibatch_mean_grad_norms: torch.Tensor
                          ) -> torch.Tensor:
    """B.2: the squared mean of per-minibatch mean-gradient norms, which
    by Jensen bounds ||g_TRUE||² from above."""
    return torch.square(torch.mean(minibatch_mean_grad_norms))
