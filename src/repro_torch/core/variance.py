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

from repro_torch.core.collectives import psum
from repro_torch.dist import DataGroup


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


def trace_sums(grad_norms: torch.Tensor,
               stale_weights: torch.Tensor) -> torch.Tensor:
    """The partial sums (Σg, Σg², Σw, Σg²/w) of a scored slice, f32[4]:
    summed over the ranks that hold its parts, they give the figure-4
    monitors (``traces_from_sums``)."""
    g = grad_norms.float()
    w = stale_weights.float()
    return torch.stack([
        torch.sum(g), torch.sum(torch.square(g)), torch.sum(w),
        torch.sum(torch.square(g) / torch.clamp(w, min=1e-30))])


def traces_from_sums(sums: torch.Tensor, n_total: int,
                     g_true_sq: float = 0.0) -> TraceSigma:
    """Eqs. 6-9 from a whole slice's ``trace_sums``, ``n_total`` its
    length."""
    n = float(n_total)
    sum_g, sum_g2, sum_w, sum_ratio = sums.unbind()
    return TraceSigma(
        ideal=torch.square(sum_g / n) - g_true_sq,
        stale=(sum_w / n) * (sum_ratio / n) - g_true_sq,
        unif=sum_g2 / n - g_true_sq)


def trace_sigma_all_dist(grad_norms: torch.Tensor,
                         stale_weights: torch.Tensor, n_total: int,
                         g_true_sq: float = 0.0,
                         group: Optional[DataGroup] = None) -> TraceSigma:
    """The figure-4 monitors over a scored slice that may be sharded over
    a data group: the partial sums of this rank's part, summed over the
    group by one all-reduce of four floats, then eqs. 6-9 with
    ``n_total`` the slice's global length.  For one device the sums are
    over the whole slice."""
    return traces_from_sums(psum(trace_sums(grad_norms, stale_weights),
                                 group), n_total, g_true_sq)


def g_true_sq_upper_bound(minibatch_mean_grad_norms: torch.Tensor
                          ) -> torch.Tensor:
    """B.2: the squared mean of per-minibatch mean-gradient norms, which
    by Jensen bounds ||g_TRUE||² from above."""
    return torch.square(torch.mean(minibatch_mean_grad_norms))
