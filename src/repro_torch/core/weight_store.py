"""The paper's "database": one proposal weight per training example.

    weights   : f32[N]   unnormalized probability weights ω̃_n
    scored_at : i32[N]   step at which ω̃_n was last recomputed
                         (-1 never scored, EMPTY reserved capacity)

The training step reads whatever the store holds (however stale) and the
scoring pass writes the slice it rescored, as with the paper's Redis
table.  Writes are functional (a new store per write).  Relaxed-mode
scoring indices are unique, so ``index_put`` is exact; duplicate-index
writes (fused mode) are not part of this port yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.importance import (ISConfig, apply_staleness_filter,
                                         smooth_weights)

# scored_at sentinel for reserved rows: no proposal mass, never scored
EMPTY = -2


class WeightStore(NamedTuple):
    weights: torch.Tensor    # f32[N] raw ω̃
    scored_at: torch.Tensor  # i32[N]


def init_store(num_examples: int, device: torch.device | str,
               init_weight: float = 0.0) -> WeightStore:
    """Fresh store: nothing scored yet, so the proposal is uniform."""
    return WeightStore(
        weights=torch.full((num_examples,), init_weight, dtype=torch.float32,
                           device=device),
        scored_at=torch.full((num_examples,), -1, dtype=torch.int32,
                             device=device))


def write_scores(store: WeightStore, indices: torch.Tensor,
                 scores: torch.Tensor, step: int | torch.Tensor
                 ) -> WeightStore:
    """Workers push fresh ω̃ (and their step stamps) at unique indices."""
    idx = (indices.long(),)
    stamp = torch.as_tensor(step, dtype=torch.int32,
                            device=store.scored_at.device)
    stamp = stamp.expand(indices.shape)
    return WeightStore(
        weights=store.weights.index_put(idx, scores.float()),
        scored_at=store.scored_at.index_put(idx, stamp))


def read_proposal(store: WeightStore, step: int, cfg: ISConfig
                  ) -> torch.Tensor:
    """The master's sampling proposal: staleness filter (B.1), additive
    smoothing (B.3), and zero mass on reserved (EMPTY) rows."""
    w = apply_staleness_filter(store.weights, store.scored_at, step, cfg)
    q = smooth_weights(w, cfg)
    return torch.where(store.scored_at <= EMPTY, torch.zeros_like(q), q)
