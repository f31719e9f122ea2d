"""The paper's "database": one proposal weight per training example.

    weights   : f32[N]   unnormalized probability weights ω̃_n
    scored_at : i32[N]   step at which ω̃_n was last recomputed
                         (-1 never scored, EMPTY reserved capacity)

The training step reads whatever the store holds (however stale) and the
scoring pass writes the slice it rescored, as with the paper's Redis
table.  Writes are functional (a new store per write).  Indices can
repeat within one write: fused mode and the ASGD baseline write at
minibatch indices drawn with replacement, and a relaxed scoring slice
wraps around its logical shard when ``score_batch_size / W > N / W``.
Those writes go through ``write_scores_global``, last-write-wins (the
reference's ``core/collectives.py::scatter_rows`` rule): of the
positions that name one row only the last is written, so the result
never depends on which of colliding writes the device applies last.
``write_scores`` keeps the plain write for indices known to be unique
(an exact-mode sweep of all N rows), where it is the same thing.
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


def _scatter_last(array: torch.Tensor, idx: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``array`` with ``values`` written at ``idx``, last write wins.

    Position i survives only if no j > i names the same row (a (B, B)
    upper-triangular equality mask); the others are sent to one scratch
    row past the end and dropped with it, so the surviving indices are
    unique and the write is defined on every device, without a host
    synchronisation."""
    n = array.shape[0]
    dup_later = torch.triu(idx[:, None] == idx[None, :], diagonal=1)
    safe = torch.where(dup_later.any(dim=1), n, idx)
    out = torch.cat([array, array.new_zeros(1)])
    out.index_put_((safe,), values.to(array.dtype))
    return out[:n]


def write_scores_global(store: WeightStore, global_indices: torch.Tensor,
                        scores: torch.Tensor, step: int | torch.Tensor
                        ) -> WeightStore:
    """Push fresh ω̃ and their step stamps (a scalar or one per index) at
    indices that may repeat: last-write-wins.  On one device global
    indices are the store's own rows."""
    idx = global_indices.long()
    stamp = torch.as_tensor(step, dtype=torch.int32,
                            device=store.scored_at.device).expand(idx.shape)
    return WeightStore(
        weights=_scatter_last(store.weights, idx, scores.float()),
        scored_at=_scatter_last(store.scored_at, idx, stamp))


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
