"""The paper's "database": one proposal weight per training example.

    weights   : f32[N]   unnormalized probability weights ω̃_n
                         (bf16[N], or int8 codes with a per-chunk f32
                         scale in ``qscale``, for the quantized tables)
    scored_at : i32[N]   step at which ω̃_n was last recomputed
                         (-1 never scored, EMPTY reserved capacity)

The training step reads whatever the store holds (however stale) and the
scoring pass writes the slice it rescored, as with the paper's Redis
table.  Writes are functional (a new store per write).  Indices can
repeat within one write: fused mode and the ASGD baseline write at
minibatch indices drawn with replacement, and a relaxed scoring slice
wraps around its logical shard when ``score_batch_size / W > N / W``.
Those writes go through ``write_scores_global``, last-write-wins
(``core/collectives.py::scatter_rows``, the reference's rule): of the
positions that name one row only the last is written, so the result
never depends on which of colliding writes the device applies last.
``write_scores`` keeps the plain write for indices known to be unique
(an exact-mode sweep of all N rows), where it is the same thing.

Sharded over a data group, a rank holds the contiguous rows
[rank·n_local, (rank + 1)·n_local) (an int8 table the scales of its own
chunks, so ``n_local`` must be a multiple of the chunk size), and
``write_scores_global`` takes global indices: each rank applies the
writes it owns and drops the rest.

Every read and write dispatches on the storage dtype, so an f32 store
runs the program it ran before the quantized tables existed.  An int8
write rescales through the f32 view of the whole table
(``_requantize``), as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.collectives import scatter_rows
from repro_torch.core.importance import (ISConfig, apply_staleness_filter,
                                         smooth_weights)
from repro_torch.dist import DataGroup

# scored_at sentinel for reserved rows: no proposal mass, never scored
EMPTY = -2

# int8 tables store codes in [0, INT8_LEVELS]; value = code·scale/INT8_LEVELS
INT8_LEVELS = 127
# round-to-nearest-bf16 relative error: 8 mantissa bits → half-ulp 2⁻⁹
BF16_HALF_ULP = 2.0 ** -9


class WeightStore(NamedTuple):
    weights: torch.Tensor    # f32[N] raw ω̃ (bf16[N], or int8 codes)
    scored_at: torch.Tensor  # i32[N]
    qscale: Optional[torch.Tensor] = None  # f32[N / chunk]: int8 scales


def init_store(num_examples: int, device: torch.device | str,
               init_weight: float = 0.0, table_dtype: str = "f32",
               chunk_size: int = 0) -> WeightStore:
    """Fresh store: nothing scored yet, so the proposal is uniform.
    ``table_dtype`` is "f32", "bf16" or "int8"; int8 needs a positive
    ``chunk_size`` dividing ``num_examples`` for its per-chunk scales."""
    scored_at = torch.full((num_examples,), -1, dtype=torch.int32,
                           device=device)
    if table_dtype not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown table_dtype {table_dtype!r}")
    if table_dtype == "int8" and (chunk_size <= 0
                                  or num_examples % chunk_size):
        raise ValueError(f"int8 tables need chunk_size > 0 dividing "
                         f"num_examples={num_examples}, got {chunk_size}")
    weights = torch.full((num_examples,), init_weight, dtype=torch.float32,
                         device=device)
    if table_dtype == "f32":
        return WeightStore(weights=weights, scored_at=scored_at)
    if table_dtype == "bf16":
        return WeightStore(weights=weights.to(torch.bfloat16),
                           scored_at=scored_at)
    codes, qscale = quantize_weights(weights, chunk_size)
    return WeightStore(weights=codes, scored_at=scored_at, qscale=qscale)


def store_chunk_size(store: WeightStore) -> int:
    """Chunk size of an int8 table, recovered from the shapes."""
    if store.qscale is None:
        raise ValueError("store has no per-chunk scales (not int8)")
    return store.weights.shape[0] // store.qscale.shape[0]


def _chunk_scales(rows: torch.Tensor) -> torch.Tensor:
    """Per-chunk int8 scale of nonnegative (C, chunk) rows: the chunk's
    max, 1.0 for an all-zero chunk (its codes stay 0)."""
    scale = torch.amax(rows, dim=1)
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def quantize_weights(weights: torch.Tensor, chunk_size: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, f32 per-chunk scale) of weights clipped at 0:
    code = round(w·INT8_LEVELS/scale), rounding half to even as
    ``jnp.round`` does.  Negative raw weights clip to code 0, which the
    smoothing (B.3) maps to the same floor as 0."""
    n = weights.shape[0]
    if chunk_size <= 0 or n % chunk_size:
        raise ValueError(f"chunk_size={chunk_size} must divide n={n}")
    rows = torch.clamp(weights.float(), min=0.0).view(-1, chunk_size)
    scale = _chunk_scales(rows)
    q = rows / scale[:, None]
    del rows
    # in place: the same roundings as the reference's chain, one temporary
    q.mul_(INT8_LEVELS).round_().clamp_(0, INT8_LEVELS)
    return q.to(torch.int8).view(-1), scale


def dequantize_weights(store: WeightStore) -> torch.Tensor:
    """The f32 view of the table: int8 codes times scale/INT8_LEVELS (one
    product a row, as the reference's), bf16 upcast, f32 itself."""
    if store.qscale is not None:
        cs = store_chunk_size(store)
        rows = store.weights.view(-1, cs) * (store.qscale
                                             / INT8_LEVELS)[:, None]
        return rows.view(-1)
    if store.weights.dtype != torch.float32:
        return store.weights.float()
    return store.weights


def _requantize(store: WeightStore, weights_f32: torch.Tensor
                ) -> WeightStore:
    """An updated f32 view written back in the storage dtype: int8
    recomputes every chunk's scale and codes (a write can raise a chunk's
    max), bf16 rounds, f32 stores as it is."""
    if store.qscale is not None:
        codes, qscale = quantize_weights(weights_f32,
                                         store_chunk_size(store))
        return store._replace(weights=codes, qscale=qscale)
    return store._replace(weights=weights_f32.to(store.weights.dtype))


def quantization_tv_bound(store_f32: WeightStore, step: int, cfg: ISConfig,
                          chunk_size: int, table_dtype: str
                          ) -> torch.Tensor:
    """Upper bound on TV(p_f32, p_quantized) for the proposal a quantized
    copy of ``store_f32`` gives: (1/A)·Σ|a_i − b_i| over the rows the B.1
    filter keeps (the neutralized rows are equal in both tables), with
    a per-row error of 2⁻⁹·|w| for bf16 and scale_c·(1/(2·INT8_LEVELS) +
    2⁻²⁰) for int8 (half a step plus f32 slack)."""
    active = apply_staleness_filter(
        torch.ones_like(store_f32.weights, dtype=torch.float32),
        store_f32.scored_at, step, cfg) > 0
    w = store_f32.weights.float()
    if table_dtype == "bf16":
        per_row = BF16_HALF_ULP * torch.abs(w)
    elif table_dtype == "int8":
        if chunk_size <= 0 or w.shape[0] % chunk_size:
            raise ValueError(f"chunk_size={chunk_size} must divide "
                             f"n={w.shape[0]}")
        scale = _chunk_scales(torch.clamp(w, min=0.0).view(-1, chunk_size))
        per_row = (scale * (0.5 / INT8_LEVELS + 2.0 ** -20))[:, None] \
            .expand(-1, chunk_size).reshape(-1)
    else:
        raise ValueError(f"no quantization bound for {table_dtype!r}")
    err = torch.sum(torch.where(active, per_row, torch.zeros_like(per_row)))
    del per_row, active   # N-sized; freed before the proposal is read
    z = torch.sum(read_proposal(store_f32, step, cfg))
    return err / z


def decay_proposal(proposal: torch.Tensor, scored_at: torch.Tensor,
                   step: int, ttl: float, cfg: ISConfig,
                   chunk_size: int) -> torch.Tensor:
    """Per-chunk TTL decay of the proposal toward the uniform floor.

    A chunk's age is ``step`` minus its newest ``scored_at`` stamp; it
    decays by d = 2^(−age/ttl):  q'_i = u + d_c·(q_i − u), u =
    max(smoothing, floor).  Chunks with no scored row keep d = 1, EMPTY
    rows stay 0, and q' ≥ min(q, u) keeps q > 0 wherever it was.  A
    trailing partial chunk counts only its rows.  ``ttl <= 0`` is the
    caller's identity path."""
    if ttl <= 0:
        raise ValueError("decay_proposal requires ttl > 0; ttl == 0 is the "
                         "caller's identity path")
    n = proposal.shape[0]
    chunks = -(-n // chunk_size)
    pad = chunks * chunk_size - n
    sa, q = scored_at, proposal
    if pad:
        sa = torch.cat([sa, sa.new_full((pad,), EMPTY)])
        q = torch.cat([q, q.new_zeros(pad)])
    freshest = torch.amax(sa.view(chunks, chunk_size), dim=1)
    age = torch.clamp(step - freshest, min=0)
    age = torch.where(freshest >= 0, age, torch.zeros_like(age)).float()
    d = torch.exp2(-age / float(ttl))
    neutral = max(cfg.smoothing, cfg.floor)
    # d broadcast over each chunk's rows: the reference's repeated d_row,
    # the same product a row, without an N-sized copy of d
    decayed = (neutral + d[:, None] * (q.view(chunks, chunk_size) - neutral)
               ).view(-1)[:n]
    return torch.where(scored_at <= EMPTY, torch.zeros_like(decayed),
                       decayed)


def write_scores_global(store: WeightStore, global_indices: torch.Tensor,
                        scores: torch.Tensor, step: int | torch.Tensor,
                        group: Optional[DataGroup] = None) -> WeightStore:
    """Push fresh ω̃ and their step stamps (a scalar or one per index) at
    global indices that may repeat: last-write-wins, and over a data
    group each rank writes only the rows it owns (``scatter_rows``).  On
    one device global indices are the store's own rows."""
    idx = global_indices.long()
    stamp = torch.as_tensor(step, dtype=torch.int32,
                            device=store.scored_at.device).expand(idx.shape)
    scored_at = scatter_rows(store.scored_at, idx, stamp, group)
    if store.qscale is not None:
        w = scatter_rows(dequantize_weights(store), idx, scores.float(),
                         group)
        return _requantize(store._replace(scored_at=scored_at), w)
    return store._replace(
        weights=scatter_rows(store.weights, idx, scores.float(), group),
        scored_at=scored_at)


def write_scores(store: WeightStore, indices: torch.Tensor,
                 scores: torch.Tensor, step: int | torch.Tensor
                 ) -> WeightStore:
    """Workers push fresh ω̃ (and their step stamps) at unique indices."""
    idx = (indices.long(),)
    stamp = torch.as_tensor(step, dtype=torch.int32,
                            device=store.scored_at.device)
    stamp = stamp.expand(indices.shape)
    scored_at = store.scored_at.index_put(idx, stamp)
    if store.qscale is not None:
        w = dequantize_weights(store).index_put_(idx, scores.float())
        return _requantize(store._replace(scored_at=scored_at), w)
    return store._replace(
        weights=store.weights.index_put(idx, scores.to(store.weights.dtype)),
        scored_at=scored_at)


def read_proposal(store: WeightStore, step: int, cfg: ISConfig
                  ) -> torch.Tensor:
    """The master's sampling proposal: staleness filter (B.1), additive
    smoothing (B.3), and zero mass on reserved (EMPTY) rows.  A quantized
    table is read through its f32 view, so the sampled distribution is
    the quantized proposal."""
    w = apply_staleness_filter(dequantize_weights(store), store.scored_at,
                               step, cfg)
    q = smooth_weights(w, cfg)
    return torch.where(store.scored_at <= EMPTY, torch.zeros_like(q), q)


def staleness_stats(store: WeightStore, step: int) -> dict:
    """B.1's monitoring: the fraction of rows scored, their mean age, and
    the oldest scored row's age (-1 when none is scored)."""
    scored = store.scored_at >= 0
    age = torch.where(scored, step - store.scored_at,
                      torch.iinfo(torch.int32).max)
    frac = torch.mean(scored.float())
    return {
        "frac_scored": frac,
        "mean_age": torch.mean(torch.where(scored, age, 0).float())
        / torch.clamp(frac, min=1e-9),
        "max_age": torch.max(torch.where(scored, age, -1)),
    }


def reserve_tail(store: WeightStore, num_live: int) -> WeightStore:
    """Mark every row past ``num_live`` as reserved capacity (EMPTY):
    no proposal mass, inert under scoring, until ``mark_live``.  The
    serving loop reserves rows for the traffic it will ingest."""
    idx = torch.arange(store.scored_at.shape[0],
                       device=store.scored_at.device)
    return store._replace(scored_at=torch.where(
        idx < num_live, store.scored_at,
        torch.full_like(store.scored_at, EMPTY)))


def mark_live(store: WeightStore, indices) -> WeightStore:
    """Flip reserved rows to never scored (-1) once real data lands in
    them: eligible for scoring and, neutral until scored, for sampling."""
    idx = torch.as_tensor(indices, dtype=torch.long,
                          device=store.scored_at.device)
    return store._replace(scored_at=store.scored_at.index_put(
        (idx,), torch.full_like(idx, -1, dtype=torch.int32)))


class BufferedWeightStore(NamedTuple):
    """The double-buffered store of the async pipeline
    (``core/async_pipeline.py``).

    The master samples from ``read_buf``, a snapshot of the table as of
    step ``synced_at`` (a host int, -1 before the first publish), while
    the scoring pass writes ``write_buf``; the two share no tensor.
    ``publish`` copies ``write_buf`` into a fresh ``read_buf``.  With
    swap cadence K the master at step t samples from the table as written
    through step K·⌊t/K⌋ − 1: a relaxed run whose proposal is
    L(t) = t − K·⌊t/K⌋ + 1 ∈ [1, K] steps staler, the lag visible in
    ``read_buf.scored_at``."""
    read_buf: WeightStore
    write_buf: WeightStore
    synced_at: int


def _copy_store(store: WeightStore) -> WeightStore:
    """Fresh tensors of every field: ``read_buf`` never aliases
    ``write_buf``."""
    return WeightStore(weights=store.weights.clone(),
                       scored_at=store.scored_at.clone(),
                       qscale=(None if store.qscale is None
                               else store.qscale.clone()))


def to_buffered(store: WeightStore) -> BufferedWeightStore:
    """Wrap a plain store: both buffers distinct copies of it, nothing
    published yet."""
    return BufferedWeightStore(read_buf=_copy_store(store),
                               write_buf=_copy_store(store), synced_at=-1)


def publish(bstore: BufferedWeightStore, step: int) -> BufferedWeightStore:
    """The swap: ``read_buf`` ← a copy of ``write_buf``, stamped with the
    last step whose writes it now holds."""
    return BufferedWeightStore(read_buf=_copy_store(bstore.write_buf),
                               write_buf=bstore.write_buf,
                               synced_at=int(step))


def mark_live_buffered(bstore: BufferedWeightStore,
                       indices) -> BufferedWeightStore:
    """``mark_live`` on ``write_buf`` only: the rows reach the master's
    snapshot at the next ``publish``, so the proposal never sees rows
    newer than its snapshot."""
    return bstore._replace(write_buf=mark_live(bstore.write_buf, indices))


class PublishedParams(NamedTuple):
    """A parameter snapshot for serving, the weights' counterpart of
    ``read_buf``: under publish cadence K it is at most K steps stale."""
    params: object      # the tree of the step it was taken at
    synced_at: int      # the train step it was taken at


def publish_params(params, step: int) -> PublishedParams:
    """Snapshot the training params.  It holds the step's own tensors: the
    port's optimizers update out of place, so no later step writes them
    (the reference copies only because its step donates the buffers)."""
    return PublishedParams(params=params, synced_at=int(step))
