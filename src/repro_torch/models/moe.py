"""Mixture-of-experts feed-forward with sort-based dispatch.

Mirrors ``src/repro/models/moe.py`` on one device: an f32 router through
the ghost tape (tap ``{prefix}.router`` on the token-flattened (B·S, E)
logits), softmax, top-k and renormalised gates; the Switch-style
load-balance loss; token replicas sorted by expert (stable, as
``jnp.argsort``) into a capacity-bounded (E, C, d) buffer; the grouped
SwiGLU as batched matmuls; the gather back and the gate-weighted combine.
Replicas past an expert's capacity are dropped (they add zero).

The dispatch is written so that its backward is bitwise reproducible on
the card, where a gather's backward over repeated indices adds with
atomics:
  * each token is replicated k times by ``expand``, whose backward is a
    fixed-order sum over k;
  * the sort permutation and the buffer fill are gathers whose indices
    repeat only where they read an appended zero row (a dropped replica
    or an empty buffer slot), whose gradient is thrown away;
  * the inverse permutation is a gather too (by ``argsort(order)``).
No index ever falls outside its source, and no two writes share a row.

With ffn-sharded experts and a ``model_group`` (``specs_moe``: the
router replicated, each expert's ffn dim sharded), every rank routes
identically and runs the Megatron column/row pair on its local ffn
slice: ``psum_backward`` on the dispatched buffer, ``psum_forward`` on
the partial outputs before the gate multiply, which keeps the router's
gradient replicated.

Under the batch-split master (``core/issgd.py``, ``split_batch``) a
rank's tokens are one block of the minibatch, and a ``BatchSplit``
keeps the routing the whole minibatch's, as the reference's jit of the
whole step has it (``route_split``): the capacity is that of the
global token count, a replica's position in its expert counts the
replicas that lower ranks route there (an exclusive prefix over ranks
of the (E,) counts, from one all-reduce of a one-owner (N, E) matrix),
and ``dropped_frac`` is the global share, so the dropped set is one
device's.  A rank's buffer keeps C_r = min(C, T_r·k) rows an expert
(C the global capacity, T_r its tokens): static, enough for every
replica it keeps, and smaller than C only once N > E / capacity
factor.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.collectives import psum, psum_backward, psum_forward
from repro_torch.dist import BatchSplit, DataGroup
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, Tape, _dense_init, activation,
                                       dtype_of, tapped_linear)


class MoEOut(NamedTuple):
    y: torch.Tensor             # (B, S, D)
    aux_loss: torch.Tensor      # load-balance loss (Switch-style), f32
    dropped_frac: torch.Tensor  # share of token replicas past capacity


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             device) -> Params:
    dtype = dtype_of(cfg)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        w = torch.randn(*shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (w * scale).to(device=device, dtype=dtype)

    return {
        "router": _dense_init(generator, d, e, torch.float32, device),
        "w_in": normal((e, d, f), d ** -0.5),
        "w_gate": normal((e, d, f), d ** -0.5),
        "w_out": normal((e, f, d), f ** -0.5),
    }


def specs_moe() -> Params:
    return {"router": ("embed", None),
            "w_in": ("expert", "embed", "ffn"),
            "w_gate": ("expert", "embed", "ffn"),
            "w_out": ("expert", "ffn", "embed")}


def capacity(cfg: ModelConfig, tokens: int, dropless: bool = False) -> int:
    """Buffer rows an expert gets for ``tokens`` tokens: all T·k replicas
    when dropless, else ⌊capacity_factor·T·k/E + 0.5⌋, at least 1."""
    tk = tokens * cfg.num_experts_per_tok
    if dropless:
        return tk
    return max(int(cfg.moe_capacity_factor * tk / cfg.num_experts + 0.5), 1)


class Routing(NamedTuple):
    """The router's decisions for T tokens (replicas sorted by expert)."""
    probs: torch.Tensor     # (T, E) f32 softmax
    gates: torch.Tensor     # (T, k) renormalised top-k probabilities
    eidx: torch.Tensor      # (T, k) expert ids
    order: torch.Tensor     # (T·k,) stable sort of the replicas by expert
    keep: torch.Tensor      # (T·k,) sorted replica within capacity
    dst: torch.Tensor       # (T·k,) its buffer row e·C + c (E·C: dropped)
    start: torch.Tensor     # (E,) first sorted replica of each expert
    counts: torch.Tensor    # (E,) replicas routed to each expert
    cap: int                # C, buffer rows an expert
    pos: Optional[torch.Tensor] = None      # (T·k,) sorted replica's
    #                         position in its expert (over the minibatch)
    fill: Optional[torch.Tensor] = None     # (E,) buffer rows filled
    #                         (None: min(counts, C)); batch split only
    dropped: Optional[torch.Tensor] = None  # the minibatch's dropped share
    #                         (None: this call's); batch split only


def _sorted_replicas(logits: torch.Tensor, cfg: ModelConfig):
    """(probs, gates, eidx, order, sorted_e, counts, start, local) of the
    (T, E) f32 router logits: the top-k gates, the T·k replicas sorted by
    expert (stable, as ``jnp.argsort``), each expert's replica count and
    first sorted replica, and each sorted replica's place among its
    expert's replicas here."""
    t = logits.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    eflat = eidx.reshape(t * k)
    order = torch.argsort(eflat, stable=True)
    sorted_e = eflat[order]
    experts = torch.arange(e, device=logits.device)
    counts = torch.sum(eflat[:, None] == experts, dim=0)       # (E,)
    start = torch.cumsum(counts, 0) - counts                   # first slot
    local = torch.arange(t * k, device=logits.device) - start[sorted_e]
    return probs, gates, eidx, order, sorted_e, counts, start, local


def route(logits: torch.Tensor, cfg: ModelConfig,
          dropless: bool = False) -> Routing:
    """Routing of the (T, E) f32 router logits, as the reference's."""
    e = cfg.num_experts
    cap = capacity(cfg, logits.shape[0], dropless)
    probs, gates, eidx, order, sorted_e, counts, start, pos_in_e = \
        _sorted_replicas(logits, cfg)
    keep = pos_in_e < cap
    dst = torch.where(keep, sorted_e * cap + pos_in_e,
                      torch.full_like(sorted_e, e * cap))
    return Routing(probs, gates, eidx, order, keep, dst, start, counts, cap,
                   pos_in_e)


def route_split(logits: torch.Tensor, cfg: ModelConfig, split: BatchSplit,
                seq_len: int, dropless: bool = False) -> Routing:
    """Routing of this rank's (T_r, E) router logits, its block of a
    minibatch of ``split.rows`` rows of ``seq_len`` tokens, with the
    whole minibatch's capacity and drops (module docstring).  ``cap`` is
    the rank's buffer rows an expert, C_r = min(C, T_r·k); ``dst`` points
    into that buffer; ``pos``, ``fill`` and ``dropped`` are set."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    rank, size = split.group.rank, split.group.size
    tokens = split.rows * seq_len
    cap = capacity(cfg, tokens, dropless)
    rows = min(cap, logits.shape[0] * k)
    probs, gates, eidx, order, sorted_e, counts, start, local = \
        _sorted_replicas(logits, cfg)
    # every rank's counts: row r is rank r's, zeros elsewhere, summed
    owned = torch.zeros(size, e, dtype=counts.dtype, device=counts.device)
    owned[rank] = counts
    every = psum(owned, split.group)                           # (N, E)
    offset = torch.sum(every[:rank], dim=0)                    # lower ranks
    pos = offset[sorted_e] + local
    keep = pos < cap
    dst = torch.where(keep, sorted_e * rows + local,
                      torch.full_like(sorted_e, e * rows))
    fill = torch.clamp(torch.minimum(counts, cap - offset), min=0)
    kept = torch.sum(torch.clamp(torch.sum(every, dim=0), max=cap))
    dropped = 1.0 - kept.float() / float(tokens * k)
    return Routing(probs, gates, eidx, order, keep, dst, start, counts,
                   rows, pos, fill, dropped)


def moe(params: Params, x: torch.Tensor, cfg: ModelConfig,
        tape: Optional[Tape] = None, prefix: str = "moe",
        dropless: bool = False,
        model_group: Optional[DataGroup] = None,
        batch_split: Optional[BatchSplit] = None) -> MoEOut:
    """x: (B, S, D) → MoEOut with y: (B, S, D).

    ``dropless`` gives every expert room for all T·k replicas (exact);
    training uses the capacity factor, and replicas past an expert's
    capacity are dropped.  With ffn-sharded experts and a
    ``model_group`` the expert SwiGLU runs on the local ffn slice (see
    the module docstring); only the replicated router is tapped.  With
    a ``batch_split`` of more than one rank, x is this rank's block of
    the minibatch and the routing is the minibatch's (``route_split``);
    the load-balance loss stays this block's."""
    sharded = model_group is not None and params["w_in"].shape[-1] != \
        cfg.d_ff
    bsz, s, d = x.shape
    t = bsz * s
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    act = activation(cfg.act)

    xf = x.reshape(t, d)
    logits = tapped_linear(xf, params["router"].to(x.dtype),
                           f"{prefix}.router", tape).float()
    if batch_split is not None and batch_split.group.size > 1:
        r = route_split(logits, cfg, batch_split, s, dropless)
    else:
        r = route(logits, cfg, dropless)
    cap = r.cap

    # ---- load-balance auxiliary loss (Switch Transformer eq. 4-6)
    me = torch.mean(r.probs, dim=0)
    experts = torch.arange(e, device=x.device)
    ce = torch.mean((r.eidx[:, :1] == experts).float(), dim=0)  # top-1 load
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    # ---- sort-based dispatch: every gather reads real rows at most once
    tk = t * k
    zero = x.new_zeros(1, d)
    x_sorted = xf[:, None, :].expand(t, k, d).reshape(tk, d)[r.order]
    # buffer slot (e, c) holds sorted replica start[e] + c when expert e
    # has more than c replicas, else the zero row at tk
    c = torch.arange(cap, device=x.device)
    fill = torch.clamp(r.counts, max=cap) if r.fill is None else r.fill
    filled = c[None, :] < fill[:, None]
    src = torch.where(filled, r.start[:, None] + c[None, :],
                      torch.full_like(r.start[:, None], tk))
    buf = torch.cat([x_sorted, zero])[src.reshape(e * cap)]
    buf = buf.reshape(e, cap, d)
    if sharded:
        buf = psum_backward(buf, model_group)

    h_in = torch.bmm(buf, params["w_in"])
    h_gate = torch.bmm(buf, params["w_gate"])
    y_buf = torch.bmm(act(h_gate) * h_in, params["w_out"])

    y_sorted = torch.cat([y_buf.reshape(e * cap, d), zero])[r.dst]
    inv = torch.argsort(r.order)         # a permutation's inverse
    y_flat = y_sorted[inv].reshape(t, k, d)
    if sharded:
        y_flat = psum_forward(y_flat, model_group)
    y = torch.sum(y_flat * r.gates[..., None].to(x.dtype), dim=1)

    dropped = (1.0 - torch.mean(r.keep.float()) if r.dropped is None
               else r.dropped)
    return MoEOut(y.reshape(bsz, s, d), aux, dropped)
