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
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.collectives import psum_backward, psum_forward
from repro_torch.dist import DataGroup
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


def route(logits: torch.Tensor, cfg: ModelConfig,
          dropless: bool = False) -> Routing:
    """Routing of the (T, E) f32 router logits, as the reference's."""
    t = logits.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)
    cap = capacity(cfg, t, dropless)
    eflat = eidx.reshape(t * k)
    order = torch.argsort(eflat, stable=True)
    sorted_e = eflat[order]
    experts = torch.arange(e, device=logits.device)
    counts = torch.sum(eflat[:, None] == experts, dim=0)       # (E,)
    start = torch.cumsum(counts, 0) - counts                   # first slot
    pos_in_e = torch.arange(t * k, device=logits.device) - start[sorted_e]
    keep = pos_in_e < cap
    dst = torch.where(keep, sorted_e * cap + pos_in_e,
                      torch.full_like(sorted_e, e * cap))
    return Routing(probs, gates, eidx, order, keep, dst, start, counts, cap)


def moe(params: Params, x: torch.Tensor, cfg: ModelConfig,
        tape: Optional[Tape] = None, prefix: str = "moe",
        dropless: bool = False,
        model_group: Optional[DataGroup] = None) -> MoEOut:
    """x: (B, S, D) → MoEOut with y: (B, S, D).

    ``dropless`` gives every expert room for all T·k replicas (exact);
    training uses the capacity factor, and replicas past an expert's
    capacity are dropped.  With ffn-sharded experts and a
    ``model_group`` the expert SwiGLU runs on the local ffn slice (see
    the module docstring); only the replicated router is tapped."""
    sharded = model_group is not None and params["w_in"].shape[-1] != \
        cfg.d_ff
    bsz, s, d = x.shape
    t = bsz * s
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    act = activation(cfg.act)

    xf = x.reshape(t, d)
    logits = tapped_linear(xf, params["router"].to(x.dtype),
                           f"{prefix}.router", tape).float()
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
    filled = c[None, :] < torch.clamp(r.counts, max=cap)[:, None]
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

    dropped = 1.0 - torch.mean(r.keep.float())
    return MoEOut(y.reshape(bsz, s, d), aux, dropped)
