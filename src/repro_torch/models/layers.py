"""Shared layers of the port: the ghost tape and the LM building blocks.

Each function mirrors its namesake in ``src/repro/models/layers.py``:
parameters are nested dicts in the reference's layout, ``init_*`` draw
from an explicit ``torch.Generator`` (on its own device) and place the
result on the given device.

A tap is a zero tensor with ``requires_grad=True`` added to a linear's
output: the gradient of the loss with respect to it is dL/dY, and the
tape records the linear's input X.  With both, ``core/scorer.py`` gets
exact per-example gradient norms without per-example gradients.

``specs_*`` give each parameter's logical axes (``dist/sharding.py``).
With a ``model_group`` (the reference's ``model_axes``) ``mlp``, ``embed``
and ``unembed`` run on this rank's shards, each detecting shardedness
from its local shapes, so a dim that fell back to replication keeps the
plain path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.collectives import (all_gather_replicated,
                                          psum_backward, psum_forward)
from repro_torch.dist import DataGroup
from repro_torch.models.config import ModelConfig

Params = Any   # nested dicts of tensors


def params_from_jax(np_params: dict, device="cpu") -> Params:
    """The reference's parameter tree (numpy leaves, same layout) → the
    port's, copied onto ``device``.  bf16 leaves arrive as ml_dtypes
    bfloat16 arrays and are rebuilt bit for bit."""
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    a = np.asarray(np_params)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


@dataclasses.dataclass
class Tape:
    """Mutable container threaded through one forward for ghost scoring:
    linear taps and score taps."""
    taps: Optional[dict] = None         # name -> tensor to ADD at the output
    records: Optional[dict] = None      # name -> linear INPUT (if not None)

    def linear(self, name: str, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
        if self.records is not None:
            self.records[name] = x
        if self.taps is not None and name in self.taps:
            y = y + self.taps[name].to(y.dtype)
        return y

    def score_tap(self, name: str, batch: int,
                  device: torch.device) -> torch.Tensor:
        """A (B,) f32 score tap: the input of an op whose backward returns
        a finished per-example score as the tap's gradient (the fused
        flash-attention backward, ``kernels/ops.py``).  The record is a
        (B, 0) placeholder so the scorer's walk sees the name; it takes
        the tap's gradient as the contribution (``.qkv_scores`` names).
        Zeros when the name has no tap."""
        if self.records is not None:
            self.records[name] = torch.zeros(batch, 0, dtype=torch.float32,
                                             device=device)
        if self.taps is not None and name in self.taps:
            return self.taps[name].float()
        return torch.zeros(batch, dtype=torch.float32, device=device)


def tapped_linear(x: torch.Tensor, w: torch.Tensor, name: str,
                  tape: Optional[Tape]) -> torch.Tensor:
    """y = x @ w with ghost-tape routing. x: (..., din), w: (din, dout)."""
    y = torch.matmul(x, w)
    if tape is not None:
        y = tape.linear(name, x, y)
    return y


# ------------------------------------------------------------------- inits
def _dense_init(generator: torch.Generator, din: int, dout: int,
                dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, 1/din) drawn in f32, cast to ``dtype``."""
    w = torch.randn(din, dout, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return (w * din ** -0.5).to(device=device, dtype=dtype)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------- norms
def init_rmsnorm(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def specs_rmsnorm() -> Params:
    return {"scale": ("embed",)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split (not interleaved) rotary embedding, computed in f32.
    x: (..., S, H, hd) or (..., H, hd) with positions broadcastable."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs        # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------- activation
def activation(name: str):
    """The reference's activations; its gelu is jax.nn.gelu's default,
    the tanh approximation."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# --------------------------------------------------------------------- MLP
def init_mlp(generator: torch.Generator, cfg: ModelConfig, device) -> Params:
    dtype = dtype_of(cfg)
    return {
        "w_in": _dense_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
        "w_gate": _dense_init(generator, cfg.d_model, cfg.d_ff, dtype,
                              device),
        "w_out": _dense_init(generator, cfg.d_ff, cfg.d_model, dtype, device),
    }


def specs_mlp() -> Params:
    return {"w_in": ("embed", "ffn"), "w_gate": ("embed", "ffn"),
            "w_out": ("ffn", "embed")}


def mlp(params: Params, x: torch.Tensor, cfg: ModelConfig,
        tape: Optional[Tape] = None, prefix: str = "mlp",
        model_group: Optional[DataGroup] = None) -> torch.Tensor:
    """SwiGLU feed-forward: w_out(act(h_gate) * h_in).  With ffn-sharded
    weights and a ``model_group``, the Megatron column/row pair:
    ``psum_backward`` on the replicated input, w_in/w_gate on the local
    ffn columns, w_out on the matching rows, ``psum_forward`` of the
    partial output.  The taps see the local slices: partial terms."""
    sharded = model_group is not None and params["w_in"].shape[-1] != \
        cfg.d_ff
    act = activation(cfg.act)
    xi = psum_backward(x, model_group) if sharded else x
    h_in = tapped_linear(xi, params["w_in"], f"{prefix}.w_in", tape)
    h_gate = tapped_linear(xi, params["w_gate"], f"{prefix}.w_gate", tape)
    h = act(h_gate) * h_in
    y = tapped_linear(h, params["w_out"], f"{prefix}.w_out", tape)
    return psum_forward(y, model_group) if sharded else y


# --------------------------------------------------------------- embeddings
def init_embed(generator: torch.Generator, cfg: ModelConfig,
               device) -> Params:
    dtype = dtype_of(cfg)
    tokens = torch.randn(cfg.vocab_size, cfg.d_model, generator=generator,
                         device=generator.device, dtype=torch.float32)
    p = {"tokens": (tokens * 0.02).to(device=device, dtype=dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = _dense_init(generator, cfg.d_model, cfg.vocab_size,
                                   dtype, device)
    return p


def specs_embed(cfg: ModelConfig) -> Params:
    p = {"tokens": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["unembed"] = ("embed", "vocab")
    return p


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
          model_group: Optional[DataGroup] = None) -> torch.Tensor:
    """Token embedding lookup: (B, S) ints → (B, S, D).  A vocab-sharded
    table (rows of (V, D) on each model rank) looks up the ids this rank
    owns, zeroes the others, and ``psum_forward`` sums the one-owner
    rows: exact, and replicated; the backward's replicated cotangent
    reaches this rank's rows only."""
    table = params["tokens"]
    tokens = tokens.long()
    if model_group is not None and table.shape[0] != cfg.vocab_size:
        v_local = table.shape[0]
        lidx = tokens - model_group.rank * v_local
        mine = (lidx >= 0) & (lidx < v_local)
        rows = table[torch.clamp(lidx, 0, v_local - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return psum_forward(rows, model_group)
    return table[tokens]


def unembed(params: Params, h: torch.Tensor, cfg: ModelConfig,
            tape: Optional[Tape] = None,
            model_group: Optional[DataGroup] = None) -> torch.Tensor:
    """Hidden states → vocab logits (tied or untied head), soft-capped
    when ``cfg.logits_softcap`` > 0.  The ghost tap sits on the logits.
    A vocab-sharded head is column-parallel: ``psum_backward`` on the
    replicated input, the local vocab slice's matmul, and
    ``all_gather_replicated`` over the vocab; the tap sits on the
    gathered logits, so its term is whole on every rank (counted once by
    the scorer)."""
    w = params["tokens"].t() if cfg.tie_embeddings else params["unembed"]
    if model_group is not None and w.shape[-1] != cfg.vocab_size:
        logits = torch.matmul(psum_backward(h, model_group), w)
        logits = all_gather_replicated(logits, model_group, dim=-1)
        if tape is not None:
            logits = tape.linear("unembed", h, logits)
    elif cfg.tie_embeddings:
        logits = torch.matmul(h, w)
        if tape is not None:
            logits = tape.linear("unembed", h, logits)
    else:
        logits = tapped_linear(h, w, "unembed", tape)
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = torch.tanh(logits / c) * c
    return logits
