"""Decode on the (data, model) groups (``src/repro/serving/sharded_decode.py``).

* ``sharded_decode_attention``: exact decode attention over a KV cache
  whose sequence axis is split over a group (long-context serving).  A
  rank holds slots ``[rank·W_loc, (rank+1)·W_loc)``, computes the
  flash-decode partials (m, ℓ, o) over them in f32, and the global
  softmax comes back from one ``pmax`` and two ``psum``s (the
  log-sum-exp merge):

      m* = max_r m_r,   ℓ* = Σ_r ℓ_r·exp(m_r − m*),
      o* = Σ_r o_r·exp(m_r − m*) / ℓ*

  Each message is a few floats a (sequence, head) and an hd-vector,
  whatever the cache length.  The reference computes the partials with
  einsums outside any Pallas kernel, and so does this module.
* ``decode_cache_specs``: the spec of every decode cache on a model
  group of M ranks, in the tuple-of-``None``/``"model"`` form of
  ``dist/sharding.py``.  GQA k/v split their KV-head axis and the mamba
  conv window and state their channel axis, as the parameters split
  whole heads and channel blocks; MLA's latent and rope caches are
  head-independent and replicated; the slot axis is whole on every rank.
  It raises, as the reference does, when M does not divide the split
  dimension of a present layer type.
* ``make_mesh_serving``: (prefill, decode) bound to a model group.  The
  params are the rank's shards (``dist/sharding.py::shard_tree``), the
  caches are allocated at their local shapes, and tokens, slots and
  lengths are replicated, so every data rank of the world computes the
  same logits: the reference's ``shard_map`` over the whole ``(data,
  model)`` mesh with replicated token and slot axes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.collectives import pmax, psum
from repro_torch.dist import DataGroup, axis_info

_NEG = -1e30


def _partial_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor, scale: float):
    """Local flash-decode partials. q:(B,H,hd) k,v:(B,W_loc,Hkv,hd),
    valid:(B,W_loc) bool → m:(B,H), ℓ:(B,H), o:(B,H,hd), all f32; a row
    masked everywhere gives ℓ = 0 and o = 0."""
    bsz, h, hd = q.shape
    hkv = k.shape[2]
    qg = (q.float() * scale).reshape(bsz, hkv, h // hkv, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.float())
    s = torch.where(valid[:, None, None, :], s, _NEG)
    m = torch.amax(s, dim=-1)                                 # (B,g,r)
    p = torch.exp(s - m[..., None]) * (s > _NEG / 2).float()
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v.float())
    return m.reshape(bsz, h), l.reshape(bsz, h), o.reshape(bsz, h, hd)


def sharded_decode_attention(q: torch.Tensor, k_loc: torch.Tensor,
                             v_loc: torch.Tensor, lengths: torch.Tensor,
                             group: Optional[DataGroup],
                             scale: Optional[float] = None) -> torch.Tensor:
    """Exact decode attention over a sequence-sharded KV cache.

    q: (B, H, hd), replicated over the group; k_loc, v_loc: (B, W_loc,
    Hkv, hd), this rank's slots of the whole cache's W = size·W_loc;
    lengths: (B,) the global valid prefix.  Returns (B, H, hd) in q's
    dtype, the same on every rank (``group`` None: one device)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    rank, _ = axis_info(group)
    w_loc = k_loc.shape[1]
    pos = rank * w_loc + torch.arange(w_loc, device=q.device)
    valid = pos[None, :] < lengths[:, None]
    m, l, o = _partial_stats(q, k_loc, v_loc, valid, scale)
    m_star = pmax(m, group)
    corr = torch.exp(m - m_star)
    l_all = psum(l * corr, group)
    o_all = psum(o * corr[..., None], group)
    return (o_all / torch.clamp(l_all[..., None], min=1e-20)).to(q.dtype)


# ------------------------------------------------- model-group serving
def decode_cache_specs(cfg, model_group: Optional[DataGroup],
                       replicate: bool = False) -> dict:
    """name → spec of every decode cache on ``model_group`` (M ranks;
    ``None`` is M = 1, where nothing is split).  A spec has one entry a
    dimension of the cache buffer (``engine.cache_shapes``): GQA k/v
    (P, B, W, Hkv, hd) split Hkv, the mamba conv (P, B, w-1, d_inner) and
    h (P, B, d_inner, d_state) split d_inner, MLA latent and rope are
    replicated.  Raises the reference's ValueError, naming the config
    field, when M does not divide the split dimension of a present layer
    type; with ``replicate`` such a layer's caches are replicated instead
    (the dry run's layout, ``launch/shapes.py``)."""
    _, m = axis_info(model_group)
    ms = "model" if m > 1 else None
    out: dict = {}
    for i, spec in enumerate(cfg.layer_specs()):
        if spec.mixer == "attn" and cfg.attention == "mla":
            if cfg.num_heads % m and not replicate:
                raise ValueError(
                    f"model-parallel degree {m} must divide num_heads "
                    f"({cfg.num_heads}) for MLA decode")
            out[f"l{i}.attn.latent"] = (None,) * 4
            out[f"l{i}.attn.rope"] = (None,) * 4
        elif spec.mixer == "attn":
            split = not (cfg.num_kv_heads % m or cfg.num_heads % m)
            if not split and not replicate:
                raise ValueError(
                    f"model-parallel degree {m} must divide num_heads "
                    f"({cfg.num_heads}) and num_kv_heads "
                    f"({cfg.num_kv_heads}) for GQA decode")
            kv = (None, None, None, ms if split else None, None)
            out[f"l{i}.attn.k"] = kv
            out[f"l{i}.attn.v"] = kv
        else:
            split = not cfg.resolved_d_inner % m
            if not split and not replicate:
                raise ValueError(
                    f"model-parallel degree {m} must divide d_inner "
                    f"({cfg.resolved_d_inner}) for mamba decode")
            ch = ms if split else None
            out[f"l{i}.mamba.conv"] = (None, None, None, ch)
            out[f"l{i}.mamba.h"] = (None, None, ch, None)
    return out


def local_shape(shape: tuple, spec: tuple, size: int) -> tuple:
    """One rank's shape of a buffer of ``shape`` under ``spec`` split over
    ``size`` ranks."""
    return tuple(n // size if ax == "model" else n
                 for n, ax in zip(shape, spec))


def make_mesh_serving(cfg, max_len: int, model_group: Optional[DataGroup],
                      decode_kernel: str = "ref", attn_impl: str = "ref"):
    """(prefill_fn, decode_fn) of the engine bound to ``model_group``
    (``None``: one device).  The params they take are the rank's shards,
    the caches the rank's local buffers (``decode_cache_specs``, checked
    here, so that an M a present layer type cannot split is refused
    before anything is allocated).

      prefill_fn(params, tokens (B, S), true_len) -> (last_logits, state)
      decode_fn(params, tokens (B,), state, active (B,)) -> (logits, state)

    The decode runs eagerly: a step that issues collectives is not
    captured in a CUDA graph (gloo cannot be captured).  ``attn_impl`` is
    the prefill route asked for (``engine.prefill_attn_impl``: an MLA
    stack takes "ref")."""
    from repro_torch.serving.engine import (decode_step, prefill,
                                            prefill_attn_impl)
    decode_cache_specs(cfg, model_group)
    attn_impl = prefill_attn_impl(cfg, attn_impl)

    def prefill_fn(params, tokens, true_len):
        return prefill(params, cfg, tokens, max_len, attn_impl=attn_impl,
                       true_len=true_len, model_group=model_group)

    def decode_fn(params, tokens, state, active):
        return decode_step(params, cfg, tokens, state,
                           decode_kernel=decode_kernel, active=active,
                           model_group=model_group)

    return prefill_fn, decode_fn


__all__ = ["decode_cache_specs", "local_shape", "make_mesh_serving",
           "sharded_decode_attention"]
