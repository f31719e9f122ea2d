"""GQA self-attention for training, scoring and prefill.

Mirrors the GQA part of ``src/repro/models/attention.py``.  ``impl="ref"``
cuts the query dimension into chunks so the S×S logits of the whole
sequence never exist at once; logits and softmax are f32, masked entries
take ``_NEG``, and the output is cast back to q's dtype.  The GQA grouping
reshapes q to (B, S, Hkv, rep, hd) against (B, S, Hkv, hd) keys and
values.  ``impl="pallas"`` is the forward-only flash-attention kernel of
``kernels/ops.py`` (the serving-prefill path; the name is the reference's);
``impl="flash"`` is the same kernel made trainable through the
FlashAttention-2 backward kernel, with the optional score tap
(``attn_scores``).

MLA (multi-head latent attention, minicpm3-4b) mirrors the reference's
train and prefill path (``init_mla``, ``_mla_qkv``, ``mla``): low-rank
query and key-value projections, a rope key shared by every head, and
materialised f32 logits chunked over queries; and its absorbed one-token
decode over the compressed cache (``mla_decode``).  Both materialised
paths recompute their query chunks in the backward above
``KEEP_LOGITS_S`` (the reference always does).

With a ``model_group`` (the reference's ``model_axes``) the training
paths shard whole heads: ``attn_shard_info``/``mla_shard_info`` read the
local head counts from the local weights, the replicated input enters
through ``psum_backward``, the per-head math is local and the row-sharded
wo's partial output leaves through ``psum_forward``.  ``mla_decode``
takes the same group: its per-head expansions run on the local heads
and its partial wo output is summed; the latent and rope rows it writes
are head-independent, hence replicated.  (The engine's GQA decode,
``serving/engine.py::_gqa_decode``, does the same on local KV heads.)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.collectives import psum_backward, psum_forward
from repro_torch.dist import DataGroup
from repro_torch.kernels import ops
from repro_torch.models import remat as remat_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, Tape, _dense_init, dtype_of,
                                       init_rmsnorm, rmsnorm, rope,
                                       specs_rmsnorm, tapped_linear)

_NEG = -1e30


def init_attn(generator: torch.Generator, cfg: ModelConfig,
              device) -> Params:
    dtype = dtype_of(cfg)
    hd = cfg.resolved_head_dim
    return {
        "wq": _dense_init(generator, cfg.d_model, cfg.num_heads * hd, dtype,
                          device),
        "wk": _dense_init(generator, cfg.d_model, cfg.num_kv_heads * hd,
                          dtype, device),
        "wv": _dense_init(generator, cfg.d_model, cfg.num_kv_heads * hd,
                          dtype, device),
        "wo": _dense_init(generator, cfg.num_heads * hd, cfg.d_model, dtype,
                          device),
    }


def specs_attn() -> Params:
    return {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
            "wv": ("embed", "kv"), "wo": ("heads", "embed")}


def attn_shard_info(params: Params, cfg: ModelConfig
                    ) -> tuple[bool, int, int]:
    """(sharded, local heads, local kv heads) of a GQA parameter tree,
    from its shapes.  A layer sharded only in part (wq split but not
    wk/wv, a split inside a head, a grouping the local counts break)
    cannot run and raises naming the config fields to fix."""
    hd = cfg.resolved_head_dim
    q_cols = params["wq"].shape[-1]
    k_cols = params["wk"].shape[-1]
    q_sharded = q_cols != cfg.num_heads * hd
    k_sharded = k_cols != cfg.num_kv_heads * hd
    if not q_sharded and not k_sharded:
        return False, cfg.num_heads, cfg.num_kv_heads
    if q_sharded != k_sharded:
        raise ValueError(
            f"attention is only partially model-sharded (wq cols={q_cols}, "
            f"wk cols={k_cols}): the model-parallel degree must divide "
            f"both num_heads ({cfg.num_heads}) and num_kv_heads "
            f"({cfg.num_kv_heads})")
    if q_cols % hd or k_cols % hd:
        raise ValueError(
            f"model-axis shard splits mid-head (local wq cols={q_cols}, "
            f"wk cols={k_cols}, head_dim={hd}): the model-parallel degree "
            f"must divide num_heads ({cfg.num_heads}) and num_kv_heads "
            f"({cfg.num_kv_heads}), not just their flattened projections")
    h_l, hkv_l = q_cols // hd, k_cols // hd
    if h_l % hkv_l or params["wo"].shape[0] != q_cols:
        raise ValueError(
            f"model-axis shard breaks the GQA grouping (local heads "
            f"{h_l}, local kv heads {hkv_l}, wo rows "
            f"{params['wo'].shape[0]}): num_heads ({cfg.num_heads}) and "
            f"num_kv_heads ({cfg.num_kv_heads}) must both be divisible by "
            f"the model-parallel degree")
    return True, h_l, hkv_l


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: int) -> torch.Tensor:
    """(..., Q, K) boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m = m & ((q_pos[..., :, None] - k_pos[..., None, :]) < window)
    return m


# the query chunks of the materialised attention (GQA's and MLA's) are
# recomputed in the backward once the sequence is longer than this; at or
# below it autograd keeps their f32 logits and softmax ((B, H, chunk, S) a
# chunk).  The reference recomputes every chunk (jax.checkpoint).
KEEP_LOGITS_S = 64


def _run_chunks(one, s: int, q_chunk: int, args) -> torch.Tensor:
    """``one(lo, *args)`` over the query chunks starting at ``lo``,
    concatenated on dim 1; each chunk is checkpointed (``models/remat``)
    when ``s`` exceeds ``KEEP_LOGITS_S``."""
    recompute = s > KEEP_LOGITS_S
    outs = [remat_mod.checkpointed(one, lo, *args) if recompute
            else one(lo, *args) for lo in range(0, s, q_chunk)]
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def _chunked_attention(q, k, v, q_pos, k_pos, window: int,
                       q_chunk: int) -> torch.Tensor:
    """q:(B,Sq,Hkv,rep,hd) k,v:(B,Sk,Hkv,hd) → (B,Sq,Hkv,rep,hd).

    Each query row is independent of the others, so a short last chunk
    equals the reference's zero-padded one.  Above ``KEEP_LOGITS_S``
    the chunks are recomputed in the backward."""
    sq, hd = q.shape[1], q.shape[-1]
    scale = hd ** -0.5
    q_chunk = min(q_chunk, sq)

    def one(lo, q, kf, vf, q_pos, k_pos):
        qc, qp = q[:, lo:lo + q_chunk], q_pos[:, lo:lo + q_chunk]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qc.float() * scale, kf)
        mask = _causal_window_mask(qp, k_pos, window)        # (B,qc,Sk)
        logits = torch.where(mask[:, None, None], logits, _NEG)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bgrqk,bkgd->bqgrd", p, vf).to(q.dtype)

    return _run_chunks(one, sq, q_chunk,
                       (q, k.float(), v.float(), q_pos, k_pos))


IMPLS = ("ref", "pallas", "flash")


def check_attn_scores(impl: str, attn_scores: Optional[str]) -> None:
    """The reference's two refusals of a score tap."""
    if attn_scores is None:
        return
    if attn_scores not in ("fused", "separate"):
        raise ValueError(f"attn_scores must be 'fused', 'separate' or "
                         f"None, got {attn_scores!r}")
    if impl != "flash":
        raise ValueError(
            f"attn_scores={attn_scores!r} needs the trainable flash "
            f"kernel (impl='flash'), got impl={impl!r}")


def attn(params: Params, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor, tape: Optional[Tape] = None,
         prefix: str = "attn", q_chunk: int = 512,
         collector: Optional[dict] = None, impl: str = "ref",
         attn_scores: Optional[str] = None,
         model_group: Optional[DataGroup] = None) -> torch.Tensor:
    """GQA self-attention. x: (B,S,D).

    impl="pallas" runs the flash-attention forward kernel (no autograd:
    the serving-prefill path), "flash" the same kernel made trainable
    through the FlashAttention-2 backward kernel, "ref" the chunked plain
    path.  With a ``collector`` dict the roped K and V (B,S,Hkv,hd) are
    recorded under ``{prefix}.k`` and ``{prefix}.v`` for the decode cache.

    ``attn_scores`` (impl="flash" only) swaps the wq/wk/wv ghost taps for
    ONE (B,) score tap ``{prefix}.qkv_scores`` whose gradient is the
    per-example ||dQ||²+||dK||²+||dV||² of the post-rope attention
    operands: "fused" from the backward kernel's epilogue, "separate" from
    the score sweep over the materialized gradients (the bitwise twin).
    The wo tap is unaffected.

    With head-sharded weights and a ``model_group`` the layer runs on
    this rank's whole heads (the kernels see local heads) and the
    partial wo output is summed over the group; the taps see the local
    slices, and the score tap the local heads' score: partial terms."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    check_attn_scores(impl, attn_scores)
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    sharded, h, hkv = (attn_shard_info(params, cfg) if model_group
                       is not None else (False, cfg.num_heads,
                                         cfg.num_kv_heads))
    rep = h // hkv
    xi = psum_backward(x, model_group) if sharded else x
    # with a score tap the attention-interface score replaces the wq/wk/wv
    # ghost Gram terms: those taps are suppressed
    qkv_tape = None if attn_scores is not None else tape
    q = tapped_linear(xi, params["wq"], f"{prefix}.wq", qkv_tape)
    k = tapped_linear(xi, params["wk"], f"{prefix}.wk", qkv_tape)
    v = tapped_linear(xi, params["wv"], f"{prefix}.wv", qkv_tape)
    q = rope(q.reshape(bsz, s, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(bsz, s, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(bsz, s, hkv, hd)
    if collector is not None:     # prefill: roped K and V feed the KV cache
        collector[f"{prefix}.k"] = k
        collector[f"{prefix}.v"] = v
    if impl == "pallas":
        out = ops.flash_attention(q, k, v, window=cfg.sliding_window)
    elif impl == "flash":
        win = cfg.sliding_window
        if attn_scores is None:
            out = ops.make_flash_attention_trainable(window=win)(q, k, v)
        else:
            tap = (tape.score_tap(f"{prefix}.qkv_scores", bsz, x.device)
                   if tape is not None else
                   torch.zeros(bsz, dtype=torch.float32, device=x.device))
            if attn_scores == "fused":
                fa = ops.make_flash_attention_trainable(window=win,
                                                        with_scores=True)
                out = fa(q, k, v, tap)
            else:
                q, k, v = ops.make_qkv_score_probe()(q, k, v, tap)
                out = ops.make_flash_attention_trainable(window=win)(q, k, v)
    else:
        qg = q.reshape(bsz, s, hkv, rep, hd)
        out = _chunked_attention(qg, k, v, positions, positions,
                                 cfg.sliding_window, q_chunk)
    out = out.reshape(bsz, s, h * hd)
    y = tapped_linear(out, params["wo"], f"{prefix}.wo", tape)
    return psum_forward(y, model_group) if sharded else y


# ===================================================================== MLA
def init_mla(generator: torch.Generator, cfg: ModelConfig,
             device) -> Params:
    dtype = dtype_of(cfg)
    h = cfg.num_heads
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    qr = cfg.q_lora_rank or cfg.d_model
    p = {
        "wkv_a": _dense_init(generator, cfg.d_model,
                             cfg.kv_lora_rank + cfg.qk_rope_dim, dtype,
                             device),
        "kv_norm": init_rmsnorm(cfg.kv_lora_rank, dtype, device),
        "wkv_b": _dense_init(generator, cfg.kv_lora_rank,
                             h * (cfg.qk_nope_dim + cfg.v_head_dim), dtype,
                             device),
        "wo": _dense_init(generator, h * cfg.v_head_dim, cfg.d_model, dtype,
                          device),
    }
    if cfg.q_lora_rank:
        p["wq_a"] = _dense_init(generator, cfg.d_model, qr, dtype, device)
        p["q_norm"] = init_rmsnorm(qr, dtype, device)
        p["wq_b"] = _dense_init(generator, qr, h * qk_dim, dtype, device)
    else:
        p["wq"] = _dense_init(generator, cfg.d_model, h * qk_dim, dtype,
                              device)
    return p


def specs_mla(cfg: ModelConfig) -> Params:
    p = {"wkv_a": ("embed", "rank"), "kv_norm": specs_rmsnorm(),
         "wkv_b": ("rank", "heads"), "wo": ("heads", "embed")}
    if cfg.q_lora_rank:
        p["wq_a"] = ("embed", "rank")
        p["q_norm"] = specs_rmsnorm()
        p["wq_b"] = ("rank", "heads")
    else:
        p["wq"] = ("embed", "heads")
    return p


def mla_shard_info(params: Params, cfg: ModelConfig) -> tuple[bool, int]:
    """(sharded, local heads) of an MLA parameter tree.  The latent
    projections (wq_a, wkv_a) stay replicated; the per-head expansions
    (wq or wq_b, wkv_b) and wo shard whole heads.  A split inconsistent
    across them, or inside a head, raises naming ``num_heads``."""
    h = cfg.num_heads
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    o_rows = params["wo"].shape[0]
    kvb_cols = params["wkv_b"].shape[-1]
    q_cols = (params["wq_b"] if cfg.q_lora_rank else params["wq"]).shape[-1]
    if o_rows == h * vdim and kvb_cols == h * (nope + vdim) \
            and q_cols == h * (nope + rdim):
        return False, h
    if o_rows % vdim or kvb_cols % (nope + vdim) or q_cols % (nope + rdim):
        raise ValueError(
            f"MLA model-axis shard splits mid-head (wo rows={o_rows}, "
            f"wkv_b cols={kvb_cols}, wq cols={q_cols}): the model-parallel "
            f"degree must divide num_heads ({cfg.num_heads})")
    h_l = o_rows // vdim
    if kvb_cols != h_l * (nope + vdim) or q_cols != h_l * (nope + rdim):
        raise ValueError(
            f"MLA is only partially model-sharded (local heads: wo "
            f"{o_rows // vdim}, wkv_b {kvb_cols // (nope + vdim)}, wq "
            f"{q_cols // (nope + rdim)}): the model-parallel degree must "
            f"divide num_heads ({cfg.num_heads}) for every per-head "
            f"projection")
    return True, h_l


def _mla_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor, tape: Optional[Tape], prefix: str,
             model_group: Optional[DataGroup] = None,
             h: Optional[int] = None):
    """The shared projections: (q_nope, q_rope, k_nope, k_rope, v,
    latent), the rope key of shape (B, S, 1, r), shared by every head.
    ``h`` is the (local) head count; with a ``model_group`` the
    replicated inputs of the head-sharded expansions, and the shared
    rope key, take ``psum_backward`` (each rank's cotangent for them is
    its heads' part)."""
    bsz, s, _ = x.shape
    h = cfg.num_heads if h is None else h
    mg = model_group
    nope, rdim = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        qa = tapped_linear(x, params["wq_a"], f"{prefix}.wq_a", tape)
        qa = rmsnorm(params["q_norm"], qa, cfg.norm_eps)
        q = tapped_linear(psum_backward(qa, mg), params["wq_b"],
                          f"{prefix}.wq_b", tape)
    else:
        q = tapped_linear(psum_backward(x, mg), params["wq"],
                          f"{prefix}.wq", tape)
    q = q.reshape(bsz, s, h, nope + rdim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    kv_a = tapped_linear(x, params["wkv_a"], f"{prefix}.wkv_a", tape)
    latent = kv_a[..., :cfg.kv_lora_rank]
    k_rope = kv_a[..., cfg.kv_lora_rank:]
    latent = rmsnorm(params["kv_norm"], latent, cfg.norm_eps)
    k_rope = psum_backward(rope(k_rope[..., None, :], positions,
                                cfg.rope_theta), mg)
    kv = tapped_linear(psum_backward(latent, mg), params["wkv_b"],
                       f"{prefix}.wkv_b", tape)
    kv = kv.reshape(bsz, s, h, nope + cfg.v_head_dim)
    return q_nope, q_rope, kv[..., :nope], k_rope, kv[..., nope:], latent


def _mla_chunk(qn, qr, qp, k_nope, k_rope, v, positions, scale: float,
               window: int, dtype: torch.dtype) -> torch.Tensor:
    lg = torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope.float())
    lg = lg + torch.einsum("bqhd,bkxd->bhqk", qr.float(), k_rope.float())
    lg = lg * scale
    mask = _causal_window_mask(qp, positions, window)
    lg = torch.where(mask[:, None], lg, _NEG)
    p = torch.softmax(lg, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(dtype)


def mla(params: Params, x: torch.Tensor, cfg: ModelConfig,
        positions: torch.Tensor, tape: Optional[Tape] = None,
        prefix: str = "attn", q_chunk: int = 512,
        collector: Optional[dict] = None,
        model_group: Optional[DataGroup] = None) -> torch.Tensor:
    """Materialised MLA for training, scoring and prefill. x: (B,S,D).

    With a ``collector`` the compressed cache is recorded: the normed
    latent (B, S, kv_lora_rank) under ``{prefix}.latent`` and the roped
    shared key (B, S, r) under ``{prefix}.rope``.  Each query row is
    independent of the others, so a short last chunk equals the
    reference's zero-padded one.  With head-sharded expansions and a
    ``model_group`` the per-head math runs on local heads and the
    partial wo output is summed over the group, as in ``attn``."""
    bsz, s, _ = x.shape
    sharded, h = (mla_shard_info(params, cfg) if model_group is not None
                  else (False, cfg.num_heads))
    mg = model_group if sharded else None
    q_nope, q_rope, k_nope, k_rope, v, latent = _mla_qkv(
        params, x, cfg, positions, tape, prefix, model_group=mg, h=h)
    if collector is not None:
        collector[f"{prefix}.latent"] = latent
        collector[f"{prefix}.rope"] = k_rope[:, :, 0, :]
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q_chunk = min(q_chunk, s)

    def one(lo, q_nope, q_rope, k_nope, k_rope, v, positions):
        return _mla_chunk(q_nope[:, lo:lo + q_chunk],
                          q_rope[:, lo:lo + q_chunk],
                          positions[:, lo:lo + q_chunk], k_nope, k_rope, v,
                          positions, scale, cfg.sliding_window, x.dtype)

    out = _run_chunks(one, s, q_chunk,
                      (q_nope, q_rope, k_nope, k_rope, v, positions))
    out = out.reshape(bsz, s, h * cfg.v_head_dim)
    y = tapped_linear(out, params["wo"], f"{prefix}.wo", tape)
    return psum_forward(y, mg)


def mla_decode(params: Params, x: torch.Tensor, cfg: ModelConfig,
               latent_cache: torch.Tensor, rope_cache: torch.Tensor,
               position: torch.Tensor, lengths: torch.Tensor,
               slot: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None,
               model_group: Optional[DataGroup] = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed one-token MLA decode over the *compressed* cache.

    latent_cache: (B, W, kv_lora), rope_cache: (B, W, qk_rope_dim);
    position: (B,) absolute position of the new token; lengths: (B,)
    valid slots including the new one; ``slot`` (B,) where the new token
    goes (default ``lengths - 1``; the engine passes the ring slot
    ``position mod W``).  W_kv_b's key half is absorbed into the query,
    and the logits, softmax and context are f32 over the cache slots.

    Where the reference attends over a copy holding the new row and
    leaves the write to its caller, the port writes the caches IN PLACE
    first (each row cast to its buffer's dtype) and then attends: rows
    where ``active`` (B,) bool is False keep their old slot, so only
    their discarded outputs can differ from the reference's.  With
    head-sharded expansions and a ``model_group`` the per-head math runs
    on the local heads and the partial wo output is summed over the
    group (forward only); the caches are whole on every rank.
    Returns (out (B, D), latent_new (B, kv_lora), rope_new (B, r))."""
    bsz = x.shape[0]
    sharded, h = (mla_shard_info(params, cfg) if model_group is not None
                  else (False, cfg.num_heads))
    mg = model_group if sharded else None
    nope, rdim, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    scale = (nope + rdim) ** -0.5
    q_nope, q_rope, _, k_rope_new, _, latent_new = _mla_qkv(
        params, x[:, None], cfg, position[:, None], None, "decode",
        model_group=mg, h=h)
    wkv_b = params["wkv_b"].reshape(cfg.kv_lora_rank, h, nope + vdim)
    w_k = wkv_b[..., :nope].float()                  # (r, h, nope)
    w_v = wkv_b[..., nope:].float()                  # (r, h, vdim)
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), w_k)

    slot = (lengths - 1 if slot is None else slot).long()
    rows = torch.arange(bsz, device=x.device)
    lat_w = latent_new[:, 0].to(latent_cache.dtype)
    rp_w = k_rope_new[:, 0, 0].to(rope_cache.dtype)
    if active is not None:
        lat_w = torch.where(active[:, None], lat_w, latent_cache[rows, slot])
        rp_w = torch.where(active[:, None], rp_w, rope_cache[rows, slot])
    latent_cache[rows, slot] = lat_w
    rope_cache[rows, slot] = rp_w

    lc = latent_cache.float()
    lg = torch.einsum("bhr,bkr->bhk", q_c, lc)
    lg = lg + torch.einsum("bhd,bkd->bhk", q_rope[:, 0].float(),
                           rope_cache.float())
    lg = lg * scale
    mask = (torch.arange(lc.shape[1], device=x.device)[None]
            < lengths[:, None])
    lg = torch.where(mask[:, None], lg, _NEG)
    p = torch.softmax(lg, dim=-1)
    ctx = torch.einsum("bhk,bkr->bhr", p, lc)                    # (B, h, r)
    out_h = torch.einsum("bhr,rhd->bhd", ctx, w_v)               # (B, h, v)
    out = out_h.reshape(bsz, h * vdim).to(x.dtype) @ params["wo"]
    return psum_forward(out, mg), latent_new[:, 0], k_rope_new[:, 0, 0]
