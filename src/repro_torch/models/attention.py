"""GQA self-attention for training, scoring and prefill.

Mirrors the GQA part of ``src/repro/models/attention.py``.  ``impl="ref"``
cuts the query dimension into chunks so the S×S logits of the whole
sequence never exist at once; logits and softmax are f32, masked entries
take ``_NEG``, and the output is cast back to q's dtype.  The GQA grouping
reshapes q to (B, S, Hkv, rep, hd) against (B, S, Hkv, hd) keys and
values.  ``impl="pallas"`` is the forward-only flash-attention kernel of
``kernels/ops.py`` (the serving-prefill path; the name is the reference's).
The trainable flash path (``impl="flash"``, the fused score taps) and MLA
come with later slices of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, Tape, _dense_init, dtype_of,
                                       rope, tapped_linear)

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


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: int) -> torch.Tensor:
    """(..., Q, K) boolean mask: causal, optionally sliding-window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        m = m & ((q_pos[..., :, None] - k_pos[..., None, :]) < window)
    return m


def _chunked_attention(q, k, v, q_pos, k_pos, window: int,
                       q_chunk: int) -> torch.Tensor:
    """q:(B,Sq,Hkv,rep,hd) k,v:(B,Sk,Hkv,hd) → (B,Sq,Hkv,rep,hd).

    Each query row is independent of the others, so a short last chunk
    equals the reference's zero-padded one."""
    sq, hd = q.shape[1], q.shape[-1]
    scale = hd ** -0.5
    q_chunk = min(q_chunk, sq)
    kf, vf = k.float(), v.float()
    outs = []
    for lo in range(0, sq, q_chunk):
        qc, qp = q[:, lo:lo + q_chunk], q_pos[:, lo:lo + q_chunk]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qc.float() * scale, kf)
        mask = _causal_window_mask(qp, k_pos, window)        # (B,qc,Sk)
        logits = torch.where(mask[:, None, None], logits, _NEG)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgrqk,bkgd->bqgrd", p, vf)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attn(params: Params, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor, tape: Optional[Tape] = None,
         prefix: str = "attn", q_chunk: int = 512,
         collector: Optional[dict] = None, impl: str = "ref",
         attn_scores: Optional[str] = None) -> torch.Tensor:
    """GQA self-attention. x: (B,S,D).

    impl="pallas" runs the flash-attention forward kernel (no autograd:
    the serving-prefill path), "ref" the chunked plain path.  With a
    ``collector`` dict the roped K and V (B,S,Hkv,hd) are recorded under
    ``{prefix}.k`` and ``{prefix}.v`` for the decode cache."""
    if impl not in ("ref", "pallas"):
        raise NotImplementedError(
            f"attention impl {impl!r} needs the trainable flash-attention "
            f"kernels (backward and score sweep), which a later slice of "
            f"the PyTorch port carries; this slice runs impl='ref' and "
            f"impl='pallas'")
    if attn_scores is not None:
        raise NotImplementedError(
            "attn_scores (the fused flash-backward score tap) comes with the "
            "trainable flash-attention slice of the PyTorch port")
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    rep = h // hkv
    q = tapped_linear(x, params["wq"], f"{prefix}.wq", tape)
    k = tapped_linear(x, params["wk"], f"{prefix}.wk", tape)
    v = tapped_linear(x, params["wv"], f"{prefix}.wv", tape)
    q = rope(q.reshape(bsz, s, h, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(bsz, s, hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(bsz, s, hkv, hd)
    if collector is not None:     # prefill: roped K and V feed the KV cache
        collector[f"{prefix}.k"] = k
        collector[f"{prefix}.v"] = v
    if impl == "pallas":
        out = ops.flash_attention(q, k, v, window=cfg.sliding_window)
    else:
        qg = q.reshape(bsz, s, hkv, rep, hd)
        out = _chunked_attention(qg, k, v, positions, positions,
                                 cfg.sliding_window, q_chunk)
    out = out.reshape(bsz, s, h * hd)
    return tapped_linear(out, params["wo"], f"{prefix}.wo", tape)
