"""Mamba-1 block of the port (the falcon-mamba and jamba mixer), one
device.

Mirrors ``src/repro/models/ssm.py``: ``init_mamba``, ``_causal_conv``,
``mamba``, ``MambaState``, ``init_mamba_state`` and ``mamba_decode``.  The
sequence recurrence runs through the plain oracle
``kernels/ref.selective_scan_ref`` (``mode="ref"``, differentiable) or
the hand-written selective-scan kernel through ``kernels/ops.py``
(``mode="pallas"``, the reference's name; forward-only).  The serving
prefill (a ``collector``) always scans with the oracle, which returns the
final state, as the reference's does; ``pad_mask`` makes a right-padded
prefill leave the state of the unpadded one.  ``mamba_decode`` is the
one-token step over the conv window and the f32 state.

With channel-sharded weights and a ``model_group`` (``specs_mamba``;
``mamba_shard_info``) the training mixer is channel-parallel: the
replicated [x | z] projection is sliced to this rank's channels, the
conv, Δ, A, D and the scan (either mode) run on them, and the
row-sharded x_proj and out_proj give partial outputs that
``psum_forward`` sums.  ``mamba_decode`` takes the same group: its state
buffers are the rank's channel block.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import psum_backward, psum_forward
from repro_torch.dist import DataGroup
from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, Tape, _dense_init, dtype_of,
                                       tapped_linear)

SSM_MODES = ("ref", "pallas")


class MambaState(NamedTuple):
    """Decode-time recurrent state (the SSM's 'KV cache')."""
    conv: torch.Tensor   # (B, conv_width-1, d_inner) trailing inputs
    h: torch.Tensor      # (B, d_inner, d_state) f32


def check_ssm_mode(mode: str) -> None:
    if mode not in SSM_MODES:
        raise ValueError(f"ssm_mode must be one of {SSM_MODES}, got {mode!r}")


def init_mamba(generator: torch.Generator, cfg: ModelConfig,
               device) -> Params:
    """The reference's mamba parameters: model-dtype projections and
    conv, f32 dt_proj, dt_bias, a_log and d_skip."""
    dtype = dtype_of(cfg)
    d, di = cfg.d_model, cfg.resolved_d_inner
    ds, dtr, w = cfg.ssm_state, cfg.resolved_dt_rank, cfg.conv_width
    gd = generator.device
    f32 = torch.float32
    in_proj = _dense_init(generator, d, 2 * di, dtype, device)
    conv_w = torch.randn(w, di, generator=generator, device=gd, dtype=f32)
    conv_w = (conv_w * w ** -0.5).to(device=device, dtype=dtype)
    x_proj = _dense_init(generator, di, dtr + 2 * ds, dtype, device)
    dt_proj = _dense_init(generator, dtr, di, f32, device)
    # softplus⁻¹ of a log-uniform dt in [1e-3, 1e-1]
    lo, hi = math.log(1e-3), math.log(1e-1)
    log_dt = torch.rand(di, generator=generator, device=gd, dtype=f32)
    dt_bias = torch.log(torch.expm1(torch.exp(lo + (hi - lo) * log_dt)))
    a_init = torch.arange(1, ds + 1, dtype=f32, device=device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros(di, dtype=dtype, device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias.to(device),
        "a_log": torch.log(a_init)[None].repeat(di, 1),
        "d_skip": torch.ones(di, dtype=f32, device=device),
        "out_proj": _dense_init(generator, di, d, dtype, device),
    }


def specs_mamba() -> Params:
    """in_proj projects to the concatenated [x | z] pair (d, 2·d_inner): a
    contiguous column shard of it would not follow the channel split, so
    it stays replicated and ``mamba`` slices its output instead."""
    return {"in_proj": ("embed", None), "conv_w": (None, "inner"),
            "conv_b": ("inner",), "x_proj": ("inner", None),
            "dt_proj": (None, "inner"), "dt_bias": ("inner",),
            "a_log": ("inner", None), "d_skip": ("inner",),
            "out_proj": ("inner", "embed")}


def mamba_shard_info(params: Params, cfg: ModelConfig) -> tuple[bool, int]:
    """(sharded, local d_inner) of a mamba parameter tree.  Every
    channel-indexed parameter shards the same d_inner, so the fallback
    takes all of them or none; a mix raises naming ``d_inner``."""
    di = cfg.resolved_d_inner
    di_l = params["a_log"].shape[0]
    if di_l == di and params["out_proj"].shape[0] == di:
        return False, di
    consistent = (params["out_proj"].shape[0] == di_l
                  and params["x_proj"].shape[0] == di_l
                  and params["conv_w"].shape[1] == di_l
                  and params["dt_proj"].shape[1] == di_l
                  and params["in_proj"].shape[-1] == 2 * di)
    if not consistent or di % di_l:
        raise ValueError(
            f"mamba is inconsistently model-sharded (a_log rows={di_l}, "
            f"out_proj rows={params['out_proj'].shape[0]}, d_inner={di}): "
            f"the model-parallel degree must divide d_inner "
            f"({di}; config field d_inner, default 2*d_model)")
    return True, di_l


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence. x: (B, S, di), w: (W, di);
    the reference's unrolled taps, in its order."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = xp[:, 0:s, :] * w[0][None, None]
    for i in range(1, width):
        y = y + xp[:, i:i + s, :] * w[i][None, None]
    return y + b[None, None]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, log(1 + eˣ) as logaddexp(x, 0)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _conv_tail(x_in: torch.Tensor, w: int,
               pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The last w-1 inputs of each row (B, w-1, di), the real ones under
    ``pad_mask``; rows shorter than the window are left-padded with zeros,
    as ``_causal_conv`` pads them."""
    bsz, s, di = x_in.shape
    if pad_mask is None:
        tail = x_in[:, -(w - 1):]
        return F.pad(tail, (0, 0, w - 1 - tail.shape[1], 0))
    tl = torch.sum(pad_mask.to(torch.int64), dim=1)             # (B,)
    idx = tl[:, None] - (w - 1) + torch.arange(w - 1,
                                               device=x_in.device)[None]
    got = torch.gather(x_in, 1, torch.clamp(idx, 0, s - 1)[..., None]
                       .expand(bsz, w - 1, di))
    return torch.where((idx >= 0)[..., None], got, torch.zeros_like(got))


def mamba(params: Params, x: torch.Tensor, cfg: ModelConfig,
          tape: Optional[Tape] = None, prefix: str = "mamba",
          mode: str = "ref", collector: Optional[dict] = None,
          pad_mask: Optional[torch.Tensor] = None,
          model_group: Optional[DataGroup] = None) -> torch.Tensor:
    """Full-sequence mamba mixer. x: (B, S, D) → (B, S, D).

    ``mode="ref"`` scans with ``ref.selective_scan_ref`` at the config's
    ``ssm_scan_dtype``; ``mode="pallas"`` runs ``ops.selective_scan`` (the
    CUDA kernel on the card) on Δ cast to the activations' dtype, as the
    reference does, so a bf16 model hands the kernel a bf16 Δ.  The
    taps are ``{prefix}.in_proj``, ``.x_proj`` and ``.out_proj``.

    With a ``collector`` (the serving prefill) the scan is the oracle at
    f32 whatever ``mode`` says, and the decode state is recorded: the last
    w-1 conv inputs under ``{prefix}.conv`` and the final f32 state under
    ``{prefix}.h``.  ``pad_mask`` (B, S) bool marks the real positions of
    a right-padded batch: Δ is zeroed at pad positions, which makes each
    pad step the identity on the state (h = exp(0·A)·h + 0·B·x), and the
    conv window is gathered from each row's real tail.

    With channel-sharded weights and a ``model_group`` the mixer runs on
    this rank's channel block (module docstring); x_proj's summed output
    feeds every rank's own channels, so it takes ``psum_backward`` after
    ``psum_forward``, and the local taps (x_proj, out_proj) are partial
    terms."""
    check_ssm_mode(mode)
    di, ds, dtr = cfg.resolved_d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    sharded, di_l = (mamba_shard_info(params, cfg) if model_group
                     is not None else (False, di))
    mg = model_group if sharded else None

    xz = tapped_linear(x, params["in_proj"], f"{prefix}.in_proj", tape)
    xz = psum_backward(xz, mg)
    x_in, z = xz[..., :di], xz[..., di:]
    if sharded:
        lo = mg.rank * di_l
        x_in, z = x_in[..., lo:lo + di_l], z[..., lo:lo + di_l]
    x_c = F.silu(_causal_conv(x_in, params["conv_w"], params["conv_b"]))

    proj = tapped_linear(x_c, params["x_proj"], f"{prefix}.x_proj", tape)
    proj = psum_backward(psum_forward(proj, mg), mg)
    dt_r = proj[..., :dtr]
    b_mat = proj[..., dtr:dtr + ds]
    c_mat = proj[..., dtr + ds:]
    delta = _softplus(torch.matmul(dt_r.float(), params["dt_proj"])
                      + params["dt_bias"])
    if pad_mask is not None:
        delta = delta * pad_mask[..., None].to(delta.dtype)
    a = -torch.exp(params["a_log"])

    if collector is not None:
        y, h_final = ref.selective_scan_ref(x_c, delta, a, b_mat, c_mat,
                                            params["d_skip"],
                                            return_state=True)
        collector[f"{prefix}.conv"] = _conv_tail(
            x_in, params["conv_w"].shape[0], pad_mask)
        collector[f"{prefix}.h"] = h_final
    elif mode == "pallas":
        y = ops.selective_scan(x_c, delta.to(x_c.dtype), a, b_mat, c_mat,
                               params["d_skip"])
    else:
        y = ref.selective_scan_ref(x_c, delta, a, b_mat, c_mat,
                                   params["d_skip"],
                                   scan_dtype=getattr(torch,
                                                      cfg.ssm_scan_dtype))

    y = y * F.silu(z)
    out = tapped_linear(y, params["out_proj"], f"{prefix}.out_proj", tape)
    return psum_forward(out, mg)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> MambaState:
    """Zeroed decode state: the conv window in ``dtype``, h in f32."""
    di = cfg.resolved_d_inner
    return MambaState(
        conv=torch.zeros(batch, cfg.conv_width - 1, di, dtype=dtype,
                         device=device),
        h=torch.zeros(batch, di, cfg.ssm_state, dtype=torch.float32,
                      device=device))


def mamba_decode(params: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: MambaState,
                 model_group: Optional[DataGroup] = None
                 ) -> tuple[torch.Tensor, MambaState]:
    """One-token decode. x: (B, D) → ((B, D), the new state).  The state
    given is only read: the caller persists the new one.

    With channel-sharded weights and a ``model_group`` the state buffers
    are this rank's channel block: the replicated in_proj output is
    sliced to it, and the row-sharded x_proj and out_proj partial outputs
    are summed over the group (``psum_forward``; decode is forward-only,
    so no backward collective is needed)."""
    di, ds, dtr = cfg.resolved_d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    sharded, di_l = (mamba_shard_info(params, cfg) if model_group
                     is not None else (False, di))
    mg = model_group if sharded else None
    xz = x @ params["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]                     # (B, di)
    if sharded:
        lo = mg.rank * di_l
        x_in, z = x_in[..., lo:lo + di_l], z[..., lo:lo + di_l]
    window = torch.cat([state.conv, x_in[:, None]], dim=1)   # (B, W, di)
    x_c = torch.sum(window * params["conv_w"][None], dim=1) + params["conv_b"]
    x_c = F.silu(x_c)

    proj = psum_forward(x_c @ params["x_proj"], mg)
    dt_r, b_t, c_t = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                      proj[..., dtr + ds:])
    delta = _softplus(torch.matmul(dt_r.float(), params["dt_proj"])
                      + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    h, y = ref.selective_scan_step_ref(state.h, x_c, delta, a, b_t, c_t,
                                       params["d_skip"])
    y = y * F.silu(z)
    return (psum_forward(y @ params["out_proj"], mg),
            MambaState(conv=window[:, 1:], h=h))
