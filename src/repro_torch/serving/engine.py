"""Batched serving engine: prefill + one-token decode over layer caches.

Mirrors ``src/repro/serving/engine.py`` on one device, for every stack the
model code builds.  Every cache buffer carries a leading period axis P,
as the decoder's stacked parameters do:

  GQA   k/v     (P, B, W, Hkv, hd)   W = sliding window (ring) or max_len
  MLA   latent  (P, B, W, kv_lora)   the *compressed* cache (absorbed decode)
        rope    (P, B, W, qk_rope)
  Mamba conv    (P, B, conv_w-1, d_inner)   constant-size recurrent state
        h       (P, B, d_inner, d_state)    f32

Every attention cache is a ring buffer: slot = position mod W.  RoPE is
applied at write time with absolute positions, so ring order is harmless
(softmax is permutation-invariant; validity is tracked by ``lengths``
alone, because a full ring holds exactly the last W tokens); the MLA
latent cache follows the same discipline.  For a full-attention config a
wrapped ring forgets the oldest context; the batcher finishes a request
before that happens.  Decode routes MoE feed-forwards dropless, as the
reference does: every expert gets room for all B·k rows.

``decode_kernel="pallas"`` routes GQA cache attention through
``kernels/ops.py::decode_attention`` (the CUDA flash-decode kernel on the
card, its plain version on the CPU); "ref" takes the reference's oracle
``kernels/ref.py::decode_attention_ref``.  MLA decode has no kernel (nor
in the reference), and its prefill runs the materialised attention only:
``prefill_attn_impl`` gives the prefill route a stack takes.

``make_decode_runner`` steps ``decode_step`` as one CUDA graph on the
card (the reference jits the step), eagerly on the CPU.

Where the reference returns new arrays (``.at[].set``), the port writes
the preallocated caches IN PLACE: ``decode_step`` updates the cache
tensors of the state it is given and returns a state that shares them.
A caller that needs the old caches clones them first.

On a model group (``model_group``, the reference's ``model_axes``) the
params are the rank's shards and each sub-layer reads its shardedness
from its local shapes (``attn_shard_info``, ``mla_shard_info``,
``mamba_shard_info``), as in training: GQA decode runs on the local KV
heads, MLA on the local heads over the whole latent cache, mamba on the
rank's channel block, the feed-forwards on their ffn slices and the
vocab-parallel embed and unembed over the vocabulary, each row-parallel
output summed over the group.  The caches are allocated at the rank's
local shapes (``cache_shapes(..., model_group)``, by
``sharded_decode.decode_cache_specs``); ``sharded_decode.make_mesh_serving``
binds prefill and decode to a group.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.collectives import psum_forward
from repro_torch.dist import DataGroup
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dtype_of, embed, mlp, rmsnorm, rope,
                                       unembed)
from repro_torch.models.transformer import _period, check_supported, forward
from repro_torch.serving.sharded_decode import decode_cache_specs, local_shape


def check_servable(cfg: ModelConfig) -> None:
    """Raise unless the engine serves ``cfg``: every stack the model code
    builds (GQA, MLA and mamba mixers, MLP and MoE feed-forwards, the
    frontends' embeds).  On a model group the degree must also split
    every present layer type, which ``decode_cache_specs`` checks."""
    check_supported(cfg)


def prefill_attn_impl(cfg: ModelConfig, attn_impl: str) -> str:
    """The prefill attention route ``cfg`` takes when ``attn_impl`` is
    asked for: an MLA stack runs its materialised attention ("ref"; the
    flash kernels are GQA kernels, and the reference has no MLA kernel
    either), every other stack ``attn_impl`` (a hybrid's mamba layers
    scan with the oracle whatever the route)."""
    return "ref" if cfg.attention == "mla" else attn_impl


class ServeState(NamedTuple):
    """Decode-loop carry: per-layer caches + per-row absolute positions."""
    caches: dict          # name -> (P, ...) cache tensors
    lengths: torch.Tensor  # (B,) int32 absolute tokens processed


def _window(cfg: ModelConfig, max_len: int) -> int:
    return (min(cfg.sliding_window, max_len) if cfg.sliding_window > 0
            else max_len)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 model_group: Optional[DataGroup] = None) -> dict:
    """name → (shape, dtype) of every cache buffer; with a
    ``model_group``, of this rank's local buffer (``decode_cache_specs``,
    which raises for a degree a present layer type cannot split)."""
    check_servable(cfg)
    p = cfg.num_periods
    w = _window(cfg, max_len)
    dtype = dtype_of(cfg)
    out = {}
    for i, spec in enumerate(cfg.layer_specs()):
        if spec.mixer == "attn" and cfg.attention == "mla":
            # the GQA ring-or-reject sizing: a configured sliding window
            # bounds the cache, full attention gets max_len
            out[f"l{i}.attn.latent"] = ((p, batch, w, cfg.kv_lora_rank),
                                        dtype)
            out[f"l{i}.attn.rope"] = ((p, batch, w, cfg.qk_rope_dim), dtype)
        elif spec.mixer == "attn":
            kv = (p, batch, w, cfg.num_kv_heads, cfg.resolved_head_dim)
            out[f"l{i}.attn.k"] = (kv, dtype)
            out[f"l{i}.attn.v"] = (kv, dtype)
        else:
            di = cfg.resolved_d_inner
            out[f"l{i}.mamba.conv"] = ((p, batch, cfg.conv_width - 1, di),
                                       dtype)
            out[f"l{i}.mamba.h"] = ((p, batch, di, cfg.ssm_state),
                                    torch.float32)
    if model_group is not None:
        specs = decode_cache_specs(cfg, model_group)
        out = {k: (local_shape(shape, specs[k], model_group.size), dt)
               for k, (shape, dt) in out.items()}
    return out


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     device, model_group: Optional[DataGroup] = None
                     ) -> ServeState:
    """Zeroed caches (see ``cache_shapes``; a ``model_group`` rank's local
    ones) and zero lengths on ``device``."""
    caches = {k: torch.zeros(shape, dtype=dt, device=device)
              for k, (shape, dt) in cache_shapes(cfg, batch, max_len,
                                                 model_group).items()}
    return ServeState(caches=caches,
                      lengths=torch.zeros(batch, dtype=torch.int32,
                                          device=device))


# ------------------------------------------------------------------ decode
def _gqa_decode(lp, hn: torch.Tensor, cfg: ModelConfig,
                k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: torch.Tensor, window: int, decode_kernel: str,
                active: Optional[torch.Tensor] = None,
                model_group: Optional[DataGroup] = None) -> torch.Tensor:
    """hn: (B,D); caches (B,W,Hkv,hd), written in place; pos: (B,)
    absolute position.  ``active`` (B,) bool leaves the cache rows of
    evicted batcher slots as they were (None = all rows live).  With
    head-sharded weights and a ``model_group`` the caches hold the local
    KV heads, the kernel sees local heads and the row-sharded wo's
    partial output is summed over the group."""
    bsz = hn.shape[0]
    hd = cfg.resolved_head_dim
    sharded, h, hkv = (attn_mod.attn_shard_info(lp, cfg)
                       if model_group is not None
                       else (False, cfg.num_heads, cfg.num_kv_heads))
    q = (hn @ lp["wq"]).reshape(bsz, h, hd)
    k_new = (hn @ lp["wk"]).reshape(bsz, hkv, hd)
    v_new = (hn @ lp["wv"]).reshape(bsz, hkv, hd)
    q = rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k_new = rope(k_new[:, None], pos[:, None], cfg.rope_theta)[:, 0]

    slot = (pos % window).long()
    rows = torch.arange(bsz, device=hn.device)
    k_w = k_new.to(k_cache.dtype)
    v_w = v_new.to(v_cache.dtype)
    if active is not None:
        keep = active[:, None, None]
        k_w = torch.where(keep, k_w, k_cache[rows, slot])
        v_w = torch.where(keep, v_w, v_cache[rows, slot])
    k_cache[rows, slot] = k_w
    v_cache[rows, slot] = v_w
    lengths = torch.clamp(pos + 1, max=window).to(torch.int32)

    if decode_kernel == "pallas":
        o = ops.decode_attention(q, k_cache, v_cache, lengths)
    else:
        o = ref.decode_attention_ref(q, k_cache, v_cache, lengths)
    out = o.reshape(bsz, h * hd) @ lp["wo"]
    return psum_forward(out, model_group) if sharded else out


def _persist(buf: torch.Tensor, new: torch.Tensor,
             active: Optional[torch.Tensor]) -> None:
    """Copy a recurrent state's new value into its buffer (B, ...), cast
    to the buffer's dtype; rows where ``active`` is False keep theirs.
    The buffer's storage stays, as a captured graph needs."""
    new = new.to(buf.dtype)
    if active is not None:
        new = torch.where(active.reshape((-1,) + (1,) * (buf.ndim - 1)),
                          new, buf)
    buf.copy_(new)


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                state: ServeState, decode_kernel: str = "ref",
                active: Optional[torch.Tensor] = None,
                model_group: Optional[DataGroup] = None
                ) -> tuple[torch.Tensor, ServeState]:
    """One new token per sequence. tokens: (B,) → (logits (B,V), state).

    The caches of ``state`` are written in place and shared by the
    returned state; every write casts to its own buffer's dtype, so mixed
    precisions (an f32 mamba ``h`` beside a bf16 cache) round-trip each
    buffer whatever the dict's order.  ``active`` (B,) bool gates rows
    the batcher has evicted: inactive rows advance neither their length
    nor any cache buffer (their logits are garbage and discarded by the
    caller).  With a ``model_group`` the params are the rank's shards and
    the caches its local buffers (module docstring); the logits are the
    gathered, replicated ones."""
    if decode_kernel not in ("ref", "pallas"):
        raise ValueError(f"decode_kernel must be 'ref' or 'pallas', got "
                         f"{decode_kernel!r}")
    check_servable(cfg)
    specs = cfg.layer_specs()
    caches = state.caches
    pos = state.lengths                                   # (B,)
    mg = model_group
    h = embed(params["embed"], tokens[:, None], cfg, model_group=mg)[:, 0]
    for p in range(cfg.num_periods):
        pp = _period(params["layers"], p)
        for i, spec in enumerate(specs):
            lp = pp[f"l{i}"]
            hn = rmsnorm(lp["ln1"], h, cfg.norm_eps)
            if spec.mixer == "attn" and cfg.attention == "mla":
                lat = caches[f"l{i}.attn.latent"][p]
                w = lat.shape[1]
                out, _, _ = attn_mod.mla_decode(
                    lp["mixer"], hn, cfg, lat, caches[f"l{i}.attn.rope"][p],
                    pos, torch.clamp(pos + 1, max=w).to(torch.int32),
                    slot=pos % w, active=active, model_group=mg)
            elif spec.mixer == "attn":
                k_cache = caches[f"l{i}.attn.k"][p]
                out = _gqa_decode(lp["mixer"], hn, cfg, k_cache,
                                  caches[f"l{i}.attn.v"][p], pos,
                                  k_cache.shape[1], decode_kernel, active,
                                  model_group=mg)
            else:
                conv = caches[f"l{i}.mamba.conv"][p]
                hs = caches[f"l{i}.mamba.h"][p]
                out, new = ssm_mod.mamba_decode(
                    lp["mixer"], hn, cfg, ssm_mod.MambaState(conv, hs),
                    model_group=mg)
                _persist(conv, new.conv, active)
                _persist(hs, new.h, active)
            h = h + out
            if cfg.d_ff > 0:
                hn = rmsnorm(lp["ln2"], h, cfg.norm_eps)
                if spec.ff == "moe":
                    ff = moe_mod.moe(lp["ff"], hn[:, None], cfg,
                                     dropless=True, model_group=mg).y[:, 0]
                else:
                    ff = mlp(lp["ff"], hn[:, None], cfg,
                             model_group=mg)[:, 0]
                h = h + ff
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg, model_group=mg)
    lengths = (state.lengths + 1 if active is None
               else torch.where(active, state.lengths + 1, state.lengths))
    return logits, ServeState(caches=caches,
                              lengths=lengths.to(torch.int32))


def _snapshot(state: ServeState):
    """A restore() that puts back everything one decode step from
    ``state`` writes: each ring cache's slot at ``lengths mod W`` and the
    whole of each mamba buffer (read-modify-write)."""
    saved = []
    for name, buf in state.caches.items():
        if ".mamba." in name:
            saved.append((buf, None, buf.clone()))
        else:
            rows = torch.arange(buf.shape[1], device=buf.device)
            slot = (state.lengths % buf.shape[2]).long()
            saved.append((buf, (rows, slot), buf[:, rows, slot].clone()))

    def restore():
        for buf, at, old in saved:
            if at is None:
                buf.copy_(old)
            else:
                buf[:, at[0], at[1]] = old
    return restore


DECODE_WARMUP = 2     # eager steps before a decode step is captured


def make_decode_runner(params, cfg: ModelConfig, state: ServeState,
                       decode_kernel: str = "pallas"):
    """A callable ``tokens (B,) int32 → (logits (B, V), state)`` that
    computes ``decode_step(params, cfg, tokens, state, decode_kernel)``
    step after step, starting from ``state``.

    On the CPU it runs ``decode_step`` eagerly.  On the card it is the
    port's counterpart of the reference's ``jax.jit`` of the step: one
    ``decode_step`` captured in a CUDA graph, replayed at each call.
      * DECODE_WARMUP eager steps on a side stream first build the
        kernels' libraries and cuBLAS's workspace.  What they write is put
        back afterwards (``_snapshot``): the ring caches' slots at the
        current lengths and the whole of every mamba conv window and
        state, which a step reads, modifies and writes, so that two
        warm-up steps do not advance the recurrence before the first
        token.  They leave the lengths where they were.  Their launches
        are real and counted.
      * The graph runs over static buffers: the tokens (copied in at each
        call), a copy of ``state.lengths`` that the graph advances in
        place, and ``state``'s caches, written in place as ``decode_step``
        does.  The scratch and outputs the kernels' wrappers allocate come
        from the graph's private memory pool.
      * A replay runs no Python, so the wrappers' launch counters
        (``kernels/ops.py::launch_counts``) do not move by themselves: what
        the capture added is taken back, and each replay adds it.
    The logits returned are the graph's static output, overwritten by the
    next call (clone them to keep them); the state returned holds the
    static lengths and the caches.  A capture or replay that fails
    raises: nothing falls back to the eager step."""
    if decode_kernel not in ("ref", "pallas"):
        raise ValueError(f"decode_kernel must be 'ref' or 'pallas', got "
                         f"{decode_kernel!r}")
    check_servable(cfg)
    dev = state.lengths.device
    if dev.type != "cuda":
        carry = [state]

        def eager(tokens: torch.Tensor):
            logits, carry[0] = decode_step(params, cfg, tokens, carry[0],
                                           decode_kernel)
            return logits, carry[0]
        return eager

    static = ServeState(caches=state.caches, lengths=state.lengths.clone())
    tokens_in = torch.zeros_like(static.lengths)
    restore = _snapshot(static)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(DECODE_WARMUP):
            decode_step(params, cfg, tokens_in, static, decode_kernel)
    torch.cuda.current_stream(dev).wait_stream(side)
    restore()
    del restore
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    with torch.cuda.graph(graph):
        logits, new = decode_step(params, cfg, tokens_in, static,
                                  decode_kernel)
        static.lengths.copy_(new.lengths)
    after = ops.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    ops.add_launch_counts({k: -n for k, n in delta.items()})

    def replay(tokens: torch.Tensor):
        tokens_in.copy_(tokens)
        graph.replay()
        ops.add_launch_counts(delta)
        return logits, static
    return replay


# ----------------------------------------------------------------- prefill
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
            embeds: Optional[torch.Tensor] = None, attn_impl: str = "ref",
            true_len: Optional[int] = None,
            model_group: Optional[DataGroup] = None
            ) -> tuple[torch.Tensor, ServeState]:
    """Process the prompt and build decode caches.

    tokens: (B, S_prompt); ``embeds`` (B, N_front, D), a frontend's
    output, goes before them, and the lengths and the ring placement count
    all S_total = N_front + S positions.  Returns (last_logits (B,V),
    ServeState).  attn_impl="pallas" routes prefill attention through the
    flash kernel (GQA layers; see ``prefill_attn_impl``).

    ``true_len`` enables bucketed prefill: the prompt arrives right-padded
    to a bucket length S and only the first ``true_len`` tokens are real.
    Causal attention never lets a real query see a padded key, and the
    mamba layers zero Δ at pad positions (an identity step) and take
    their conv window from the real tail, so their state is the unpadded
    run's.  Cache slot s of a cap-W buffer takes source position
    ``s + W·⌊(true_len−1−s)/W⌋``: the plain copy when true_len ≤ W and
    the ring layout that ``slot = pos mod W`` continues when it is not.
    Mamba states are copied as they are.  A capacity-routed MoE prefill
    lets the pad tokens compete for expert capacity, as the reference's
    does, so its routing can differ from the unpadded run's (decode
    routes dropless).  ``true_len`` with ``embeds`` raises, as in the
    reference.

    With a ``model_group`` the forward runs on the rank's shards (no
    sequence parallelism: serving passes only the model group, as the
    reference passes only ``model_axes``) and collects the rank's local
    caches: the K and V of its KV heads, its mamba channel block, the
    whole MLA latents; each buffer takes its trailing dims from what the
    forward collected."""
    bsz, s = tokens.shape
    pad_mask = None
    if true_len is not None:
        if embeds is not None:
            raise ValueError("true_len (bucketed prefill) does not compose "
                             "with frontend embeds")
        true_len = int(true_len)
        if not 1 <= true_len <= s:
            raise ValueError(f"true_len {true_len} outside [1, {s}]")
        pad_mask = (torch.arange(s, device=tokens.device)[None]
                    < true_len).expand(bsz, s)
    logits, aux = forward(params, cfg, tokens, embeds=embeds,
                          collect_cache=True, attn_impl=attn_impl,
                          pad_mask=pad_mask, model_group=model_group)
    s_total = s + (embeds.shape[1] if embeds is not None else 0)
    caches = {}
    for name, (shape, dt) in cache_shapes(cfg, bsz, max_len).items():
        got = aux.cache[name]                 # (P, B, S_total, ...) or state
        if ".mamba." in name:
            caches[name] = got.to(dt)
            continue
        cap = shape[2]
        # the trailing dims come from the collected cache: the local heads
        # of a model rank's shards, as the reference takes them
        buf = torch.zeros(shape[:3] + tuple(got.shape[3:]), dtype=dt,
                          device=got.device)
        if true_len is None:
            if s_total <= cap:
                buf[:, :, :s_total] = got
            else:  # ring placement of the last `cap` positions
                slots = (torch.arange(s_total - cap, s_total,
                                      device=got.device) % cap)
                buf[:, :, slots] = got[:, :, -cap:].to(dt)
        else:
            sidx = torch.arange(cap, device=got.device)
            src = sidx + cap * torch.div(true_len - 1 - sidx, cap,
                                         rounding_mode="floor")
            take = got[:, :, torch.clamp(src, 0, s - 1)]
            valid = (src >= 0).reshape((1, 1, cap) + (1,) * (got.ndim - 3))
            buf = torch.where(valid, take.to(dt), buf)
        caches[name] = buf
    if true_len is None:
        lengths = torch.full((bsz,), s_total, dtype=torch.int32,
                             device=tokens.device)
        last = logits[:, -1].clone()      # not a view: frees the (B,S,V)
    else:
        lengths = torch.full((bsz,), true_len, dtype=torch.int32,
                             device=tokens.device)
        last = logits[:, true_len - 1].clone()
    return last, ServeState(caches=caches, lengths=lengths)


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, steps: int,
             max_len: int, decode_kernel: str = "ref",
             embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy generation. Returns (B, steps) sampled tokens."""
    logits, st = prefill(params, cfg, prompt, max_len, embeds=embeds)
    toks = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(steps):
        toks.append(tok)
        logits, st = decode_step(params, cfg, tok, st,
                                 decode_kernel=decode_kernel)
        tok = torch.argmax(logits, -1).to(torch.int32)
    return torch.stack(toks, dim=1)
