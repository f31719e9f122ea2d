"""Decoder stack of the port: a loop over layer periods with ghost taps.

Mirrors ``src/repro/models/transformer.py`` on one device for every
stack the reference builds: GQA or MLA attention, or mamba mixers, each
followed by a SwiGLU MLP or a mixture of experts (``ModelConfig.
layer_specs``), or by nothing when ``d_ff`` is 0 (the pure-SSM stacks,
falcon-mamba); and the modality-frontend stub, whose (B, N_front, D)
embeds are prepended to the token embeddings.  The depth is
``num_periods`` repetitions of one layer *period*; layer parameters are
stacked on a leading period axis, as in the reference.  Where the
reference runs a ``lax.scan`` over periods, the port runs a Python loop:
each layer tap is ONE (P, B, S, dout) leaf (the MoE router's (P, B·S,
E)), sliced per period, so its gradient comes back already stacked, and
the records leave stacked to (P, B, S, din) ((P, B·S, d) for the
router).  The unembed tap lives outside the loop.  ``Aux.aux_loss`` sums
the MoE layers' load-balance losses (0 for a dense stack).

With ``collect_cache`` the forward also returns the decode caches of the
serving engine, stacked over periods: the roped K and V of every GQA
layer (P, B, S, Hkv, hd), MLA's latent and rope rows (P, B, S, ·), and
each mamba layer's decode state (its conv window and f32 h).

``ssm_mode`` picks the mamba scan: "ref" (the plain oracle, which autograd
differentiates) or "pallas" (the forward-only selective-scan kernel).

``ModelConfig.remat`` (default True, as in the reference) checkpoints
each layer period of a forward that runs under grad
(``models/remat.checkpointed``, the reference's ``jax.checkpoint`` of
its scan body): only the period boundaries, the records and the taps'
slices stay live until the backward, which re-runs one period at a
time.  ``collect_cache`` (the serving prefill) and ``no_grad`` passes
take the plain loop; ``remat=False`` keeps every layer's activations.
Either way the results are bitwise the same.  Whatever ``remat`` says,
``lm_head_metrics`` checkpoints each chunk of its loss head and the
attention its query chunks above ``attention.KEEP_LOGITS_S``, as the
reference always does.

With a ``model_group`` (the reference's ``model_axes``) the whole stack
runs tensor-parallel on this rank's shards (``transformer_specs``):
head-sharded attention, ffn-sharded MLP and MoE experts,
channel-sharded mamba, a vocab-parallel embed and unembed, each
sub-layer reading its shardedness from its local shapes.
``seq_shard=True`` makes the RMSNorm segments sequence-parallel
(``_norm_segment``).  ``tap_structure_from_params`` gives the taps of
the local shards and ``sharded_tap_names`` which of them are partial
terms of the ghost norm.

A ``batch_split`` (``dist.BatchSplit``) says that the tokens are this
rank's block of a minibatch split over a data group (the batch-split
master, ``core/issgd.py``); only the MoE layers read it, to route as
the whole minibatch would (``models/moe.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import remat as remat_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.core.collectives import (all_gather_replicated,
                                          psum_backward, scatter_seq)
from repro_torch.dist import BatchSplit, DataGroup
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (Params, Tape, dtype_of, embed,
                                       init_embed, init_mlp, init_rmsnorm,
                                       mlp, rmsnorm, specs_embed, specs_mlp,
                                       specs_rmsnorm, unembed)


class Aux(NamedTuple):
    aux_loss: torch.Tensor              # MoE load-balance loss (0 if dense)
    records: Optional[dict] = None      # name -> stacked records (P, ...)
    cache: Optional[dict] = None        # name -> stacked caches (P, B, ...)


ATTENTIONS = ("gqa", "mla", "none")
FRONTENDS = ("none", "vision", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` names an attention kind and a frontend the
    model code knows (those of the reference)."""
    if cfg.attention not in ATTENTIONS:
        raise ValueError(f"{cfg.name}: attention must be one of "
                         f"{ATTENTIONS}, got {cfg.attention!r}")
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: frontend must be one of "
                         f"{FRONTENDS}, got {cfg.frontend!r}")


# ------------------------------------------------------------------- init
def _init_layer(generator: torch.Generator, cfg: ModelConfig,
                spec: LayerSpec, device) -> Params:
    if spec.mixer == "attn":
        mixer = (attn_mod.init_mla(generator, cfg, device)
                 if cfg.attention == "mla"
                 else attn_mod.init_attn(generator, cfg, device))
    else:
        mixer = ssm_mod.init_mamba(generator, cfg, device)
    p = {"ln1": init_rmsnorm(cfg.d_model, dtype_of(cfg), device),
         "mixer": mixer}
    if cfg.d_ff > 0:  # pure-SSM stacks (falcon-mamba) have no FF sub-layer
        p["ln2"] = init_rmsnorm(cfg.d_model, dtype_of(cfg), device)
        p["ff"] = (moe_mod.init_moe(generator, cfg, device)
                   if spec.ff == "moe" else init_mlp(generator, cfg, device))
    return p


def _layer_specs_tree(cfg: ModelConfig, spec: LayerSpec) -> Params:
    p = {"ln1": specs_rmsnorm()}
    if spec.mixer == "attn":
        p["mixer"] = (attn_mod.specs_mla(cfg) if cfg.attention == "mla"
                      else attn_mod.specs_attn())
    else:
        p["mixer"] = ssm_mod.specs_mamba()
    if cfg.d_ff > 0:
        p["ln2"] = specs_rmsnorm()
        p["ff"] = moe_mod.specs_moe() if spec.ff == "moe" else specs_mlp()
    return p


def transformer_specs(cfg: ModelConfig) -> Params:
    """The logical axes of every parameter, beside ``init_transformer``'s
    tree (the stacked period axis is a leading dim no spec names)."""
    return {
        "embed": specs_embed(cfg),
        "layers": {f"l{i}": _layer_specs_tree(cfg, s)
                   for i, s in enumerate(cfg.layer_specs())},
        "final_norm": specs_rmsnorm(),
    }


def _stack(trees: list) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_transformer(generator: torch.Generator, cfg: ModelConfig,
                     device) -> Params:
    """Random parameters drawn from ``generator`` (on its own device),
    placed on ``device``; layer leaves stacked on a leading period axis."""
    check_supported(cfg)
    specs = cfg.layer_specs()
    emb = init_embed(generator, cfg, device)
    periods = [{f"l{i}": _init_layer(generator, cfg, spec, device)
                for i, spec in enumerate(specs)}
               for _ in range(cfg.num_periods)]
    return {
        "embed": emb,
        "layers": _stack(periods),
        "final_norm": init_rmsnorm(cfg.d_model, dtype_of(cfg), device),
    }


# ---------------------------------------------------------------- forward
def _sp_active(h: torch.Tensor, model_group: Optional[DataGroup],
               seq_shard: bool) -> bool:
    """Whether the sequence-parallel norm segment applies: asked for, a
    model group, and a sequence length the group divides."""
    return seq_shard and model_group is not None and \
        h.shape[1] % model_group.size == 0


def _norm_segment(ln: Params, h: torch.Tensor, cfg: ModelConfig,
                  model_group: Optional[DataGroup],
                  seq_shard: bool) -> torch.Tensor:
    """RMSNorm, as a sequence-parallel segment when ``_sp_active``: the
    replicated residual is ``scatter_seq``-sliced so each rank normalises
    1/M of the positions, the norm's scale takes ``psum_backward`` (its
    per-slice gradients sum to the replicated one), and
    ``all_gather_replicated`` over the sequence rebuilds the replicated
    input of the sharded mixer or FFN.  A position's norm is the same
    arithmetic either way, so the forward is bitwise the plain one."""
    if not _sp_active(h, model_group, seq_shard):
        return rmsnorm(ln, h, cfg.norm_eps)
    hs = scatter_seq(h, model_group, dim=1)
    sc = {"scale": psum_backward(ln["scale"], model_group)}
    return all_gather_replicated(rmsnorm(sc, hs, cfg.norm_eps), model_group,
                                 dim=1)


def _apply_layer(lp: Params, h: torch.Tensor, cfg: ModelConfig,
                 spec: LayerSpec, positions: torch.Tensor,
                 tape: Optional[Tape], prefix: str,
                 collector: Optional[dict] = None, attn_impl: str = "ref",
                 attn_scores: Optional[str] = None,
                 ssm_mode: str = "ref",
                 pad_mask: Optional[torch.Tensor] = None,
                 model_group: Optional[DataGroup] = None,
                 seq_shard: bool = False,
                 batch_split: Optional[BatchSplit] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer: (h, its MoE load-balance loss, a 0-d f32 tensor).
    ``pad_mask`` reaches the mamba mixers only: causal attention is exact
    for the real rows of a right-padded batch by construction.
    ``model_group``, ``seq_shard`` and ``batch_split``: see the module
    docstring."""
    mg = model_group
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    hn = _norm_segment(lp["ln1"], h, cfg, mg, seq_shard)
    if spec.mixer == "attn" and cfg.attention == "mla":
        if attn_impl != "ref" or attn_scores is not None:
            raise ValueError(
                f"attention='mla' runs its materialised attention only: "
                f"the flash kernels and their score tap are GQA features "
                f"(attn_impl={attn_impl!r}, attn_scores={attn_scores!r}); "
                f"use the default ghost taps")
        h = h + attn_mod.mla(lp["mixer"], hn, cfg, positions, tape,
                             prefix=f"{prefix}.attn", collector=collector,
                             model_group=mg)
    elif spec.mixer == "attn":
        h = h + attn_mod.attn(lp["mixer"], hn, cfg, positions, tape,
                              prefix=f"{prefix}.attn",
                              q_chunk=cfg.attn_chunk, collector=collector,
                              impl=attn_impl, attn_scores=attn_scores,
                              model_group=mg)
    else:
        h = h + ssm_mod.mamba(lp["mixer"], hn, cfg, tape,
                              prefix=f"{prefix}.mamba", mode=ssm_mode,
                              collector=collector, pad_mask=pad_mask,
                              model_group=mg)
    if cfg.d_ff == 0:
        return h, aux
    hn = _norm_segment(lp["ln2"], h, cfg, mg, seq_shard)
    if spec.ff == "moe":
        out = moe_mod.moe(lp["ff"], hn, cfg, tape, prefix=f"{prefix}.moe",
                          model_group=mg, batch_split=batch_split)
        return h + out.y, out.aux_loss
    return h + mlp(lp["ff"], hn, cfg, tape, prefix=f"{prefix}.mlp",
                   model_group=mg), aux


def _period(tree: Params, p: int) -> Params:
    if isinstance(tree, dict):
        return {k: _period(v, p) for k, v in tree.items()}
    return tree[p]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None,
            taps: Optional[dict] = None, collect: bool = False,
            collect_cache: bool = False, attn_impl: str = "ref",
            attn_scores: Optional[str] = None, ssm_mode: str = "ref",
            return_hidden: bool = False,
            pad_mask: Optional[torch.Tensor] = None,
            model_group: Optional[DataGroup] = None,
            seq_shard: bool = False,
            batch_split: Optional[BatchSplit] = None
            ) -> tuple[torch.Tensor, Aux]:
    """tokens (B, S_text) → logits (B, S, vocab) (or the final hidden
    states with ``return_hidden``) and Aux, S = N_front + S_text.

    ``embeds`` (B, N_front, D), the frontend stub's output, is prepended
    to the token embeddings (cast to their dtype).  ``taps``: name →
    (P, B, S, dout) tensor for every layer tap (period p adds
    ``taps[name][p]``; the MoE router's is (P, B·S, E)) and name
    "unembed" → (B, S, vocab).  With ``collect`` the records come back in
    Aux, stacked to (P, B, S, din) ((P, B·S, d) for a router), and the
    unembed record as (B, S, d_model).  With ``collect_cache`` Aux.cache
    holds every layer's decode cache stacked over periods (the roped K and
    V, MLA's latent and rope, mamba's conv window and state): the prefill
    of the serving engine.  ``attn_impl`` is
    "ref", "pallas" (the flash-attention forward kernel) or "flash" (the
    trainable flash kernels); ``attn_scores`` ("fused"/"separate", with
    "flash") puts a (P, B) score tap ``l{i}.attn.qkv_scores`` in place of
    the wq/wk/wv taps (``models/attention.attn``); MLA takes neither.
    ``ssm_mode`` ("ref" or "pallas") is the mamba layers' scan
    (``models/ssm.mamba``).  ``pad_mask`` (B, S) bool marks the real
    positions of a right-padded batch (the bucketed prefill); only the
    mamba layers read it.  ``Aux.aux_loss`` is the sum of the MoE
    layers' load-balance losses.  ``model_group``/``seq_shard`` run the
    stack on this rank's shards (module docstring); the logits are the
    gathered, replicated ones.  ``batch_split``: the module docstring."""
    check_supported(cfg)
    specs = cfg.layer_specs()
    h = embed(params["embed"], tokens, cfg, model_group=model_group)
    if embeds is not None:
        h = torch.cat([embeds.to(h.dtype), h], dim=1)
    bsz, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(bsz, s)

    layer_taps = dict(taps) if taps is not None else {}
    head_tap = layer_taps.pop("unembed", None)
    aux_loss = torch.zeros((), dtype=torch.float32, device=h.device)

    def run_period(carry: list, pp, ptaps, positions, pad_mask,
                   cache=None):
        # one period's layers on carry = [h, aux_loss], which it empties so
        # that a pass without autograd frees the period's input after its
        # first layer; it returns the records and writes nothing but the
        # prefill's cache, so that a recompute can run it again
        h, aux_loss = carry
        carry.clear()
        tape = Tape(taps=ptaps or None, records={} if collect else None)
        for i, spec in enumerate(specs):
            h, aux = _apply_layer(pp[f"l{i}"], h, cfg, spec, positions,
                                  tape, f"l{i}", collector=cache,
                                  attn_impl=attn_impl,
                                  attn_scores=attn_scores, ssm_mode=ssm_mode,
                                  pad_mask=pad_mask, model_group=model_group,
                                  seq_shard=seq_shard,
                                  batch_split=batch_split)
            aux_loss = aux_loss + aux
        return h, aux_loss, tape.records

    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    per_period, per_cache = [], []
    for p in range(cfg.num_periods):
        pp = _period(params["layers"], p)
        ptaps = {k: v[p] for k, v in layer_taps.items()}
        cache = {} if collect_cache else None
        if remat:
            h, aux_loss, records = remat_mod.checkpointed(
                lambda h, a, *rest: run_period([h, a], *rest), h, aux_loss,
                pp, ptaps, positions, pad_mask)
        else:
            carry = [h, aux_loss]
            del h
            h, aux_loss, records = run_period(carry, pp, ptaps, positions,
                                              pad_mask, cache)
        per_period.append(records)
        per_cache.append(cache)

    records = _stack_periods(per_period) if collect else None
    caches = _stack_periods(per_cache) if collect_cache else None
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    if return_hidden:
        return h, Aux(aux_loss, records, caches)
    head_tape = Tape(taps={"unembed": head_tap} if head_tap is not None
                     else None, records={} if collect else None)
    logits = unembed(params["embed"], h, cfg, tape=head_tape,
                     model_group=model_group)
    if collect:
        records.update(head_tape.records)
    return logits, Aux(aux_loss, records, caches)


def _stack_periods(per_period: list) -> dict:
    """[{name: tensor}] over periods → {name: stacked (P, ...)}."""
    return {k: torch.stack([r[k] for r in per_period])
            for k in per_period[0]}


def tap_structure(cfg: ModelConfig, batch: int, seq: int,
                  attn_impl: str = "ref",
                  attn_scores: Optional[str] = None) -> dict:
    """name → shape of every tap, in the forward's record order: layer
    taps with the leading period axis, then the (B, S, vocab) unembed.
    ``seq`` is the whole sequence the forward runs, the frontend's
    positions included (N_front + S_text).  Computed from the config's
    arithmetic (the taps are f32).  ``attn_impl``/``attn_scores`` must
    match the forward the taps feed: an active score tap replaces the
    wq/wk/wv taps of each GQA layer with one (P, B) ``qkv_scores`` tap.
    A mamba layer taps in_proj (2·d_inner), x_proj (dt_rank + 2·d_state)
    and out_proj (d_model), whichever scan its forward runs; an MLA layer
    wq_a and wq_b (or wq), wkv_a, wkv_b and wo; an MoE layer only its
    router, on the token-flattened (P, B·S, E) logits."""
    check_supported(cfg)
    attn_mod.check_attn_scores(attn_impl, attn_scores)
    hd = cfg.resolved_head_dim
    di = cfg.resolved_d_inner
    h = cfg.num_heads
    lead = (cfg.num_periods, batch, seq)
    out = {}
    for i, spec in enumerate(cfg.layer_specs()):
        if spec.mixer == "mamba":
            out.update({
                f"l{i}.mamba.in_proj": lead + (2 * di,),
                f"l{i}.mamba.x_proj": lead + (cfg.resolved_dt_rank
                                              + 2 * cfg.ssm_state,),
                f"l{i}.mamba.out_proj": lead + (cfg.d_model,),
            })
        elif cfg.attention == "mla":
            qk = h * (cfg.qk_nope_dim + cfg.qk_rope_dim)
            if cfg.q_lora_rank:
                out[f"l{i}.attn.wq_a"] = lead + (cfg.q_lora_rank,)
                out[f"l{i}.attn.wq_b"] = lead + (qk,)
            else:
                out[f"l{i}.attn.wq"] = lead + (qk,)
            out.update({
                f"l{i}.attn.wkv_a": lead + (cfg.kv_lora_rank
                                            + cfg.qk_rope_dim,),
                f"l{i}.attn.wkv_b": lead + (
                    h * (cfg.qk_nope_dim + cfg.v_head_dim),),
            })
        elif attn_scores is not None:
            out[f"l{i}.attn.qkv_scores"] = (cfg.num_periods, batch)
        else:
            out.update({
                f"l{i}.attn.wq": lead + (h * hd,),
                f"l{i}.attn.wk": lead + (cfg.num_kv_heads * hd,),
                f"l{i}.attn.wv": lead + (cfg.num_kv_heads * hd,),
            })
        if spec.mixer == "attn":
            out[f"l{i}.attn.wo"] = lead + (cfg.d_model,)
        if cfg.d_ff > 0 and spec.ff == "moe":
            out[f"l{i}.moe.router"] = (cfg.num_periods, batch * seq,
                                       cfg.num_experts)
        elif cfg.d_ff > 0:
            out.update({
                f"l{i}.mlp.w_in": lead + (cfg.d_ff,),
                f"l{i}.mlp.w_gate": lead + (cfg.d_ff,),
                f"l{i}.mlp.w_out": lead + (cfg.d_model,),
            })
    out["unembed"] = (batch, seq, cfg.vocab_size)
    return out


def tap_structure_from_params(params: Params, cfg: ModelConfig, batch: int,
                              seq: int, attn_impl: str = "ref",
                              attn_scores: Optional[str] = None) -> dict:
    """``tap_structure`` for the parameters at hand: under model
    parallelism a column-sharded linear's tap carries only this rank's
    dY columns, so each linear tap is as wide as its local weight's last
    dim; the router's and the score taps keep their shapes, and the
    unembed tap is the gathered full-vocab logits."""
    out = tap_structure(cfg, batch, seq, attn_impl=attn_impl,
                        attn_scores=attn_scores)
    for name, shape in out.items():
        parts = name.split(".")
        if len(parts) != 3 or parts[2] in ("qkv_scores", "router"):
            continue
        layer, kind, w = parts
        sub = "mixer" if kind in ("attn", "mamba") else "ff"
        out[name] = shape[:-1] + (params["layers"][layer][sub][w].shape[-1],)
    return out


def sharded_tap_names(params: Params, cfg: ModelConfig,
                      attn_scores: Optional[str] = None) -> set:
    """The taps whose ghost terms are partial sums over the model group:
    a column-sharded linear taps this rank's dY columns, a row-sharded
    one records this rank's input columns.  The replicated ones (the
    router, MLA's latent projections, mamba's in_proj, the unembed) are
    whole on every rank and counted once by the scorer.  Detection
    follows the forward's own shape checks, so a layer that fell back to
    replication classifies as replicated."""
    layers0 = _period(params["layers"], 0)
    names: set = set()
    for i, spec in enumerate(cfg.layer_specs()):
        lp = layers0[f"l{i}"]
        if spec.mixer == "attn" and cfg.attention == "mla":
            if attn_mod.mla_shard_info(lp["mixer"], cfg)[0]:
                names |= {f"l{i}.attn.wkv_b", f"l{i}.attn.wo",
                          (f"l{i}.attn.wq_b" if cfg.q_lora_rank
                           else f"l{i}.attn.wq")}
        elif spec.mixer == "attn":
            if attn_mod.attn_shard_info(lp["mixer"], cfg)[0]:
                # the score tap's (B,) score comes from the local heads'
                # gradients: a partial term too
                names |= ({f"l{i}.attn.qkv_scores", f"l{i}.attn.wo"}
                          if attn_scores is not None else
                          {f"l{i}.attn.wq", f"l{i}.attn.wk",
                           f"l{i}.attn.wv", f"l{i}.attn.wo"})
        elif ssm_mod.mamba_shard_info(lp["mixer"], cfg)[0]:
            names |= {f"l{i}.mamba.x_proj", f"l{i}.mamba.out_proj"}
        if cfg.d_ff > 0 and spec.ff == "mlp" \
                and lp["ff"]["w_in"].shape[-1] != cfg.d_ff:
            names |= {f"l{i}.mlp.w_in", f"l{i}.mlp.w_gate",
                      f"l{i}.mlp.w_out"}
    return names


# ------------------------------------------------------------------- loss
def lm_head_metrics(params: Params, cfg: ModelConfig, h: torch.Tensor,
                    targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    model_group: Optional[DataGroup] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked unembed + CE: per-example (mean_nll, logit_grad_norm).

    Projects ``cfg.loss_chunk`` positions at a time (all of them when 0).
    Each chunk's unembed, log-softmax and squared logit gradient run
    inside ``remat.checkpointed``, whatever ``cfg.remat`` says (the
    reference's ``jax.checkpoint`` of ``one``): under grad the backward
    recomputes them a chunk at a time, so neither pass holds more than
    one chunk's (B, chunk, V) f32 logits.  logit_grad_norm is
    ||∂L_n/∂logits||₂ of the mean per-example loss."""
    bsz, s, _ = h.shape
    chunk = cfg.loss_chunk if cfg.loss_chunk > 0 else s
    chunk = min(chunk, s)
    if mask is None:
        mask = torch.ones(bsz, s, dtype=torch.float32, device=h.device)

    def one(h_c, t_c, m_c):
        logits = unembed(params["embed"], h_c, cfg,
                         model_group=model_group).float()
        lp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(lp, -1, t_c[..., None])[..., 0]
        pr = torch.exp(lp)
        p_y = torch.gather(pr, -1, t_c[..., None])[..., 0]
        gsq = torch.sum(torch.square(pr), -1) - 2.0 * p_y + 1.0
        return torch.sum(nll * m_c, -1), torch.sum(gsq * m_c, -1)

    nll_sum = torch.zeros(bsz, dtype=torch.float32, device=h.device)
    gsq_sum = torch.zeros(bsz, dtype=torch.float32, device=h.device)
    for lo in range(0, s, chunk):
        nll_c, gsq_c = remat_mod.checkpointed(
            one, h[:, lo:lo + chunk], targets[:, lo:lo + chunk].long(),
            mask[:, lo:lo + chunk])
        nll_sum = nll_sum + nll_c
        gsq_sum = gsq_sum + gsq_c
    count = torch.clamp(torch.sum(mask, -1), min=1.0)
    return nll_sum / count, torch.sqrt(gsq_sum) / count


def per_example_loss(params: Params, cfg: ModelConfig, batch: dict, *,
                     taps: Optional[dict] = None, collect: bool = False,
                     attn_impl: str = "ref",
                     attn_scores: Optional[str] = None,
                     ssm_mode: str = "ref",
                     model_group: Optional[DataGroup] = None,
                     seq_shard: bool = False,
                     batch_split: Optional[BatchSplit] = None
                     ) -> tuple[torch.Tensor, Aux]:
    """Mean next-token CE per example. batch: {tokens (B, S+1), [embeds
    (B, N_front, D)], [mask]}.  The embeds are prepended and the loss
    covers the token positions only.  ``attn_impl``/``attn_scores``/
    ``ssm_mode``/``model_group``/``seq_shard``/``batch_split`` go to
    ``forward``."""
    mp = dict(model_group=model_group, seq_shard=seq_shard,
              batch_split=batch_split)
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    n_front = embeds.shape[1] if embeds is not None else 0
    targets = tokens[:, 1:].long()
    mask = batch.get("mask")
    if cfg.loss_chunk > 0 and taps is None:
        h, aux = forward(params, cfg, tokens[:, :-1], embeds=embeds,
                         collect=collect, attn_impl=attn_impl,
                         attn_scores=attn_scores, ssm_mode=ssm_mode,
                         return_hidden=True, **mp)
        mean_nll, _ = lm_head_metrics(
            params, cfg, h[:, n_front:], targets,
            None if mask is None else mask[:, 1:].float(),
            model_group=model_group)
        return mean_nll, aux
    logits, aux = forward(params, cfg, tokens[:, :-1], embeds=embeds,
                          taps=taps, collect=collect, attn_impl=attn_impl,
                          attn_scores=attn_scores, ssm_mode=ssm_mode, **mp)
    lp = torch.log_softmax(logits[:, n_front:].float(), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    if mask is not None:
        m = mask[:, 1:].float()
        loss = torch.sum(nll * m, -1) / torch.clamp(torch.sum(m, -1),
                                                     min=1.0)
    else:
        loss = torch.mean(nll, dim=-1)
    return loss, aux


def per_example_loss_and_score(params: Params, cfg: ModelConfig,
                               batch: dict, ssm_mode: str = "ref",
                               model_group: Optional[DataGroup] = None,
                               seq_shard: bool = False,
                               batch_split: Optional[BatchSplit] = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-mode objective: (mean NLL (B,), logit-grad scores (B,)) from
    ONE forward: the score the workers' pass would compute falls out of
    the chunked head (``lm_head_metrics``), over the token positions.  The
    attention is the ref path, as in the reference.  Under a
    ``model_group`` the score comes from the gathered logits: replicated,
    no sum needed.  ``batch_split`` goes to ``forward``."""
    tokens = batch["tokens"]
    embeds = batch.get("embeds")
    n_front = embeds.shape[1] if embeds is not None else 0
    h, _ = forward(params, cfg, tokens[:, :-1], embeds=embeds,
                   ssm_mode=ssm_mode, return_hidden=True,
                   model_group=model_group, seq_shard=seq_shard,
                   batch_split=batch_split)
    mask = batch.get("mask")
    return lm_head_metrics(params, cfg, h[:, n_front:], tokens[:, 1:].long(),
                           None if mask is None else mask[:, 1:].float(),
                           model_group=model_group)
