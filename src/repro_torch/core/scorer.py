"""Per-example gradient-norm scoring — the paper's ω̃_n = ||g(x_n)||₂.

Strategies, for the MLP classifier and for the transformer LMs:

  loss        ω̃_n = L(x_n): forward only, a curriculum-style baseline.
  logit_grad  ω̃_n = ||∂L_n/∂logits||₂ in closed form (p − onehot).
  ghost       EXACT ||∇_θ L_n||₂ over every tapped linear (paper Prop. 1,
              and the ghost-norm Gram kernel for linears shared across
              the sequence): one forward, one backward to the taps, and
              the kernels; no per-example gradient is ever formed.
  ghost_rev   the same quantity for the LMs, by a reverse walk over the
              layer periods: memory for the period boundaries and ONE
              period's records and cotangents, not every layer's.
  full        per-example gradients through ``torch.func`` — the test
              oracle, O(B·|θ|) memory.

All strategies return ω̃ ≥ 0 of shape (B,) in float32.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.collectives import model_sum
from repro_torch.dist import DataGroup, axis_info
from repro_torch.kernels import ops
from repro_torch.models.layers import Tape
from repro_torch.models.mlp import (MLPConfig, layer_is_sharded,
                                    mlp_forward, per_example_loss)
from repro_torch.optim import tree_leaves

STRATEGIES = ("loss", "logit_grad", "ghost", "ghost_rev", "full")


def _contribution(x: torch.Tensor, dt: torch.Tensor, batch: int,
                  with_bias: bool, scanned: bool) -> torch.Tensor:
    """Squared per-example grad-norm contribution of one tapped linear.

    ``scanned`` declares whether the arrays carry a leading period axis
    (the stacked layer records); never guessed from shapes: a (P, B·S, d)
    token-flattened record is shape-ambiguous with (B, S, d) when P == B.

    Shapes handled:
      not scanned: (B, d) rank-1 (paper Prop. 1) | (B, S, d) ghost norm
      scanned:     (P, B, S, d) | (P, B·S, d) token-flattened (MoE router)
    """
    if not scanned:
        if x.ndim == 2:
            return ops.per_example_sqnorm(x, dt, with_bias=with_bias)
        return ops.ghost_norm(x, dt)
    if x.ndim == 3:      # (P, B·S, d) token-flattened
        p = x.shape[0]
        s = x.shape[1] // batch
        x = x.reshape(p, batch, s, x.shape[-1])
        dt = dt.reshape(p, batch, s, dt.shape[-1])
    # every (period, example) row is an independent layer copy, so one
    # call covers all P·B rows
    p, b = x.shape[:2]
    r = ops.ghost_norm(x.reshape(p * b, *x.shape[2:]),
                       dt.reshape(p * b, *dt.shape[2:]))
    return torch.sum(r.reshape(p, b), dim=0)


def ghost_sq_norms(loss_with_taps: Callable, tap_shapes: dict, batch: int,
                   device: torch.device | str,
                   scanned_names: Optional[set] = None,
                   with_bias: bool = False,
                   model_group: Optional[DataGroup] = None,
                   sharded_names: Optional[set] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-example squared grad-norms via the tap trick.

    ``loss_with_taps(taps) -> (per_example_losses (B,), records)``, where
    ``records[name]`` is the input of the linear whose output tap is
    ``taps[name]``.  ``scanned_names``: which records carry a leading
    period axis (default: every name except "unembed", the transformer
    convention).  The reference's single-device grouping rule
    (``src/repro/core/scorer.py::ghost_sq_norms``): consecutive rank-1
    unscanned taps are batched into one ``ops.per_example_sqnorm_multi``
    launch (``ops.per_example_sqnorm`` for a group of one), and any other
    tap flushes the group and adds its ``_contribution``.  A score tap
    (a name ending in ``.qkv_scores``) flushes the group and adds its
    gradient itself, summed over the periods when scanned.

    With a ``model_group`` (model-sharded params) each tap has a
    replication class: the taps in ``sharded_names`` carry this rank's
    dY columns (or input rows), so their terms are partial sums over the
    group, added as they are; every other tap is computed whole on every
    rank and counted once, divided by the group's size.  A group of
    rank-1 taps holds one class only (a change of class flushes it, so a
    lone replicated tap takes ``ops.per_example_sqnorm``), and the total
    is summed over the group: exact and the same on every rank.

    Returns (sq_norms (B,), per_example_losses (B,))."""
    taps = {k: torch.zeros(s, dtype=torch.float32, device=device,
                           requires_grad=True) for k, s in tap_shapes.items()}
    losses, records = loss_with_taps(taps)
    names = [k for k in records if k in taps]
    grads = torch.autograd.grad(losses.sum(), [taps[k] for k in names])
    dtaps = dict(zip(names, grads))
    del taps, grads       # the taps are large on an LM; the walk needs dtaps

    _, n_model = axis_info(model_group)
    sq = torch.zeros(batch, dtype=torch.float32, device=device)
    group_x: list = []
    group_d: list = []
    group_div = [False]

    def counted_once(contrib, divide):
        return contrib / n_model if divide else contrib

    def flush(sq):
        if not group_x:
            return sq
        if len(group_x) == 1:
            contrib = ops.per_example_sqnorm(group_x[0], group_d[0],
                                             with_bias=with_bias)
        else:
            contrib = ops.per_example_sqnorm_multi(group_x, group_d,
                                                   with_bias=with_bias)
        group_x.clear()
        group_d.clear()
        return sq + counted_once(contrib, group_div[0])

    for name in names:
        x = records[name].detach()
        dt = dtaps.pop(name)
        scanned = (name in scanned_names) if scanned_names is not None \
            else name != "unembed"
        divide = model_group is not None and \
            name not in (sharded_names or ())
        if name.endswith(".qkv_scores"):      # the gradient IS the score
            sq = flush(sq)
            contrib = dt.float()
            contrib = torch.sum(contrib, dim=0) if scanned else contrib
            sq = sq + counted_once(contrib, divide)
            continue
        if not scanned and x.ndim == 2:       # rank-1 tap: groupable
            if group_x and group_div[0] != divide:
                sq = flush(sq)
            group_x.append(x)
            group_d.append(dt)
            group_div[0] = divide
            continue
        sq = flush(sq)
        sq = sq + counted_once(_contribution(x, dt, batch, with_bias,
                                             scanned), divide)
    sq = flush(sq)
    return model_sum(sq, model_group), losses.detach()


def make_mlp_scorer(cfg: MLPConfig, strategy: str,
                    row_block: int = 0,
                    model_group: Optional[DataGroup] = None) -> Callable:
    """Scorer for the paper's MLP classifier: fn(params, batch) → ω̃ (B,).

    ``row_block`` (the rows of one logical shard's scoring slice, set by
    the launcher when W > 1) makes the forward and backward GEMMs one a
    block: a row then scores the same bits whether its rank scores one
    shard's slice or all W, so a sharded run's store is the one-device
    run's bit for bit on the card too (``models/mlp.py::_matmul_rows``).
    The kernels still take the whole batch in one launch.

    With a ``model_group`` the scorer takes this rank's column shards:
    ``ghost`` sums the partial per-example norms of the sharded layers
    and the once-counted replicated ones over the group
    (``ghost_sq_norms``); ``loss`` and ``logit_grad`` read the gathered
    logits and need no sum.  ``full`` is the one-device oracle."""
    n_layers = len(cfg.hidden) + 1
    mg = model_group

    if strategy == "loss":
        @torch.no_grad()
        def score(params, batch):
            return torch.clamp(per_example_loss(params, batch, cfg,
                                                row_block=row_block,
                                                model_group=mg),
                               min=0.0)
        return score

    if strategy == "logit_grad":
        @torch.no_grad()
        def score(params, batch):
            logits = mlp_forward(params, batch["x"], cfg,
                                 row_block=row_block, model_group=mg)
            p = torch.softmax(logits.float(), dim=-1)
            py = torch.gather(p, 1, batch["y"].long()[:, None])[:, 0]
            sq = torch.sum(torch.square(p), -1) - 2.0 * py + 1.0
            return torch.sqrt(sq)
        return score

    if strategy == "ghost":
        def score(params, batch):
            b = batch["x"].shape[0]
            # a tap is as wide as its (local) weight's columns
            shapes = {f"fc{i}": (b, params[f"fc{i}"]["w"].shape[-1])
                      for i in range(n_layers)}
            sharded = {f"fc{i}" for i in range(n_layers)
                       if mg is not None and layer_is_sharded(params, cfg,
                                                              i)}

            def loss_with_taps(taps):
                tape = Tape(taps=taps, records={})
                losses = per_example_loss(params, batch, cfg, tape=tape,
                                          row_block=row_block,
                                          model_group=mg)
                return losses, tape.records

            sq, _ = ghost_sq_norms(loss_with_taps, shapes, b,
                                   batch["x"].device, scanned_names=set(),
                                   with_bias=True, model_group=mg,
                                   sharded_names=sharded)
            return torch.sqrt(sq)
        return score

    if strategy == "full":
        if mg is not None:
            raise ValueError(
                "strategy 'full' (the per-example-gradient test oracle) "
                "does not take model-sharded params; use 'ghost', which "
                "sums partial per-example norms over the model group")
        from torch.func import grad, vmap

        def loss_one(p, x, y):
            return per_example_loss(p, {"x": x[None], "y": y[None]}, cfg)[0]

        def score(params, batch):
            grads = vmap(grad(loss_one), in_dims=(None, 0, 0))(
                params, batch["x"], batch["y"])
            sq = sum(torch.sum(torch.square(g.float()),
                               dim=tuple(range(1, g.ndim)))
                     for layer in grads.values() for g in layer.values())
            return torch.sqrt(sq)
        return score

    raise ValueError(f"unknown strategy {strategy!r} for the MLP; it has "
                     f"loss, logit_grad, ghost, full (ghost_rev walks an "
                     f"LM's layer periods)")


# ----------------------------------------------------------- LM strategies
def by_row_blocks(score: Callable, row_block: int) -> Callable:
    """``score`` over a batch of more than ``row_block`` rows, one call a
    block of ``row_block`` rows, the results concatenated; ``score``
    itself when ``row_block`` is 0.  With the rows of one logical shard's
    scoring slice as the block, a rank holding some of the W shards
    scores them with the very calls (and so the bits) the one-device run
    makes: on the card cuBLAS picks its GEMM kernel by the row count."""
    if not row_block:
        return score

    def blocked(params, batch):
        b = next(iter(batch.values())).shape[0]
        if b <= row_block:
            return score(params, batch)
        return torch.cat([
            score(params, {k: v[i:i + row_block] for k, v in batch.items()})
            for i in range(0, b, row_block)])
    return blocked


def make_lm_scorer(cfg, strategy: str, ssm_mode: str = "ref",
                   attn_impl: str = "ref",
                   attn_scores: Optional[str] = None,
                   row_block: int = 0,
                   model_group: Optional[DataGroup] = None,
                   seq_shard: bool = False) -> Callable:
    """Scorer for transformer LMs: fn(params, batch) → ω̃ (B,), a
    ``row_block`` rows at a time when it is set (``by_row_blocks``; the
    launcher sets one logical shard's slice when W > 1).

    ``ssm_mode`` is the mamba layers' scan in every strategy: "ref" (the
    plain oracle) or "pallas" (the selective-scan kernel, forward-only, so
    only with the forward-only strategies ``loss`` and ``logit_grad``).

    ``attn_impl`` selects the attention path of the ghost strategies
    ("ref" chunked plain, "flash" the trainable flash kernels).
    ``attn_scores`` ("fused"/"separate", ghost or ghost_rev with
    attn_impl="flash" only) swaps each
    attention layer's wq/wk/wv Gram terms for the flash-backward score
    ||dQ||²+||dK||²+||dV||² at the attention interface: "fused" from the
    backward kernel's epilogue, "separate" from the score sweep (its
    bitwise twin for f32).  ω̃ is then no longer the exact full-parameter
    gradient norm; every other layer's term stays exact.

    With a ``model_group`` the scorer takes this rank's shards and the
    forward runs model-parallel (``seq_shard``: sequence-parallel norms).
    ``ghost`` and ``ghost_rev`` sum the partial per-example norms of the
    sharded taps and the once-counted replicated ones over the group
    (``sharded_tap_names``), so ω̃ is exact and the same on every rank;
    ``loss`` and ``logit_grad`` read the gathered logits and need no
    sum.  ``full`` is the one-device oracle and refuses a group."""
    from repro_torch.models.ssm import check_ssm_mode
    from repro_torch.models.transformer import (forward, lm_head_metrics,
                                                per_example_loss,
                                                sharded_tap_names,
                                                tap_structure,
                                                tap_structure_from_params)
    check_ssm_mode(ssm_mode)
    mp = dict(model_group=model_group, seq_shard=seq_shard)
    if strategy == "full" and model_group is not None:
        raise ValueError(
            "strategy 'full' (the per-example-gradient test oracle) does "
            "not take model-sharded params; use 'ghost' or 'ghost_rev', "
            "which sum partial per-example norms over the model group")
    if ssm_mode == "pallas" and strategy in ("ghost", "ghost_rev", "full"):
        raise ValueError(
            f"strategy {strategy!r} differentiates the model, and the "
            f"selective-scan kernel (ssm_mode='pallas') has no backward; "
            f"use ssm_mode='ref', or the forward-only 'loss' or "
            f"'logit_grad'")
    if attn_scores is not None:
        if attn_scores not in ("fused", "separate"):
            raise ValueError(f"attn_scores must be 'fused', 'separate' or "
                             f"None, got {attn_scores!r}")
        if strategy not in ("ghost", "ghost_rev"):
            raise ValueError(
                f"attn_scores={attn_scores!r} modifies the ghost-tap walk; "
                f"it has no effect on strategy {strategy!r}; use 'ghost' "
                f"or 'ghost_rev'")
        if attn_impl != "flash":
            raise ValueError(
                f"attn_scores={attn_scores!r} needs the trainable flash "
                f"kernel (attn_impl='flash'), got attn_impl={attn_impl!r}")
        if cfg.attention == "mla":
            raise ValueError("attn_scores is a GQA flash-kernel feature; "
                             "attention='mla' has no flash backward")

    if strategy == "loss":
        @torch.no_grad()
        def score(params, batch):
            losses, _ = per_example_loss(params, cfg, batch,
                                         ssm_mode=ssm_mode, **mp)
            return torch.clamp(losses.float(), min=0.0)

    elif strategy == "logit_grad":
        @torch.no_grad()
        def score(params, batch):
            tokens = batch["tokens"]
            embeds = batch.get("embeds")
            n_front = embeds.shape[1] if embeds is not None else 0
            h, _ = forward(params, cfg, tokens[:, :-1], embeds=embeds,
                           ssm_mode=ssm_mode, return_hidden=True, **mp)
            # chunked head: never materializes (B,S,V) logits at once
            _, grad_norm = lm_head_metrics(params, cfg, h[:, n_front:],
                                           tokens[:, 1:],
                                           model_group=model_group)
            return grad_norm

    elif strategy == "ghost":
        def score(params, batch):
            b, s = batch["tokens"].shape
            embeds = batch.get("embeds")
            n_front = embeds.shape[1] if embeds is not None else 0
            # the taps cover the frontend's positions too
            if model_group is None:
                tap_shapes = tap_structure(cfg, b, n_front + s - 1,
                                           attn_impl=attn_impl,
                                           attn_scores=attn_scores)
                sharded = None
            else:
                tap_shapes = tap_structure_from_params(
                    params, cfg, b, n_front + s - 1, attn_impl=attn_impl,
                    attn_scores=attn_scores)
                sharded = sharded_tap_names(params, cfg,
                                            attn_scores=attn_scores)

            def loss_with_taps(taps):
                losses, aux = per_example_loss(
                    params, cfg, batch, taps=taps, collect=True,
                    attn_impl=attn_impl, attn_scores=attn_scores,
                    ssm_mode=ssm_mode, **mp)
                return losses, aux.records

            sq, _ = ghost_sq_norms(loss_with_taps, tap_shapes, b,
                                   batch["tokens"].device, with_bias=False,
                                   model_group=model_group,
                                   sharded_names=sharded)
            return torch.sqrt(sq)

    elif strategy == "ghost_rev":
        score = _make_ghost_rev_scorer(cfg, ssm_mode, attn_impl, attn_scores,
                                       model_group, seq_shard)

    elif strategy == "full":
        from torch.func import grad, vmap

        def loss_one(p, example):
            one = {k: v[None] for k, v in example.items()}
            losses, _ = per_example_loss(p, cfg, one, ssm_mode=ssm_mode)
            return losses[0]

        def score(params, batch):
            # an MoE layer routes each example alone (capacity of T = S
            # tokens), as the reference's vmap does
            example = {k: batch[k] for k in ("tokens", "embeds")
                       if k in batch}
            grads = vmap(grad(loss_one), in_dims=(None, 0))(params, example)
            leaves = tree_leaves(grads)
            sq = sum(torch.sum(torch.square(g.float()),
                               dim=tuple(range(1, g.ndim))) for g in leaves)
            return torch.sqrt(sq)

    else:
        raise ValueError(f"unknown strategy {strategy!r}; this port has "
                         f"{', '.join(STRATEGIES)}")
    return by_row_blocks(score, row_block)


# ----------------------------------------------- memory-scalable ghost_rev
def _make_ghost_rev_scorer(cfg, ssm_mode: str, attn_impl: str,
                           attn_scores: Optional[str],
                           model_group: Optional[DataGroup] = None,
                           seq_shard: bool = False) -> Callable:
    """Exact ghost scoring by a reverse walk over the layer periods
    (``src/repro/core/scorer.py::_make_ghost_rev_scorer``, one device).

    Phase A runs the periods forward under ``no_grad`` and keeps each
    period's input.  The head gives dL/dh of the summed per-example mean
    NLL (autograd through log_softmax, as the reference's vjp) and the
    unembed term ``ghost_norm(hn, dlogits)`` with the closed-form f32
    ``dlogits = (softmax − onehot) / S`` of the reference, over the token
    positions (the frontend's embeds, if any, are prepended to the
    walk's input and have no logits).  Phase B walks the
    periods in reverse: it recomputes one period with zero taps and
    records, takes ONE ``torch.autograd.grad`` to (its input, its taps)
    with the incoming dL/dh, adds the period's contributions and frees
    its graph before the next.  Memory: the P boundaries and one period's
    records and cotangents, instead of ``ghost``'s for every layer.

    With a ``model_group`` each period's terms follow ``ghost``'s
    classes (``sharded_tap_names``; the unembed term, from the gathered
    logits, is counted once) and the total is summed over the group at
    the end."""
    from repro_torch.models.layers import embed, rmsnorm, unembed
    from repro_torch.models.transformer import (_apply_layer, _period,
                                                check_supported,
                                                sharded_tap_names,
                                                tap_structure,
                                                tap_structure_from_params)
    check_supported(cfg)
    specs = cfg.layer_specs()
    mg = model_group
    _, n_model = axis_info(mg)

    def period_fwd(h, pp, positions, tape):
        for i, spec in enumerate(specs):
            h, _ = _apply_layer(pp[f"l{i}"], h, cfg, spec, positions, tape,
                                f"l{i}", attn_impl=attn_impl,
                                attn_scores=attn_scores, ssm_mode=ssm_mode,
                                model_group=mg, seq_shard=seq_shard)
        return h

    def score(params, batch):
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        n_front = embeds.shape[1] if embeds is not None else 0
        inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
        b, s_text = inputs.shape
        s = n_front + s_text
        device = tokens.device

        sharded = (sharded_tap_names(params, cfg, attn_scores=attn_scores)
                   if mg is not None else set())
        # ---- phase A: forward, keeping only the period boundaries
        with torch.no_grad():
            h = embed(params["embed"], inputs, cfg, model_group=mg)
            if embeds is not None:
                h = torch.cat([embeds.to(h.dtype), h], dim=1)
            positions = torch.arange(s, device=device)[None].expand(b, s)
            boundaries = []
            for p in range(cfg.num_periods):
                boundaries.append(h)
                h = period_fwd(h, _period(params["layers"], p), positions,
                               None)

        # ---- head: dL/dh_final of the summed per-example mean NLL (the
        # reference's vjp through log_softmax) and the unembed term
        h = h.detach().requires_grad_(True)
        hn = rmsnorm(params["final_norm"], h[:, n_front:], cfg.norm_eps)
        lp = torch.log_softmax(unembed(params["embed"], hn, cfg,
                                       model_group=mg).float(), dim=-1)
        nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
        dh, = torch.autograd.grad(torch.sum(torch.mean(nll, dim=-1)), h)
        with torch.no_grad():
            # dlogits = (p − onehot) / S_text, built in lp's place: the
            # head holds one f32 (B, S_text, V) tensor after the vjp
            dlogits = lp.detach().exp_()
            del lp, nll
            dlogits.scatter_add_(-1, targets[..., None],
                                 torch.full_like(dlogits[..., :1], -1.0))
            dlogits.div_(s_text)
        # the gathered logits' term: whole on every rank, counted once
        sq = ops.ghost_norm(hn.detach(), dlogits) / n_model
        del hn, dlogits

        # ---- phase B: reverse walk, one period of cotangents at a time
        full = (tap_structure(cfg, b, s, attn_impl=attn_impl,
                              attn_scores=attn_scores) if mg is None else
                tap_structure_from_params(params, cfg, b, s,
                                          attn_impl=attn_impl,
                                          attn_scores=attn_scores))
        shapes = {k: v[1:] for k, v in full.items() if k != "unembed"}
        for p in reversed(range(cfg.num_periods)):
            h_in = boundaries.pop().requires_grad_(True)
            taps = {k: torch.zeros(v, dtype=torch.float32, device=device,
                                   requires_grad=True)
                    for k, v in shapes.items()}
            tape = Tape(taps=taps, records={})
            h_out = period_fwd(h_in, _period(params["layers"], p),
                               positions, tape)
            names = [k for k in tape.records if k in taps]
            dh, *dts = torch.autograd.grad(
                h_out, [h_in] + [taps[k] for k in names], grad_outputs=dh)
            dtaps = dict(zip(names, dts))
            del h_in, h_out, taps, dts
            for name in names:
                x = tape.records.pop(name).detach()
                dt = dtaps.pop(name)
                if name.endswith(".qkv_scores"):   # the cotangent IS the score
                    c = dt.float()
                else:
                    if x.ndim == 2 and x.shape[0] != b:  # token-flat (T, d)
                        x = x.reshape(b, -1, x.shape[-1])
                        dt = dt.reshape(b, -1, dt.shape[-1])
                    c = _contribution(x, dt, b, False, scanned=False)
                if mg is not None and name not in sharded:
                    c = c / n_model          # replicated: counted once
                sq = sq + c
        return torch.sqrt(model_sum(sq, mg))

    return score
