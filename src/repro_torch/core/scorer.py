"""Per-example gradient-norm scoring — the paper's ω̃_n = ||g(x_n)||₂.

Strategies for the MLP classifier:

  loss        ω̃_n = L(x_n): forward only, a curriculum-style baseline.
  logit_grad  ω̃_n = ||∂L_n/∂logits||₂ in closed form (p − onehot).
  ghost       EXACT ||∇_θ L_n||₂ over every tapped linear (paper Prop. 1):
              one forward, one backward to the taps, and the
              per-example squared-norm kernel; no per-example gradient is
              ever formed.
  full        per-example gradients through ``torch.func`` — the test
              oracle, O(B·|θ|) memory.

All strategies return ω̃ ≥ 0 of shape (B,) in float32.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import Tape
from repro_torch.models.mlp import (MLPConfig, mlp_dims, mlp_forward,
                                    per_example_loss)

STRATEGIES = ("loss", "logit_grad", "ghost", "full")


def ghost_sq_norms(loss_with_taps: Callable, tap_shapes: dict,
                   device: torch.device | str, with_bias: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-example squared grad-norms via the tap trick.

    ``loss_with_taps(taps) -> (per_example_losses (B,), records)``, where
    ``records[name]`` is the input of the linear whose output tap is
    ``taps[name]``.  Consecutive rank-1 taps form one group and go through
    ``ops.per_example_sqnorm_multi`` in one launch; a group of one goes
    through ``ops.per_example_sqnorm`` (the reference's grouping rule,
    ``src/repro/core/scorer.py::ghost_sq_norms``, on one device).

    Returns (sq_norms (B,), per_example_losses (B,))."""
    taps = {k: torch.zeros(s, dtype=torch.float32, device=device,
                           requires_grad=True) for k, s in tap_shapes.items()}
    losses, records = loss_with_taps(taps)
    names = [k for k in records if k in taps]
    grads = torch.autograd.grad(losses.sum(), [taps[k] for k in names])
    dtaps = dict(zip(names, grads))

    xs = [records[k].detach() for k in names]
    ds = [dtaps[k].detach() for k in names]
    for name, x in zip(names, xs):
        if x.ndim != 2:
            raise ValueError(f"tap {name!r} records a {x.ndim}-D input; only "
                             f"rank-1 (B, d) taps are ported (sequence-"
                             f"shared taps need the ghost_norm kernel)")
    # every tap is rank-1, so all of them form one consecutive group
    if len(xs) == 1:
        sq = ops.per_example_sqnorm(xs[0], ds[0], with_bias=with_bias)
    else:
        sq = ops.per_example_sqnorm_multi(xs, ds, with_bias=with_bias)
    return sq, losses.detach()


def make_mlp_scorer(cfg: MLPConfig, strategy: str) -> Callable:
    """Scorer for the paper's MLP classifier: fn(params, batch) → ω̃ (B,)."""
    n_layers = len(cfg.hidden) + 1
    dims = mlp_dims(cfg)

    if strategy == "loss":
        @torch.no_grad()
        def score(params, batch):
            return torch.clamp(per_example_loss(params, batch, cfg), min=0.0)
        return score

    if strategy == "logit_grad":
        @torch.no_grad()
        def score(params, batch):
            logits = mlp_forward(params, batch["x"], cfg)
            p = torch.softmax(logits.float(), dim=-1)
            py = torch.gather(p, 1, batch["y"].long()[:, None])[:, 0]
            sq = torch.sum(torch.square(p), -1) - 2.0 * py + 1.0
            return torch.sqrt(sq)
        return score

    if strategy == "ghost":
        def score(params, batch):
            b = batch["x"].shape[0]
            shapes = {f"fc{i}": (b, dims[i + 1]) for i in range(n_layers)}

            def loss_with_taps(taps):
                tape = Tape(taps=taps, records={})
                losses = per_example_loss(params, batch, cfg, tape=tape)
                return losses, tape.records

            sq, _ = ghost_sq_norms(loss_with_taps, shapes,
                                   batch["x"].device, with_bias=True)
            return torch.sqrt(sq)
        return score

    if strategy == "full":
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

    raise ValueError(f"unknown strategy {strategy!r}; this port has "
                     f"{', '.join(STRATEGIES)}")
