"""Functional optimizers over nested dicts of tensors.

Same interface as the reference (``src/repro/optim/optimizers.py``):
``Optimizer(init, update)`` with ``update(grads, state, params, step) ->
(new_params, new_state)``.  Updates build new tensors and never touch
their inputs, so a caller may keep aliases of old params (the workers'
stale copy does).  ``torch.optim`` is not used: its in-place updates
would not follow the reference's arithmetic.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any]]
    # update(grads, state, params, step) -> (new_params, new_state)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts with identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """Clip ``tree`` to ``max_norm``; pass ``norm`` when already known."""
    n = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), tree), n


# leaves above this many elements are updated a slice at a time, so that
# the f32 temporaries of the unfused update stay small (an MoE expert leaf
# of 2.1 B elements would otherwise hold ~25 GB of them); the update is
# elementwise, so the slices give the whole leaf's bits
_SLICE = 1 << 26


def _by_slices(fn: Callable, p: torch.Tensor, *rest) -> torch.Tensor:
    """fn(p, *rest) (elementwise, in p's shape and dtype), computed over
    slices of at most ``_SLICE`` elements when p is larger."""
    if p.numel() <= _SLICE:
        return fn(p, *rest)
    out = torch.empty_like(p)
    flat = [t.reshape(-1) for t in (p, *rest)]
    o = out.view(-1)
    for lo in range(0, p.numel(), _SLICE):
        o[lo:lo + _SLICE] = fn(*(f[lo:lo + _SLICE] for f in flat))
    return out


def sgd(lr: float | Callable, momentum: float = 0.0) -> Optimizer:
    """Plain SGD (the paper's optimizer), optional heavy-ball momentum."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        if momentum == 0.0:
            new_params = tree_map(lambda p, g: _by_slices(
                lambda pp, gg: (pp.float() - lr_t * gg.float()).to(p.dtype),
                p, g), params, grads)
            return new_params, state
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        new_params = tree_map(
            lambda p, m: (p.float() - lr_t * m).to(p.dtype), params, new_m)
        return new_params, new_m

    return Optimizer(init, update)


def adam(lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments.  The step is a host int; the bias
    corrections take f32 ``t = step + 1`` as the reference's traced step
    does, so ``1 − b ** t`` is rounded as there."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        t = np.float32(step) + np.float32(1.0)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                         state["m"], grads)
        new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.float()), state["v"], grads)

        def upd(p, m, v):
            step_ = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.float()
            return (p.float() - lr_t * step_).to(p.dtype)

        return (tree_map(upd, params, new_m, new_v),
                {"m": new_m, "v": new_v})

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1) -> Callable[[int], float]:
    """Cosine decay from ``base_lr`` to ``final_frac · base_lr`` over
    ``total_steps``, in f32 like the reference's traced schedule."""
    f32 = np.float32

    def fn(step):
        frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
        return float(f32(base_lr) * (f32(final_frac)
                                     + f32(1 - final_frac) * cos))
    return fn


def warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up over ``warmup`` steps, then ``cosine_schedule``."""
    cos = cosine_schedule(base_lr, total_steps - warmup, final_frac)
    f32 = np.float32

    def fn(step):
        if step < warmup:
            w = np.clip(f32(step) / f32(max(warmup, 1)), f32(0), f32(1))
            return float(f32(base_lr) * w)
        return cos(step - warmup)
    return fn
