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
            new_params = tree_map(
                lambda p, g: (p.float() - lr_t * g.float()).to(p.dtype),
                params, grads)
            return new_params, state
        new_m = tree_map(lambda m, g: momentum * m + g.float(), state, grads)
        new_params = tree_map(
            lambda p, m: (p.float() - lr_t * m).to(p.dtype), params, new_m)
        return new_params, new_m

    return Optimizer(init, update)
