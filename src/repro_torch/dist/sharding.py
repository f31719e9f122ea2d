"""Logical-axis → mesh-axis sharding rules (``src/repro/dist/sharding.py``).

Each model's ``*_specs`` functions annotate every parameter with
*logical* axis names (``("embed", "heads")`` …).  This module maps those
names onto the mesh: tensor-parallel axes go to ``"model"``, everything
else is replicated, and a dimension that the model axis does not divide
falls back to replication, with a one-time warning that names the
parameter (an uneven vocab, the 10 classes of mlp_svhn at 4 ranks).

Where the reference returns a ``PartitionSpec``, the port's spec is a
plain tuple with one entry a dimension of the parameter: ``None``
(replicated) or ``"model"`` (split in M contiguous chunks, chunk m on
model rank m).  Stacked layer parameters carry a leading period axis
that their logical spec does not name; it is replicated.

A mesh here is anything with ``axis_names`` and a ``shape`` mapping
(``MeshShape``, or the reference's ``jax.sharding.Mesh``): the rules
read nothing else.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import torch

# logical name → preferred mesh axis; None = always replicate
_RULES = {
    "embed": None,      # activations/residual dim: replicated
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "ffn": "model",
    "inner": "model",   # mamba expanded inner dim
    "rank": None,       # MLA latent rank: small, replicated
    "expert": None,     # expert axis: replicated (its ffn dim is sharded)
}


class MeshShape(NamedTuple):
    """A mesh by its axis names and sizes: ``(data, model)`` for the
    port's ``--mesh N --model-parallel M`` world."""
    axis_names: tuple
    shape: dict


def mesh_shape(n_data: int, n_model: int) -> MeshShape:
    """The ``(data, model)`` mesh of N data ranks by M model ranks."""
    return MeshShape(("data", "model"), {"data": n_data, "model": n_model})


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of ``mesh`` (everything but ``model``)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def model_axes(mesh) -> tuple[str, ...]:
    """("model",) when the mesh has a model axis of more than one rank,
    else (): a size-1 model axis replicates every parameter."""
    if "model" in mesh.axis_names and mesh.shape["model"] > 1:
        return ("model",)
    return ()


def rules_for(mesh) -> dict:
    """The logical→mesh rules restricted to the axes ``mesh`` has."""
    names = set(mesh.axis_names)
    return {k: (v if v in names else None) for k, v in _RULES.items()}


# (parameter, logical axis, mesh axis, axis size, dim) already warned
# about: the fallback warns once a cause, not once a call
_warned_fallbacks: set = set()


def logical_to_pspec(logical: tuple, shape: tuple, mesh,
                     name: str = "") -> tuple:
    """The spec of one parameter: a tuple of ``None``/mesh-axis entries,
    one a dimension of ``shape``.  ``logical`` annotates the trailing
    dims; the leading ones (the stacked period axis) are replicated.  A
    mesh axis is used at most once, and only where it divides the
    dimension; where it does not, the dim is replicated with a one-time
    warning naming the parameter."""
    rules = rules_for(mesh)
    offset = len(shape) - len(logical)
    if offset < 0:
        raise ValueError(f"spec {logical} longer than shape {shape}")
    parts: list = [None] * offset
    used: set = set()
    for lname, dim in zip(logical, shape[offset:]):
        ax = rules.get(lname) if lname is not None else None
        if ax is None or ax in used:
            parts.append(None)
        elif dim % mesh.shape[ax] != 0:
            key = (name, lname, ax, mesh.shape[ax], dim)
            if key not in _warned_fallbacks:
                _warned_fallbacks.add(key)
                warnings.warn(
                    f"parameter {name or '<unnamed>'}: logical axis "
                    f"{lname!r} (dim {dim}) is not divisible by mesh axis "
                    f"{ax!r} (size {mesh.shape[ax]}); replicating this "
                    f"dim instead of sharding it", stacklevel=2)
            parts.append(None)
        else:
            parts.append(ax)
            used.add(ax)
    return tuple(parts)


def _keystr(path: tuple) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes a dict path."""
    return "".join(f"[{k!r}]" for k in path)


def param_pspecs(specs, params, mesh, _path: tuple = ()):
    """A logical-spec tree (tuple leaves) and the matching parameter tree
    (tensors, or anything with ``.shape``) → the tree of specs; the
    fallback warning names each parameter by its path."""
    if isinstance(params, dict):
        return {k: param_pspecs(specs[k], v, mesh, _path + (k,))
                for k, v in params.items()}
    return logical_to_pspec(specs, tuple(params.shape), mesh,
                            name=_keystr(_path))


def is_sharded(spec: Optional[tuple]) -> bool:
    """Whether a spec splits any dimension over the model axis."""
    return spec is not None and "model" in spec


def shard_leaf(x: torch.Tensor, spec: tuple, rank: int,
               size: int) -> torch.Tensor:
    """Model rank ``rank``'s chunk of ``x`` under ``spec`` (its own
    contiguous tensor); ``x`` itself when nothing is split."""
    if not is_sharded(spec):
        return x
    dim = spec.index("model")
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).clone()


def shard_tree(tree, specs, rank: int, size: int):
    """``shard_leaf`` over a tree and its spec tree (``None`` replicates
    a whole subtree)."""
    if specs is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], rank, size)
                for k, v in tree.items()}
    return shard_leaf(tree, specs, rank, size)


def opt_state_pspecs(opt_state, params, params_pspecs):
    """The spec tree of an optimizer state: a subtree that mirrors the
    parameter tree (sgd momentum, each of adam's m and v) takes the
    parameter specs, every other leaf is replicated (``None``)."""
    def same_structure(a, b) -> bool:
        if isinstance(a, dict) and isinstance(b, dict):
            return a.keys() == b.keys() and all(
                same_structure(a[k], b[k]) for k in a)
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)

    def rec(sub):
        if same_structure(sub, params):
            return params_pspecs
        if isinstance(sub, dict):
            return {k: rec(v) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)) and not hasattr(sub, "_fields"):
            return type(sub)(rec(v) for v in sub)
        return None

    return rec(opt_state)


__all__ = ["MeshShape", "data_axes", "is_sharded", "logical_to_pspec",
           "mesh_shape", "model_axes", "opt_state_pspecs", "param_pspecs",
           "rules_for", "shard_leaf", "shard_tree"]
