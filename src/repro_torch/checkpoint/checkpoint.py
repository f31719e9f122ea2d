"""Checkpoints of the port: any tree of tensors (params, optimizer state,
the ISSGD weight store) in the reference's flat-key npz layout
(``src/repro/checkpoint/checkpoint.py``), written atomically.

The layout, shared by both packages so each restores the other's files:

  * keys ``a/b/c`` from dict keys, NamedTuple fields and list/tuple
    positions; ``None`` leaves are skipped;
  * ``__step__`` (int64) and ``__manifest__``, a JSON dict that tags the
    leaves that are not plain numpy arrays;
  * bf16 tensors stored as their uint16 bit patterns, tagged
    ``"bfloat16"`` (numpy has no bf16: the bits go through a
    ``torch.int16`` view, never through a float cast);
  * a gather-free reference file holds a sharded array as
    ``<key>::shard<i>`` entries with a ``"sharded:"`` manifest tag (global
    shape, dtype, each shard's index slices); restore reassembles it.

A ``torch.Generator`` (the port's ``TrainState.rng``) is saved as its
``get_state()`` bytes under the tag ``"torch.Generator:<device type>"``,
so a restored run continues the same random stream.  A reference file's
PRNG key (``"prngkey:"`` tag) means nothing to a generator: restore then
keeps the template's generator, as the reference does for a key-less
file; the reference likewise keeps its template key for a port file.
A host int leaf (the port's ``step``) is stored as a 0-d int32, as the
reference's step.  Restored tensors take the template's device and
dtype; keys missing from the file keep the template's value.

A sharded run saves **gather-free** (``save_checkpoint(..., group=)``):
the leaves of every WeightStore in the tree (``weights``, ``scored_at``,
an int8 table's ``qscale``; both buffers of a BufferedWeightStore) are
this rank's rows, and each rank writes them to a part file beside the
target; after all parts are down, rank 0 reads them into host RAM and
writes one npz in the reference's sharded layout (a ``<key>::shard<i>``
entry a shard, the ``"sharded:"`` tag with the global shape, dtype and
each shard's index slices), with the replicated leaves (params,
optimizer state, generator, step) written once, from its own copy.

Under model parallelism (``model_group=`` and ``shard_specs=``, a tree
beside ``tree`` whose spec tuples mark the model-sharded leaves: the
params, their stale copy and the optimizer state's mirrors of them)
both axes are saved gather-free, replicas dropped as the reference
drops them: the store's rows come from the ranks of model rank 0, one
a data rank, and each model-sharded leaf's chunks from the ranks of
data rank 0, one a model rank.  No rank ever builds a whole table or a
whole sharded parameter, and the file restores at any world and any M,
one device included, in either package.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core.weight_store import WeightStore

_BF16_TAG = "bfloat16"
_GEN_TAG = "torch.Generator:"
_SHARD_TAG = "sharded:"
_SHARD_SEP = "::shard"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix.rstrip("/")] = tree
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, manifest tag or "") of one leaf."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy(), _GEN_TAG + leaf.device.type
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16_TAG
        return t.numpy(), ""
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32), ""
    return np.asarray(leaf), ""


def _store_keys(tree: Any, prefix: str = "") -> set[str]:
    """The flat keys of the leaves of every WeightStore in ``tree``: the
    example-axis-sharded leaves of a sharded run's state."""
    if isinstance(tree, WeightStore):
        return set(_flatten(tree, prefix))
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((k, getattr(tree, k)) for k in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return set()
    return {key for k, v in items for key in _store_keys(v, f"{prefix}{k}/")}


def _write_npz(path: Path, stored: dict, manifest: dict, step: int) -> None:
    """``stored`` as an npz at ``path``, written to a temporary file in the
    target directory, then renamed over it: a failed write leaves no file
    at ``path``."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __step__=np.int64(step),
                     __manifest__=np.frombuffer(
                         json.dumps(manifest).encode(), dtype=np.uint8),
                     **stored)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_checkpoint(path: str | Path, tree: Any, step: int,
                    group=None, model_group=None,
                    shard_specs: Any = None) -> Path:
    """Atomic save: the npz is written to a temporary file in the target
    directory, then renamed over ``path``.  With a data ``group`` every
    rank calls it on its own state and the save is gather-free (see the
    module docstring), over the ``model_group`` too when one is given
    with the ``shard_specs`` of the tree's model-sharded leaves; a rank
    that fails makes every rank raise, and no file is left at
    ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if group is not None:
        return _save_sharded(path, tree, step, group, model_group,
                             shard_specs)
    manifest, stored = {}, {}
    for k, leaf in _flatten(tree).items():
        stored[k], tag = _to_numpy(leaf)
        if tag:
            manifest[k] = tag
    _write_npz(path, stored, manifest, step)
    return path


def _part_path(path: Path, rank: int) -> Path:
    return path.parent / f".{path.name}.rank{rank}.part.npz"


def _all_ok(ok: bool, device, group, model_group=None) -> bool:
    """Whether every rank of the world (``group`` by ``model_group``) is
    ok: an all-reduce of the failures over each axis."""
    from repro_torch.core.collectives import model_sum, psum
    failed = torch.tensor([0 if ok else 1], dtype=torch.int32, device=device)
    return int(model_sum(psum(failed, group), model_group).item()) == 0


def _model_dims(tree: Any, specs: Any, prefix: str = "") -> dict[str, int]:
    """{flat key: the model-split dim} of the leaves whose spec in
    ``specs`` (a tree beside ``tree``) splits a dim over ``"model"``."""
    if specs is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix.rstrip("/"): specs.index("model")} \
            if "model" in specs else {}
    if isinstance(tree, dict):
        items = ((k, v, specs[k]) for k, v in tree.items())
    elif hasattr(tree, "_fields"):
        items = ((k, getattr(tree, k), getattr(specs, k))
                 for k in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = ((i, v, sp) for i, (v, sp) in enumerate(zip(tree, specs)))
    else:
        return {}
    return {key: dim for k, v, sp in items
            for key, dim in _model_dims(v, sp, f"{prefix}{k}/").items()}


def _save_sharded(path: Path, tree: Any, step: int, group,
                  model_group=None, shard_specs=None) -> Path:
    """The gather-free save of one rank: the shards it owns to its part
    file with their global slices (its store rows when it is model rank
    0, its chunk of each model-sharded leaf when it is data rank 0),
    then rank 0 merges the parts and the replicated leaves.  Each half
    ends in an all-reduce of the failures, so every rank raises when one
    fails, and the parts are removed either way."""
    flat = _flatten(tree)
    rows_keys = _store_keys(tree)
    model_keys = _model_dims(tree, shard_specs) if model_group else {}
    d, n_data = group.rank, group.size
    m, n_model = (model_group.rank, model_group.size) if model_group \
        else (0, 1)
    world_rank, world = d * n_model + m, n_data * n_model
    device = next(flat[k].device for k in sorted(rows_keys))
    part = _part_path(path, world_rank)

    def slices(k: str) -> list:
        """This rank's shard of leaf k: [[start, stop]] a dim."""
        leaf = flat[k]
        out = [[0, n] for n in leaf.shape]
        if k in rows_keys:
            n = leaf.shape[0]
            out[0] = [d * n, (d + 1) * n]
        else:
            dim, n = model_keys[k], leaf.shape[model_keys[k]]
            out[dim] = [m * n, (m + 1) * n]
        return out

    owned = sorted([k for k in rows_keys if m == 0]
                   + [k for k in model_keys if d == 0])

    def on_every_rank(fn, what: str) -> None:
        err = None
        try:
            fn()
        except Exception as e:          # re-raised below, on every rank
            err = e
        if not _all_ok(err is None, device, group, model_group):
            raise err or RuntimeError(f"gather-free save of {path}: {what} "
                                      f"failed on another rank")

    def write_part():
        with open(part, "wb") as f:
            np.savez(f, **{k: _to_numpy(flat[k])[0] for k in owned},
                     __slices__=np.frombuffer(json.dumps(
                         {k: slices(k) for k in owned}).encode(),
                         dtype=np.uint8))

    def merge():
        if world_rank == 0:
            _merge_parts(path, flat, set(rows_keys) | set(model_keys), step,
                         world)

    try:
        on_every_rank(write_part, "writing a part")
        on_every_rank(merge, "merging the parts")
    finally:
        part.unlink(missing_ok=True)
    return path


def _merge_parts(path: Path, flat: dict, sharded: set, step: int,
                 world: int) -> None:
    """Rank 0's half: the ranks' parts read into host RAM as
    ``<key>::shard<i>`` entries, in rank order, with their manifest
    slices; the replicated leaves from its own state; one atomic npz."""
    manifest, stored = {}, {}
    for k, leaf in flat.items():
        if k not in sharded:
            stored[k], tag = _to_numpy(leaf)
            if tag:
                manifest[k] = tag
    shards: dict[str, list] = {k: [] for k in sharded}
    for r in range(world):
        with np.load(_part_path(path, r), allow_pickle=False) as z:
            part_slices = json.loads(bytes(z["__slices__"].tobytes())
                                     .decode())
            for k, sl in part_slices.items():
                shards[k].append((z[k], sl))
    for k in sorted(sharded):
        leaf = flat[k]
        parts = shards[k]
        for i, (arr, _) in enumerate(parts):
            stored[f"{k}{_SHARD_SEP}{i}"] = arr
        manifest[k] = _SHARD_TAG + json.dumps({
            "shape": [max(sl[j][1] for _, sl in parts)
                      for j in range(leaf.dim())],
            "dtype": (_BF16_TAG if leaf.dtype == torch.bfloat16
                      else str(parts[0][0].dtype)),
            "slices": [sl for _, sl in parts]})
    _write_npz(path, stored, manifest, step)


def _reassemble_sharded(meta: dict, shards: dict) -> tuple[np.ndarray, str]:
    """One array (and its tag) from its per-shard entries and manifest
    slices; bf16 stays as its uint16 bits."""
    bf16 = meta["dtype"] == _BF16_TAG
    out = np.empty(tuple(meta["shape"]),
                   np.uint16 if bf16 else np.dtype(meta["dtype"]))
    for i, idx in enumerate(meta["slices"]):
        out[tuple(slice(a, b) for a, b in idx)] = shards[i]
    return out, _BF16_TAG if bf16 else ""


def _from_numpy(arr: np.ndarray, tag: str, template):
    """The stored leaf rebuilt in the template's kind, device and dtype."""
    if isinstance(template, torch.Generator):
        if tag != _GEN_TAG + template.device.type:
            return template  # a reference PRNG key, or another device's
        gen = torch.Generator(device=template.device)
        gen.set_state(torch.from_numpy(arr.copy()))
        return gen
    if tag.startswith(_GEN_TAG):
        return template
    if isinstance(template, int):  # a host int: the port's step
        return type(template)(arr)
    if tag == _BF16_TAG:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(template, torch.Tensor):
        return t.to(device=template.device, dtype=template.dtype)
    return t


def _unflatten_into(template: Any, flat: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*[
            _unflatten_into(getattr(template, k), flat, f"{prefix}{k}/")
            for k in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(
            _unflatten_into(v, flat, f"{prefix}{i}/")
            for i, v in enumerate(template))
    key = prefix.rstrip("/")
    if template is None or key not in flat:
        return template  # anything missing keeps its current value
    return _from_numpy(*flat[key], template)


def restore_checkpoint(path: str | Path, template: Any) -> tuple[Any, int]:
    """Restore into the structure of ``template``: (tree, step)."""
    with np.load(path, allow_pickle=False) as z:
        step = int(z["__step__"])
        manifest = json.loads(bytes(z["__manifest__"].tobytes()).decode())
        flat: dict[str, tuple[np.ndarray, str]] = {}
        shard_parts: dict[str, dict] = {}
        for k in z.files:
            if k.startswith("__"):
                continue
            if _SHARD_SEP in k:
                base, _, i = k.rpartition(_SHARD_SEP)
                shard_parts.setdefault(base, {})[int(i)] = z[k]
                continue
            flat[k] = (z[k], manifest.get(k, ""))
        for base, parts in shard_parts.items():
            meta = json.loads(manifest[base][len(_SHARD_TAG):])
            flat[base] = _reassemble_sharded(meta, parts)
    return _unflatten_into(template, flat), step
