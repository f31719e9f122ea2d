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
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

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


def save_checkpoint(path: str | Path, tree: Any, step: int) -> Path:
    """Atomic save: the npz is written to a temporary file in the target
    directory, then renamed over ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    manifest, stored = {}, {}
    for k, leaf in _flatten(tree).items():
        stored[k], tag = _to_numpy(leaf)
        if tag:
            manifest[k] = tag
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
    return path


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
