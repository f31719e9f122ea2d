"""The dry run's input shapes and one rank's inputs and state on an (N, M)
world (the port's counterpart of ``src/repro/launch/shapes.py``).

``SHAPES``, ``LONG_CONTEXT_WINDOW`` and ``arch_for_shape`` are the
reference's.  Where the reference builds ``ShapeDtypeStruct``s with the
``NamedSharding``s of the whole mesh, and leaves it to XLA to partition,
the port builds the tensors one rank of an (N, M) world holds, by its
own rules (``launch/mesh.py``: rank r = d·M + m), usually under
``FakeTensorMode``, where they have shapes and dtypes but no storage:

  * params: the logical→mesh rules of ``dist/sharding.py`` (whole heads,
    ffn and channel blocks, vocab-parallel embeddings), with one rule of
    the dry run's own: a mixer whose heads (GQA: heads and KV heads; MLA:
    heads) or whose d_inner (mamba) M does not divide is replicated over
    the model group, where the trainer refuses the degree.  The models
    read their shardedness from the local shapes, so such a layer runs
    whole on every model rank;
  * the weight store and the dataset: the data group's contiguous block
    of the example axis (``core/distributed.py``);
  * the decode caches: ``decode_cache_specs`` with the same replication
    (``replicate=True``), the batch split over the data group where N
    divides it (else every data rank holds it whole: long_500k's one
    sequence).

The reference's ``serve_cache_specs`` instead shards a cache's W axis over
``model`` (over the whole mesh for one sequence) and lets XLA partition
the attention; the port's decode attention splits heads, not slots
(``serving/sharded_decode.py::sharded_decode_attention`` is the
sequence-split kernel, and the engine does not use it), so the dry run
does not emulate that layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.dist import DataGroup
from repro_torch.dist.sharding import mesh_shape, param_pspecs, shard_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1),
}

# the window a pure-attention arch runs the long-context shape with
LONG_CONTEXT_WINDOW = 8_192


def arch_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """The reference's per-shape config: the chunked LM head for the
    training shapes, sliding-window attention for long_500k on the
    pure-attention archs."""
    if shape.kind == "train" and cfg.loss_chunk == 0:
        cfg = dataclasses.replace(cfg, loss_chunk=512)
    if (shape.name == "long_500k" and cfg.ssm_state == 0
            and cfg.sliding_window == 0):
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def local_rows(total: int, group: Optional[DataGroup]) -> int:
    """The rows of ``total`` a data rank holds: a contiguous 1/N block
    where N divides them, else all of them."""
    n = 1 if group is None else group.size
    return total // n if total % n == 0 else total


def _splits(cfg: ModelConfig, m: int, mixer: str) -> bool:
    """Whether M splits a layer of ``mixer`` whole."""
    if mixer == "mamba":
        return cfg.resolved_d_inner % m == 0
    if cfg.attention == "mla":
        return cfg.num_heads % m == 0
    return cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0


def _replicated(specs):
    if isinstance(specs, dict):
        return {k: _replicated(v) for k, v in specs.items()}
    return tuple(None for _ in specs)


def rank_param_specs(cfg: ModelConfig, params, n: int, m: int):
    """The spec tree of ``params`` (the whole tree) on an (n, m) world:
    ``dist/sharding.py``'s rules, with every mixer M cannot split whole
    replicated (module docstring)."""
    from repro_torch.models.transformer import transformer_specs
    specs = param_pspecs(transformer_specs(cfg), params, mesh_shape(n, m))
    layers = specs["layers"]
    for i, spec in enumerate(cfg.layer_specs()):
        if not _splits(cfg, m, spec.mixer):
            layers[f"l{i}"]["mixer"] = _replicated(layers[f"l{i}"]["mixer"])
    return specs


def rank_params(cfg: ModelConfig, group: Optional[DataGroup],
                model_group: Optional[DataGroup], seed: int = 0,
                device="cpu"):
    """(this rank's params, the spec tree): the whole tree initialised
    from ``seed`` and this model rank's shards kept.  Under
    ``FakeTensorMode`` nothing is allocated."""
    from repro_torch.models.transformer import init_transformer
    params = init_transformer(torch.Generator().manual_seed(seed), cfg,
                              device)
    if model_group is None:
        return params, None
    n = 1 if group is None else group.size
    specs = rank_param_specs(cfg, params, n, model_group.size)
    return shard_tree(params, specs, model_group.rank,
                      model_group.size), specs


def train_data(cfg: ModelConfig, shape: InputShape, num_examples: int,
               group: Optional[DataGroup], device="cpu") -> dict:
    """This rank's rows of the dataset: tokens (rows, S_text + 1) and, for
    a frontend arch, its embeds (rows, N_front, D)."""
    rows = local_rows(num_examples, group)
    s_text = shape.seq_len - cfg.num_frontend_tokens
    data = {"tokens": torch.zeros((rows, s_text + 1), dtype=torch.int32,
                                  device=device)}
    if cfg.frontend != "none":
        data["embeds"] = torch.zeros(
            (rows, cfg.num_frontend_tokens, cfg.d_model),
            dtype=dtype_of(cfg), device=device)
    return data


def decode_caches(cfg: ModelConfig, shape: InputShape,
                  group: Optional[DataGroup],
                  model_group: Optional[DataGroup], device="cpu"):
    """This rank's ServeState: its local caches (``decode_cache_specs``
    with the dry run's replication) for its rows of the batch, at
    ``max_len`` = the shape's sequence length."""
    from repro_torch.serving.engine import ServeState, cache_shapes
    from repro_torch.serving.sharded_decode import (decode_cache_specs,
                                                    local_shape)
    b = local_rows(shape.global_batch, group)
    m = 1 if model_group is None else model_group.size
    specs = decode_cache_specs(cfg, model_group, replicate=True)
    caches = {k: torch.zeros(local_shape(s, specs[k], m), dtype=dt,
                             device=device)
              for k, (s, dt) in cache_shapes(cfg, b, shape.seq_len).items()}
    return ServeState(caches=caches,
                      lengths=torch.full((b,), shape.seq_len - 1,
                                         dtype=torch.int32, device=device))


def prefill_inputs(cfg: ModelConfig, shape: InputShape,
                   group: Optional[DataGroup], device="cpu"):
    """This rank's prompt tokens (rows, S_text) and frontend embeds (or
    None)."""
    b = local_rows(shape.global_batch, group)
    s_text = shape.seq_len - cfg.num_frontend_tokens
    toks = torch.zeros((b, s_text), dtype=torch.int32, device=device)
    emb = None
    if cfg.frontend != "none":
        emb = torch.zeros((b, cfg.num_frontend_tokens, cfg.d_model),
                          dtype=dtype_of(cfg), device=device)
    return toks, emb


__all__ = ["InputShape", "LONG_CONTEXT_WINDOW", "SHAPES", "arch_for_shape",
           "decode_caches", "local_rows", "prefill_inputs",
           "rank_param_specs", "rank_params", "train_data"]
