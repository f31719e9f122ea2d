"""The paper's own model: a permutation-invariant MLP classifier
(4 hidden layers × 2048 units, ReLU, softmax) — section 5.1.

Parameters are a dict ``{"fc{i}": {"w": (din, dout), "b": (dout,)}}`` in
the JAX reference's layout, so ``layers.params_from_jax`` is a plain
copy and parity tests compare like with like.

Model parallelism (``model_group``, the reference's ``model_axes``):
each layer whose width the model group divides is column-sharded
(``mlp_specs``: w ("embed", "ffn"), b ("ffn",)); a layer whose width it
does not divide stays replicated (``dist/sharding.py``'s fallback), so
shardedness is a layer's, read from its weight's width
(``layer_is_sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.collectives import all_gather_replicated, psum_backward
from repro_torch.dist import DataGroup
from repro_torch.models.layers import Params, Tape


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str = "mlp_svhn"
    arch_type: str = "mlp"
    input_dim: int = 3072           # 32x32x3, flattened (permutation-invariant)
    num_classes: int = 10
    hidden: tuple = (2048, 2048, 2048, 2048)
    dtype: str = "float32"


def mlp_dims(cfg: MLPConfig) -> tuple:
    return (cfg.input_dim, *cfg.hidden, cfg.num_classes)


def mlp_specs(cfg: MLPConfig) -> Params:
    """The logical axes of every parameter (``dist/sharding.py``)."""
    n = len(cfg.hidden) + 1
    return {f"fc{i}": {"w": ("embed", "ffn"), "b": ("ffn",)}
            for i in range(n)}


def layer_is_sharded(params: Params, cfg: MLPConfig, i: int) -> bool:
    """Whether layer i's weight is a column shard: its width is narrower
    than the config's."""
    return params[f"fc{i}"]["w"].shape[-1] != mlp_dims(cfg)[i + 1]


def init_mlp_classifier(generator: torch.Generator, cfg: MLPConfig,
                        device: torch.device | str) -> Params:
    """He-normal weights drawn from ``generator`` (on its own device), zero
    biases, placed on ``device``."""
    dims = mlp_dims(cfg)
    dtype = getattr(torch, cfg.dtype)
    params = {}
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=generator,
                        device=generator.device, dtype=torch.float32)
        params[f"fc{i}"] = {
            "w": (w * (2.0 / dims[i]) ** 0.5).to(device=device, dtype=dtype),
            "b": torch.zeros(dims[i + 1], device=device, dtype=dtype),
        }
    return params


def _matmul_rows(h: torch.Tensor, w: torch.Tensor,
                 row_block: int) -> torch.Tensor:
    """``h @ w``, one GEMM per ``row_block`` rows when ``row_block`` is
    set: cuBLAS picks its kernel by the row count, so a row's bits then
    do not depend on how many blocks share the batch (and the backward's
    GEMMs are per block too)."""
    if not row_block or h.shape[0] <= row_block:
        return h @ w
    return torch.cat([h[i:i + row_block] @ w
                      for i in range(0, h.shape[0], row_block)])


def mlp_forward(params: Params, x: torch.Tensor, cfg: MLPConfig,
                tape: Optional[Tape] = None, row_block: int = 0,
                model_group: Optional[DataGroup] = None) -> torch.Tensor:
    """x: (B, input_dim) → logits (B, num_classes); with ``row_block``
    each linear multiplies that many rows at a time.

    With a ``model_group`` each column-sharded layer runs Megatron-style:
    ``psum_backward`` on the replicated input, the local columns'
    matmul, ``all_gather_replicated`` of the local output slice.  The
    tap sits on the local slice, so a layer's ghost term is a partial
    sum over the group that the scorer sums.  A replicated layer takes
    none of the three."""
    n = len(cfg.hidden) + 1
    h = x
    for i in range(n):
        p = params[f"fc{i}"]
        sharded = model_group is not None and layer_is_sharded(params, cfg,
                                                               i)
        if sharded:
            h = psum_backward(h, model_group)
        y = _matmul_rows(h, p["w"], row_block) + p["b"]
        if tape is not None:
            y = tape.linear(f"fc{i}", h, y)
        if sharded:
            y = all_gather_replicated(y, model_group, dim=-1)
        h = torch.relu(y) if i < n - 1 else y
    return h


def per_example_loss(params: Params, batch: dict, cfg: MLPConfig,
                     tape: Optional[Tape] = None, row_block: int = 0,
                     model_group: Optional[DataGroup] = None
                     ) -> torch.Tensor:
    """Cross-entropy per example. batch: {x (B,D), y (B,)}."""
    logits = mlp_forward(params, batch["x"], cfg, tape, row_block,
                         model_group=model_group)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, 1, batch["y"].long()[:, None])[:, 0]


def per_example_loss_and_score(params: Params, batch: dict, cfg: MLPConfig,
                               model_group: Optional[DataGroup] = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused-mode objective: (CE losses, logit-grad norms) from one
    forward; the score ||p − onehot||₂ is closed-form from the gathered
    logits, the same on every rank of a model group."""
    logits = mlp_forward(params, batch["x"], cfg, model_group=model_group)
    lp = torch.log_softmax(logits.float(), dim=-1)
    y = batch["y"].long()[:, None]
    nll = -torch.gather(lp, 1, y)[:, 0]
    p = torch.exp(lp)
    p_y = torch.gather(p, 1, y)[:, 0]
    score = torch.sqrt(torch.sum(torch.square(p), -1) - 2.0 * p_y + 1.0)
    return nll, score


def accuracy(params: Params, batch: dict, cfg: MLPConfig) -> torch.Tensor:
    logits = mlp_forward(params, batch["x"], cfg)
    return (torch.argmax(logits, -1) == batch["y"]).float().mean()
