"""The sharded ISSGD step: the paper's system shape over a data group
(``src/repro/core/distributed.py``).

  * the dataset and the WeightStore (``weights``, ``scored_at``, an int8
    table's scales) are sharded over the group's ranks in contiguous
    blocks of the example axis, one rank a device;
  * each rank scores the round-robin slices of the logical scoring
    shards it owns, the paper's worker fan-out, with no communication;
  * the draw is the hierarchical two-stage draw (W shard totals shared by
    one all-reduce of W floats, each draw resolved by the rank that owns
    its shard, one all-reduce of the B indices), so no rank ever holds
    the f32[N] table: a step moves W floats, B indices and the B sampled
    proposal weights and minibatch rows, the paper's "one float per
    sample instead of gradients";
  * parameters stay replicated and every rank computes the same master
    update on the same gathered minibatch; with ``split_batch`` (off by
    default, as the reference's ``constrain_batch``) each rank takes its
    block of the minibatch through the loss and the backward and the
    gradients are summed over the group (``issgd.make_master_pass``).

A rank runs the one-code-path step of ``core/issgd.py`` with the group
(``make_train_step(..., group=...)``) on the state ``shard_train_state``
gives it and the rows ``shard_dataset`` gives it.  The planes run over
the group too: ``make_sharded_async_steps`` gives the async pipeline's
two steps (``core/async_pipeline.py``; the store double-buffered by
rows), ``make_sharded_streamed_steps`` the streamed step's three
(``data/streaming.py``; a rank's host store holds only its own chunks,
and the minibatch rows come through one one-owner all-reduce).
``launch/train.py --mesh N`` spawns the ranks (``launch/mesh.py``).
With ``group=None`` every factory here gives the one-device step, so
the launcher makes one call a path whatever the world.

Model parallelism (``--model-parallel M``): each factory also takes a
model group and the parameters' spec tree (``resolve_param_specs``, the
reference's ``_resolve_param_specs``/``opt_state_pspecs``), and
``shard_train_state`` keeps this rank's column or row shard of every
sharded parameter, of its stale copy and of its optimizer state; the
store stays sharded over the data group alone, the same on the M ranks
that share a data rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.issgd import (ISSGDConfig, TrainState,
                                    make_score_step, make_train_step)
from repro_torch.core.weight_store import BufferedWeightStore, WeightStore
from repro_torch.dist import DataGroup, axis_info
from repro_torch.dist.sharding import (mesh_shape, opt_state_pspecs,
                                       param_pspecs, shard_tree)
from repro_torch.optim import tree_leaves


def resolve_param_specs(logical_specs, params,
                        model_group: Optional[DataGroup],
                        n_data: int = 1):
    """The spec tree of ``params`` (the whole, unsharded tree) under the
    ``(data, model)`` mesh of this world, or None without a model group
    (M = 1: every parameter replicated, today's run)."""
    if model_group is None or logical_specs is None:
        return None
    return param_pspecs(logical_specs, params,
                        mesh_shape(n_data, model_group.size))


def resolve_score_shards(cfg: ISSGDConfig,
                         group: Optional[DataGroup]) -> ISSGDConfig:
    """W defaults to the number of ranks when the config leaves it at 1,
    and must be a multiple of it."""
    _, nd = axis_info(group)
    w = cfg.score_shards
    if w <= 1:
        return dataclasses.replace(cfg, score_shards=nd)
    if w % nd:
        raise ValueError(f"score_shards={w} must be a multiple of the "
                         f"data-axis device count {nd}")
    return cfg


def _check_rows(num_examples: int, group: Optional[DataGroup]) -> int:
    _, nd = axis_info(group)
    if num_examples % nd:
        raise ValueError(f"num_examples={num_examples} not divisible by "
                         f"{nd} devices")
    return num_examples // nd


def _rows(x: torch.Tensor, group: Optional[DataGroup],
          device) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis, as its own
    tensor on ``device``."""
    rank, nd = axis_info(group)
    n_local = x.shape[0] // nd
    return x[rank * n_local:(rank + 1) * n_local].to(device).clone()


def shard_store(store: WeightStore, group: Optional[DataGroup],
                device) -> WeightStore:
    """This rank's rows of a whole store: ``weights`` and ``scored_at``,
    and an int8 table's scales of the chunks in those rows (the chunk
    size must divide the rows a rank holds)."""
    _, nd = axis_info(group)
    n = store.weights.shape[0]
    _check_rows(n, group)
    if store.qscale is not None and store.qscale.shape[0] % nd:
        raise ValueError(f"int8 table of {store.qscale.shape[0]} chunks "
                         f"does not split over {nd} devices: the chunk "
                         f"size must divide the per-shard rows ({n // nd})")
    return WeightStore(
        weights=_rows(store.weights, group, device),
        scored_at=_rows(store.scored_at, group, device),
        qscale=(None if store.qscale is None
                else _rows(store.qscale, group, device)))


def train_state_specs(state: TrainState, param_specs) -> TrainState:
    """The spec tree beside a TrainState: the params' specs on the params
    and their stale copy, ``opt_state_pspecs`` on the optimizer state,
    None (replicated, or sharded over the data group) elsewhere; the
    gather-free save reads the model-sharded leaves from it."""
    return TrainState(
        params=param_specs,
        opt_state=opt_state_pspecs(state.opt_state, state.params,
                                   param_specs),
        stale_params=param_specs, store=None, step=None, rng=None)


def shard_train_state(state: TrainState, group: Optional[DataGroup],
                      device=None, param_specs=None,
                      model_group: Optional[DataGroup] = None
                      ) -> TrainState:
    """A rank's TrainState from a whole one (built or restored on the
    host): its rows of the store on ``device`` (default: the params'),
    of both buffers of a BufferedWeightStore (``synced_at`` as it is);
    params, optimizer state and stale params as they are (replicated),
    or, with a ``model_group`` and ``param_specs``, this model rank's
    shard of each sharded leaf (an optimizer state's subtrees that mirror
    the params take their specs)."""
    if device is None:
        device = tree_leaves(state.params)[0].device
    if model_group is not None and param_specs is not None:
        m, size = model_group.rank, model_group.size
        op = opt_state_pspecs(state.opt_state, state.params, param_specs)
        state = state._replace(
            params=shard_tree(state.params, param_specs, m, size),
            stale_params=shard_tree(state.stale_params, param_specs, m,
                                    size),
            opt_state=shard_tree(state.opt_state, op, m, size))
    store = state.store
    if isinstance(store, BufferedWeightStore):
        return state._replace(store=BufferedWeightStore(
            shard_store(store.read_buf, group, device),
            shard_store(store.write_buf, group, device), store.synced_at))
    return state._replace(store=shard_store(store, group, device))


def shard_dataset(data: dict, group: Optional[DataGroup],
                  device=None) -> dict:
    """This rank's contiguous rows of every dataset tensor (on ``device``,
    default each tensor's own); for one device and no ``device``,
    ``data`` itself."""
    if group is None and device is None:
        return data
    n = next(iter(data.values())).shape[0]
    _check_rows(n, group)
    return {k: _rows(v, group, v.device if device is None else device)
            for k, v in data.items()}


def make_sharded_train_step(per_example_loss: Callable, scorer: Callable,
                            optimizer, cfg: ISSGDConfig, num_examples: int,
                            group: Optional[DataGroup],
                            aux_loss: Optional[Callable] = None,
                            fused_score: Optional[Callable] = None,
                            monitors=None, gated: bool = False,
                            model_group: Optional[DataGroup] = None,
                            param_specs=None, split_batch: bool = False
                            ) -> tuple[Callable, ISSGDConfig]:
    """(step, cfg): the ISSGD step over ``group``, ``step(state, data[,
    use_is]) -> (state, metrics[, monitors])`` on the rank's state and
    rows (``shard_train_state``, ``shard_dataset``), and the config with
    W resolved against the group.  Every rank calls it with the same
    arguments in the same order; the metrics and monitors come out the
    same on every rank.  A ``model_group`` and ``param_specs`` make it
    the model-parallel step, ``split_batch`` the batch-split master
    (``issgd.make_master_pass``)."""
    cfg = resolve_score_shards(cfg, group)
    _check_rows(num_examples, group)
    step = make_train_step(per_example_loss, scorer, optimizer, cfg,
                           num_examples, aux_loss=aux_loss,
                           fused_score=fused_score, monitors=monitors,
                           gated=gated, group=group,
                           model_group=model_group, param_specs=param_specs,
                           split_batch=split_batch)
    return step, cfg


def make_sharded_score_step(scorer: Callable, cfg: ISSGDConfig,
                            num_examples: int,
                            group: Optional[DataGroup]) -> Callable:
    """Fused mode's probe over ``group``: each rank rescores its shards'
    round-robin slices, with no collective."""
    cfg = resolve_score_shards(cfg, group)
    _check_rows(num_examples, group)
    return make_score_step(scorer, cfg, num_examples, group=group)


def make_sharded_async_steps(per_example_loss: Callable, scorer: Callable,
                             optimizer, cfg: ISSGDConfig, num_examples: int,
                             group: Optional[DataGroup],
                             aux_loss: Optional[Callable] = None,
                             monitor_traces: bool = True, monitors=None,
                             gated: bool = False,
                             model_group: Optional[DataGroup] = None,
                             param_specs=None, split_batch: bool = False
                             ) -> tuple[Callable, Callable, ISSGDConfig]:
    """(scoring_step, master_step, cfg): the async pipeline's two steps
    over ``group`` (``async_pipeline.make_async_steps(..., group=)``),
    for ``AsyncPipeline``, and the config with W resolved.  The scoring
    step writes the rank's rows of ``write_buf`` with no collective (with
    ``monitor_traces``, its trace sums are summed by the pipeline on the
    current stream); the master draws from the rank's rows of
    ``read_buf`` with the hierarchical draw (split over the group with
    ``split_batch``)."""
    from repro_torch.core.async_pipeline import make_async_steps
    cfg = resolve_score_shards(cfg, group)
    _check_rows(num_examples, group)
    scoring_step, master_step = make_async_steps(
        per_example_loss, scorer, optimizer, cfg, num_examples,
        aux_loss=aux_loss, monitor_traces=monitor_traces,
        monitors=monitors, gated=gated, group=group,
        model_group=model_group, param_specs=param_specs,
        split_batch=split_batch)
    return scoring_step, master_step, cfg


def make_sharded_streamed_steps(per_example_loss: Callable,
                                scorer: Callable, optimizer,
                                cfg: ISSGDConfig, num_examples: int,
                                group: Optional[DataGroup], chunk_size: int,
                                aux_loss: Optional[Callable] = None,
                                fused_score: Optional[Callable] = None,
                                async_mode: bool = False,
                                monitor_traces: bool = True, monitors=None,
                                gated: bool = False,
                                model_group: Optional[DataGroup] = None,
                                param_specs=None, split_batch: bool = False
                                ) -> tuple[Callable, Callable, Callable,
                                           ISSGDConfig]:
    """(scoring_step, sample_step, master_step, cfg): the streamed step's
    three computations over ``group`` (``streaming.make_streamed_steps(
    ..., group=)``), for ``StreamedISSGD`` over a plane of the same
    group, and the config with W resolved.  The scoring step takes the
    rows of the rank's own shards' slices; the sample step draws the
    replicated indices and sums the rank's rows into its chunks' masses
    (no collective for them); the master takes the replicated
    minibatch rows (and its block of them with ``split_batch``)."""
    from repro_torch.data.streaming import make_streamed_steps
    cfg = resolve_score_shards(cfg, group)
    n_local = _check_rows(num_examples, group)
    if n_local % chunk_size:
        raise ValueError(f"chunk_size={chunk_size} must divide the "
                         f"per-rank rows ({n_local}): a chunk may not "
                         f"straddle ranks")
    steps = make_streamed_steps(
        per_example_loss, scorer, optimizer, cfg, num_examples, chunk_size,
        aux_loss=aux_loss, fused_score=fused_score, async_mode=async_mode,
        monitor_traces=monitor_traces, monitors=monitors, gated=gated,
        group=group, model_group=model_group, param_specs=param_specs,
        split_batch=split_batch)
    return (*steps, cfg)
