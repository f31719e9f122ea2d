"""One rank of a (data, model) gloo world for
``tests/test_torch_model_parallel.py``.

Run as a script, one process a rank:

    python tests/_torch_model_parallel_rank.py RANK N M PORT PLAN OUT_DIR

It joins a world of N·M ranks through ``launch/mesh.py`` (its data group
and its model group), scores the plan's batches with the model-parallel
scorers, runs every step case of the plan on its shards of the
parameters with the master's draws injected (the reference's, or the
one-device run's), records one step's
model-axis messages and scorer calls, at (1, 2) a pass of two LMs with
remat off and on, and (the world of the plan's ``checkpoint_world``)
saves its relaxed MLP state gather-free.  With RANK
``one`` (and N, M, PORT ignored) it runs the same cases on one device,
the runs the worlds are held to within the port, and writes the draws of
the cases the reference does not run to ``OUT_DIR/../one_draws.pt``.
The reference's draws come from ``OUT_DIR/../reference.pt``, which the
test writes while the ranks run.  What a rank saw goes to ``OUT_DIR/rank<RANK>.pt``.  It
imports only the port.
"""
import dataclasses
import os
import sys
import time
import warnings

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import collectives
from repro_torch.core import distributed as D
from repro_torch.core import issgd
from repro_torch.core.async_pipeline import AsyncPipeline
from repro_torch.core.importance import ISConfig
from repro_torch.core.scorer import make_lm_scorer, make_mlp_scorer
from repro_torch.core.weight_store import to_buffered
from repro_torch.data.store import ChunkedExampleStore
from repro_torch.data.streaming import StreamedISSGD, StreamingDataPlane
from repro_torch.dist import axis_info
from repro_torch.dist.sharding import shard_tree
from repro_torch.kernels import ops
from repro_torch.launch import mesh
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttf
from repro_torch.optim import sgd, tree_leaves, tree_map

# step cases: name → (model, ISSGDConfig overrides, driver, sequence
# parallel); the MLP and the dense LM in every mode, the other families
# relaxed, the hybrid without sequence parallelism
CASES = {
    "mlp/relaxed": ("mlp", {}, "sync", False),
    "mlp/fused": ("mlp", {"mode": "fused"}, "sync", False),
    "mlp/async": ("mlp", {}, "async", False),
    "mlp/stream": ("mlp", {}, "stream", False),
    "glm4/relaxed": ("glm4", {}, "sync", True),
    "glm4/fused": ("glm4", {"mode": "fused"}, "sync", True),
    "glm4/async": ("glm4", {}, "async", True),
    "glm4/stream": ("glm4", {}, "stream", True),
    "moe/relaxed": ("moe", {}, "sync", True),
    "mla/relaxed": ("mla", {}, "sync", True),
    "ssm/relaxed": ("ssm", {}, "sync", True),
    "hybrid/relaxed": ("hybrid", {}, "sync", False),
}
# the cases whose draws are the reference's; the others take the
# one-device run's own (``OUT_DIR/../one_draws.pt``)
REFERENCE_CASES = ("mlp/relaxed", "mlp/fused", "mlp/async", "mlp/stream",
                   "glm4/relaxed")
# the models whose remat on and off the world (1, 2) compares
REMAT_MODELS = ("glm4", "hybrid")
REMAT_WORLD = (1, 2)
SWAP = 2
WINDOW = 2
WAIT_S = 240


def models_for(m_size: int) -> tuple:
    """The models a model group of ``m_size`` ranks can split: every LM
    smoke config has 2 kv heads, so M = 4 runs the MLP and the mamba LM."""
    if m_size <= 2:
        return ("mlp", "glm4", "moe", "mla", "ssm", "hybrid")
    return ("mlp", "ssm")


def _metrics(m) -> dict:
    return {k: getattr(m, k).detach().clone()
            for k in ("loss", "grad_norm", "mean_weight", "sample_indices")}


def _logical(spec):
    cfg = spec["cfg"]
    return (tmlp.mlp_specs(cfg) if spec["kind"] == "mlp"
            else ttf.transformer_specs(cfg))


def _parts(spec, mg, sp: bool, row_block: int):
    """(per-example loss, ghost scorer, fused objective) of a model on a
    model group's shards, as the launcher builds them."""
    cfg = spec["cfg"]
    if spec["kind"] == "mlp":
        return (lambda p, b: tmlp.per_example_loss(p, b, cfg,
                                                   model_group=mg),
                make_mlp_scorer(cfg, "ghost", row_block=row_block,
                                model_group=mg),
                lambda p, b: tmlp.per_example_loss_and_score(
                    p, b, cfg, model_group=mg))
    kw = dict(model_group=mg, seq_shard=sp)
    return (lambda p, b: ttf.per_example_loss(p, cfg, b, **kw)[0],
            make_lm_scorer(cfg, "ghost", row_block=row_block, **kw),
            lambda p, b: ttf.per_example_loss_and_score(p, cfg, b, **kw))


def optimizer(spec):
    """SGD with momentum for the MLP (so that a rank holds an optimizer
    state's shards too), plain SGD for the LMs."""
    return sgd(0.05, momentum=0.9 if spec["kind"] == "mlp" else 0.0)


def _inject(driver, indices) -> None:
    """The master of ``driver`` trains on ``indices[t]`` at step t."""
    if isinstance(driver, StreamedISSGD):
        sample = driver._sample

        def injected(store, step, generator, *gate):
            _, mass = sample(store, step, generator, *gate)
            return indices[int(step)], mass
        driver._sample = injected
    else:
        master = driver._master
        driver._master = lambda *a: master(
            *a, sample_indices=indices[int(a[4])])


def build(plan, case, group, mg, indices):
    """(step function, the rank's state, the rank's data): the case's
    driver on this rank's shards, the master on ``indices``."""
    model, overrides, pipe, sp = CASES[case]
    spec = plan["models"][model]
    kw = dict(spec["step"], **overrides)
    tcfg = issgd.ISSGDConfig(is_cfg=ISConfig(smoothing=0.1), **kw)
    n_data = axis_info(group)[1]
    # one logical shard's slice a scorer call, as the launcher scores
    # when W > 1: an MoE layer's capacity then does not depend on the
    # number of data ranks
    pel, scorer, fused = _parts(spec, mg, sp,
                                kw["score_batch_size"] // kw["score_shards"])
    opt = optimizer(spec)
    n = spec["n"]
    specs = D.resolve_param_specs(_logical(spec), spec["params"], mg,
                                  n_data)
    mp = dict(model_group=mg, param_specs=specs)
    state = issgd.init_train_state(spec["params"], opt, n, "cpu", seed=3)
    data = None
    if pipe == "sync":
        step, tcfg = D.make_sharded_train_step(
            pel, scorer, opt, tcfg, n, group,
            fused_score=fused if tcfg.mode == "fused" else None, **mp)
        data = D.shard_dataset(spec["data"], group, "cpu")

        def run(st, t):
            return step(st, data, sample_indices=None if indices is None
                        else indices[t])
    elif pipe == "async":
        *steps, tcfg = D.make_sharded_async_steps(pel, scorer, opt, tcfg, n,
                                                  group, **mp)
        driver = AsyncPipeline(*steps, SWAP)
        if indices is not None:
            _inject(driver, indices)
        data = D.shard_dataset(spec["data"], group, "cpu")
        state = state._replace(store=to_buffered(state.store))

        def run(st, t):
            return driver.step(st, data)
    else:
        chunk = spec["chunk"]
        store = ChunkedExampleStore.from_arrays(spec["data"], chunk,
                                                shard=axis_info(group))
        plane = StreamingDataPlane(store, WINDOW, device="cpu", group=group)
        *steps, tcfg = D.make_sharded_streamed_steps(
            pel, scorer, opt, tcfg, n, group, chunk, **mp)
        driver = StreamedISSGD(plane, *steps, tcfg, n)
        if indices is not None:
            _inject(driver, indices)

        def run(st, t):
            return driver.step(st)
    state = D.shard_train_state(state, group, "cpu", param_specs=specs,
                                model_group=mg)
    return run, state, specs


def run_case(plan, case, group, mg, indices, steps=None) -> dict:
    """The case's steps on ``indices`` (on its own draws when None, for
    ``steps`` steps)."""
    run, state, specs = build(plan, case, group, mg, indices)
    rec = []
    for t in range(len(indices) if indices is not None else steps):
        state, m = run(state, t)
        rec.append(_metrics(m))
    return {"steps": rec, "params": state.params, "opt": state.opt_state,
            "stale": state.stale_params, "store": state.store,
            "specs": specs}


def scores_case(plan, mg) -> dict:
    """ω̃ of each scorer of the plan on its batch, on this rank's shards."""
    out = {}
    for name, (model, kw) in plan["scorers"].items():
        spec = plan["models"][model]
        if model not in models_for(axis_info(mg)[1]):
            continue
        specs = D.resolve_param_specs(_logical(spec), spec["params"], mg)
        params = (spec["params"] if specs is None else
                  shard_tree(spec["params"], specs, *axis_info(mg)))
        if spec["kind"] == "mlp":
            scorer = make_mlp_scorer(spec["cfg"], model_group=mg, **kw)
        else:
            scorer = make_lm_scorer(spec["cfg"], model_group=mg,
                                    seq_shard=mg is not None, **kw)
        out[name] = scorer(params, plan["batches"][model]).detach()
    return out


class _Counting:
    """Counts the scorer's sq-norm calls (single- and multi-tap)."""

    def __init__(self):
        self.calls = {"per_example_sqnorm": 0, "per_example_sqnorm_multi": 0}
        self._orig = {k: getattr(ops, k) for k in self.calls}

    def __enter__(self):
        for k, fn in self._orig.items():
            def counted(*a, _k=k, _fn=fn, **kw):
                self.calls[_k] += 1
                return _fn(*a, **kw)
            setattr(ops, k, counted)
        return self

    def __exit__(self, *exc):
        for k, fn in self._orig.items():
            setattr(ops, k, fn)


def traffic_case(plan, group, mg) -> dict:
    """One recorded MLP relaxed step: its model-axis messages' shapes, the
    COUNTS it moved, its sq-norm calls; the fallback warnings the spec
    resolution gave; the shapes of the rank's shards."""
    import torch.distributed as dist
    spec = plan["models"]["mlp"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        D.resolve_param_specs(_logical(spec), spec["params"], mg,
                              axis_info(group)[1])
        D.resolve_param_specs(_logical(spec), spec["params"], mg,
                              axis_info(group)[1])
    run, state, _ = build(plan, "mlp/relaxed", group, mg,
                          plan["indices"]["mlp/traffic"])
    state, _ = run(state, 0)
    shapes = []
    real = dist.all_reduce

    def recording(t, *a, **kw):
        if kw.get("group") is mg.pg:
            shapes.append(tuple(t.shape))
        return real(t, *a, **kw)
    collectives.reset_counts()
    dist.all_reduce = recording
    try:
        with _Counting() as counting:
            state, _ = run(state, 1)
    finally:
        dist.all_reduce = real
    return {"messages": shapes, "counts": dict(collectives.COUNTS),
            "calls": counting.calls,
            "warnings": [str(w.message) for w in caught],
            "param_shapes": {k: tuple(v["w"].shape)
                             for k, v in state.params.items()},
            "opt_shapes": {k: tuple(v["w"].shape)
                           for k, v in state.opt_state.items()}}


def remat_case(plan, mg) -> dict:
    """Remat off, then on, on this rank's shards: the losses, the MoE aux
    loss and the shards' gradients of each model of ``REMAT_MODELS``
    (sequence parallel), its ghost ω̃, and the model-axis all-reduces the
    pass sent (``COUNTS``: the recompute's are counted)."""
    kw = dict(model_group=mg, seq_shard=True)
    out = {}
    for model in REMAT_MODELS:
        spec = plan["models"][model]
        specs = D.resolve_param_specs(_logical(spec), spec["params"], mg)
        params = shard_tree(spec["params"], specs, *axis_info(mg))
        batch = plan["batches"][model]
        for remat in (False, True):
            cfg = dataclasses.replace(spec["cfg"], remat=remat)
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            params)
            collectives.reset_counts()
            losses, aux = ttf.per_example_loss(live, cfg, batch, **kw)
            grads = torch.autograd.grad(torch.mean(losses) + aux.aux_loss,
                                        tree_leaves(live))
            sent = collectives.COUNTS["model_all_reduce"]
            scores = make_lm_scorer(cfg, "ghost", **kw)(params, batch)
            out[(model, remat)] = {
                "results": [losses.detach(), aux.aux_loss.detach(),
                            *grads, scores.detach()],
                "model_all_reduce": sent}
    return out


def _wait(path: str) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > WAIT_S:
            raise TimeoutError(f"{path} did not appear in {WAIT_S} s")
        time.sleep(0.1)


def main(rank: str, n_data: int, m_size: int, port: int, plan_path: str,
         out_dir: str):
    torch.set_num_threads(1)
    plan = torch.load(plan_path, weights_only=False)
    if rank == "one":
        group = mg = None
        models = models_for(1)
    else:
        group, mg = mesh.init_rank(int(rank), n_data * m_size, port, "gloo",
                                   "cpu", model_parallel=m_size)
        models = models_for(m_size)
    out = {}
    if mg is not None:      # first: the fallback warns once a parameter
        out["traffic"] = traffic_case(plan, group, mg)
    if (n_data, m_size) == REMAT_WORLD and mg is not None:
        out["remat"] = remat_case(plan, mg)
    out["scores"] = scores_case(plan, mg)
    root = os.path.dirname(out_dir)
    ref_path = os.path.join(root, "reference.pt")
    one_path = os.path.join(root, "one_draws.pt")
    cases = [c for c in CASES if CASES[c][0] in models]
    if rank == "one":
        # the one-device run draws for itself where the reference does
        # not, and hands those draws to the worlds
        own = [c for c in cases if c not in REFERENCE_CASES]
        for case in own:
            out[case] = run_case(plan, case, None, None, None,
                                 steps=plan["steps"][CASES[case][0]])
        torch.save({c: [s["sample_indices"] for s in out[c]["steps"]]
                    for c in own}, one_path + ".part")
        os.replace(one_path + ".part", one_path)
    # the cases on the one-device draws first, while the reference runs
    for case in sorted(cases, key=lambda c: c in REFERENCE_CASES):
        if case in out:
            continue
        path = ref_path if case in REFERENCE_CASES else one_path
        _wait(path)
        indices = torch.load(path, weights_only=False)[case]
        out[case] = run_case(plan, case, group, mg, indices)
        if case == "mlp/relaxed" and mg is not None and (
                n_data, m_size) == plan["checkpoint_world"]:
            st = out[case]
            whole = issgd.TrainState(st["params"], st["opt"], st["stale"],
                                     st["store"], len(indices),
                                     torch.Generator().manual_seed(0))
            save_checkpoint(plan["ckpt"], whole, whole.step, group=group,
                            model_group=mg,
                            shard_specs=D.train_state_specs(whole,
                                                            st["specs"]))
    name = "one" if rank == "one" else f"rank{rank}"
    torch.save(out, os.path.join(out_dir, f"{name}.pt"))
    if mg is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5], sys.argv[6])
