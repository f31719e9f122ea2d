"""One rank of a gloo world for ``tests/test_torch_sharded.py``.

Run as a script, one process a rank:

    python tests/_torch_sharded_rank.py RANK WORLD PORT PLAN OUT_DIR

It joins the world through ``launch/mesh.py``, runs every case of the
plan (a ``torch.save`` file the test writes) with the world's data group
(a world of one also without a group, the one-device step), and saves what it
saw to ``OUT_DIR/rank<RANK>.pt`` for the test to compare.  It imports
only the port: the test holds the results against the reference.
"""
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import distributed as D
from repro_torch.core import issgd
from repro_torch.core.collectives import gather_rows, scatter_rows
from repro_torch.core.importance import ISConfig
from repro_torch.core.sampler import chunk_proposal_mass, two_stage_sample
from repro_torch.core.scorer import make_lm_scorer, make_mlp_scorer
from repro_torch.core.weight_store import init_store, write_scores_global
from repro_torch.launch import mesh
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttf
from repro_torch.optim import sgd
from repro_torch.telemetry import MonitorSet

# the step cases: name → (ISSGDConfig overrides, step options)
STEP_CASES = {
    "relaxed": ({}, {}),
    "exact": ({"mode": "exact"}, {}),
    "uniform": ({"mode": "uniform"}, {}),
    "fused": ({"mode": "fused"}, {"probe_every": 2}),
    "index_tree": ({"index": "tree"}, {}),
    "int8": ({"table_dtype": "int8", "index_chunk_size": 50}, {}),
    "monitors": ({}, {"monitors": True}),
    "adaptive_is": ({}, {"gate": (False, True, True, False, True, True)}),
}
STEPS = 6


def _metrics(m) -> dict:
    return {k: getattr(m, k).detach().clone()
            for k in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                      "trace_unif", "ess_frac", "mean_weight",
                      "sample_indices")}


def collect_case(plan, group) -> dict:
    """gather_rows, scatter_rows, write_scores_global (f32 and int8) and
    chunk_proposal_mass on this rank's shard of the plan's tables."""
    c = plan["collect"]
    table, idx, vals = c["table"], c["idx"], c["vals"]
    mine = D.shard_dataset({"t": table, "x": c["rows"]}, group)
    store = D.shard_store(init_store(table.shape[0], "cpu"), group, "cpu")
    q8 = D.shard_store(init_store(table.shape[0], "cpu", table_dtype="int8",
                                  chunk_size=c["chunk"]), group, "cpu")
    return {
        "gather": gather_rows(mine, idx, group),
        "scatter": scatter_rows(mine["t"], idx, vals, group),
        "write": write_scores_global(store, idx, vals, 7, group),
        "write_int8": write_scores_global(q8, idx, vals, 7, group),
        "chunk_mass": chunk_proposal_mass(mine["t"], c["chunk"], group),
    }


def draw_case(plan, group) -> dict:
    """The two-stage draw from the plan's uniforms for each table and W."""
    d = plan["draw"]
    out = {}
    for name, table in d["tables"].items():
        for w in d["shards"]:
            local = D.shard_dataset({"t": table}, group)["t"]
            out[(name, w)] = two_stage_sample(
                local, d["uniforms"].shape[0],
                num_shards=w // (group.size if group else 1),
                uniforms=d["uniforms"], group=group)
    return out


def _row_block(kw: dict, n: int) -> int:
    """The launcher's ``score_row_block``: one logical shard's slice."""
    sb = n if kw.get("mode") == "exact" else kw["score_batch_size"]
    return sb // kw["score_shards"]


def _mlp_parts(plan, row_block):
    cfg = plan["mlp_cfg"]
    return (cfg, lambda p, b: tmlp.per_example_loss(p, b, cfg),
            make_mlp_scorer(cfg, "ghost", row_block=row_block),
            lambda p, b: tmlp.per_example_loss_and_score(p, b, cfg))


def _run_steps(plan, group, overrides, opts, steps=STEPS,
               sample_indices=None, parts=None, data=None, params=None,
               n=None, base=None):
    data = plan["mlp_data"] if data is None else data
    params = plan["mlp_params"] if params is None else params
    n = plan["N"] if n is None else n
    kw = dict(base or plan["step_cfg"], **overrides)
    cfg, pel, scorer, fused = parts or _mlp_parts(plan, _row_block(kw, n))
    tcfg = issgd.ISSGDConfig(is_cfg=ISConfig(smoothing=0.1), **kw)
    opt = sgd(0.05)
    monitors = MonitorSet.all() if opts.get("monitors") else None
    gate = opts.get("gate")
    step, tcfg = D.make_sharded_train_step(
        pel, scorer, opt, tcfg, n, group,
        fused_score=fused if tcfg.mode == "fused" else None,
        monitors=monitors, gated=gate is not None)
    probe = (D.make_sharded_score_step(scorer, tcfg, n, group)
             if opts.get("probe_every") else None)
    state = D.shard_train_state(issgd.init_train_state(
        params, opt, n, "cpu", seed=3, table_dtype=tcfg.table_dtype,
        index_chunk_size=tcfg.index_chunk_size), group)
    local = D.shard_dataset(data, group)
    rec = []
    for i in range(steps):
        sargs = (state, local) + ((gate[i],) if gate is not None else ())
        kwargs = ({} if sample_indices is None
                  else {"sample_indices": sample_indices[i]})
        state, m, *mon = step(*sargs, **kwargs)
        r = _metrics(m)
        if mon:
            r["monitors"] = {k: v.clone() for k, v in mon[0].items()}
        rec.append(r)
        if probe is not None and i % opts["probe_every"] == 0:
            state = probe(state, local)
    return {"steps": rec, "store": state.store, "params": state.params,
            "stale_params": state.stale_params}


class _RowRecorder(TorchDispatchMode):
    """Every tensor an op takes or makes whose shape holds ``n``."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor) and self.n in tuple(t.shape):
                self.seen.append((str(func), tuple(t.shape)))
        return out


def gate_case(plan, group) -> dict:
    """One relaxed step under a recorder of N-row tensors, and the shard
    sizes of the state and the data."""
    n = plan["N"]
    cfg, pel, scorer, _ = _mlp_parts(plan, _row_block(plan["step_cfg"], n))
    tcfg = issgd.ISSGDConfig(is_cfg=ISConfig(smoothing=0.1),
                             **plan["step_cfg"])
    opt = sgd(0.05)
    step, tcfg = D.make_sharded_train_step(pel, scorer, opt, tcfg, n, group)
    state = D.shard_train_state(issgd.init_train_state(
        plan["mlp_params"], opt, n, "cpu"), group)
    local = D.shard_dataset(plan["mlp_data"], group)
    state, _ = step(state, local)        # a scored store for the draw
    rec = _RowRecorder(n)
    with rec:
        state, _ = step(state, local)
    return {"seen": rec.seen, "store_rows": state.store.weights.shape[0],
            "data_rows": local["x"].shape[0]}


def reference_cases(plan, group) -> dict:
    """The sharded step replaying the reference's one-device draws, for
    the MLP and for an LM."""
    out = {}
    r = plan["ref_mlp"]
    out["mlp"] = _run_steps(plan, group, {}, {}, steps=len(r["indices"]),
                            sample_indices=r["indices"], params=r["params"],
                            data=r["data"], n=r["n"], base=r["cfg"])
    r = plan["ref_lm"]
    cfg = r["model_cfg"]
    parts = (cfg, lambda p, b: ttf.per_example_loss(p, cfg, b)[0],
             make_lm_scorer(cfg, "ghost"), None)
    out["lm"] = _run_steps(plan, group, {}, {}, steps=len(r["indices"]),
                           sample_indices=r["indices"], parts=parts,
                           params=r["params"], data=r["data"], n=r["n"],
                           base=r["cfg"])
    return out


def main(rank: int, world: int, port: int, plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    group = mesh.init_rank(rank, world, port, "gloo", "cpu")
    plan = torch.load(plan_path, weights_only=False)
    out = {"collect": collect_case(plan, group),
           "draw": draw_case(plan, group),
           "gate": gate_case(plan, group),
           "steps": {name: _run_steps(plan, group, *spec)
                     for name, spec in STEP_CASES.items()}}
    if world == 1:
        out["steps_one_device"] = {
            name: _run_steps(plan, None, *spec)
            for name, spec in STEP_CASES.items()}
        out["draw_one_device"] = draw_case(plan, None)
        out["gate_one_device"] = gate_case(plan, None)
    if world == plan["reference_world"]:
        out["reference"] = reference_cases(plan, group)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
