"""One rank of a gloo world for ``tests/test_torch_sharded_planes.py``.

Run as a script, one process a rank:

    python tests/_torch_sharded_planes_rank.py RANK WORLD PORT PLAN OUT_DIR

It joins the world through ``launch/mesh.py`` and runs the sharded
planes of the plan (a ``torch.save`` file the test writes) over the
world's data group: the async pipeline and the streamed step (sync,
async, fused with its probe), the async ones also gated by an adaptive
controller whose swap cadence follows dispatch times that differ from
rank to rank, a recorded step of each, and the gather-free checkpoint
(world 2 saves it, worlds 1 and 4 resume from it).  A world of one also runs every case without a group, the
one-device runs the others are held to; the world of the plan's
``reference_world`` replays the reference's draws, which the test
writes to ``OUT_DIR/../reference.pt`` while the ranks run.  What a rank
saw goes to ``OUT_DIR/rank<RANK>.pt``.  It imports only the port.
"""
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import distributed as D
from repro_torch.core import issgd
from repro_torch.core.async_pipeline import AsyncPipeline
from repro_torch.core.controller import ControllerConfig, ProposalController
from repro_torch.core.importance import ISConfig
from repro_torch.core.scorer import make_lm_scorer, make_mlp_scorer
from repro_torch.core.weight_store import to_buffered
from repro_torch.data.store import ChunkedExampleStore, ForeignChunkError
from repro_torch.data.streaming import StreamedISSGD, StreamingDataPlane
from repro_torch.dist import axis_info
from repro_torch.launch import mesh
from repro_torch.launch.train import rank0_cadence
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttf
from repro_torch.optim import sgd
from repro_torch.telemetry import NullSink

# the plane cases: name → (ISSGDConfig overrides, driver options)
CASES = {
    "async": ({}, {"pipe": "async"}),
    "stream_sync": ({}, {"pipe": "stream"}),
    "stream_async": ({}, {"pipe": "stream", "async": True}),
    "stream_fused": ({"mode": "fused"}, {"pipe": "stream",
                                         "probe_every": 2}),
    "async_gated": ({}, {"pipe": "async", "gated": True}),
    "stream_async_gated": ({}, {"pipe": "stream", "async": True,
                                "gated": True}),
}
STEPS = 6
SWAP = 2           # the async cases' publish cadence
WINDOW = 2         # chunks a rank's window holds
MID = 3            # the step the checkpoint is saved at
WAIT_S = 240       # the longest wait for a file another process writes


def _metrics(m) -> dict:
    return {k: getattr(m, k).detach().clone()
            for k in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                      "trace_unif", "ess_frac", "mean_weight",
                      "sample_indices")}


def _parts(spec: dict, kw: dict):
    """(per-example loss, scorer, fused objective) of a spec's model, the
    scorer a logical shard's slice a call, as the launcher builds it."""
    cfg = spec["model_cfg"]
    row_block = kw["score_batch_size"] // kw["score_shards"]
    if spec["model"] == "mlp":
        return (lambda p, b: tmlp.per_example_loss(p, b, cfg),
                make_mlp_scorer(cfg, "ghost", row_block=row_block),
                lambda p, b: tmlp.per_example_loss_and_score(p, b, cfg))
    return (lambda p, b: ttf.per_example_loss(p, cfg, b)[0],
            make_lm_scorer(cfg, "ghost", row_block=row_block),
            lambda p, b: ttf.per_example_loss_and_score(p, cfg, b))


def _controller(group):
    """A gated case's controller: the gate open at first, a decision every
    2 steps (a ratio of 1.02 clears the gate: a fresh store gives ratios
    of 1 up to rounding), its cadence agreed on rank 0's
    (``launch/train.py``), and a ``fold(metrics, step)`` that feeds it
    the step's traces and dispatch times as the launcher's sink does.  The times are made up and differ from rank to
    rank, so that the ranks' own cadences differ."""
    ctl = ProposalController(
        ControllerConfig(adapt_every=2, var_margin=1.02, adapt_swap=True),
        swap_every=SWAP, use_is=True,
        agree=None if group is None else rank0_cadence(group, "cpu"))
    tap = ctl.attach(NullSink())
    rank, _ = axis_info(group)

    def fold(m, i):
        tap.emit("metrics", step=i, trace_stale=float(m.trace_stale),
                 trace_unif=float(m.trace_unif), ess_frac=float(m.ess_frac))
        tap.span("scoring.dispatch", 1e-3 * (3 + 2 * rank + i), step=i)
        tap.span("master.dispatch", 1e-3, step=i)
    ctl.fold = fold
    return ctl


def build(spec: dict, group, case: str, indices=None):
    """(driver, the rank's state, the rank's data or None) of a case; with
    ``indices`` the master takes them in place of its own draws."""
    overrides, opts = CASES[case]
    kw = dict(spec["cfg"], **overrides)
    tcfg = issgd.ISSGDConfig(is_cfg=ISConfig(smoothing=0.1), **kw)
    pel, scorer, fused = _parts(spec, kw)
    opt, n = sgd(0.05), spec["n"]
    state = issgd.init_train_state(spec["params"], opt, n, "cpu", seed=3)
    fused = fused if tcfg.mode == "fused" else None
    gated = opts.get("gated", False)
    ctl = _controller(group) if gated else None
    if opts["pipe"] == "async":
        *steps, tcfg = D.make_sharded_async_steps(pel, scorer, opt, tcfg, n,
                                                  group, gated=gated)
        driver = AsyncPipeline(*steps, SWAP, controller=ctl)
        data = D.shard_dataset(spec["data"], group)
    else:
        async_mode = opts.get("async", False)
        chunk = spec["chunk"]
        store = ChunkedExampleStore.from_arrays(spec["data"], chunk,
                                                shard=axis_info(group))
        plane = StreamingDataPlane(store, WINDOW, device="cpu", group=group)
        *steps, tcfg = D.make_sharded_streamed_steps(
            pel, scorer, opt, tcfg, n, group, chunk, fused_score=fused,
            async_mode=async_mode, gated=gated)
        driver = StreamedISSGD(plane, *steps, tcfg, n, async_mode=async_mode,
                               swap_every=SWAP, controller=ctl)
        data = None
    if opts.get("async", opts["pipe"] == "async"):
        state = state._replace(store=to_buffered(state.store))
    if indices is not None:
        _inject(driver, indices)
    return driver, D.shard_train_state(state, group, "cpu"), data


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


def drive(driver, state, data, steps, probe_every=None) -> tuple:
    """``steps`` steps; (state, each step's metrics).  A gated driver's
    controller folds each step and sets the cadence it decides."""
    rec = []
    ctl = driver.controller
    for i in range(steps):
        state, m = driver.step(state, data)
        rec.append(_metrics(m))
        if probe_every and i % probe_every == 0:
            state = driver.probe(state)
        if ctl is not None:
            ctl.fold(m, i)
            d = ctl.maybe_decide(i)
            if d is not None:
                driver.swap_every = d.swap_every
    driver.join()
    return state, rec


def _result(state, rec, driver=None) -> dict:
    out = {"steps": rec, "store": state.store, "params": state.params,
           "stale_params": state.stale_params, "step": state.step}
    if isinstance(driver, StreamedISSGD):
        out["stats"] = driver.plane.stats
    if driver is not None and driver.controller is not None:
        out["decisions"] = [d._asdict() for d in driver.controller.decisions]
    return out


def run_case(spec, group, case, steps=STEPS, indices=None) -> dict:
    driver, state, data = build(spec, group, case, indices)
    state, rec = drive(driver, state, data, steps,
                       CASES[case][1].get("probe_every"))
    return _result(state, rec, driver)


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


def gate_case(spec, group) -> dict:
    """A recorded second step of the async pipeline and of the streamed
    async step, the store's held chunks, its refusal of a foreign row and
    the rows of the rank's buffers."""
    out = {}
    for case in ("async", "stream_async"):
        driver, state, data = build(spec, group, case)
        state, _ = driver.step(state, data)
        rec = _RowRecorder(spec["n"])
        with rec:
            state, _ = driver.step(state, data)
            driver.join()
        out[case] = {"seen": rec.seen,
                     "rows": [b.weights.shape[0] for b in
                              (state.store.read_buf, state.store.write_buf)]}
        if case == "stream_async":
            store = driver.plane.store
            held = store.held_chunks
            foreign = (held.stop % store.num_chunks) * store.chunk_size
            try:
                store.fetch_rows([foreign])
                refused = None
            except ForeignChunkError as e:
                refused = str(e)
            out[case].update(
                held=(held.start, held.stop), num_chunks=store.num_chunks,
                window=driver.plane.window_ids.tolist(),
                refused=None if axis_info(group)[1] == 1 else refused,
                held_rows=sum(v.shape[0] for _, c in store.iter_chunks()
                              for v in c.values()) // len(store.keys))
    return out


def _wait(path: str) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > WAIT_S:
            raise TimeoutError(f"{path} did not appear in {WAIT_S} s")
        time.sleep(0.1)


def checkpoint_case(plan, group, world) -> dict:
    """World 2 saves the streamed async run gather-free at step MID;
    worlds 1 and 4 restore that file into a whole host state, keep their
    rows and run the remaining steps."""
    spec, path = plan["mlp"], plan["ckpt"]
    if world == 2:
        driver, state, data = build(spec, group, "stream_async")
        state, _ = drive(driver, state, data, MID)
        save_checkpoint(path, state, state.step, group=group)
        return {"saved_at": state.step}
    _wait(path)
    out = {}
    for tag, g in (("group", group), ("one_device", None)):
        if tag == "one_device" and world != 1:
            continue
        driver, _, data = build(spec, g, "stream_async")
        opt = sgd(0.05)
        whole = issgd.init_train_state(spec["params"], opt, spec["n"], "cpu",
                                       seed=3)
        whole = whole._replace(store=to_buffered(whole.store))
        restored, step = restore_checkpoint(path, whole)
        state = D.shard_train_state(restored, g, "cpu")
        state, rec = drive(driver, state, data, STEPS - step)
        out[tag] = _result(state, rec)
    return out


def main(rank: int, world: int, port: int, plan_path: str, out_dir: str):
    torch.set_num_threads(1)
    group = mesh.init_rank(rank, world, port, "gloo", "cpu")
    plan = torch.load(plan_path, weights_only=False)
    spec = plan["mlp"]
    out = {"cases": {c: run_case(spec, group, c) for c in CASES},
           "gate": gate_case(spec, group)}
    if world == 1:
        out["one_device"] = {c: run_case(spec, None, c) for c in CASES}
        out["gate_one_device"] = gate_case(spec, None)
        # the one-device streamed async run as it stands at the save
        mid = run_case(spec, None, "stream_async", steps=MID)
        out["mid"] = {k: mid[k] for k in ("store", "params", "stale_params",
                                          "step")}
    out["checkpoint"] = checkpoint_case(plan, group, world)
    if world == plan["reference_world"]:
        ref_path = os.path.join(os.path.dirname(out_dir), "reference.pt")
        _wait(ref_path)
        ref = torch.load(ref_path, weights_only=False)
        out["reference"] = {
            (model, case): run_case(plan[model], group, case,
                                    steps=len(idx), indices=idx)
            for (model, case), idx in ref.items()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
