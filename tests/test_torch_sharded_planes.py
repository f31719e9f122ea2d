"""The port's sharded planes over ``torch.distributed`` on worlds of 1, 2
and 4 gloo ranks: the async pipeline over a data group, the streamed
step over a rank's own host chunks, and the gather-free checkpoint.

Each world is spawned once for the module (``_torch_sharded_planes_rank
.py``, one process a rank) and runs every case; the tests below compare
what the ranks saved.  Within the port, bitwise: every world's async and
streamed (sync, async, fused with its probe; async and streamed async
also gated by an adaptive controller whose ranks time different
dispatches and apply rank 0's cadence) runs equal the one-device runs
in draws, losses, grad norms, Σw, both buffers of the store, params
and stale params (the trace monitors, psum'd partial sums, at rtol 1e-5
/ atol 1e-6); no rank makes a tensor of N rows, and no rank's host store
holds or serves a foreign chunk.  A world-2 gather-free file restores
into a whole reference state with the one-device run's values, and into
the port at worlds 1 and 4, which resume bitwise.  Against the
reference: world 4 replays the reference's one-device ``AsyncPipeline``
and ``StreamedISSGD`` draws at rtol 1e-5 / atol 1e-6 for the smoke MLP
and glm4-9b-smoke.  The launcher runs ``--mesh 2 --stream
--async-scoring`` with the one-device losses and refuses ``--mesh 2
--serve-loop`` by name.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _helpers import REPO  # noqa: E402
from _torch_sharded_planes_rank import CASES, MID, STEPS, SWAP  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import async_pipeline as japipe  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core.importance import ISConfig as JISConfig  # noqa: E402
from repro.core.scorer import make_lm_scorer as j_lm_scorer  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_mlp_scorer  # noqa: E402
from repro.data.streaming import make_streamed_issgd as j_streamed  # noqa
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.data import make_svhn_like, make_token_dataset  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import free_port  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.models.mlp import init_mlp_classifier  # noqa: E402
from repro_torch.models.transformer import init_transformer  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

WORLDS = (1, 2, 4)
N = 1000                  # no width of the smoke MLP is 1000
RTOL, ATOL = 1e-5, 1e-6
REF_STEPS = 3
TRAJECTORY = ("sample_indices", "loss", "grad_norm", "mean_weight")
MONITORS = ("trace_ideal", "trace_stale", "trace_unif", "ess_frac")


def _np(t):
    return t.detach().float().cpu().numpy()


def _jax_tree(tree):
    """The port's tree (the reference's layout) as the reference's."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _named(sub, f"{prefix}{name}/").items()}
    return {prefix: tree}


def _plan(tmp):
    """The inputs of every case, made by the port's own recipes."""
    gen = lambda s: torch.Generator().manual_seed(s)
    cfg = smoke()
    lcfg = configs.get_smoke_config("glm4-9b")
    plan = {"reference_world": 4, "ckpt": os.path.join(tmp, "ck.npz"),
            "mlp": {"model": "mlp", "model_cfg": cfg, "n": N, "chunk": 50,
                    "params": init_mlp_classifier(gen(1), cfg, "cpu"),
                    "data": make_svhn_like(gen(0), n=N,
                                           dim=cfg.input_dim)[0].arrays,
                    "cfg": dict(batch_size=32, score_batch_size=200,
                                refresh_every=2, score_shards=4)},
            "lm": {"model": "lm", "model_cfg": lcfg, "n": 128, "chunk": 16,
                   "params": init_transformer(gen(5), lcfg, "cpu"),
                   "data": make_token_dataset(gen(4), n=128, seq=17,
                                              vocab=lcfg.vocab_size).arrays,
                   "cfg": dict(batch_size=4, score_batch_size=16,
                               refresh_every=2, score_shards=4)}}
    path = os.path.join(tmp, "plan.pt")
    torch.save(plan, path)
    return plan, path


def _reference_runs(plan):
    """The reference's one-device AsyncPipeline (K = SWAP) and sync
    StreamedISSGD for each model: each step's metrics and the final
    state."""
    jcfgs = {"mlp": j_smoke(), "lm": jconfigs.get_smoke_config("glm4-9b")}
    out = {}
    for model, jcfg in jcfgs.items():
        spec = plan[model]
        if model == "mlp":
            pel = lambda p, b, c=jcfg: jmlp.per_example_loss(p, b, c)
            scorer = j_mlp_scorer(jcfg, "ghost")
        else:
            pel = lambda p, b, c=jcfg: jtf.per_example_loss(p, c, b)[0]
            scorer = j_lm_scorer(jcfg, "ghost")
        tcfg = jissgd.ISSGDConfig(is_cfg=JISConfig(smoothing=0.1),
                                  **spec["cfg"])
        opt, n = j_sgd(0.05), spec["n"]
        params, arrays = _jax_tree(spec["params"]), _jax_tree(spec["data"])
        pipe = japipe.AsyncPipeline(*japipe.make_async_steps(
            pel, scorer, opt, tcfg, n), swap_every=SWAP)
        state = japipe.init_async_state(params, opt, n)
        drv = j_streamed(pel, scorer, opt, tcfg,
                         {k: np.asarray(v) for k, v in arrays.items()},
                         spec["chunk"], 2)
        for case, step, st in (("async", lambda s: pipe.step(s, arrays),
                                state),
                               ("stream_sync", drv.step,
                                jissgd.init_train_state(params, opt, n))):
            mets = []
            for _ in range(REF_STEPS):
                st, m = step(st)
                mets.append(jax.tree.map(np.asarray, m))
            out[(model, case)] = (mets, st)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world spawned at once, each rank a process; the reference's
    draws written for world 4 while the ranks run; the results by world
    and rank, the plan and the reference runs."""
    tmp = str(tmp_path_factory.mktemp("planes"))
    plan, path = _plan(tmp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for w in WORLDS:
        out = os.path.join(tmp, f"world{w}")
        os.makedirs(out)
        port = free_port()
        for r in range(w):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(
                    REPO, "tests", "_torch_sharded_planes_rank.py"),
                 str(r), str(w), str(port), path, out],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    try:
        refs = _reference_runs(plan)
        ref_idx = {key: [torch.from_numpy(m.sample_indices.astype(np.int64))
                         for m in mets] for key, (mets, _) in refs.items()}
        part = os.path.join(tmp, "reference.part")
        torch.save(ref_idx, part)
        os.replace(part, os.path.join(tmp, "reference.pt"))
    finally:
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=300)
            if p.returncode:
                errs.append(err[-3000:])
    assert not errs, errs[0]
    res = {w: [torch.load(os.path.join(tmp, f"world{w}", f"rank{r}.pt"),
                          weights_only=False) for r in range(w)]
           for w in WORLDS}
    return res, plan, refs


def _gathered(parts):
    return torch.cat(list(parts))


def _whole_store(ranks, key="store"):
    """The ranks' buffered or plain store rows, concatenated."""
    first = ranks[0][key]
    if isinstance(first, ws.BufferedWeightStore):
        return ws.BufferedWeightStore(
            _whole_store([{key: r[key].read_buf} for r in ranks], key),
            _whole_store([{key: r[key].write_buf} for r in ranks], key),
            first.synced_at)
    return ws.WeightStore(*(None if first[i] is None else
                            _gathered(r[key][i] for r in ranks)
                            for i in range(3)))


def _same_store(a, b):
    if isinstance(a, ws.BufferedWeightStore):
        return (a.synced_at == b.synced_at and _same_store(a.read_buf,
                                                           b.read_buf)
                and _same_store(a.write_buf, b.write_buf))
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b, strict=True))


def _same_tree(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b), strict=True))


def _steps_equal(a, b, bitwise_monitors=False):
    for i, (x, y) in enumerate(zip(a, b, strict=True)):
        for k in TRAJECTORY:
            assert torch.equal(x[k], y[k]), (i, k)
        for k in MONITORS:
            if bitwise_monitors:
                assert torch.equal(x[k], y[k]), (i, k)
            else:
                np.testing.assert_allclose(_np(x[k]), _np(y[k]), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{i} {k}")


# ------------------------------------------------------ within the port
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_plane_equals_one_device(worlds, case, world):
    """Each world's run is the one-device run bit for bit: draws, losses,
    grad norms, Σw, both buffers, params, stale params; the ranks agree."""
    res, _, _ = worlds
    ranks = [res[world][r]["cases"][case] for r in range(world)]
    one = res[1][0]["one_device"][case]
    for other in ranks[1:]:
        _steps_equal(ranks[0]["steps"], other["steps"],
                     bitwise_monitors=True)
        assert _same_tree(ranks[0]["params"], other["params"])
    _steps_equal(ranks[0]["steps"], one["steps"],
                 bitwise_monitors=world == 1)
    assert _same_store(_whole_store(ranks), one["store"])
    for which in ("params", "stale_params"):
        assert _same_tree(ranks[0][which], one[which]), which
    if case.startswith("stream"):
        # the window counts are each rank's: together, every sampled row
        hits = sum(r["stats"].hits + r["stats"].misses for r in ranks)
        assert hits == sum(s["sample_indices"].numel()
                           for s in one["steps"])


def _decided(d):
    return d["step"], d["use_is"], d["swap_every"], d["reason"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["async_gated", "stream_async_gated"])
def test_gated_ranks_apply_rank0_cadence(worlds, case, world):
    """Rank r's controller times dispatches 2r ms slower than rank 0's, so
    each rank would pick a cadence of its own; every rank applies rank
    0's (the one-device run's), and the gate, folded from replicated
    traces, opens and closes as one device's."""
    res, _, _ = worlds
    want = [_decided(d) for d in res[1][0]["one_device"][case]["decisions"]]
    assert [w[2] for w in want] == [4, 6, 8]
    assert {w[1] for w in want} == {False, True}
    for r in range(world):
        got = res[world][r]["cases"][case]["decisions"]
        assert [_decided(d) for d in got] == want
        assert got[0]["dispatch_ratio"] == pytest.approx(3.5 + 2 * r)


@pytest.mark.parametrize("world", [2, 4])
def test_no_rank_holds_the_table_or_a_foreign_chunk(worlds, world):
    """N / world rows of each buffer a rank, no op of a recorded step
    takes or makes an N-row tensor (the one-device step, recorded the
    same way, does), and a rank's host store holds its chunk range alone,
    its window inside it, and refuses a foreign row by name."""
    res, plan, _ = worlds
    for case in ("async", "stream_async"):
        assert res[1][0]["gate_one_device"][case]["seen"]
    per = plan["mlp"]["n"] // plan["mlp"]["chunk"] // world
    for r in range(world):
        g = res[world][r]["gate"]
        for case in ("async", "stream_async"):
            assert g[case]["rows"] == [N // world] * 2
            assert g[case]["seen"] == [], g[case]["seen"][:5]
        s = g["stream_async"]
        assert s["held"] == (r * per, (r + 1) * per)
        assert s["held_rows"] == N // world
        assert all(r * per <= c < (r + 1) * per for c in s["window"][0])
        assert s["refused"] and "is not held by this store" in s["refused"]


# ------------------------------------------------------------ checkpoint
def test_gather_free_file_restores_into_the_reference(worlds):
    """World 2's file (one ``::shard<r>`` entry a rank for each store
    leaf) restores through the reference into a whole async state with
    the one-device run's values at the save."""
    res, plan, refs = worlds
    assert res[2][0]["checkpoint"]["saved_at"] == MID
    with np.load(plan["ckpt"]) as z:
        assert "store/read_buf/weights::shard1" in z.files
        assert "store/read_buf/weights" not in z.files
    mid = res[1][0]["mid"]
    _, jstate = refs[("mlp", "async")]
    got, step = j_restore(plan["ckpt"], jstate)
    assert step == MID
    for buf in ("read_buf", "write_buf"):
        for f in ("weights", "scored_at"):
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(got.store, buf), f)),
                _np(getattr(getattr(mid["store"], buf), f)))
    assert int(got.store.synced_at) == mid["store"].synced_at
    for which in ("params", "stale_params"):
        want = _named(mid[which])
        have = _named(getattr(got, which))
        assert sorted(have) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(have[k]), _np(v))


@pytest.mark.parametrize("world", [1, 4])
def test_gather_free_file_resumes_bitwise(worlds, world):
    """Worlds 1 (over a group and as one device) and 4 resume the world-2
    file and end where the uninterrupted one-device run ends."""
    res, _, _ = worlds
    full = res[1][0]["one_device"]["stream_async"]
    for tag in (("group", "one_device") if world == 1 else ("group",)):
        ranks = [res[world][r]["checkpoint"][tag] for r in range(world)]
        _steps_equal(ranks[0]["steps"], full["steps"][MID:])
        assert _same_store(_whole_store(ranks), full["store"])
        for which in ("params", "stale_params"):
            assert _same_tree(ranks[0][which], full[which]), which


# ------------------------------------------------------------- reference
@pytest.mark.parametrize("case", ["async", "stream_sync"])
@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_world4_replays_the_reference(worlds, model, case):
    """4 ranks on the reference's one-device draws (W = 4) follow its
    metrics, store and params at the f32 bounds."""
    res, _, refs = worlds
    ref_mets, ref_state = refs[(model, case)]
    ranks = [res[4][r]["reference"][(model, case)] for r in range(4)]
    got = ranks[0]
    for i, (m, jm) in enumerate(zip(got["steps"], ref_mets, strict=True)):
        assert np.array_equal(_np(m["sample_indices"]), jm.sample_indices)
        for k in ("loss", "grad_norm", "mean_weight") + MONITORS:
            np.testing.assert_allclose(_np(m[k]), getattr(jm, k), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{i} {k}")
    store = _whole_store(ranks)
    jstore = ref_state.store
    pairs = ([(store.read_buf, jstore.read_buf),
              (store.write_buf, jstore.write_buf)] if case == "async"
             else [(store, jstore)])
    for mine, theirs in pairs:
        np.testing.assert_allclose(_np(mine.weights),
                                   np.asarray(theirs.weights), rtol=RTOL,
                                   atol=ATOL)
        assert np.array_equal(_np(mine.scored_at),
                              np.asarray(theirs.scored_at))
    for which in ("params", "stale_params"):
        want = _named(params_from_jax(jax.tree.map(
            np.asarray, getattr(ref_state, which))))
        have = _named(got[which])
        assert sorted(have) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(_np(have[k]), _np(v), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{which} {k}")


# -------------------------------------------------------------- launcher
def _loss_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("step ")]


def test_launcher_mesh_streams_async_with_the_one_device_losses(capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--examples",
            "1024", "--log-every", "1", "--stream", "--async-scoring",
            "--swap-every", "2"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *argv, "--mesh", "2"], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh: (2,)" in r.stdout and "x 2 shard(s)" in r.stdout
    ttrain.main(argv + ["--score-shards", "2"])
    want = _loss_lines(capsys.readouterr().out)
    assert len(want) == 6
    assert _loss_lines(r.stdout) == want


def test_launcher_mesh_runs_the_serve_loop():
    """``--mesh 2 --stream --serve-loop``: the reserved chunks are laid
    out before the store is split (the last rank holds them), and the
    launcher exits 0 with rows ingested."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "glm4-9b", "--smoke", "--device", "cpu",
                        "--mesh", "2", "--stream", "--serve-loop",
                        "--steps", "3", "--examples", "256", "--seq", "16",
                        "--batch", "8", "--score-batch", "32"],
                       capture_output=True, text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "32 reserved rows" in r.stdout
    got = [int(line.split()[2]) for line in r.stdout.splitlines()
           if line.startswith("serve-loop: ingested")]
    assert got and got[0] >= 1
