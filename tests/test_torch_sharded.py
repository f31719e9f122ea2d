"""The port's sharded ISSGD step (``core/collectives.py``,
``core/distributed.py``, ``launch/mesh.py``) on worlds of 1, 2 and 4 gloo
ranks, against the reference and against the port's one-device step.

Each world is spawned once for the module (``_torch_sharded_rank.py``,
one process a rank) and runs every case; the tests below compare what
the ranks saved.  Against the reference: ``gather_rows``,
``scatter_rows`` and ``write_scores_global`` with ``axes=()`` exactly
(duplicate indices: last write wins; foreign rows dropped); the
two-stage draw from the reference's uniforms exactly, on a table of
integer weights whose sums are exact in any order; the sharded step on
4 ranks replaying the reference's one-device draws at the f32 bounds of
``docs/KERNELS.md`` (rtol 1e-5, atol 1e-6; ``scored_at`` equal), for the
MLP and for glm4-9b-smoke.  Within the port, beyond what
``tests/test_sharded.py`` pins for the reference (indices bitwise, the
rest at tolerances): every world is the one-device step bitwise in every
mode (draws, losses, grad norms, Σw, store, params, stale params), the
trace and ESS monitors, psum'd partial sums, at rtol 1e-5 / atol 1e-6;
the ranks agree bitwise; no rank holds or makes a tensor of N rows.
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
from _torch_sharded_rank import STEP_CASES  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import collectives as jcoll  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core import sampler as jsampler  # noqa: E402
from repro.core import weight_store as jws  # noqa: E402
from repro.core.importance import ISConfig as JISConfig  # noqa: E402
from repro.core.scorer import make_lm_scorer as j_lm_scorer  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_mlp_scorer  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.data import make_svhn_like, make_token_dataset  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.models.mlp import init_mlp_classifier  # noqa: E402
from repro_torch.models.transformer import init_transformer  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

WORLDS = (1, 2, 4)
N = 1000                  # no width of the smoke MLP is 1000
RTOL, ATOL = 1e-5, 1e-6
STEP_CFG = dict(batch_size=32, score_batch_size=200, refresh_every=2,
                score_shards=4)


def _np(t):
    return t.detach().float().cpu().numpy()


def _torch_tree(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _named(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _named(sub, f"{prefix}{name}/").items()}
    return {prefix: tree}


def _jax_tree(tree):
    """The port's tree (the reference's layout) as the reference's."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _reference_run(jcfg_kw, pel, scorer, params, arrays, n, steps):
    """The reference's one-device step: its metrics, indices and state."""
    jopt = j_sgd(0.05)
    jstep = jax.jit(jissgd.make_train_step(
        pel, scorer, jopt, jissgd.ISSGDConfig(
            is_cfg=JISConfig(smoothing=0.1), **jcfg_kw), n))
    state = jissgd.init_train_state(params, jopt, n)
    metrics = []
    for _ in range(steps):
        state, m = jstep(state, arrays)
        metrics.append(jax.tree.map(np.asarray, m))
    return metrics, state


def _plan(tmp):
    """The inputs of every case (made by the port's own recipes and handed
    to the reference as arrays), and the reference's runs."""
    rng = np.random.default_rng(0)
    gen = lambda s: torch.Generator().manual_seed(s)
    plan = {"N": N, "step_cfg": STEP_CFG, "reference_world": 4}
    cfg = smoke()
    plan["mlp_cfg"] = cfg
    plan["mlp_params"] = init_mlp_classifier(gen(1), cfg, "cpu")
    plan["mlp_data"] = make_svhn_like(gen(0), n=N, dim=cfg.input_dim)[0] \
        .arrays
    # collectives: duplicates, rows of every rank
    table = rng.uniform(0.0, 3.0, N).astype(np.float32)
    idx = np.concatenate([rng.integers(0, N, 36), [5, 999, 5, 500, 5]])
    plan["collect"] = {
        "table": torch.from_numpy(table),
        "rows": torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)),
        "idx": torch.from_numpy(idx.astype(np.int64)),
        "vals": torch.from_numpy(rng.uniform(0, 4, idx.size)
                                 .astype(np.float32)),
        "chunk": 50}
    # the draw: the reference's uniforms
    key = jax.random.key(11)
    plan["draw"] = {
        "tables": {
            "integer": torch.from_numpy(
                rng.integers(0, 6, N).astype(np.float32)),
            "float": torch.from_numpy(table)},
        "shards": (4, 20),
        "uniforms": torch.from_numpy(np.array(jax.random.uniform(
            key, (300,), jnp.float32))),
        "key": key}
    # the sharded step against the reference's one-device step
    jcfg = j_smoke()
    kw = dict(batch_size=16, score_batch_size=64, refresh_every=2,
              score_shards=4)
    mdata = make_svhn_like(gen(2), n=512, dim=cfg.input_dim)[0].arrays
    mparams = init_mlp_classifier(gen(3), cfg, "cpu")
    mref = _reference_run(kw, lambda p, b: jmlp.per_example_loss(p, b, jcfg),
                          j_mlp_scorer(jcfg, "ghost"), _jax_tree(mparams),
                          _jax_tree(mdata), 512, 3)
    lcfg = configs.get_smoke_config("glm4-9b")
    jlcfg = jconfigs.get_smoke_config("glm4-9b")
    lkw = dict(batch_size=4, score_batch_size=16, refresh_every=2,
               score_shards=4)
    ldata = make_token_dataset(gen(4), n=128, seq=17,
                               vocab=lcfg.vocab_size).arrays
    lparams = init_transformer(gen(5), lcfg, "cpu")
    lref = _reference_run(lkw, lambda p, b: jtf.per_example_loss(p, jlcfg,
                                                                 b)[0],
                          j_lm_scorer(jlcfg, "ghost"), _jax_tree(lparams),
                          _jax_tree(ldata), 128, 2)
    for name, (ref, params, data, n, kw_) in {
            "ref_mlp": (mref, mparams, mdata, 512, kw),
            "ref_lm": (lref, lparams, ldata, 128, lkw)}.items():
        plan[name] = {
            "params": params, "data": data,
            "indices": [torch.from_numpy(m.sample_indices.astype(np.int64))
                        for m in ref[0]],
            "n": n, "cfg": kw_}
    plan["ref_lm"]["model_cfg"] = lcfg
    path = os.path.join(tmp, "plan.pt")
    torch.save({**plan, "draw": {k: v for k, v in plan["draw"].items()
                                 if k != "key"}}, path)
    return plan, path, {"mlp": mref, "lm": lref}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world spawned at once, each rank a process; the results by
    world and rank, the plan and the reference runs."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    plan, path, refs = _plan(tmp)
    from repro_torch.launch.mesh import free_port
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for w in WORLDS:
        out = os.path.join(tmp, f"world{w}")
        os.makedirs(out)
        port = free_port()
        for r in range(w):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests",
                                              "_torch_sharded_rank.py"),
                 str(r), str(w), str(port), path, out],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
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


def _gathered(shards):
    return torch.cat([s for s in shards])


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("world", [2, 4])
def test_gather_rows_matches_reference(worlds, world):
    res, plan, _ = worlds
    c = plan["collect"]
    want = jcoll.gather_rows(
        {"t": jnp.asarray(c["table"].numpy()),
         "x": jnp.asarray(c["rows"].numpy())},
        jnp.asarray(c["idx"].numpy()), ())
    for r in range(world):
        got = res[world][r]["collect"]["gather"]
        for k in ("t", "x"):
            assert np.array_equal(_np(got[k]), np.asarray(want[k])), (r, k)


@pytest.mark.parametrize("world", [2, 4])
def test_scatter_rows_last_write_wins_as_reference(worlds, world):
    res, plan, _ = worlds
    c = plan["collect"]
    want = jcoll.scatter_rows(jnp.asarray(c["table"].numpy()),
                              jnp.asarray(c["idx"].numpy()),
                              jnp.asarray(c["vals"].numpy()), ())
    got = _gathered([res[world][r]["collect"]["scatter"]
                     for r in range(world)])
    assert got.shape == (N,)
    assert np.array_equal(_np(got), np.asarray(want))
    assert got[5] == c["vals"][-1]          # the last of three writes


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("world", [2, 4])
def test_write_scores_global_matches_reference(worlds, world, dtype):
    res, plan, _ = worlds
    c = plan["collect"]
    key = "write" if dtype == "f32" else "write_int8"
    jstore = jws.init_store(N, table_dtype=dtype,
                            chunk_size=c["chunk"] if dtype == "int8" else 0)
    want = jws.write_scores_global(jstore, jnp.asarray(c["idx"].numpy()),
                                   jnp.asarray(c["vals"].numpy()), 7, ())
    shards = [res[world][r]["collect"][key] for r in range(world)]
    assert {s.weights.shape[0] for s in shards} == {N // world}
    got = ws.WeightStore(*(None if shards[0][i] is None else
                           _gathered([s[i] for s in shards])
                           for i in range(3)))
    assert np.array_equal(_np(got.weights), np.asarray(
        want.weights.astype(jnp.float32)))
    assert np.array_equal(_np(got.scored_at), np.asarray(want.scored_at))
    if dtype == "int8":
        np.testing.assert_allclose(_np(got.qscale), np.asarray(want.qscale),
                                   rtol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_chunk_proposal_mass_over_the_group(worlds, world):
    res, plan, _ = worlds
    c = plan["collect"]
    want = jsampler.chunk_proposal_mass(jnp.asarray(c["table"].numpy()),
                                        c["chunk"], ())
    one = res[1][0]["collect"]["chunk_mass"]
    for r in range(world):
        got = res[world][r]["collect"]["chunk_mass"]
        assert torch.equal(got, one)        # the leaf reduction, bitwise
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


# -------------------------------------------------------------- the draw
@pytest.mark.parametrize("shards", [4, 20])
@pytest.mark.parametrize("world", WORLDS)
def test_two_stage_draw_equals_reference(worlds, world, shards):
    """From the reference's uniforms: the reference's indices exactly
    (integer weights: every sum exact), and on a float table the
    one-device draw of the port bitwise."""
    res, plan, _ = worlds
    d = plan["draw"]
    want = jsampler.two_stage_sample(
        d["key"], jnp.asarray(d["tables"]["integer"].numpy()),
        d["uniforms"].shape[0], shards_per_device=shards)
    one = res[1][0]["draw_one_device"]
    for r in range(world):
        got = res[world][r]["draw"]
        assert np.array_equal(_np(got[("integer", shards)]),
                              np.asarray(want)), r
        assert torch.equal(got[("float", shards)], one[("float", shards)])


# -------------------------------------------------------------- the step
def _steps_equal(a, b, bitwise_metrics=False):
    for i, (x, y) in enumerate(zip(a["steps"], b["steps"], strict=True)):
        # the trajectory: W fixes every sum it depends on
        for k in ("sample_indices", "loss", "grad_norm", "mean_weight"):
            assert torch.equal(x[k], y[k]), (i, k)
        for k in ("trace_ideal", "trace_stale", "trace_unif", "ess_frac"):
            if bitwise_metrics:
                assert torch.equal(x[k], y[k]), (i, k)
            else:
                np.testing.assert_allclose(_np(x[k]), _np(y[k]), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{i} {k}")
        for k, v in x.get("monitors", {}).items():
            np.testing.assert_allclose(_np(v), _np(y["monitors"][k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{i} {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_step_equals_one_device(worlds, case, world):
    res, _, _ = worlds
    ranks = [res[world][r]["steps"][case] for r in range(world)]
    for other in ranks[1:]:              # replicated outputs, bitwise
        _steps_equal(ranks[0], other, bitwise_metrics=True)
        for a, b in zip(tree_leaves(ranks[0]["params"]),
                        tree_leaves(other["params"])):
            assert torch.equal(a, b)
    for one in (res[1][0]["steps_one_device"][case],
                res[1][0]["steps"][case]):
        _steps_equal(ranks[0], one)
        store = ws.WeightStore(*(None if ranks[0]["store"][i] is None else
                                 _gathered([r_["store"][i] for r_ in ranks])
                                 for i in range(3)))
        assert store.weights.shape == one["store"].weights.shape == (N,)
        for x, y in zip(store, one["store"]):
            assert (x is None and y is None) or torch.equal(x, y)
        for which in ("params", "stale_params"):
            for a, b in zip(tree_leaves(ranks[0][which]),
                            tree_leaves(one[which]), strict=True):
                assert torch.equal(a, b), which
    if world == 1:                       # the group of one is the step
        _steps_equal(ranks[0], res[1][0]["steps_one_device"][case],
                     bitwise_metrics=True)


@pytest.mark.parametrize("model", ["mlp", "lm"])
def test_sharded_step_replays_reference(worlds, model):
    """4 ranks replay the reference's one-device draws (W = 4) and follow
    its metrics, store and params at the f32 bounds."""
    res, _, refs = worlds
    ref_metrics, ref_state = refs[model]
    ranks = [res[4][r]["reference"][model] for r in range(4)]
    got = ranks[0]
    for i, (m, jm) in enumerate(zip(got["steps"], ref_metrics,
                                    strict=True)):
        assert np.array_equal(_np(m["sample_indices"]), jm.sample_indices)
        for k in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                  "trace_unif", "ess_frac", "mean_weight"):
            np.testing.assert_allclose(_np(m[k]), getattr(jm, k), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{i} {k}")
    weights = _gathered([r["store"].weights for r in ranks])
    np.testing.assert_allclose(_np(weights), np.asarray(
        ref_state.store.weights), rtol=RTOL, atol=ATOL)
    assert np.array_equal(_np(_gathered([r["store"].scored_at
                                         for r in ranks])),
                          np.asarray(ref_state.store.scored_at))
    for which in ("params", "stale_params"):
        want = _named(_torch_tree(getattr(ref_state, which)))
        have = _named(got[which])
        assert sorted(have) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(_np(have[k]), _np(v), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{which} {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_no_rank_holds_the_table(worlds, world):
    """Each rank holds N / world rows of the store and the data, and no
    op of a step takes or makes a tensor with N rows; the one-device
    step, recorded the same way, does (the recorder sees them)."""
    res, _, _ = worlds
    assert res[1][0]["gate_one_device"]["seen"]
    for r in range(world):
        g = res[world][r]["gate"]
        assert g["store_rows"] == g["data_rows"] == N // world
        assert g["seen"] == [], g["seen"][:5]


# -------------------------------------------------------------- launcher
def _loss_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("step ")]


def test_launcher_mesh_prints_the_unsharded_losses(capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "8", "--examples",
            "1024", "--log-every", "1"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *argv, "--mesh", "2"], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh: (2,)" in r.stdout
    ttrain.main(argv + ["--score-shards", "2"])
    want = _loss_lines(capsys.readouterr().out)
    assert len(want) == 8
    assert _loss_lines(r.stdout) == want


def test_launcher_mesh_restores_a_checkpoint(tmp_path, capsys):
    """Each rank restores the whole state on the host and keeps its rows:
    the sharded run resumes as the one-device run does."""
    ck = str(tmp_path / "ck.npz")
    argv = ["--smoke", "--device", "cpu", "--examples", "1024",
            "--log-every", "1", "--score-shards", "2"]
    ttrain.main(argv + ["--steps", "3", "--save-checkpoint", ck])
    capsys.readouterr()
    ttrain.main(argv + ["--steps", "4", "--restore-checkpoint", ck])
    want = _loss_lines(capsys.readouterr().out)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *argv, "--steps", "4", "--restore-checkpoint", ck,
                        "--mesh", "2"], capture_output=True, text=True,
                       cwd=REPO, timeout=300,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "restored" in r.stdout and "(step 3)" in r.stdout
    assert len(want) == 4 and _loss_lines(r.stdout) == want


SERVE_LOOP_ARGV = ["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                   "--mesh", "2", "--stream", "--serve-loop", "--steps", "3",
                   "--examples", "256", "--seq", "16", "--batch", "8",
                   "--score-batch", "32", "--log-every", "100"]


def _launch(argv, timeout=300):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *argv], capture_output=True, text=True, cwd=REPO,
                          timeout=timeout,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.join(REPO, "src"),
                                   OMP_NUM_THREADS="1"))


@pytest.mark.parametrize("flag", ["--stream", "--async-scoring",
                                  "--save-checkpoint"])
def test_launcher_mesh_runs_the_serve_loop(flag, tmp_path):
    """``--mesh 2 --stream --serve-loop`` composes with ``flag``: each
    data rank serves the same traffic and ingests the rows of its chunks;
    the launcher exits 0 with rows ingested."""
    argv = SERVE_LOOP_ARGV + [flag]
    if flag == "--save-checkpoint":
        argv.append(str(tmp_path / "ck.npz"))
    r = _launch(argv)
    assert r.returncode == 0, r.stderr[-3000:]
    got = [int(line.split()[2]) for line in r.stdout.splitlines()
           if line.startswith("serve-loop: ingested")]
    assert got and got[0] >= 1
    if flag == "--save-checkpoint":
        assert (tmp_path / "ck.npz").exists()


def test_launcher_serve_loop_refuses_an_unsplit_kv_head():
    """An M that does not divide num_kv_heads (glm4-9b smoke: 2) cannot
    split the GQA decode caches: exit 1 up front, naming the field."""
    r = _launch(SERVE_LOOP_ARGV + ["--model-parallel", "4"], timeout=120)
    assert r.returncode == 1
    assert "num_kv_heads (2) for GQA decode" in r.stderr


def test_launcher_mesh_refusal_exits_1():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--smoke", "--device", "cpu", "--mesh", "3",
                        "--examples", "1024"], capture_output=True,
                       text=True, cwd=REPO, timeout=120,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src"),
                                OMP_NUM_THREADS="1"))
    assert r.returncode == 1
    assert "not divisible by --mesh 3" in r.stderr


def test_launcher_mesh_names_the_card_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = ttrain.parse_args(["--smoke", "--device", "cpu", "--mesh", "2"])
    args.device = "cuda"
    with pytest.raises(ValueError, match="1 CUDA device"):
        ttrain.check_mesh(args)
