"""The port's ISSGD slice against the JAX reference: weight store,
two-stage sampler, three whole train steps per mode, the data recipe,
the launcher, and the rule that the port imports nothing of JAX.

Tolerances: store reads and writes are elementwise, so they must match
bitwise; sampled indices must be equal (integer-valued weights make both
frameworks' CDFs exact); train-step results pass through matmuls summed
in different orders and compare at rtol 1e-5 / atol 1e-6.
"""
import ast
import math
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core import sampler as jsampler  # noqa: E402
from repro.core import weight_store as jws  # noqa: E402
from repro.core.importance import ISConfig as JISConfig  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_make_scorer  # noqa: E402
from repro.data import make_svhn_like as j_make_svhn_like  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import issgd, sampler  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.core.importance import ISConfig  # noqa: E402
from repro_torch.core.scorer import make_mlp_scorer  # noqa: E402
from repro_torch.data import make_svhn_like  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ weight store
@pytest.mark.parametrize("threshold", [0, 3])
def test_store_write_and_read_match_reference(threshold):
    rng = np.random.default_rng(0)
    n = 64
    scored = rng.integers(-1, 8, n).astype(np.int32)
    scored[[5, 6, 40]] = jws.EMPTY               # reserved rows
    weights = np.abs(rng.standard_normal(n)).astype(np.float32) * 4
    idx = rng.permutation(n)[:16].astype(np.int32)
    scores = np.abs(rng.standard_normal(16)).astype(np.float32)
    jstore = jws.WeightStore(jnp.asarray(weights), jnp.asarray(scored))
    tstore = ws.WeightStore(torch.from_numpy(weights),
                            torch.from_numpy(scored))
    jstore = jws.write_scores(jstore, jnp.asarray(idx), jnp.asarray(scores), 9)
    tstore = ws.write_scores(tstore, torch.from_numpy(idx),
                             torch.from_numpy(scores), 9)
    assert np.array_equal(_np(tstore.weights), np.asarray(jstore.weights))
    assert np.array_equal(_np(tstore.scored_at), np.asarray(jstore.scored_at))
    jq = jws.read_proposal(jstore, 10, JISConfig(staleness_threshold=threshold))
    tq = ws.read_proposal(tstore, 10, ISConfig(staleness_threshold=threshold))
    assert np.array_equal(_np(tq), np.asarray(jq))
    assert ws.EMPTY == jws.EMPTY


def test_init_store_is_uniform():
    store = ws.init_store(32, "cpu")
    assert store.weights.dtype == torch.float32
    assert store.scored_at.dtype == torch.int32
    q = ws.read_proposal(store, 0, ISConfig())
    assert torch.equal(q, torch.ones(32))


# ------------------------------------------------------------------ sampler
@pytest.mark.parametrize("shards", [1, 4])
def test_two_stage_sample_replays_reference_draws(shards):
    rng = np.random.default_rng(shards)
    weights = rng.integers(0, 6, 512).astype(np.float32)
    key = jax.random.key(7)
    want = jsampler.two_stage_sample(key, jnp.asarray(weights), 256,
                                     shards_per_device=shards)
    # the uniforms the reference drew inside two_stage_sample
    u01 = np.asarray(jax.random.uniform(key, (256,), jnp.float32))
    got = sampler.two_stage_sample(torch.from_numpy(weights), 256,
                                   num_shards=shards,
                                   uniforms=torch.tensor(u01))
    assert np.array_equal(_np(got), np.asarray(want))


def test_two_stage_sample_generator_draws_only_support():
    weights = torch.zeros(400)
    weights[[3, 150, 399]] = torch.tensor([1.0, 2.0, 5.0])
    idx = sampler.two_stage_sample(weights, 2000, num_shards=4,
                                   generator=torch.Generator().manual_seed(0))
    counts = torch.bincount(idx, minlength=400)
    assert set(torch.nonzero(counts).flatten().tolist()) == {3, 150, 399}
    assert counts[399] > counts[150] > counts[3]


# ------------------------------------------------------ the slice, 3 steps
@pytest.fixture(scope="module")
def slice_setup():
    jcfg = j_smoke()
    train, _ = j_make_svhn_like(jax.random.key(0), n=512, dim=jcfg.input_dim)
    jparams = jmlp.init_mlp_classifier(jax.random.key(1), jcfg)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, train, jparams, data, tparams


@pytest.mark.parametrize("mode,extra", [
    ("relaxed", {}), ("exact", {}), ("uniform", {}),
    ("relaxed", {"score_shards": 2, "grad_clip": 0.5}),
])
def test_three_train_steps_match_reference(slice_setup, mode, extra):
    """The slice as a whole: the port replays the reference's sampled
    indices and must follow its losses, grad norms, monitors, store and
    params (refresh_every=2 puts a stale-param push inside the run)."""
    jcfg, train, jparams, data, tparams = slice_setup
    cfg = smoke()
    kw = dict(batch_size=16, score_batch_size=64, refresh_every=2, mode=mode,
              **extra)
    jopt = j_sgd(0.05)
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg),
        j_make_scorer(jcfg, "ghost"), jopt, jissgd.ISSGDConfig(**kw), 512))
    jstate = jissgd.init_train_state(jparams, jopt, 512)
    topt = sgd(0.05)
    tstep = issgd.make_train_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg),
        make_mlp_scorer(cfg, "ghost"), topt, issgd.ISSGDConfig(**kw), 512)
    tstate = issgd.init_train_state(tparams, topt, 512, "cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, train.arrays)
        tstate, tm = tstep(tstate, data, sample_indices=torch.tensor(
            np.asarray(jm.sample_indices)))
        for field in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                      "trace_unif", "ess_frac", "mean_weight"):
            np.testing.assert_allclose(_np(getattr(tm, field)),
                                       np.asarray(getattr(jm, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=field)
    assert tstate.step == int(jstate.step) == 3
    np.testing.assert_allclose(_np(tstate.store.weights),
                               np.asarray(jstate.store.weights),
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(_np(tstate.store.scored_at),
                          np.asarray(jstate.store.scored_at))
    for which in ("params", "stale_params"):
        for name, leaves in getattr(jstate, which).items():
            for k, v in leaves.items():
                np.testing.assert_allclose(
                    _np(getattr(tstate, which)[name][k]), np.asarray(v),
                    rtol=RTOL, atol=ATOL, err_msg=f"{which} {name}.{k}")


def test_master_draws_without_injection(slice_setup):
    """Without injected indices the master draws from its generator, and
    the same seed gives the same run."""
    _, _, _, data, tparams = slice_setup
    cfg = smoke()

    def run(seed):
        opt = sgd(0.05)
        step = issgd.make_train_step(
            lambda p, b: tmlp.per_example_loss(p, b, cfg),
            make_mlp_scorer(cfg, "ghost"), opt,
            issgd.ISSGDConfig(batch_size=16, score_batch_size=64), 512)
        state = issgd.init_train_state(tparams, opt, 512, "cpu", seed=seed)
        state, m = step(state, data)
        return m
    a, b = run(0), run(0)
    assert torch.equal(a.sample_indices, b.sample_indices)
    assert a.sample_indices.min() >= 0 and a.sample_indices.max() < 512
    assert math.isfinite(a.loss.item())


def test_unported_mode_is_refused():
    with pytest.raises(ValueError, match="not ported"):
        issgd.make_train_step(None, None, sgd(0.1),
                              issgd.ISSGDConfig(mode="bogus"), 512)
    # fused mode is ported, and like the reference's needs its objective
    with pytest.raises(ValueError, match="requires fused_score"):
        issgd.make_train_step(None, None, sgd(0.1),
                              issgd.ISSGDConfig(mode="fused"), 512)


def test_make_svhn_like_recipe():
    train, test = make_svhn_like(torch.Generator().manual_seed(0), n=640,
                                 dim=24)
    x, y = train.arrays["x"], train.arrays["y"]
    assert x.shape == (640, 24) and x.dtype == torch.float32
    assert y.dtype == torch.int32 and 0 <= y.min() and y.max() < 10
    assert test.size == 64
    torch.testing.assert_close(x.mean(0), torch.zeros(24), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(x.std(0, correction=0), torch.ones(24),
                               atol=1e-4, rtol=0)


# ----------------------------------------------------------------- launcher
def _reference_flag_defaults() -> dict:
    """--flag → default, read from the reference launcher's source."""
    tree = ast.parse((REPO / "src/repro/launch/train.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument" and node.args
                and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default")
            out[node.args[0].value] = (ast.literal_eval(default)
                                       if default is not None else None)
    return out


def test_launcher_flags_have_reference_defaults():
    ref = _reference_flag_defaults()
    ours = vars(ttrain.parse_args(["--device", "cpu"]))
    for name, value in ours.items():
        flag = "--" + name.replace("_", "-")
        if flag == "--device":
            continue
        assert flag in ref, flag
        # an absent default is a store_true flag's False, but for the
        # reference's one tri-state flag: --(no-)sequence-parallel, whose
        # None means on when M > 1
        want = ref[flag] if ref[flag] is not None else (
            None if flag == "--sequence-parallel" else False)
        assert value == want, flag
    # every other reference flag is refused by name
    assert set(ref) - {"--" + n.replace("_", "-") for n in ours} <= \
        set(ttrain.LATER_FLAGS)


@pytest.mark.parametrize("argv,match", [
    (["--model-parallel", "2", "--strategy", "full", "--device", "cpu"],
     "--strategy full"),
    (["--arch", "glm4-9b", "--model-parallel", "3", "--device", "cpu"],
     "num_heads"),
    (["--bogus", "--device", "cpu"], "unrecognized"),
])
def test_launcher_refuses_what_the_slice_lacks(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args(argv)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_launcher_defaults_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args(["--smoke"])
    assert e.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_launcher_runs_on_cpu_when_asked(capsys):
    result = ttrain.main(["--smoke", "--steps", "3", "--examples", "256",
                          "--batch", "16", "--score-batch", "64",
                          "--log-every", "1", "--device", "cpu"])
    assert [r["step"] for r in result.history] == [0, 1, 2]
    assert len(result.step_ms) == 3 and result.state.step == 3
    lines = capsys.readouterr().out.splitlines()
    # the reference launcher's log line, field for field
    pat = re.compile(r"step +\d+ loss \d+\.\d{4} √TrΣ ideal/stale/unif = "
                     r"\d+\.\d{3}/\d+\.\d{3}/\d+\.\d{3} ess \d+\.\d{3}$")
    assert all(pat.match(line) for line in lines[:3]), lines
    assert lines[3].startswith("done: 3 steps on cpu")


# ------------------------------------------------------ no JAX in the port
def _port_files():
    return sorted((REPO / "src/repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("torch_*.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    elif torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke runs for real")
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
