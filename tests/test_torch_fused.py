"""The port's fused mode, probe step, last-write-wins store writes, Adam
and its schedules, and the ASGD baseline against the JAX reference, and
the launcher's flags of this slice.

Inputs are made from a seed with numpy (the reference's dataset and
params, copied to the port), and the port replays the reference's sampled
indices.  Tolerances: store writes are elementwise and must match
bitwise; results that pass through matmuls summed in another order, f32
rtol 1e-5 / atol 1e-6 (as ``tests/test_torch_issgd.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import asgd as jasgd  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core import sampler as jsampler  # noqa: E402
from repro.core import weight_store as jws  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_make_scorer  # noqa: E402
from repro.data import make_svhn_like as j_make_svhn_like  # noqa: E402
from repro.data import make_token_dataset as j_make_tokens  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import asgd, distributed, issgd, sampler  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.core.scorer import make_mlp_scorer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
N = 64          # few examples, so that minibatches of 32 repeat rows


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close_tree(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close_tree(got[k], want[k], f"{what}/{k}")
        return
    _close(got, want, what)


@pytest.fixture(scope="module")
def mlp_setup():
    jcfg = j_smoke()
    train, _ = j_make_svhn_like(jax.random.key(0), n=N, dim=jcfg.input_dim)
    jparams = jmlp.init_mlp_classifier(jax.random.key(1), jcfg)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, smoke(), train, jparams, data, tparams


# ------------------------------------------------------ last-write-wins
def _lww_loop(base, idx, vals):
    out = base.copy()
    for i, v in zip(idx, vals):
        out[i] = v
    return out


@pytest.mark.parametrize("b,rows", [(64, 8), (16, 16), (5, 1)])
def test_write_scores_global_is_last_write_wins(b, rows):
    """B writes over few rows, distinct values: the last write of each row
    wins, bitwise as the reference's write_scores_global (axes=())."""
    rng = np.random.default_rng(b)
    n = 32
    idx = rng.integers(0, rows, b).astype(np.int32)
    vals = rng.permutation(b).astype(np.float32) + 0.5
    steps = np.arange(b, dtype=np.int32) + 100
    base = ws.init_store(n, "cpu")
    got = ws.write_scores_global(base, torch.from_numpy(idx),
                                 torch.from_numpy(vals),
                                 torch.from_numpy(steps))
    want = jws.write_scores_global(jws.init_store(n), jnp.asarray(idx),
                                   jnp.asarray(vals), jnp.asarray(steps))
    assert np.array_equal(_np(got.weights), np.asarray(want.weights))
    assert np.array_equal(_np(got.scored_at), np.asarray(want.scored_at))
    assert np.array_equal(_np(got.weights),
                          _lww_loop(np.zeros(n, np.float32), idx, vals))
    assert np.array_equal(_np(got.scored_at),
                          _lww_loop(np.full(n, -1, np.int32), idx, steps))
    assert got.weights.shape == (n,) and got.weights.dtype == torch.float32
    # a scalar stamp, and the input store untouched (functional writes)
    one = ws.write_scores_global(base, torch.from_numpy(idx),
                                 torch.from_numpy(vals), 7)
    assert set(_np(one.scored_at)[np.unique(idx)]) == {7}
    assert torch.equal(base.weights, torch.zeros(n))


def test_relaxed_scoring_slice_longer_than_its_shard(mlp_setup):
    """score_batch_size / W > N / W: the round-robin slice wraps around
    its logical shard, so its indices repeat; three steps still follow the
    reference (store bitwise in its stamps, scores at rtol 1e-5)."""
    jcfg, cfg, train, jparams, data, tparams = mlp_setup
    kw = dict(batch_size=8, score_batch_size=96, refresh_every=2,
              score_shards=2)
    jo = jopt.sgd(0.05)
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg),
        j_make_scorer(jcfg, "ghost"), jo, jissgd.ISSGDConfig(**kw), N))
    jstate = jissgd.init_train_state(jparams, jo, N)
    to = topt.sgd(0.05)
    tstep = issgd.make_train_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg),
        make_mlp_scorer(cfg, "ghost"), to, issgd.ISSGDConfig(**kw), N)
    tstate = issgd.init_train_state(tparams, to, N, "cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, train.arrays)
        tstate, tm = tstep(tstate, data, sample_indices=torch.tensor(
            np.asarray(jm.sample_indices)))
        for f in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                  "trace_unif", "ess_frac"):
            _close(getattr(tm, f), getattr(jm, f), f)
    _close(tstate.store.weights, jstate.store.weights, "weights")
    assert np.array_equal(_np(tstate.store.scored_at),
                          np.asarray(jstate.store.scored_at))
    _close_tree(tstate.params, jstate.params, "params")


# ------------------------------------------------------------ fused mode
def test_mlp_fused_objective_matches_reference(mlp_setup):
    jcfg, cfg, train, jparams, data, tparams = mlp_setup
    jl, js = jmlp.per_example_loss_and_score(jparams, train.arrays, jcfg)
    tl, ts = tmlp.per_example_loss_and_score(tparams, data, cfg)
    _close(tl, jl, "losses")
    _close(ts, js, "scores")
    # the score is the logit_grad scorer's, and the loss the trainer's
    _close(ts, j_make_scorer(jcfg, "logit_grad")(jparams, train.arrays),
           "logit_grad")
    torch.testing.assert_close(tl, tmlp.per_example_loss(tparams, data, cfg))


def test_lm_fused_objective_matches_reference():
    jcfg = jconfigs.get_smoke_config("glm4-9b")
    cfg = configs.get_smoke_config("glm4-9b")
    train = j_make_tokens(jax.random.key(0), n=6, seq=13,
                          vocab=jcfg.vocab_size)
    jparams = jtf.init_transformer(jax.random.key(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = train.arrays["tokens"]
    jl, js = jtf.per_example_loss_and_score(jparams, jcfg, {"tokens": toks})
    tl, ts = ttf.per_example_loss_and_score(
        tparams, cfg, {"tokens": torch.from_numpy(np.array(toks))})
    _close(tl, jl, "losses")
    _close(ts, js, "scores")


@pytest.mark.parametrize("probe_every", [1, 2])
def test_three_fused_steps_and_probes_match_reference(mlp_setup,
                                                      probe_every):
    """Fused steps (the scores of the sampled minibatch written
    last-write-wins) and the probe after step i when i % K == 0, replaying
    the reference's draws, which repeat rows (32 draws from 64 rows)."""
    jcfg, cfg, train, jparams, data, tparams = mlp_setup
    kw = dict(batch_size=32, score_batch_size=16, refresh_every=2,
              mode="fused")
    jo = jopt.sgd(0.05)
    jcfg_s = jissgd.ISSGDConfig(**kw)
    jscorer = j_make_scorer(jcfg, "ghost")
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg), jscorer, jo, jcfg_s,
        N, fused_score=lambda p, b: jmlp.per_example_loss_and_score(
            p, b, jcfg)))
    jprobe = jax.jit(jissgd.make_score_step(jscorer, jcfg_s, N))
    jstate = jissgd.init_train_state(jparams, jo, N)
    to = topt.sgd(0.05)
    tcfg = issgd.ISSGDConfig(**kw)
    tscorer = make_mlp_scorer(cfg, "ghost")
    tstep = issgd.make_train_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg), tscorer, to, tcfg, N,
        fused_score=lambda p, b: tmlp.per_example_loss_and_score(p, b, cfg))
    tprobe = issgd.make_score_step(tscorer, tcfg, N)
    tstate = issgd.init_train_state(tparams, to, N, "cpu")
    repeats = 0
    for i in range(3):
        jstate, jm = jstep(jstate, train.arrays)
        idx = np.asarray(jm.sample_indices)
        repeats += idx.size - np.unique(idx).size
        tstate, tm = tstep(tstate, data, sample_indices=torch.tensor(idx))
        for f in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                  "trace_unif", "ess_frac", "mean_weight"):
            _close(getattr(tm, f), getattr(jm, f), f)
        # the rows trained on at step i carry stamp i
        assert set(_np(tstate.store.scored_at)[idx]) == {i}
        if i % probe_every == 0:
            jstate = jprobe(jstate, train.arrays)
            tstate = tprobe(tstate, data)
        _close(tstate.store.weights, jstate.store.weights, f"weights {i}")
        assert np.array_equal(_np(tstate.store.scored_at),
                              np.asarray(jstate.store.scored_at))
    assert repeats > 0
    assert tstate.step == int(jstate.step) == 3
    _close_tree(tstate.params, jstate.params, "params")
    _close_tree(tstate.stale_params, jstate.stale_params, "stale_params")


def test_fused_step_draws_without_injection(mlp_setup):
    _, cfg, _, _, data, tparams = mlp_setup
    to = topt.sgd(0.05)
    step = issgd.make_train_step(
        None, None, to, issgd.ISSGDConfig(batch_size=32, mode="fused"), N,
        fused_score=lambda p, b: tmlp.per_example_loss_and_score(p, b, cfg))
    outs = []
    for _ in range(2):
        state = issgd.init_train_state(tparams, to, N, "cpu", seed=4)
        state, m = step(state, data)
        outs.append((m.sample_indices, state.store.weights))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------- Adam and schedules
@pytest.mark.parametrize("sched", ["const", "cosine", "warmup_cosine"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_five_steps_match_reference(sched, wd):
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params) for _ in range(5)]
    lr = {"const": (0.01, 0.01),
          "cosine": (jopt.cosine_schedule(0.1, 5), topt.cosine_schedule(
              0.1, 5)),
          "warmup_cosine": (jopt.warmup_cosine(0.1, 2, 6),
                            topt.warmup_cosine(0.1, 2, 6))}[sched]
    jo = jopt.adam(lr[0], weight_decay=wd)
    to = topt.adam(lr[1], weight_decay=wd)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jo.init(jp)
    tp = params_from_jax(params)
    ts = to.init(tp)
    assert set(ts) == {"m", "v"}
    assert ts["m"]["a"]["w"].dtype == torch.float32
    for step, g in enumerate(grads):
        jp, js = jax.jit(jo.update)(jax.tree.map(jnp.asarray, g), js, jp,
                                    jnp.int32(step))
        tp, ts = to.update(params_from_jax(g), ts, tp, step)
    _close_tree(tp, jp, "params")
    _close_tree(ts, js, "state")


def test_schedules_match_reference():
    pairs = [(jopt.cosine_schedule(0.1, 10), topt.cosine_schedule(0.1, 10)),
             (jopt.cosine_schedule(0.3, 0, 0.2),
              topt.cosine_schedule(0.3, 0, 0.2)),
             (jopt.warmup_cosine(0.1, 3, 12), topt.warmup_cosine(0.1, 3, 12))]
    for jf, tf in pairs:
        for step in range(14):
            want = float(jax.jit(jf)(jnp.int32(step)))
            assert tf(step) == pytest.approx(want, rel=1e-6, abs=1e-9), step


def test_apply_updates_matches_reference():
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    u = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    want = jopt.apply_updates(p, u)
    got = topt.apply_updates(params_from_jax(p), params_from_jax(u))
    assert np.array_equal(_np(got["w"]), np.asarray(want["w"]))


# ------------------------------------------------------------------ ASGD
def _reference_draw(jstate, cfg, n):
    """The indices the reference's asgd_step draws from its key."""
    _, k = jax.random.split(jstate.rng)
    if cfg.mode == "issgd":
        q = jws.read_proposal(jstate.store, jstate.step, cfg.is_cfg)
        return np.asarray(jsampler.sample_indices(k, q, cfg.batch_size))
    return np.asarray(jax.random.randint(k, (cfg.batch_size,), 0, n))


@pytest.mark.parametrize("mode", ["uniform", "issgd"])
@pytest.mark.parametrize("delay", [0, 4])
def test_asgd_steps_match_reference(mlp_setup, mode, delay):
    jcfg, cfg, train, jparams, data, tparams = mlp_setup
    jc = jasgd.ASGDConfig(batch_size=32, delay=delay, mode=mode)
    tc = asgd.ASGDConfig(batch_size=32, delay=delay, mode=mode)
    jo, to = jopt.sgd(0.05), topt.sgd(0.05)
    jstep = jax.jit(jasgd.make_asgd_step(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg), jo, jc, N,
        fused_score=lambda p, b: jmlp.per_example_loss_and_score(
            p, b, jcfg)))
    tstep = asgd.make_asgd_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg), to, tc, N,
        fused_score=lambda p, b: tmlp.per_example_loss_and_score(p, b, cfg))
    jstate = jasgd.init_asgd_state(jparams, jo, jc, N)
    tstate = asgd.init_asgd_state(tparams, to, tc, N, "cpu")
    for i in range(6):
        idx = _reference_draw(jstate, jc, N)
        jstate, jm = jstep(jstate, train.arrays)
        tstate, tm = tstep(tstate, data, sample_indices=torch.tensor(idx))
        for f in ("loss", "grad_norm", "delay_gap"):
            _close(getattr(tm, f), getattr(jm, f), f"{f} {i}")
        if mode == "issgd":
            assert set(_np(tstate.store.scored_at)[idx]) == {i}
    _close(tstate.store.weights, jstate.store.weights, "weights")
    assert np.array_equal(_np(tstate.store.scored_at),
                          np.asarray(jstate.store.scored_at))
    _close_tree(tstate.params, jstate.params, "params")
    assert len(tstate.fifo) == delay + 1
    for k, fifo in enumerate(tstate.fifo):
        _close_tree(fifo, jax.tree.map(lambda b: b[k], jstate.fifo),
                    f"fifo {k}")
    assert tstate.step == 6


def test_asgd_refusals_and_generator_draws(mlp_setup):
    _, cfg, _, _, data, tparams = mlp_setup
    to = topt.sgd(0.05)
    with pytest.raises(ValueError, match="requires fused_score"):
        asgd.make_asgd_step(None, to, asgd.ASGDConfig(mode="issgd"), N)
    with pytest.raises(ValueError, match="mode 'bogus'"):
        asgd.make_asgd_step(None, to, asgd.ASGDConfig(mode="bogus"), N)
    tc = asgd.ASGDConfig(batch_size=16, delay=2, mode="issgd")
    step = asgd.make_asgd_step(
        None, to, tc, N,
        fused_score=lambda p, b: tmlp.per_example_loss_and_score(p, b, cfg))
    runs = []
    for _ in range(2):
        state = asgd.init_asgd_state(tparams, to, tc, N, "cpu", seed=2)
        for _ in range(3):
            state, m = step(state, data)
        runs.append(state.store.weights)
    assert torch.equal(runs[0], runs[1])
    assert np.isfinite(m.loss.item())


def test_sample_indices_replays_reference():
    rng = np.random.default_rng(9)
    w = rng.integers(0, 5, 256).astype(np.float32)
    key = jax.random.key(3)
    want = jsampler.sample_indices(key, jnp.asarray(w), 64, num_shards=4)
    u = np.asarray(jax.random.uniform(key, (64,), jnp.float32))
    got = sampler.sample_indices(torch.from_numpy(w), 64, num_shards=4,
                                 uniforms=torch.from_numpy(u))
    assert np.array_equal(_np(got), np.asarray(want))


# -------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv,match", [
    (["--arch", "glm4-9b", "--model-parallel", "3"], "num_heads"),
    (["--strategy", "full", "--model-parallel", "2"], "--strategy full"),
    (["--arch", "glm4-9b", "--smoke", "--stream", "--serve-loop",
      "--model-parallel", "4"], "num_kv_heads \\(2\\) for GQA decode"),
])
def test_flags_still_later_are_refused_by_name(argv, match, capsys):
    """The launcher carries every flag of the reference's; what
    ``--model-parallel`` still refuses is refused by name: the
    reference's refusals (a degree that does not divide num_heads, the
    ``full`` oracle) exit 2 from the parser; under the serve loop a
    degree the decode caches cannot split (glm4-9b smoke's 2 KV heads at
    M = 4) raises from ``main`` before any rank starts, as ``--mesh``'s
    refusals do, with ``decode_cache_specs``'s message."""
    assert ttrain.LATER_FLAGS == ()
    if "--serve-loop" in argv:
        with pytest.raises(ValueError, match=match):
            ttrain.main(argv + ["--device", "cpu"])
        return
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_new_flags_parse_with_reference_defaults():
    for flag in ("--probe-every", "--save-checkpoint",
                 "--restore-checkpoint", "--score-shards"):
        assert flag not in ttrain.LATER_FLAGS
    args = ttrain.parse_args(["--device", "cpu", "--mode", "fused",
                              "--strategy", "ghost_rev", "--probe-every",
                              "3", "--score-shards", "2"])
    assert (args.mode, args.strategy, args.probe_every,
            args.score_shards) == ("fused", "ghost_rev", 3, 2)
    d = ttrain.parse_args(["--device", "cpu"])
    assert (d.probe_every, d.score_shards, d.save_checkpoint,
            d.restore_checkpoint) == (8, 0, "", "")


def test_launcher_fused_mode_probes_after_step_i(monkeypatch):
    """--mode fused --probe-every 3: probes after steps 0, 3, 6; the
    rows of each probe slice carry the probed step's stamp."""
    probed = []
    real = issgd.make_score_step

    def spy(*a, **k):
        inner = real(*a, **k)

        def probe(state, data):
            probed.append(state.step)
            return inner(state, data)
        return probe

    # the launcher builds its probe through core/distributed.py
    monkeypatch.setattr(distributed, "make_score_step", spy)
    res = ttrain.run(ttrain.parse_args([
        "--smoke", "--device", "cpu", "--mode", "fused", "--steps", "7",
        "--examples", "256", "--batch", "16", "--score-batch", "32",
        "--probe-every", "3", "--log-every", "1"]))
    assert probed == [1, 4, 7]       # after steps 0, 3, 6: state.step i+1
    assert all(np.isfinite(r["loss"]) for r in res.history)
    # the last probe (state.step 7) wrote its 32-row slice after every
    # fused write
    assert int((res.state.store.scored_at == 7).sum()) == 32


@pytest.mark.parametrize("argv", [
    ["--score-shards", "2"],
    ["--mode", "fused", "--score-shards", "2"],
    ["--score-shards", "0"],
])
def test_launcher_score_shards(argv):
    args = ttrain.parse_args(["--smoke", "--device", "cpu", "--steps", "2",
                              "--examples", "256", "--batch", "16",
                              "--score-batch", "32"] + argv)
    built = ttrain.build(args)
    state, _ = built.step(built.state, built.data)
    assert state.step == 1
    if argv[-1] == "2" and "fused" not in argv:
        # W = 2: the slice takes 16 rows of each half of the table
        scored = np.nonzero(_np(state.store.scored_at) == 0)[0]
        assert (scored < 128).sum() == 16 and (scored >= 128).sum() == 16


def test_launcher_ghost_rev_lm_on_cpu():
    res = ttrain.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--strategy", "ghost_rev", "--seq",
                       "16", "--examples", "64", "--batch", "4",
                       "--score-batch", "8"])
    assert all(np.isfinite(r["loss"]) for r in res.history)
    with pytest.raises(ValueError, match="for the MLP"):
        ttrain.build(ttrain.parse_args(["--smoke", "--device", "cpu",
                                        "--strategy", "ghost_rev"]))
