"""The port's adaptive-IS controller and proposal strategies against the
JAX reference: live and replayed decisions on one event stream, the host
gate (closed ≡ uniform, open ≡ relaxed), the strategy zoo's scorers and
the bandit mixer, and an --adaptive-is launcher run replayed from its
JSONL.

Tolerances: the controller and the mixer are pure Python and must agree
exactly; the scorers are f32 forwards summed in another order, rtol 1e-6;
gated and plain-mode steps of the port must agree bitwise.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import controller as jctl  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_make_scorer  # noqa: E402
from repro.data import make_svhn_like as j_make_svhn_like  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.telemetry import EventSink as JEventSink  # noqa: E402
from repro.telemetry.events import read_events as j_read_events  # noqa: E402
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import controller as ctl_mod  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core import strategies  # noqa: E402
from repro_torch.core.scorer import make_mlp_scorer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.telemetry import EventSink, NullSink  # noqa: E402
from repro_torch.telemetry.events import read_events  # noqa: E402

SCORE_RTOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ the controller
def _events(seed, steps=60):
    """A seeded stream of the records a run emits: metrics (some traces
    missing, NaN or non-positive), scoring/master spans, a counter."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        stale = float(rng.uniform(0.5, 2.0))
        unif = float(stale * rng.uniform(0.7, 1.4))
        if i % 11 == 5:
            stale = float("nan")
        if i % 13 == 7:
            unif = 0.0
        out.append(("metrics", i, {"loss": float(rng.uniform(1, 3)),
                                   "trace_stale": stale, "trace_unif": unif,
                                   "ess_frac": float(rng.uniform(0.2, 1.0))}))
        out.append(("span", i, {"name": "scoring.dispatch",
                                "dur_s": round(float(rng.uniform(1e-3, 9e-3)),
                                               6)}))
        out.append(("span", i, {"name": "master.dispatch",
                                "dur_s": round(float(rng.uniform(1e-3, 3e-3)),
                                               6)}))
        if i % 4 == 0:
            out.append(("counter", i, {"name": "store.swaps", "value": i}))
    return out


CONFIGS = [{"adapt_every": 10},
           {"adapt_every": 7, "var_margin": 1.05, "ess_floor": 0.45,
            "hysteresis": 2},
           {"adapt_every": 5, "adapt_swap": True, "swap_min": 1,
            "swap_max": 6, "hysteresis": 3}]


@pytest.mark.parametrize("seed,cfg", [(0, CONFIGS[0]), (1, CONFIGS[1]),
                                      (2, CONFIGS[2])])
def test_live_and_replayed_decisions_match_reference(tmp_path, seed, cfg):
    """One event stream through the port's controller and the
    reference's: the live decisions agree exactly, and each package's
    replay of either package's JSONL reproduces them."""
    ours = ctl_mod.ProposalController(ctl_mod.ControllerConfig(**cfg),
                                      swap_every=2)
    ref = jctl.ProposalController(jctl.ControllerConfig(**cfg),
                                  swap_every=2)
    tap = ours.attach(EventSink(str(tmp_path / "port.jsonl")))
    jtap = ref.attach(JEventSink(str(tmp_path / "ref.jsonl")))
    for kind, step, fields in _events(seed):
        for t in (tap, jtap):
            if kind == "span":
                t.span(fields["name"], fields["dur_s"], step=step)
            elif kind == "counter":
                t.counter(fields["name"], fields["value"], step=step)
            else:
                t.emit(kind, step=step, **fields)
        if kind == "metrics":
            continue
        if kind == "span" and fields["name"] == "master.dispatch":
            d, jd = ours.maybe_decide(step), ref.maybe_decide(step)
            assert (d is None) == (jd is None)
            if d is not None:
                assert tuple(d) == tuple(jd)
                assert ours.gate() is d.use_is
    tap.close(), jtap.close()
    live = [tuple(d) for d in ours.decisions]
    assert live == [tuple(d) for d in ref.decisions]
    assert len(live) == 60 // cfg["adapt_every"]
    assert {d[6] for d in live} - {"no-signal"}    # the rule decided
    for path in ("port.jsonl", "ref.jsonl"):
        p = str(tmp_path / path)
        assert [tuple(d) for d in ctl_mod.replay_decisions(
            read_events(p))] == live
        assert [tuple(d) for d in jctl.replay_decisions(
            j_read_events(p))] == live


def test_replay_strict_raises_on_tampered_stream(tmp_path):
    p = str(tmp_path / "run.jsonl")
    ctl = ctl_mod.ProposalController(ctl_mod.ControllerConfig(adapt_every=2))
    with ctl.attach(EventSink(p)) as tap:
        for i in range(4):
            tap.emit("metrics", step=i, trace_stale=1.0, trace_unif=2.0)
            ctl.maybe_decide(i)
    recs = read_events(p)
    for r in recs:
        if r["kind"] == ctl_mod.DECISION_KIND:
            r["use_is"] = not r["use_is"]
    with pytest.raises(ValueError, match="replay mismatch"):
        ctl_mod.replay_decisions(recs)
    assert len(ctl_mod.replay_decisions(recs, strict=False)) == 2
    with pytest.raises(ValueError, match="before"):
        ctl_mod.replay_decisions([{"kind": ctl_mod.DECISION_KIND,
                                   "step": 0}])


def test_controller_gate_is_a_host_bool_and_tap_is_truthy():
    ctl = ctl_mod.ProposalController()
    tap = ctl.attach(NullSink())
    assert tap and ctl.gate() is False
    with pytest.raises(ValueError, match="adapt_every"):
        ctl_mod.ProposalController(ctl_mod.ControllerConfig(adapt_every=0))


# ---------------------------------------------------------------- the gate
@pytest.fixture(scope="module")
def mlp_setup():
    jcfg = j_smoke()
    train, _ = j_make_svhn_like(jax.random.key(0), n=512, dim=jcfg.input_dim)
    jparams = jmlp.init_mlp_classifier(jax.random.key(1), jcfg)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = {k: torch.from_numpy(np.array(v[:48]))
             for k, v in train.arrays.items()}
    jbatch = {k: v[:48] for k, v in train.arrays.items()}
    return jcfg, jparams, data, tparams, batch, jbatch


def _step(mode="relaxed", gated=False, **kw):
    cfg = smoke()
    opt = sgd(0.05)
    tcfg = issgd.ISSGDConfig(batch_size=16, score_batch_size=64,
                             refresh_every=2, score_shards=4, mode=mode,
                             **kw)
    return issgd.make_train_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg),
        make_mlp_scorer(cfg, "ghost"), opt, tcfg, 512, gated=gated), opt


def _same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.store.weights, b.store.weights)
    assert torch.equal(a.store.scored_at, b.store.scored_at)
    for which in ("params", "stale_params"):
        for name, leaves in getattr(a, which).items():
            for k, v in leaves.items():
                assert torch.equal(v, getattr(b, which)[name][k]), (which,
                                                                    name, k)


@pytest.mark.parametrize("schedule", [
    [False] * 4, [True] * 4, [False, True, True, False, True]])
def test_gate_is_the_mode_step_bitwise(mlp_setup, schedule):
    """Closed gate ≡ a uniform-mode step, open gate ≡ a relaxed step,
    draws from the generator included, step by step."""
    *_, data, tparams, _, _ = mlp_setup
    gstep, opt = _step(gated=True)
    assert gstep.gated
    ustep, _ = _step("uniform")
    rstep, _ = _step("relaxed")
    gs = issgd.init_train_state(tparams, opt, 512, "cpu", seed=3)
    rs = issgd.init_train_state(tparams, opt, 512, "cpu", seed=3)
    for t, use_is in enumerate(schedule):
        gs, gm = gstep(gs, data, use_is)
        rs, rm = (rstep if use_is else ustep)(rs, data)
        assert torch.equal(gm.sample_indices, rm.sample_indices), t
        assert torch.equal(gm.loss, rm.loss), t
        assert torch.equal(gs.rng.get_state(), rs.rng.get_state()), t
    _same_state(gs, rs)


def test_gate_needs_relaxed_mode_and_a_host_bool(mlp_setup):
    *_, data, tparams, _, _ = mlp_setup
    for mode in ("uniform", "exact"):
        with pytest.raises(ValueError, match="relaxed"):
            _step(mode, gated=True)
    step, opt = _step(gated=True)
    state = issgd.init_train_state(tparams, opt, 512, "cpu")
    with pytest.raises(ValueError, match="host bool"):
        step(state, data, torch.tensor(True))


# -------------------------------------------------------------- strategies
@pytest.mark.parametrize("strategy,kw", [
    ("upper_bound", {}), ("bandit_mixed", {}),
    ("bandit_mixed", {"mix": (0.3, 0.7)}),
    ("bandit_mixed", {"mix_of": ("loss", "ghost"), "mix": (2.0, 1.0)}),
    ("null", {}), ("logit_grad", {})])
def test_proposal_scorers_match_reference(mlp_setup, strategy, kw):
    jcfg, jparams, _, tparams, batch, jbatch = mlp_setup
    want = jstrat.make_proposal(j_make_scorer, jcfg, strategy, **kw)(
        jparams, jbatch)
    got = strategies.make_proposal(make_mlp_scorer, smoke(), strategy,
                                   **kw)(tparams, batch)
    assert got.shape == (48,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=SCORE_RTOL,
                               atol=0)
    if strategy == "null":
        assert not got.any()


def test_upper_bound_bounds_logit_grad(mlp_setup):
    *_, tparams, batch, _ = mlp_setup
    ub = strategies.make_proposal(make_mlp_scorer, smoke(), "upper_bound")
    lg = make_mlp_scorer(smoke(), "logit_grad")
    assert bool((ub(tparams, batch) >= lg(tparams, batch) - 1e-6).all())


def test_strategy_refusals():
    assert strategies.PROPOSALS == jstrat.PROPOSALS
    with pytest.raises(ValueError, match="unknown proposal strategy"):
        strategies.make_proposal(make_mlp_scorer, smoke(), "bogus")
    for weights, match in (([1.0], "mixture weights"),
                           ([-1.0, 2.0], "non-negative"),
                           ([0.0, 0.0], "all be zero")):
        with pytest.raises(ValueError, match=match):
            strategies.mixed_scorer([lambda p, b: 0, lambda p, b: 0],
                                    weights)
    with pytest.raises(ValueError, match="at least one"):
        strategies.mixed_scorer([])
    with pytest.raises(ValueError, match="at least one arm"):
        strategies.BanditMixer([])


def test_bandit_mixer_matches_reference():
    ours = strategies.BanditMixer(("loss", "logit_grad", "ghost"), eta=0.7,
                                  explore=0.05)
    ref = jstrat.BanditMixer(("loss", "logit_grad", "ghost"), eta=0.7,
                             explore=0.05)
    rng = np.random.default_rng(4)
    for _ in range(12):
        assert ours.mix() == ref.mix()
        r = float(rng.uniform(0.5, 2.0))
        ours.update(r)
        ref.update(r)
    assert ours.rounds == ref.rounds == 12
    assert abs(sum(ours.mix()) - 1.0) < 1e-12


# ---------------------------------------------------------------- launcher
def test_adaptive_is_launcher_replays_from_its_jsonl(tmp_path):
    """--adaptive-is through the launcher on the CPU: the run's live
    decisions are what both packages' replay_decisions derive from the
    JSONL, and the decision records sit in the stream."""
    jsonl = str(tmp_path / "run.jsonl")
    result = ttrain.main([
        "--smoke", "--steps", "12", "--examples", "512", "--batch", "16",
        "--score-batch", "64", "--adaptive-is", "--adapt-every", "4",
        "--metrics-every", "1", "--proposal-strategy", "upper_bound",
        "--metrics-jsonl", jsonl, "--device", "cpu"])
    assert len(result.decisions) == 3
    recs = read_events(jsonl)
    assert recs[0]["adaptive_is"] and \
        recs[0]["proposal_strategy"] == "upper_bound"
    assert [r["kind"] for r in recs].count(ctl_mod.DECISION_KIND) == 3
    live = [tuple(d) for d in result.decisions]
    assert [tuple(d) for d in ctl_mod.replay_decisions(recs)] == live
    assert [tuple(d) for d in jctl.replay_decisions(recs)] == live
    cfg = next(r for r in recs if r["kind"] == ctl_mod.CONFIG_KIND)
    assert {f.name for f in dataclasses.fields(ctl_mod.ControllerConfig)} \
        <= set(cfg)
