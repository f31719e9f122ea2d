"""The port's telemetry against the JAX reference: MonitorSet, the event
sink and its records, spans, the proposal-health monitors, monitors on ≡
off, and a launcher run whose JSONL ``tools/metrics_report.py`` reads.

Tolerances: the monitors are f32 reductions over the same proposal in
another order, rtol 1e-6 (the counts exactly); event records compare
exactly but for their wall-clock field ``t``; monitors on and off must
give the same trajectory bitwise.
"""
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core import weight_store as jws  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_make_scorer  # noqa: E402
from repro.data import make_svhn_like as j_make_svhn_like  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.telemetry import EventSink as JEventSink  # noqa: E402
from repro.telemetry import MonitorSet as JMonitorSet  # noqa: E402
from repro.telemetry.monitors import \
    proposal_monitors as j_proposal_monitors  # noqa: E402
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.core.importance import ISConfig  # noqa: E402
from repro_torch.core.scorer import make_mlp_scorer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.telemetry import (MONITOR_NAMES, SCHEMA_VERSION,  # noqa: E402
                                   EventSink, MonitorSet, NullSink,
                                   Telemetry)
from repro_torch.telemetry.events import read_events  # noqa: E402
from repro_torch.telemetry.monitors import proposal_monitors  # noqa: E402
from repro_torch.telemetry.spans import span, timed  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
MON_RTOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------- MonitorSet
@pytest.mark.parametrize("spec", ["all", "none", "", "off", "staleness,ess",
                                  "ENTROPY, empty_rows", "max_weight_frac"])
def test_monitor_set_parse_matches_reference(spec):
    assert MonitorSet.parse(spec).names == JMonitorSet.parse(spec).names
    assert bool(MonitorSet.parse(spec)) == bool(JMonitorSet.parse(spec))


def test_monitor_set_errors_and_falsiness():
    assert MONITOR_NAMES == JMonitorSet.all().names
    assert (MonitorSet(()) or None) is None
    with pytest.raises(ValueError, match="unknown monitor"):
        MonitorSet.parse("ess,bogus")
    with pytest.raises(ValueError, match="unknown monitor"):
        MonitorSet(("bogus",))


# ---------------------------------------------------------------- event sink
def _write_stream(sink_cls, path):
    sink = sink_cls(str(path), run={"arch": "mlp", "seed": 3},
                    flush_every=2)
    sink.span("scoring.dispatch", 0.01234567, step=0)
    sink.counter("stream.hit_rate", np.float32(0.5), step=0)
    sink.emit("metrics", step=1, loss=float(np.float32(1.5)),
              idx=np.arange(2), ess=np.float32(0.25))
    sink.emit("monitors", step=1, staleness=np.int32(3))
    sink.emit("run_end", step=1, steps=2, odd=object())
    sink.close()
    sink.close()   # idempotent
    return [{k: v for k, v in r.items() if k != "t"}
            for r in read_events(str(path))]


def test_event_sink_records_equal_the_reference(tmp_path):
    ours = _write_stream(EventSink, tmp_path / "port.jsonl")
    ref = _write_stream(JEventSink, tmp_path / "ref.jsonl")
    assert ours[:-1] == ref[:-1]
    # a value JSON cannot hold is stringified, as the reference does
    assert ours[-1].keys() == ref[-1].keys()
    assert isinstance(ours[-1]["odd"], str)
    assert [r["kind"] for r in ours] == ["run", "span", "counter", "metrics",
                                        "monitors", "run_end"]
    assert all(r["v"] == SCHEMA_VERSION == 1 for r in ours)
    assert ours[1]["dur_s"] == round(0.01234567, 6)
    assert ours[3]["idx"] == [0, 1] and ours[3]["ess"] == 0.25
    # a torn last line is skipped, not fatal
    with open(tmp_path / "port.jsonl", "a") as f:
        f.write("{not json\n")
    assert len(read_events(str(tmp_path / "port.jsonl"))) == 6


def test_port_sink_takes_tensor_scalars(tmp_path):
    p = tmp_path / "t.jsonl"
    with EventSink(str(p)) as sink:
        sink.emit("metrics", step=0, loss=torch.tensor(1.5),
                  idx=torch.arange(3), n=torch.tensor(4, dtype=torch.int32))
    rec = read_events(str(p))[1]
    assert rec["loss"] == 1.5 and rec["idx"] == [0, 1, 2] and rec["n"] == 4


def test_null_sink_is_inert():
    sink = NullSink()
    assert not sink
    sink.emit("metrics", loss=1.0)
    sink.span("x", 0.1)
    sink.counter("c", 1)
    sink.flush(), sink.close()
    assert sink.emitted == 0 and sink.path is None
    tel = Telemetry.null()
    assert not tel and tel is Telemetry.null()
    assert tel.timed("x", lambda a: a + 1, 1) == 2
    with tel.span("y"):
        pass
    assert not tel.due(0)
    with pytest.raises(ValueError, match="cadence"):
        Telemetry(NullSink(), every=0)


@pytest.mark.parametrize("block", [False, True])
def test_span_and_timed(tmp_path, block):
    p = str(tmp_path / "s.jsonl")
    sink = EventSink(p)
    with span(sink, "serve.tick", step=4):
        time.sleep(0.01)
    out = timed(sink, "master.dispatch", torch.square, torch.tensor(3.0),
                step=5, block=block)
    assert float(out) == 9.0
    tel = Telemetry(sink, every=3, blocking=block)
    assert tel.timed("train.step", lambda a: a * 2, 4, step=6) == 8
    assert [tel.due(t) for t in range(4)] == [True, False, False, True]
    sink.close()
    recs = [r for r in read_events(p) if r["kind"] == "span"]
    assert [r["name"] for r in recs] == ["serve.tick", "master.dispatch",
                                         "train.step"]
    assert recs[0]["step"] == 4 and recs[0]["dur_s"] >= 0.01
    assert recs[2]["step"] == 6 and recs[2]["dur_s"] >= 0


# ------------------------------------------------------------------ monitors
def _store_and_proposal(seed, n=512):
    rng = np.random.default_rng(seed)
    weights = (np.abs(rng.standard_normal(n)) * 3).astype(np.float32)
    scored = rng.integers(-1, 9, n).astype(np.int32)
    scored[rng.choice(n, 40, replace=False)] = jws.EMPTY
    return weights, scored


@pytest.mark.parametrize("seed,threshold", [(0, 0), (1, 3)])
def test_proposal_monitors_match_reference(seed, threshold):
    weights, scored = _store_and_proposal(seed)
    n, step = weights.shape[0], 10
    jstore = jws.WeightStore(jnp.asarray(weights), jnp.asarray(scored))
    tstore = ws.WeightStore(torch.from_numpy(weights),
                            torch.from_numpy(scored))
    from repro.core.importance import ISConfig as JISConfig
    jq = jws.read_proposal(jstore, step,
                           JISConfig(staleness_threshold=threshold))
    tq = ws.read_proposal(tstore, step,
                          ISConfig(staleness_threshold=threshold))
    want = j_proposal_monitors(jstore, jq, step, (), n, JMonitorSet.all())
    for kw in ({}, {"sum_w": torch.sum(tq),
                    "sum_w2": torch.sum(torch.square(tq))}):
        got = proposal_monitors(tstore, tq, step, n, MonitorSet.all(), **kw)
        assert list(got) == list(want)
        for k in MONITOR_NAMES:
            assert got[k].ndim == 0, k
            if k in ("empty_rows", "staleness"):
                assert int(got[k]) == int(want[k]), k
            else:
                np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                           rtol=MON_RTOL, err_msg=k)
    sub = proposal_monitors(tstore, tq, step, n,
                            MonitorSet.parse("staleness"))
    assert list(sub) == ["staleness"]


# ------------------------------------------------------------ the step, on
@pytest.fixture(scope="module")
def mlp_setup():
    jcfg = j_smoke()
    train, _ = j_make_svhn_like(jax.random.key(0), n=512, dim=jcfg.input_dim)
    jparams = jmlp.init_mlp_classifier(jax.random.key(1), jcfg)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, train, jparams, data, tparams


def _port_step(monitors, **kw):
    cfg = smoke()
    opt = sgd(0.05)
    tcfg = issgd.ISSGDConfig(batch_size=16, score_batch_size=64,
                             refresh_every=2, score_shards=4, **kw)
    step = issgd.make_train_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg),
        make_mlp_scorer(cfg, "ghost"), opt, tcfg, 512, monitors=monitors)
    return step, opt


def test_step_monitors_match_reference(mlp_setup):
    """Two steps with every monitor, the reference's draws injected: the
    port's monitors follow the reference's."""
    jcfg, train, jparams, data, tparams = mlp_setup
    jopt = j_sgd(0.05)
    kw = dict(batch_size=16, score_batch_size=64, refresh_every=2,
              score_shards=4)
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg),
        j_make_scorer(jcfg, "ghost"), jopt, jissgd.ISSGDConfig(**kw), 512,
        monitors=JMonitorSet.all()))
    jstate = jissgd.init_train_state(jparams, jopt, 512)
    tstep, topt = _port_step(MonitorSet.all())
    assert tstep.with_monitors
    tstate = issgd.init_train_state(tparams, topt, 512, "cpu")
    for _ in range(2):
        jstate, jm, jmon = jstep(jstate, train.arrays)
        tstate, tm, tmon = tstep(tstate, data, sample_indices=torch.tensor(
            np.asarray(jm.sample_indices)))
        for k in MONITOR_NAMES:
            np.testing.assert_allclose(_np(tmon[k]), np.asarray(jmon[k]),
                                       rtol=MON_RTOL, err_msg=k)
        np.testing.assert_allclose(_np(tmon["ess"]), _np(tm.ess_frac),
                                   rtol=MON_RTOL)


def test_monitors_on_is_bitwise_off(mlp_setup):
    """Monitors only read: four drawn steps with every monitor give the
    params, store and draws of four steps without."""
    *_, data, tparams = mlp_setup
    runs = {}
    for on in (False, True):
        step, opt = _port_step(MonitorSet.all() if on else None)
        assert step.with_monitors is on
        state = issgd.init_train_state(tparams, opt, 512, "cpu", seed=5)
        draws = []
        for _ in range(4):
            state, m, *mon = step(state, data)
            assert bool(mon) is on
            draws.append(m.sample_indices)
        runs[on] = (state, draws)
    (a, da), (b, db) = runs[False], runs[True]
    assert all(torch.equal(x, y) for x, y in zip(da, db))
    assert torch.equal(a.store.weights, b.store.weights)
    assert torch.equal(a.store.scored_at, b.store.scored_at)
    for name, leaves in a.params.items():
        for k, v in leaves.items():
            assert torch.equal(v, b.params[name][k]), (name, k)


# ---------------------------------------------------- launcher end to end
def _report(jsonl, out_json):
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "metrics_report.py"), jsonl,
         "--json", out_json], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out_json) as f:
        return r.stdout, json.load(f)


def test_metrics_jsonl_end_to_end(tmp_path):
    """--metrics-jsonl, --monitors all and --metrics-out through the
    launcher on the CPU, then the unmodified tools/metrics_report.py: its
    trajectory is the run's metrics records, which are the history."""
    jsonl = str(tmp_path / "run.jsonl")
    hist = str(tmp_path / "history.json")
    result = ttrain.main([
        "--smoke", "--steps", "7", "--examples", "512", "--batch", "16",
        "--score-batch", "64", "--log-every", "3", "--metrics-every", "2",
        "--monitors", "all", "--metrics-jsonl", jsonl, "--metrics-out", hist,
        "--device", "cpu"])
    recs = read_events(jsonl)
    kinds = [r["kind"] for r in recs]
    assert kinds[0] == "run" and kinds[-1] == "run_end"
    assert {"span", "metrics", "monitors"} <= set(kinds)
    assert recs[0]["monitors"] == list(MONITOR_NAMES)
    assert recs[0]["device"] == "cpu" and recs[0]["arch"] == "mlp_svhn"
    mets = [r for r in recs if r["kind"] == "metrics"]
    mons = [r for r in recs if r["kind"] == "monitors"]
    assert [r["step"] for r in mets] == [0, 2, 4, 6]
    assert [r["step"] for r in mons] == [0, 2, 4, 6]
    assert all(isinstance(r["staleness"], int) and r["staleness"] == 0
               for r in mons)
    assert sum(k == "span" for k in kinds) == 7
    logged = {r["step"]: r for r in result.history}
    assert sorted(logged) == [0, 3, 6]
    with open(hist) as f:
        assert json.load(f) == result.history
    for rec in mets:
        if rec["step"] in logged:
            for k in ttrain.METRIC_KEYS:
                assert rec[k] == logged[rec["step"]][k], k
    assert recs[-1]["final_loss"] == result.history[-1]["loss"]
    text, summary = _report(jsonl, str(tmp_path / "summary.json"))
    assert [row["step"] for row in summary["trajectory"]] == [0, 2, 4, 6]
    for row, rec in zip(summary["trajectory"], mets):
        for k in ("trace_ideal", "trace_stale", "trace_unif", "loss"):
            assert row[k] == rec[k]
    assert summary["monitors"]["ess"] == [r["ess"] for r in mons]
    assert summary["spans"]["train.step"]["count"] == 7
    assert summary["run"]["arch"] == "mlp_svhn"
    assert "√TrΣ trajectory" in text and math.isfinite(
        summary["trajectory"][-1]["loss"])


def test_profile_window_writes_trace(tmp_path):
    """--profile-dir opens a torch.profiler window over --profile-steps,
    writes its trace into the directory and records profile start and
    stop; --telemetry-blocking closes each span after a synchronise."""
    jsonl = str(tmp_path / "run.jsonl")
    pdir = tmp_path / "prof"
    ttrain.main(["--smoke", "--steps", "4", "--examples", "512", "--batch",
                 "16", "--score-batch", "64", "--profile-dir", str(pdir),
                 "--profile-steps", "1:2", "--telemetry-blocking",
                 "--metrics-jsonl", jsonl, "--device", "cpu"])
    prof = [r for r in read_events(jsonl) if r["kind"] == "profile"]
    assert [(r["step"], r["action"]) for r in prof] == [(1, "start"),
                                                         (2, "stop")]
    assert prof[0]["dir"] == str(pdir)
    trace = json.loads((pdir / "trace.json").read_text())
    assert trace["traceEvents"]
    assert os.path.getsize(pdir / "trace.json") > 0
