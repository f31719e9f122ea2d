"""The port's falcon-mamba-7b (smoke) against the JAX reference: the
config, forward, loss, taps and parameter transfer; the LM scorers in
both scan modes; three relaxed ISSGD steps; the refusals; the launcher
(the scan kernel and the mamba block are ``tests/test_torch_ssm.py``,
whose tolerances and input recipes these tests share).  Inputs are made
with numpy from a seed and handed to both frameworks; weights come from
the reference through ``params_from_jax``.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core.scorer import make_lm_scorer as j_make_lm_scorer  # noqa: E402
from repro.data import make_token_dataset as j_make_token_dataset  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core.scorer import make_lm_scorer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_ssm import (BF16_RTOL, F32, MODEL_F32, N_EXAMPLES,  # noqa
                            _both, _close_bf16, _mamba_cfg, _np,
                            _scan_inputs)


# -------------------------------------------------- falcon-mamba-7b (smoke)
@pytest.fixture(scope="module")
def falcon():
    jcfg = jconfigs.get_smoke_config("falcon-mamba-7b")
    cfg = configs.get_smoke_config("falcon-mamba-7b")
    jparams = jtf.init_transformer(jax.random.key(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    train = j_make_token_dataset(jax.random.key(0), n=N_EXAMPLES, seq=17,
                                 vocab=jcfg.vocab_size)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    return jcfg, cfg, jparams, tparams, train, data


def test_falcon_config_matches_reference():
    for getter in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, getter)("falcon-mamba-7b")
        for name in ("falcon-mamba-7b", "falcon_mamba_7b"):
            got = getattr(configs, getter)(name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cfg = configs.get_config("falcon-mamba-7b")
    assert cfg.param_count() == jconfigs.get_config(
        "falcon-mamba-7b").param_count() == 7_272_140_800
    assert [s.mixer for s in cfg.layer_specs()] == ["mamba"]


def test_params_from_jax_is_bitwise_on_mixed_dtypes():
    """A bf16 falcon-mamba smoke tree (bf16 projections and norms, f32 Δ
    and A leaves) comes across bit for bit, dtype for dtype."""
    jcfg = dataclasses.replace(
        jconfigs.get_smoke_config("falcon-mamba-7b"), dtype="bfloat16")
    jp = jax.tree.map(np.asarray, jtf.init_transformer(jax.random.key(2),
                                                       jcfg))
    tp = params_from_jax(jp)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    kinds = set()
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        kinds.add(str(leaf.dtype))
        assert str(t.dtype)[6:] == str(leaf.dtype)
        bits = np.int16 if leaf.dtype.itemsize == 2 else np.int32
        np.testing.assert_array_equal(
            t.view(torch.int16 if bits is np.int16 else torch.int32).numpy(),
            leaf.view(bits))
    assert kinds == {"bfloat16", "float32"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_falcon_smoke_forward_and_loss(falcon, dtype):
    jcfg, cfg, jparams, _, train, data = falcon
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    # model-dtype leaves as the config's dtype, the f32 leaves stay f32
    jparams = jtf.init_transformer(jax.random.key(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = train.arrays["tokens"][:3]
    want, _ = jtf.forward(jparams, jcfg, toks[:, :-1])
    got, _ = ttf.forward(tparams, cfg, data["tokens"][:3, :-1])
    assert got.dtype == getattr(torch, dtype)
    wl, _ = jtf.per_example_loss(jparams, jcfg, {"tokens": toks})
    gl, _ = ttf.per_example_loss(tparams, cfg, {"tokens": data["tokens"][:3]})
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_F32)
        np.testing.assert_allclose(_np(gl), np.asarray(wl), **MODEL_F32)
    else:
        _close_bf16(got, want)
        np.testing.assert_allclose(_np(gl), np.asarray(wl), rtol=BF16_RTOL)


def test_falcon_smoke_pallas_forward_matches_reference(falcon):
    jcfg, cfg, jparams, tparams, train, data = falcon
    toks = train.arrays["tokens"][:2, :-1]
    want, _ = jtf.forward(jparams, jcfg, toks, ssm_mode="pallas")
    with torch.no_grad():
        got, _ = ttf.forward(tparams, cfg, data["tokens"][:2, :-1],
                             ssm_mode="pallas")
    np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_F32)


def test_falcon_tap_structure_and_records(falcon):
    jcfg, cfg, jparams, tparams, train, data = falcon
    want = jtf.tap_structure(jcfg, 4, 9)
    got = ttf.tap_structure(cfg, 4, 9)
    assert list(got) == list(want) == ["l0.mamba.in_proj", "l0.mamba.x_proj",
                                       "l0.mamba.out_proj", "unembed"]
    assert {k: tuple(v.shape) for k, v in want.items()} == got
    toks = data["tokens"][:4, :10]
    taps = {k: torch.zeros(v, requires_grad=True) for k, v in got.items()}
    _, aux = ttf.per_example_loss(tparams, cfg, {"tokens": toks}, taps=taps,
                                  collect=True)
    _, jaux = jtf.per_example_loss(
        jparams, jcfg, {"tokens": jnp.asarray(toks.numpy())},
        taps={k: jnp.zeros(v) for k, v in got.items()}, collect=True)
    assert list(aux.records) == list(got)
    for k, r in aux.records.items():
        np.testing.assert_allclose(_np(r), np.asarray(jaux.records[k]),
                                   **MODEL_F32, err_msg=k)


# ----------------------------------------------------------------- scorers
@pytest.mark.parametrize("strategy,mode", [
    ("loss", "ref"), ("loss", "pallas"), ("logit_grad", "ref"),
    ("logit_grad", "pallas"), ("ghost", "ref"), ("full", "ref")])
def test_falcon_scores_match_reference(falcon, strategy, mode):
    jcfg, cfg, jparams, tparams, train, data = falcon
    n = 2 if strategy == "full" else 6
    want = j_make_lm_scorer(jcfg, strategy, ssm_mode=mode)(
        jparams, {"tokens": train.arrays["tokens"][:n]})
    got = make_lm_scorer(cfg, strategy, ssm_mode=mode)(
        tparams, {"tokens": data["tokens"][:n]})
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


# ------------------------------------------------------ the slice, 3 steps
@pytest.mark.parametrize("strategy,mode", [("ghost", "ref"),
                                           ("logit_grad", "pallas")])
def test_three_falcon_train_steps_match_reference(falcon, strategy, mode):
    """Relaxed ISSGD on falcon-mamba-7b-smoke: the master differentiates
    the ref scan; the scorer runs ``mode``.  The port replays the
    reference's sampled indices and follows its losses, monitors, store
    and params (refresh_every=2 puts a stale-param push in the run)."""
    jcfg, cfg, jparams, tparams, train, data = falcon
    kw = dict(batch_size=4, score_batch_size=16, refresh_every=2,
              mode="relaxed")
    jopt = j_sgd(0.05)
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jtf.per_example_loss(p, jcfg, b)[0],
        j_make_lm_scorer(jcfg, strategy, ssm_mode=mode), jopt,
        jissgd.ISSGDConfig(**kw), N_EXAMPLES))
    jstate = jissgd.init_train_state(jparams, jopt, N_EXAMPLES)
    topt = sgd(0.05)
    tstep = issgd.make_train_step(
        lambda p, b: ttf.per_example_loss(p, cfg, b)[0],
        make_lm_scorer(cfg, strategy, ssm_mode=mode), topt,
        issgd.ISSGDConfig(**kw), N_EXAMPLES)
    tstate = issgd.init_train_state(tparams, topt, N_EXAMPLES, "cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, train.arrays)
        tstate, tm = tstep(tstate, data, sample_indices=torch.tensor(
            np.asarray(jm.sample_indices)))
        for field in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                      "trace_unif", "ess_frac", "mean_weight"):
            np.testing.assert_allclose(_np(getattr(tm, field)),
                                       np.asarray(getattr(jm, field)),
                                       **F32, err_msg=field)
    np.testing.assert_allclose(_np(tstate.store.weights),
                               np.asarray(jstate.store.weights), **F32)
    assert np.array_equal(_np(tstate.store.scored_at),
                          np.asarray(jstate.store.scored_at))
    want = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    for path, leaf in want:
        t = tstate.params
        for key in path:
            t = t[key.key]
        np.testing.assert_allclose(_np(t), np.asarray(leaf), **F32,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------- refusals
def test_forward_only_kernel_refusals(falcon):
    _, cfg, _, tparams, _, data = falcon
    for strategy in ("ghost", "full"):
        with pytest.raises(ValueError, match="no backward"):
            make_lm_scorer(cfg, strategy, ssm_mode="pallas")
    with pytest.raises(ValueError, match="ssm_mode must be one of"):
        make_lm_scorer(cfg, "loss", ssm_mode="scan")
    _, tx = _both(_scan_inputs(1, 8, 16, 4, seed=9), "float32")
    tx[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.selective_scan(*tx)
    with torch.no_grad():
        ops.selective_scan(*tx)            # fine without a gradient
    # the model's pallas path under autograd raises instead of dropping
    # the gradient; its ref path differentiates
    live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams)
    batch = {"tokens": data["tokens"][:2]}
    with pytest.raises(RuntimeError, match="forward-only"):
        ttf.per_example_loss(live, cfg, batch, ssm_mode="pallas")
    loss, _ = ttf.per_example_loss(live, cfg, batch)
    loss.sum().backward()
    assert live["layers"]["l0"]["mixer"]["a_log"].grad is not None
    lp = ttf._period(tparams["layers"], 0)["l0"]["mixer"]
    # the prefill collector (the serving engine's decode state) works, on
    # the oracle scan whatever the mode
    for mode in ("ref", "pallas"):
        c = {}
        tssm.mamba(lp, torch.zeros(1, 4, cfg.d_model), cfg, mode=mode,
                   collector=c)
        assert set(c) == {"mamba.conv", "mamba.h"}
        assert c["mamba.h"].dtype == torch.float32
    with pytest.raises(ValueError, match="ssm_mode must be one of"):
        tssm.mamba(lp, torch.zeros(1, 4, cfg.d_model), cfg, mode="scan")


def test_model_code_admits_mamba_but_not_moe_or_mla():
    """A mamba stack with MoE feed-forwards builds (jamba's layout), and
    the serving engine serves it: a prefill and a decode step."""
    from repro_torch.serving.engine import (check_servable, decode_step,
                                            prefill)
    _, cfg = _mamba_cfg(num_experts=4, num_experts_per_tok=2, d_ff=40)
    p = ttf.init_transformer(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(p["layers"]["l0"]["ff"]) == {"router", "w_in", "w_gate",
                                            "w_out"}
    check_servable(cfg)
    logits, st = prefill(p, cfg, torch.zeros(2, 6, dtype=torch.int32), 8)
    logits, st = decode_step(p, cfg, torch.argmax(logits, -1).to(
        torch.int32), st)
    assert torch.isfinite(logits).all() and st.lengths.tolist() == [7, 7]
    # a hybrid of mamba and GQA attention layers with MLPs: both mixers
    _, cfg = _mamba_cfg(num_layers=2, attn_every=2, attention="gqa",
                        num_heads=4, num_kv_heads=2, d_ff=40)
    p = ttf.init_transformer(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(p["layers"]["l0"]) == {"ln1", "mixer", "ln2", "ff"}
    assert "wq" in p["layers"]["l0"]["mixer"]
    assert "a_log" in p["layers"]["l1"]["mixer"]
    loss, _ = ttf.per_example_loss(p, cfg, {"tokens": torch.zeros(
        2, 6, dtype=torch.int32)})
    assert torch.isfinite(loss).all()


# ---------------------------------------------------------------- launcher
def test_launcher_trains_falcon_on_cpu(capsys):
    result = ttrain.main(["--arch", "falcon-mamba-7b", "--smoke", "--steps",
                          "2", "--examples", "64", "--batch", "4",
                          "--score-batch", "16", "--seq", "8",
                          "--log-every", "1", "--device", "cpu"])
    assert result.state.step == 2
    assert result.state.params["layers"]["l0"]["mixer"]["in_proj"].shape == \
        (2, 256, 1024)
    lines = capsys.readouterr().out.splitlines()
    assert all(re.match(r"step +\d+ loss \d+\.\d{4} ", ln) for ln in lines[:2])
    assert lines[2].startswith("done: 2 steps on cpu")


def test_launcher_reaches_the_kernel_through_the_scorer_only(monkeypatch):
    """run(..., ssm_mode="pallas") routes the scorer's scans through
    ops.selective_scan (one call a layer a scoring pass) while the master
    stays on the ref scan; the two runs draw and train identically up to
    the scores' f32 rounding."""
    calls = []
    real = ops.selective_scan
    monkeypatch.setattr(ops, "selective_scan",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    argv = ["--arch", "falcon-mamba-7b", "--smoke", "--steps", "2",
            "--examples", "64", "--batch", "4", "--score-batch", "16",
            "--seq", "8", "--strategy", "logit_grad", "--device", "cpu"]
    kern = ttrain.run(ttrain.parse_args(argv), ssm_mode="pallas")
    assert len(calls) == 2 * 2            # 2 layers × 2 scoring passes
    plain = ttrain.run(ttrain.parse_args(argv))
    assert len(calls) == 4
    for a, b in zip(kern.history, plain.history):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    with pytest.raises(ValueError, match="no attention or mamba"):
        ttrain.build(ttrain.parse_args(["--device", "cpu", "--smoke",
                                        "--examples", "64"]),
                     ssm_mode="pallas")
