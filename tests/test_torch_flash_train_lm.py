"""The port's trainable flash-attention path against the JAX reference:
the autograd Functions and the LM path (the kernels' plain versions and
the CUDA legs are ``tests/test_torch_flash_train.py``, whose tolerances
and input recipes these tests share).

The autograd Functions against the reference's ``custom_vjp``s and
against ``torch.autograd.grad`` through the plain oracle; the LM scorer
with ``attn_impl="flash"`` and each ``attn_scores``; three relaxed/ghost
train steps on the fused path; the validation errors and the tap layout.
Inputs are made with numpy and handed to both frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import issgd as jissgd  # noqa: E402
from repro.core.scorer import make_lm_scorer as j_make_lm_scorer  # noqa: E402
from repro.data import make_token_dataset as j_make_token_dataset  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core.scorer import make_lm_scorer  # noqa: E402
from repro_torch.data import make_token_dataset  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import Tape, params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
from test_torch_flash_train import (ATOL, GRAD, N_EXAMPLES,  # noqa: E402
                                    RTOL, SCORE, SHAPES, _inputs, _leaves,
                                    _np)


@pytest.mark.parametrize("b,s,h,hkv,hd,win", SHAPES)
def test_trainable_functions_match_reference_custom_vjp(b, s, h, hkv, hd,
                                                        win):
    """The autograd Functions on CPU tensors against the reference's
    custom_vjp ops (interpret mode): 3-argument grads, and the 4-argument
    form's tap gradient against the oracle of the port's own grads."""
    q, k, v, do = _inputs(b, s, h, hkv, hd, seed=2 * s + win)
    fa3 = jops.make_flash_attention_trainable(window=win, block_q=16,
                                              block_k=16)
    fas = jops.make_flash_attention_trainable(window=win, block_q=16,
                                              block_k=16, with_scores=True)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    tap0 = jnp.zeros((b,), jnp.float32)
    want = jax.grad(lambda *a: jnp.sum(fas(*a) * jdo),
                    argnums=(0, 1, 2, 3))(jq, jk, jv, tap0)
    want3 = jax.grad(lambda *a: jnp.sum(fa3(*a) * jdo),
                     argnums=(0, 1, 2))(jq, jk, jv)
    tdo = torch.from_numpy(do)
    lq = _leaves(q, k, v)
    got3 = torch.autograd.grad(
        ops.make_flash_attention_trainable(window=win)(*lq), lq, tdo)
    ls = _leaves(q, k, v)
    tap = torch.zeros(b, requires_grad=True)
    got = torch.autograd.grad(ops.make_flash_attention_trainable(
        window=win, with_scores=True)(*ls, tap), ls + [tap], tdo)
    for g, w in zip(got3, want3):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD)
    assert all(torch.equal(a, c) for a, c in zip(got[:3], got3))
    np.testing.assert_allclose(_np(got[3]), np.asarray(want[3]), rtol=1e-4)
    oracle = jref.attn_grad_sqnorm_ref(*(jnp.asarray(_np(g))
                                         for g in got[:3]))
    np.testing.assert_allclose(_np(got[3]), np.asarray(oracle), **SCORE)


@pytest.mark.parametrize("b,s,h,hkv,hd,win", SHAPES[:3])
def test_trainable_function_matches_autograd_through_oracle(b, s, h, hkv,
                                                            hd, win):
    q, k, v, do = _inputs(b, s, h, hkv, hd, seed=3 * s)
    tdo = torch.from_numpy(do)
    lw = _leaves(q, k, v)
    want = torch.autograd.grad(ref.flash_attention_ref(*lw, window=win), lw,
                               tdo)
    lg = _leaves(q, k, v)
    out = ops.make_flash_attention_trainable(window=win)(*lg)
    torch.testing.assert_close(out, ref.flash_attention_ref(
        *(t.detach() for t in lg), window=win), rtol=2e-5, atol=2e-6)
    got = torch.autograd.grad(out, lg, tdo)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **GRAD)


# ---------------------------------------------------------------- models
def _cfgs(**kw):
    base = dict(name="t", arch_type="dense", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=64,
                dtype="float32", remat=False)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = _cfgs()
    train = j_make_token_dataset(jax.random.key(0), n=N_EXAMPLES, seq=13,
                                 vocab=jcfg.vocab_size)
    jparams = jtf.init_transformer(jax.random.key(1), jcfg)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, train, jparams, data, tparams


def test_tape_score_tap():
    tape = Tape(taps={"a": torch.arange(3.0)}, records={})
    assert torch.equal(tape.score_tap("a", 3, "cpu"), torch.arange(3.0))
    assert torch.equal(tape.score_tap("b", 3, "cpu"), torch.zeros(3))
    assert tape.records["a"].shape == (3, 0)
    assert Tape().score_tap("a", 2, "cpu").shape == (2,)


@pytest.mark.parametrize("attn_scores", [None, "fused", "separate"])
def test_tap_structure_with_score_tap(attn_scores):
    jcfg, cfg = _cfgs()
    want = jtf.tap_structure(jcfg, 3, 12, attn_impl="flash",
                             attn_scores=attn_scores)
    got = ttf.tap_structure(cfg, 3, 12, attn_impl="flash",
                            attn_scores=attn_scores)
    assert list(got.items()) == [(k, tuple(v.shape)) for k, v in want.items()]
    names = set(got)
    assert ("l0.attn.qkv_scores" in names) == (attn_scores is not None)
    assert ("l0.attn.wq" in names) == (attn_scores is None)


@pytest.mark.parametrize("window", [0, 5])
def test_attn_flash_route_equals_ref(tiny, window):
    """impl="flash" (the plain versions on the CPU) equals the chunked
    impl="ref" in value and in gradient."""
    _, cfg, _, _, _, tparams = tiny
    cfg = dataclasses.replace(cfg, sliding_window=window)
    lp = ttf._period(tparams["layers"], 0)["l0"]["mixer"]
    x = np.random.default_rng(5).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)
    pos = torch.arange(13)[None].expand(2, 13)
    outs = {}
    for impl in ("ref", "flash"):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = tattn.attn(lp, xt, cfg, pos, q_chunk=4, impl=impl)
        outs[impl] = (y, torch.autograd.grad(y.square().sum(), xt)[0])
    torch.testing.assert_close(outs["flash"][0], outs["ref"][0], rtol=2e-5,
                               atol=2e-6)
    torch.testing.assert_close(outs["flash"][1], outs["ref"][1], **GRAD)


@pytest.mark.parametrize("attn_scores", [None, "fused", "separate"])
def test_lm_flash_scorer_matches_reference(tiny, attn_scores):
    jcfg, cfg, train, jparams, data, tparams = tiny
    toks = train.arrays["tokens"][:6]
    want = j_make_lm_scorer(jcfg, "ghost", attn_impl="flash",
                            attn_scores=attn_scores)(jparams,
                                                     {"tokens": toks})
    got = make_lm_scorer(cfg, "ghost", attn_impl="flash",
                         attn_scores=attn_scores)(
        tparams, {"tokens": data["tokens"][:6]})
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if attn_scores is None:      # the exact estimator: flash == ref
        exact = make_lm_scorer(cfg, "ghost")(tparams,
                                             {"tokens": data["tokens"][:6]})
        torch.testing.assert_close(got, exact, rtol=1e-4, atol=0)


def test_fused_and_separate_stores_bitwise_after_four_steps():
    """The contract of tests/test_sampler_stats.py's fused-scorer leg, on
    the port: frozen params, 4 × 64 rows scored, stores bitwise equal."""
    _, cfg = _cfgs()
    train = make_token_dataset(torch.Generator().manual_seed(0), n=256,
                               seq=13, vocab=cfg.vocab_size)
    params = ttf.init_transformer(torch.Generator().manual_seed(1), cfg,
                                  "cpu")
    opt = sgd(0.0)
    tcfg = issgd.ISSGDConfig(batch_size=16, score_batch_size=64,
                             mode="relaxed", score_shards=4)
    pel = lambda p, b: ttf.per_example_loss(p, cfg, b, attn_impl="flash")[0]
    stores = {}
    for variant in ("fused", "separate"):
        step = issgd.make_train_step(
            pel, make_lm_scorer(cfg, "ghost", attn_impl="flash",
                                attn_scores=variant), opt, tcfg, train.size)
        st = issgd.init_train_state(params, opt, train.size, "cpu", seed=3)
        for _ in range(4):
            st, _ = step(st, train.arrays)
        stores[variant] = st.store
    assert bool((stores["fused"].scored_at >= 0).all())
    assert torch.equal(stores["fused"].weights, stores["separate"].weights)
    assert torch.equal(stores["fused"].scored_at, stores["separate"].scored_at)


def test_three_flash_train_steps_match_reference(tiny):
    """The slice as a whole: relaxed, ghost, the master on the trainable
    flash path and the scorer on the fused score tap; the port replays
    the reference's sampled indices and follows its losses, monitors,
    store and params."""
    jcfg, cfg, train, jparams, data, tparams = tiny
    kw = dict(batch_size=4, score_batch_size=16, refresh_every=2,
              mode="relaxed")
    jopt = j_sgd(0.05)
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jtf.per_example_loss(p, jcfg, b, attn_impl="flash")[0],
        j_make_lm_scorer(jcfg, "ghost", attn_impl="flash",
                         attn_scores="fused"),
        jopt, jissgd.ISSGDConfig(**kw), N_EXAMPLES))
    jstate = jissgd.init_train_state(jparams, jopt, N_EXAMPLES)
    topt = sgd(0.05)
    tstep = issgd.make_train_step(
        lambda p, b: ttf.per_example_loss(p, cfg, b, attn_impl="flash")[0],
        make_lm_scorer(cfg, "ghost", attn_impl="flash", attn_scores="fused"),
        topt, issgd.ISSGDConfig(**kw), N_EXAMPLES)
    tstate = issgd.init_train_state(tparams, topt, N_EXAMPLES, "cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, train.arrays)
        tstate, tm = tstep(tstate, data, sample_indices=torch.tensor(
            np.asarray(jm.sample_indices)))
        for field in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                      "trace_unif", "ess_frac", "mean_weight"):
            np.testing.assert_allclose(_np(getattr(tm, field)),
                                       np.asarray(getattr(jm, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_allclose(_np(tstate.store.weights),
                               np.asarray(jstate.store.weights),
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(_np(tstate.store.scored_at),
                          np.asarray(jstate.store.scored_at))
    want = _flat(params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    got = _flat(tstate.params)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), _np(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------------ validation
def test_validation_errors(tiny):
    _, cfg, _, _, _, tparams = tiny
    with pytest.raises(ValueError, match="'fused', 'separate' or None"):
        make_lm_scorer(cfg, "ghost", attn_impl="flash", attn_scores="both")
    with pytest.raises(ValueError, match="no effect on strategy 'loss'"):
        make_lm_scorer(cfg, "loss", attn_impl="flash", attn_scores="fused")
    with pytest.raises(ValueError, match="needs the trainable flash"):
        make_lm_scorer(cfg, "ghost", attn_scores="fused")
    with pytest.raises(ValueError, match="mla"):
        make_lm_scorer(dataclasses.replace(cfg, attention="mla"), "ghost",
                       attn_impl="flash", attn_scores="separate")
    lp = ttf._period(tparams["layers"], 0)["l0"]["mixer"]
    x, pos = torch.zeros(1, 4, cfg.d_model), torch.arange(4)[None]
    with pytest.raises(ValueError, match="'fused', 'separate' or None"):
        tattn.attn(lp, x, cfg, pos, impl="flash", attn_scores="x")
    with pytest.raises(ValueError, match="needs the trainable flash"):
        tattn.attn(lp, x, cfg, pos, impl="pallas", attn_scores="fused")
    with pytest.raises(ValueError, match="needs the trainable flash"):
        ttf.tap_structure(cfg, 1, 4, attn_scores="separate")
    with pytest.raises(ValueError, match="impl must be one of"):
        tattn.attn(lp, x, cfg, pos, impl="bogus")
    args = ttrain.parse_args(["--device", "cpu", "--smoke", "--examples",
                              "64", "--steps", "1"])
    with pytest.raises(ValueError, match="no attention"):
        ttrain.build(args, attn_impl="flash")


def test_launcher_builds_the_flash_path_on_cpu(tiny):
    """build(..., attn_impl="flash", attn_scores="fused") runs steps whose
    losses match the ref path's (same params, same draws: the master's
    flash loss equals the ref loss to f32 rounding)."""
    _, cfg, _, _, _, _ = tiny
    argv = ["--arch", "glm4-9b", "--device", "cpu", "--steps", "2", "--seq",
            "12", "--batch", "4", "--score-batch", "8", "--examples", "64",
            "--log-every", "1"]
    args = ttrain.parse_args(argv)
    flash = ttrain.run(args, cfg, attn_impl="flash", attn_scores="fused")
    exact = ttrain.run(args, cfg, attn_impl="flash")
    plain = ttrain.run(args, cfg)
    assert len(flash.history) == 2
    for a, b in zip(exact.history, plain.history):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    assert all(np.isfinite(r["loss"]) for r in flash.history)
