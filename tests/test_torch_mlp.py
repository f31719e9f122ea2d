"""The port's MLP, scorers, optimizer and IS primitives against the JAX
reference, on the reference's mlp_svhn smoke config (64→128→128→10).

Inputs and parameters are made once with numpy/JAX and fed to both
packages.  Tolerances: rtol 1e-5 (atol 1e-6 where values can be near 0)
for f32 results that pass through a few matmuls and reductions, whose
summation orders differ between the frameworks (each step a few ulps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import mlp_svhn as jcfg_mod  # noqa: E402
from repro.core import importance as jimp  # noqa: E402
from repro.core import variance as jvar  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_make_scorer  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import mlp_svhn as tcfg_mod  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import variance as tvar  # noqa: E402
from repro_torch.core.scorer import make_mlp_scorer  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def setup():
    jcfg = jcfg_mod.smoke()
    tcfg = tcfg_mod.smoke()
    jparams = jmlp.init_mlp_classifier(jax.random.key(1), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, jcfg.input_dim)).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, 48).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=params_from_jax(np_params),
                jbatch={"x": jnp.asarray(x), "y": jnp.asarray(y)},
                tbatch={"x": torch.from_numpy(x), "y": torch.from_numpy(y)})


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", ["CONFIG", "smoke"])
def test_config_copies_match_reference(which):
    def fields(mod):
        c = mod.CONFIG if which == "CONFIG" else mod.smoke()
        return dataclasses.asdict(c)
    assert fields(tcfg_mod) == fields(jcfg_mod)


def test_params_from_jax_layout(setup):
    for name, leaves in setup["jparams"].items():
        for k, v in leaves.items():
            t = setup["tparams"][name][k]
            assert t.dtype == torch.float32 and tuple(t.shape) == v.shape
            assert np.array_equal(t.numpy(), np.asarray(v))


def test_init_matches_reference_statistics():
    """Draws differ across frameworks; the layout and He scale must not."""
    cfg = tcfg_mod.smoke()
    p = tmlp.init_mlp_classifier(torch.Generator().manual_seed(0), cfg, "cpu")
    dims = tmlp.mlp_dims(cfg)
    for i in range(len(dims) - 1):
        w, b = p[f"fc{i}"]["w"], p[f"fc{i}"]["b"]
        assert tuple(w.shape) == (dims[i], dims[i + 1])
        assert torch.count_nonzero(b) == 0
        assert abs(w.std().item() / (2.0 / dims[i]) ** 0.5 - 1) < 0.1


def test_forward_loss_accuracy_match_reference(setup):
    s = setup
    _close(tmlp.mlp_forward(s["tparams"], s["tbatch"]["x"], s["tcfg"]),
           jmlp.mlp_forward(s["jparams"], s["jbatch"]["x"], s["jcfg"]))
    _close(tmlp.per_example_loss(s["tparams"], s["tbatch"], s["tcfg"]),
           jmlp.per_example_loss(s["jparams"], s["jbatch"], s["jcfg"]))
    assert tmlp.accuracy(s["tparams"], s["tbatch"], s["tcfg"]).item() == \
        pytest.approx(float(jmlp.accuracy(s["jparams"], s["jbatch"],
                                          s["jcfg"])))


@pytest.mark.parametrize("strategy", ["ghost", "logit_grad", "loss"])
def test_scorer_matches_reference(setup, strategy):
    s = setup
    want = j_make_scorer(s["jcfg"], strategy)(s["jparams"], s["jbatch"])
    got = make_mlp_scorer(s["tcfg"], strategy)(s["tparams"], s["tbatch"])
    assert got.shape == (48,) and got.dtype == torch.float32
    _close(got, want)


def test_ghost_matches_full_oracle(setup):
    """The tap trick equals per-example gradients materialized by
    torch.func (rtol: the two sum the squares in different orders)."""
    s = setup
    ghost = make_mlp_scorer(s["tcfg"], "ghost")(s["tparams"], s["tbatch"])
    full = make_mlp_scorer(s["tcfg"], "full")(s["tparams"], s["tbatch"])
    _close(ghost, full.numpy())


def test_ghost_scorer_leaves_params_without_grad(setup):
    s = setup
    make_mlp_scorer(s["tcfg"], "ghost")(s["tparams"], s["tbatch"])
    for leaves in s["tparams"].values():
        for t in leaves.values():
            assert not t.requires_grad and t.grad is None


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(setup, momentum):
    s = setup
    rng = np.random.default_rng(1)
    np_grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, s["jparams"]))
    jo, to = jopt.sgd(0.05, momentum), topt.sgd(0.05, momentum)
    jp, js = s["jparams"], jo.init(s["jparams"])
    tp, ts = s["tparams"], to.init(s["tparams"])
    tgrads = params_from_jax(np_grads)
    jgrads = jax.tree.map(jnp.asarray, np_grads)
    for step in range(2):
        jp, js = jo.update(jgrads, js, jp, jnp.asarray(step))
        tp, ts = to.update(tgrads, ts, tp, step)
    for name in s["jparams"]:
        for k in ("w", "b"):
            _close(tp[name][k], jp[name][k])
    _close(topt.global_norm(tgrads), jopt.global_norm(jgrads))
    for max_norm in (1.0, 1e6):
        tc, tn = topt.clip_by_global_norm(tgrads, max_norm)
        jc, jn = jopt.clip_by_global_norm(jgrads, max_norm)
        _close(tn, jn)
        _close(tc["fc0"]["w"], jc["fc0"]["w"])


def test_importance_primitives_match_reference():
    rng = np.random.default_rng(2)
    raw = rng.standard_normal(64).astype(np.float32) * 3
    scored_at = rng.integers(-1, 20, 64).astype(np.int32)
    for cfg_kw in ({}, {"smoothing": 0.1, "staleness_threshold": 5}):
        jc, tc = jimp.ISConfig(**cfg_kw), timp.ISConfig(**cfg_kw)
        jw = jimp.smooth_weights(jimp.apply_staleness_filter(
            jnp.asarray(raw), jnp.asarray(scored_at), 20, jc), jc)
        tw = timp.smooth_weights(timp.apply_staleness_filter(
            torch.from_numpy(raw), torch.from_numpy(scored_at), 20, tc), tc)
        assert np.array_equal(tw.numpy(), np.asarray(jw))
        _close(timp.effective_sample_size(tw),
               jimp.effective_sample_size(jw))
        _close(timp.is_loss_scale(tw[:8], tw.mean()),
               jimp.is_loss_scale(jw[:8], jw.mean()))


def test_trace_sigma_matches_reference():
    rng = np.random.default_rng(3)
    g = np.abs(rng.standard_normal(256)).astype(np.float32) * 5
    w = np.abs(rng.standard_normal(256)).astype(np.float32) + 0.5
    tg, tw = torch.from_numpy(g), torch.from_numpy(w)
    jall = jvar.trace_sigma_all(jnp.asarray(g), jnp.asarray(w))
    jdist = jvar.trace_sigma_all_dist(jnp.asarray(g), jnp.asarray(w), (), 256)
    for got, want in ((tvar.trace_sigma_all(tg, tw), jall),
                      (tvar.trace_sigma_all_dist(tg, tw, 256), jdist)):
        for field in ("ideal", "stale", "unif"):
            _close(getattr(got, field), getattr(want, field))
