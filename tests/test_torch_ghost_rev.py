"""The port's memory-scalable exact scorer ``ghost_rev`` against the JAX
reference's ``ghost_rev`` and against the port's own ``ghost``.

A dense GQA smoke config runs with ``attn_impl`` "ref" and "flash" and
``attn_scores`` None, "fused" and "separate" (the JAX side runs the Pallas
flash kernels in interpret mode, as ``tests/test_torch_flash_train.py``);
a falcon-mamba-7b smoke config with ``ssm_mode="ref"``; a tied, soft-capped
head (where ghost_rev's unembed term is the reference's closed form).
Inputs are made from a seed with numpy.  Tolerance: f32 rtol 1e-5 /
atol 1e-6 (sums of the same per-example terms taken in another order).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core.scorer import make_lm_scorer as j_make_lm_scorer  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import scorer as tscorer  # noqa: E402
from repro_torch.core.scorer import make_lm_scorer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
B, S = 5, 13


def _np(t):
    return t.detach().cpu().numpy()


def _pair(jcfg, cfg, seed=1):
    jparams = jtf.init_transformer(jax.random.key(seed), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jparams, tparams, toks


def _cfgs(**kw):
    base = dict(name="t", arch_type="dense", num_layers=3, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=64,
                dtype="float32", remat=False)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.fixture(scope="module")
def dense():
    jcfg, cfg = _cfgs()
    return (jcfg, cfg) + _pair(jcfg, cfg)


def _scores(jcfg, cfg, jparams, tparams, toks, **kw):
    want = j_make_lm_scorer(jcfg, "ghost_rev", **kw)(jparams,
                                                     {"tokens": toks})
    batch = {"tokens": torch.from_numpy(toks)}
    got = make_lm_scorer(cfg, "ghost_rev", **kw)(tparams, batch)
    ghost = make_lm_scorer(cfg, "ghost", **kw)(tparams, batch)
    return got, np.asarray(want), ghost


@pytest.mark.parametrize("attn_impl,attn_scores", [
    ("ref", None), ("flash", None), ("flash", "fused"),
    ("flash", "separate")])
def test_dense_ghost_rev_matches_reference_and_ghost(dense, attn_impl,
                                                     attn_scores):
    jcfg, cfg, jparams, tparams, toks = dense
    got, want, ghost = _scores(jcfg, cfg, jparams, tparams, toks,
                               attn_impl=attn_impl, attn_scores=attn_scores)
    assert got.shape == (B,) and got.dtype == torch.float32
    assert bool((got > 0).all())
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(got), _np(ghost), rtol=RTOL, atol=ATOL)


def test_falcon_mamba_ghost_rev_matches_reference_and_ghost():
    jcfg = jconfigs.get_smoke_config("falcon-mamba-7b")
    cfg = configs.get_smoke_config("falcon-mamba-7b")
    got, want, ghost = _scores(jcfg, cfg, *_pair(jcfg, cfg),
                               ssm_mode="ref")
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(got), _np(ghost), rtol=RTOL, atol=ATOL)


def test_tied_softcapped_head_matches_reference():
    """The head's dL/dh goes through the soft cap; the unembed term uses
    the closed-form dlogits of the capped logits, as the reference's."""
    jcfg, cfg = _cfgs(tie_embeddings=True, logits_softcap=3.0,
                      num_layers=2)
    got, want, _ = _scores(jcfg, cfg, *_pair(jcfg, cfg, seed=2))
    np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)


def test_ghost_rev_refusals(dense):
    jcfg, cfg, *_ = dense
    with pytest.raises(ValueError, match="selective-scan kernel"):
        make_lm_scorer(cfg, "ghost_rev", ssm_mode="pallas")
    with pytest.raises(ValueError, match="trainable flash"):
        make_lm_scorer(cfg, "ghost_rev", attn_scores="fused")
    with pytest.raises(ValueError, match="'ghost' or 'ghost_rev'"):
        make_lm_scorer(cfg, "logit_grad", attn_impl="flash",
                       attn_scores="fused")
    assert "ghost_rev" in tscorer.STRATEGIES


def test_ghost_rev_keeps_one_period_of_records(dense, monkeypatch):
    """Phase B asks autograd for one period's taps at a time: every
    autograd.grad call gets the (B, S, d) boundary and that period's taps,
    never a (P, ...) stack; P calls in all, plus the head's one."""
    _, cfg, _, tparams, toks = dense
    calls = []
    real = torch.autograd.grad

    def spy(outputs, inputs, *a, **k):
        seq = [inputs] if isinstance(inputs, torch.Tensor) else inputs
        calls.append([tuple(t.shape) for t in seq])
        return real(outputs, inputs, *a, **k)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    make_lm_scorer(cfg, "ghost_rev")(tparams,
                                     {"tokens": torch.from_numpy(toks)})
    assert len(calls) == 1 + cfg.num_periods
    for shapes in calls:
        assert shapes[0] == (B, S - 1, cfg.d_model)
        assert all(s[:2] == (B, S - 1) for s in shapes[1:])


def test_launcher_trains_with_ghost_rev_like_ghost():
    """--strategy ghost_rev: the same scores as ghost, so the same run."""
    argv = ["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--steps",
            "3", "--seq", "12", "--examples", "64", "--batch", "4",
            "--score-batch", "16", "--log-every", "1"]
    rev = ttrain.run(ttrain.parse_args(argv + ["--strategy", "ghost_rev"]))
    ghost = ttrain.run(ttrain.parse_args(argv + ["--strategy", "ghost"]))
    for a, b in zip(rev.history, ghost.history):
        for k in ("loss", "trace_ideal", "trace_stale", "trace_unif"):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(_np(rev.state.store.weights),
                               _np(ghost.state.store.weights), rtol=RTOL,
                               atol=ATOL)
