"""The port's transformer LM code against the JAX reference.

Configs field for field; the layers (rmsnorm, rope, SwiGLU mlp,
embed/unembed tied, untied and soft-capped, GQA attention with a
sliding window and query chunks shorter than S); glm4-9b-smoke logits
and per-example loss from the reference's params; ``tap_structure``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: f32 rtol 1e-5 / atol 1e-5 where both sides do the same
arithmetic in another order (matmul and softmax sums of ≤512 terms, on
values of order 1, so entries near zero carry an absolute error of a
few 1e-6 after two layers);
bf16 rtol/atol 2e-2 (``docs/KERNELS.md``), since the two frameworks round
bf16 intermediates at different places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCH_ALIASES = ("glm4-9b", "deepseek-7b", "internlm2-20b", "falcon-mamba-7b",
                "minicpm3-4b", "dbrx-132b", "grok-1-314b", "jamba-v0.1-52b",
                "llava-next-34b", "musicgen-medium")


def _np(t):
    return t.detach().float().cpu().numpy()


def _pair(a, dtype="float32"):
    """One numpy array as (jax, torch) arrays of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    return j, t


def _params_to_torch(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams))


def _small_cfg(**kw):
    base = dict(name="t", arch_type="dense", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=40,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ARCH_ALIASES)
def test_configs_equal_reference_field_by_field(name):
    for getter in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, getter)(name))
        got = dataclasses.asdict(getattr(configs, getter)(name))
        assert got == want, getter
        mod = configs.resolve(name)
        assert dataclasses.asdict(getattr(configs, getter)(mod)) == want
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    assert [dataclasses.asdict(s) for s in cfg.layer_specs()] == \
        [dataclasses.asdict(s) for s in jcfg.layer_specs()]
    assert cfg.period_len() == jcfg.period_len()
    assert cfg.num_periods == jcfg.num_periods
    assert cfg.param_count() == jcfg.param_count()


def test_arch_registry_matches_reference_and_names_what_is_missing():
    """Every arch of the reference resolves in the port; an unknown name
    is refused by name."""
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert configs._ALIASES == jconfigs._ALIASES
    assert sorted(configs.resolve(a) for a in ARCH_ALIASES) == sorted(
        configs.ARCH_NAMES)
    for name in configs.ARCH_NAMES:
        assert configs.resolve(name) == name
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


def test_unported_model_code_raises():
    """MoE, MLA and the frontend stub build; an attention kind or a
    frontend the reference does not know is refused by name."""
    for kw in (dict(num_experts=4, num_experts_per_tok=2),
               dict(attention="mla", q_lora_rank=8, kv_lora_rank=8,
                    qk_nope_dim=4, qk_rope_dim=4, v_head_dim=4),
               dict(frontend="vision")):
        _, cfg = _small_cfg(**kw)
        ttf.init_transformer(torch.Generator().manual_seed(0), cfg, "cpu")
    for kw, what in ((dict(attention="linear"), "attention must be"),
                     (dict(frontend="video"), "frontend must be")):
        _, cfg = _small_cfg(**kw)
        with pytest.raises(ValueError, match=what):
            ttf.init_transformer(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
    # a mamba stack without MLPs is ported: it builds
    _, cfg = _small_cfg(ssm_state=4, d_ff=0, attention="none")
    p = ttf.init_transformer(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(p["layers"]["l0"]) == {"ln1", "mixer"}
    assert p["layers"]["l0"]["mixer"]["a_log"].shape == (2, 64, 4)
    _, cfg = _small_cfg()
    with pytest.raises(ValueError, match="impl must be one of"):
        tattn.attn(None, torch.zeros(1, 2, 32), cfg, None, impl="splash")


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    jx, tx = _pair(x, dtype)
    js, ts = _pair(scale, dtype)
    tol = F32 if dtype == "float32" else BF16
    got = tlayers.rmsnorm({"scale": ts}, tx, 1e-5)
    want = jlayers.rmsnorm({"scale": js}, jx, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    pos = np.broadcast_to(np.arange(7) + 3, (2, 7))
    got = tlayers.rope(tx, torch.from_numpy(pos.copy()), 10_000.0)
    want = jlayers.rope(jx, jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_swiglu_mlp(act):
    jcfg, cfg = _small_cfg(act=act)
    jp = jlayers.init_mlp(jax.random.key(1), jcfg)
    x = np.random.default_rng(1).standard_normal((3, 5, 32)).astype(
        np.float32)
    want = jlayers.mlp(jp, jnp.asarray(x), jcfg)
    got = tlayers.mlp(_params_to_torch(jp), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("tie,softcap", [(False, 0.0), (True, 0.0),
                                         (False, 3.0)])
def test_embed_and_unembed(tie, softcap):
    jcfg, cfg = _small_cfg(tie_embeddings=tie, logits_softcap=softcap)
    jp = jlayers.init_embed(jax.random.key(2), jcfg)
    assert ("unembed" in jp) == (not tie)
    tp = _params_to_torch(jp)
    toks = np.random.default_rng(2).integers(0, 40, (2, 6)).astype(np.int32)
    want = jlayers.embed(jp, jnp.asarray(toks), jcfg)
    got = tlayers.embed(tp, torch.from_numpy(toks), cfg)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    h = np.random.default_rng(3).standard_normal((2, 6, 32)).astype(
        np.float32)
    want = jlayers.unembed(jp, jnp.asarray(h), jcfg)
    got = tlayers.unembed(tp, torch.from_numpy(h), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("window,q_chunk", [(0, 512), (0, 5), (4, 512),
                                            (4, 3)])
def test_gqa_attention(window, q_chunk):
    """Causal and sliding-window GQA (rep 2), with query chunks shorter
    than (and not dividing) S = 11."""
    jcfg, cfg = _small_cfg(sliding_window=window)
    jp = jattn.init_attn(jax.random.key(4), jcfg)
    x = np.random.default_rng(4).standard_normal((2, 11, 32)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11)).astype(np.int32)
    want = jattn.attn(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                      q_chunk=q_chunk)
    got = tattn.attn(_params_to_torch(jp), torch.from_numpy(x), cfg,
                     torch.from_numpy(pos.copy()), q_chunk=q_chunk)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


# ---------------------------------------------------- the model as a whole
@pytest.fixture(scope="module")
def glm_smoke():
    jcfg = jconfigs.get_smoke_config("glm4-9b")
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (3, 17)).astype(np.int32)
    return jcfg, jparams, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glm4_smoke_logits_and_loss(glm_smoke, dtype):
    jcfg, jparams, toks = glm_smoke
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke_config("glm4-9b"),
                              dtype=dtype)
    jparams = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), jparams)
    tparams = _params_to_torch(jparams)
    tol = F32 if dtype == "float32" else BF16
    want, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks[:, :-1]))
    got, _ = ttf.forward(tparams, cfg, torch.from_numpy(toks[:, :-1]))
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want, np.float32)
    # bf16 logits: the two frameworks round a layer's intermediates at
    # different places, so an entry's error scales with the largest logit
    # (a few bf16 ulps of it), not with the entry itself
    np.testing.assert_allclose(
        _np(got), want, rtol=tol["rtol"],
        atol=tol["atol"] * (np.abs(want).max() if dtype == "bfloat16" else 1))
    for chunk in (0, 5):
        jc = dataclasses.replace(jcfg, loss_chunk=chunk)
        c = dataclasses.replace(cfg, loss_chunk=chunk)
        want, _ = jtf.per_example_loss(jparams, jc,
                                       {"tokens": jnp.asarray(toks)})
        got, _ = ttf.per_example_loss(tparams, c,
                                      {"tokens": torch.from_numpy(toks)})
        assert got.shape == (3,) and got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), **tol)


def test_lm_head_metrics_and_masked_loss(glm_smoke):
    jcfg, jparams, toks = glm_smoke
    cfg = configs.get_smoke_config("glm4-9b")
    tparams = _params_to_torch(jparams)
    mask = (np.random.default_rng(6).random(toks.shape) < 0.7).astype(
        np.int32)
    for chunk in (0, 5):
        jc = dataclasses.replace(jcfg, loss_chunk=chunk)
        c = dataclasses.replace(cfg, loss_chunk=chunk)
        want, _ = jtf.per_example_loss(jparams, jc, {
            "tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)})
        got, _ = ttf.per_example_loss(tparams, c, {
            "tokens": torch.from_numpy(toks), "mask": torch.from_numpy(mask)})
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
        jh, _ = jtf.forward(jparams, jc, jnp.asarray(toks[:, :-1]),
                            return_hidden=True)
        th, _ = ttf.forward(tparams, c, torch.from_numpy(toks[:, :-1]),
                            return_hidden=True)
        want = jtf.lm_head_metrics(jparams, jc, jh, jnp.asarray(toks[:, 1:]))
        got = ttf.lm_head_metrics(tparams, c, th,
                                  torch.from_numpy(toks[:, 1:]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **F32)


@pytest.mark.parametrize("name", ARCH_ALIASES)
def test_tap_structure_matches_reference(name):
    jcfg = jconfigs.get_smoke_config(name)
    want = jtf.tap_structure(jcfg, 4, 9)
    got = ttf.tap_structure(configs.get_smoke_config(name), 4, 9)
    assert list(got) == list(want)
    assert {k: tuple(v.shape) for k, v in want.items()} == got


def test_forward_records_are_stacked_per_period(glm_smoke):
    """Records leave the period loop stacked to (P, B, S, din) in the
    forward's order, as the reference's scan ys; taps are one (P, ...)
    leaf each, so their gradient comes back stacked."""
    jcfg, jparams, toks = glm_smoke
    cfg = configs.get_smoke_config("glm4-9b")
    tparams = _params_to_torch(jparams)
    b, s = toks.shape[0], toks.shape[1] - 1
    shapes = ttf.tap_structure(cfg, b, s)
    taps = {k: torch.zeros(v, requires_grad=True) for k, v in shapes.items()}
    _, aux = ttf.per_example_loss(tparams, cfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  taps=taps, collect=True)
    _, jaux = jtf.per_example_loss(
        jparams, jcfg, {"tokens": jnp.asarray(toks)},
        taps={k: jnp.zeros(v) for k, v in shapes.items()}, collect=True)
    # the reference's scan returns its records dict in sorted key order
    assert list(aux.records) == list(shapes)
    assert set(jaux.records) == set(shapes)
    for k, r in aux.records.items():
        np.testing.assert_allclose(_np(r), np.asarray(jaux.records[k]),
                                   **F32, err_msg=k)
