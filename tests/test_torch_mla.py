"""The port's multi-head latent attention (MLA) against the JAX reference.

The MLA layer with and without ``q_lora_rank`` (query chunks shorter than
S, and the prefill collector's latent and rope rows); the chunks
recomputed in the backward (above ``KEEP_LOGITS_S``) against kept
ones; minicpm3-4b's smoke config through the forward and the per-example
loss, both query paths; every LM strategy's scores; one relaxed train
step; the refusals of the flash kernels and their score tap.

Inputs are made with numpy from a seed; the weights come from the
reference (``params_from_jax``) and the port replays the reference's
sampled indices.  Tolerance: f32 rtol 1e-5 / atol 1e-6 (matmuls, softmax
and Gram sums in another order; the ghost walk adds its taps in forward
order, the reference in sorted-key order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core import scorer as jscorer  # noqa: E402
from repro.core.strategies import make_proposal as j_make_proposal  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core import scorer as tscorer  # noqa: E402
from repro_torch.core.strategies import make_proposal  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
B, S = 4, 12


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, msg="", atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=msg)


def _cfgs(q_lora=True):
    jcfg = jconfigs.get_smoke_config("minicpm3-4b")
    cfg = configs.get_smoke_config("minicpm3-4b")
    if not q_lora:
        jcfg = dataclasses.replace(jcfg, q_lora_rank=0)
        cfg = dataclasses.replace(cfg, q_lora_rank=0)
    return jcfg, cfg


def _arch(q_lora=True, seed=1):
    jcfg, cfg = _cfgs(q_lora)
    jparams = jax.jit(lambda k: jtf.init_transformer(k, jcfg))(
        jax.random.key(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return jcfg, cfg, jparams, tparams, toks


@pytest.fixture(scope="module")
def minicpm():
    return _arch()


def _layer(q_lora, seed, s):
    jcfg, cfg = _cfgs(q_lora)
    jp = jattn.init_mla(jax.random.key(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).standard_normal((2, s, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    return jcfg, cfg, jp, tp, x, pos


# ------------------------------------------------------------------ layer
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_layer_matches_reference(q_lora):
    """Output, the compressed cache rows and the parameter names; query
    chunks of 5 over S = 13 (a short last chunk)."""
    jcfg, cfg, jp, tp, x, pos = _layer(q_lora, 2, 13)

    def ref(p, xx):
        col = {}
        y = jattn.mla(p, xx, jcfg, jnp.asarray(pos), q_chunk=5,
                      collector=col)
        return y, col

    want, jcol = jax.jit(ref)(jp, jnp.asarray(x))
    tcol = {}
    got = tattn.mla(tp, torch.from_numpy(x), cfg,
                    torch.from_numpy(pos.copy()), q_chunk=5, collector=tcol)
    _close(got, want, "y")
    assert set(tcol) == set(jcol) == {"attn.latent", "attn.rope"}
    for k in jcol:
        _close(tcol[k], jcol[k], k)
    tgen = tattn.init_mla(torch.Generator().manual_seed(0), cfg, "cpu")
    assert set(tgen) == set(jp)
    for k in jp:
        assert tuple(_np_shape(tgen[k])) == tuple(_np_shape(jp[k])), k


def _np_shape(leaf):
    if isinstance(leaf, dict):
        return _np_shape(leaf["scale"])
    return leaf.shape


def test_mla_recomputed_chunks_equal_kept_chunks(monkeypatch):
    """Above KEEP_LOGITS_S the query chunks are recomputed in the
    backward (torch.utils.checkpoint); outputs and gradients equal the
    kept chunks' bitwise, and the reference's gradients at rtol 1e-5."""
    jcfg, cfg, jp, tp, x, pos = _layer(True, 3, 20)
    w = np.random.default_rng(4).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)

    def grads(keep_s):
        monkeypatch.setattr(tattn, "KEEP_LOGITS_S", keep_s)
        live = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
        tx = torch.from_numpy(x).requires_grad_(True)
        y = tattn.mla(live, tx, cfg, torch.from_numpy(pos.copy()), q_chunk=8)
        torch.sum(y * torch.from_numpy(w)).backward()
        return y, tx.grad, live["wkv_a"].grad

    kept, recomputed = grads(64), grads(8)
    for a, b in zip(kept, recomputed):
        assert torch.equal(a, b)
    jgx, jgw = jax.jit(jax.grad(lambda xx, p: jnp.sum(jattn.mla(
        p, xx, jcfg, jnp.asarray(pos), q_chunk=8) * w), argnums=(0, 1)))(
            jnp.asarray(x), jp)
    for got, want in ((recomputed[1], jgx), (recomputed[2], jgw["wkv_a"])):
        want = np.asarray(want)
        _close(got, want, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- the arch
@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_arch_forward_and_loss_match_reference(q_lora):
    jcfg, cfg, jparams, tparams, toks = _arch(q_lora)

    @jax.jit
    def ref(p, t):
        loss, aux = jtf.per_example_loss(p, jcfg, {"tokens": t})
        return loss, aux.aux_loss, jtf.forward(p, jcfg, t[:, :-1])[0]

    jl, jaux, jlog = ref(jparams, jnp.asarray(toks))
    tl, taux = ttf.per_example_loss(tparams, cfg,
                                    {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, "losses")
    assert float(taux.aux_loss) == float(jaux) == 0.0
    tlog, _ = ttf.forward(tparams, cfg, torch.from_numpy(toks[:, :-1]))
    _close(tlog, jlog, "logits", atol=1e-5)


STRATEGIES = ("loss", "logit_grad", "ghost", "ghost_rev", "full",
              "upper_bound")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mla_scores_match_reference(minicpm, strategy):
    jcfg, cfg, jparams, tparams, toks = minicpm
    want = jax.jit(j_make_proposal(jscorer.make_lm_scorer, jcfg, strategy))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = make_proposal(tscorer.make_lm_scorer, cfg, strategy)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, want)


def test_mla_without_q_lora_ghost_matches_reference():
    """The wq tap in place of wq_a/wq_b."""
    jcfg, cfg, jparams, tparams, toks = _arch(q_lora=False, seed=3)
    want = jax.jit(jscorer.make_lm_scorer(jcfg, "ghost"))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = tscorer.make_lm_scorer(cfg, "ghost")(
        tparams, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def test_mla_train_step_matches_reference(minicpm):
    """One relaxed ghost step, the port replaying the reference's draws."""
    jcfg, cfg, jparams, tparams, _ = minicpm
    n = 32
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (n, S + 1)).astype(np.int32)
    kw = dict(batch_size=4, score_batch_size=8, refresh_every=1,
              mode="relaxed")
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jtf.per_example_loss(p, jcfg, b)[0],
        jscorer.make_lm_scorer(jcfg, "ghost"), j_sgd(0.1),
        jissgd.ISSGDConfig(**kw), n))
    tstep = issgd.make_train_step(
        lambda p, b: ttf.per_example_loss(p, cfg, b)[0],
        tscorer.make_lm_scorer(cfg, "ghost"), sgd(0.1),
        issgd.ISSGDConfig(**kw), n)
    jstate, jm = jstep(jissgd.init_train_state(jparams, j_sgd(0.1), n),
                       {"tokens": jnp.asarray(toks)})
    tstate, tm = tstep(issgd.init_train_state(tparams, sgd(0.1), n, "cpu"),
                       {"tokens": torch.from_numpy(toks)},
                       sample_indices=torch.tensor(
                           np.asarray(jm.sample_indices)))
    for field in ("loss", "grad_norm", "trace_ideal", "trace_stale"):
        _close(getattr(tm, field), getattr(jm, field), field)
    _close(tstate.store.weights, jstate.store.weights, "store")
    for k, v in jstate.params["layers"]["l0"]["mixer"].items():
        if isinstance(v, dict):
            continue
        _close(tstate.params["layers"]["l0"]["mixer"][k], np.asarray(v), k)


def test_mla_refuses_flash_and_score_taps(minicpm):
    _, cfg, _, tparams, toks = minicpm
    batch = {"tokens": torch.from_numpy(toks)}
    for kw in (dict(attn_impl="flash"), dict(attn_impl="pallas"),
               dict(attn_impl="flash", attn_scores="fused")):
        with pytest.raises(ValueError, match="attention='mla'"):
            ttf.per_example_loss(tparams, cfg, batch, **kw)
    with pytest.raises(ValueError, match="attention='mla' has no flash"):
        tscorer.make_lm_scorer(cfg, "ghost", attn_impl="flash",
                               attn_scores="fused")
