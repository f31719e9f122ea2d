"""The port's mixture of experts against the JAX reference.

The MoE layer (outputs, load-balance loss, dropped share, and the
routing itself: expert ids and kept mask equal), with the default
capacity, a drop-heavy capacity and dropless; the MoE archs' smoke
configs (dbrx-132b, grok-1-314b, jamba-v0.1-52b) through the forward, the
per-example loss and ``Aux.aux_loss``; every LM strategy's scores; the
scorer's token-flattened router record; one relaxed train step with and
without ``aux_loss=``; the SGD update of a leaf as large as a
full-width expert leaf, a slice at a time.

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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core import scorer as tscorer  # noqa: E402
from repro_torch.core.strategies import make_proposal  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
B, S = 4, 12


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _arch(name, seed=1):
    jcfg = jconfigs.get_smoke_config(name)
    cfg = configs.get_smoke_config(name)
    jparams = jax.jit(lambda k: jtf.init_transformer(k, jcfg))(
        jax.random.key(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    return jcfg, cfg, jparams, tparams, toks


@pytest.fixture(scope="module")
def dbrx():
    return _arch("dbrx-132b")


def _reference_routing(jp, x, cfg, dropless):
    """The reference's routing decisions, as ``src/repro/models/moe.py``
    makes them: (expert ids (T, k), kept mask over the sorted replicas)."""
    t = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax((xf @ jp["router"]).astype(jnp.float32), -1)
    _, eidx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    tk = t * cfg.num_experts_per_tok
    cap = tk if dropless else max(
        int(cfg.moe_capacity_factor * tk / cfg.num_experts + 0.5), 1)
    sorted_e = eidx.reshape(tk)[jnp.argsort(eidx.reshape(tk))]
    pos = jnp.arange(tk) - jnp.searchsorted(sorted_e, sorted_e, side="left")
    return np.asarray(eidx), np.asarray(pos < cap)


# ------------------------------------------------------------------ layer
@pytest.mark.parametrize("capacity,dropless", [(1.25, False), (0.5, False),
                                               (1.25, True)])
def test_moe_layer_matches_reference(capacity, dropless):
    """y, aux loss and dropped share at rtol 1e-5; expert ids and the
    kept mask equal.  Capacity 0.5 drops replicas (the kept mask has both
    values), dropless keeps all."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("dbrx-132b"),
                               moe_capacity_factor=capacity)
    cfg = dataclasses.replace(configs.get_smoke_config("dbrx-132b"),
                              moe_capacity_factor=capacity)
    jp = jmoe.init_moe(jax.random.key(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(3).standard_normal((3, 11, cfg.d_model)) \
        .astype(np.float32)
    want = jax.jit(lambda p, xx: jmoe.moe(p, xx, jcfg, dropless=dropless))(
        jp, jnp.asarray(x))
    got = tmoe.moe(tp, torch.from_numpy(x), cfg, dropless=dropless)
    _close(got.y, want.y, "y")
    _close(got.aux_loss, want.aux_loss, "aux_loss")
    assert float(got.dropped_frac) == pytest.approx(
        float(want.dropped_frac), abs=1e-6)

    eidx, keep = _reference_routing(jp, x, jcfg, dropless)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    r = tmoe.route((xf @ tp["router"]).float(), cfg, dropless)
    assert np.array_equal(r.eidx.numpy(), eidx)
    assert np.array_equal(r.keep.numpy(), keep)
    assert keep.all() == (capacity > 1 or dropless) or not keep.all()
    if capacity < 1:
        assert 0 < float(got.dropped_frac) < 1
    assert r.cap == tmoe.capacity(cfg, xf.shape[0], dropless)


def test_moe_backward_matches_reference():
    """Gradients through the dispatch (expand, the sort's gathers, the
    zero row of dropped replicas) equal the reference's, at a capacity
    that drops replicas."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("dbrx-132b"),
                               moe_capacity_factor=0.5)
    cfg = dataclasses.replace(configs.get_smoke_config("dbrx-132b"),
                              moe_capacity_factor=0.5)
    jp = jmoe.init_moe(jax.random.key(4), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(4).standard_normal((2, 9, cfg.d_model)) \
        .astype(np.float32)

    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out = jmoe.moe(p, xx, jcfg)
        return jnp.sum(out.y * w) + out.aux_loss

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tmoe.moe(live, tx, cfg)
    (torch.sum(out.y * torch.from_numpy(w)) + out.aux_loss).backward()
    # gradients sum signed terms over tokens: entries near zero are held
    # to an atol of 1e-5 of the tensor's largest
    for got, want in [(live[k].grad, jg[k]) for k in tp] + [(tx.grad, jgx)]:
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=RTOL,
                                   atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- the archs
@pytest.mark.parametrize("name", ["dbrx-132b", "grok-1-314b",
                                  "jamba-v0.1-52b"])
def test_moe_arch_forward_loss_and_aux_match_reference(name):
    jcfg, cfg, jparams, tparams, toks = _arch(name)

    @jax.jit
    def ref(p, t):
        loss, aux = jtf.per_example_loss(p, jcfg, {"tokens": t})
        return loss, aux.aux_loss, jtf.forward(p, jcfg, t[:, :-1])[0]

    jl, jaux, jlog = ref(jparams, jnp.asarray(toks))
    tl, taux = ttf.per_example_loss(tparams, cfg,
                                    {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, "losses")
    _close(taux.aux_loss, jaux, "aux_loss")
    assert float(taux.aux_loss) > 0
    tlog, _ = ttf.forward(tparams, cfg, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=RTOL,
                               atol=1e-5)


STRATEGIES = ("loss", "logit_grad", "ghost", "ghost_rev", "full",
              "upper_bound")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_moe_scores_match_reference(dbrx, strategy):
    jcfg, cfg, jparams, tparams, toks = dbrx
    want = jax.jit(j_make_proposal(jscorer.make_lm_scorer, jcfg, strategy))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = make_proposal(tscorer.make_lm_scorer, cfg, strategy)(
        tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("name,strategy", [("grok-1-314b", "ghost"),
                                           ("jamba-v0.1-52b", "ghost_rev")])
def test_moe_arch_ghost_scores_match_reference(name, strategy):
    """grok's soft-capped head and jamba's mamba + MoE period."""
    jcfg, cfg, jparams, tparams, toks = _arch(name, seed=2)
    want = jax.jit(jscorer.make_lm_scorer(jcfg, strategy))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = tscorer.make_lm_scorer(cfg, strategy)(
        tparams, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def test_router_contribution_token_flattened_matches_reference():
    """A scanned (P, B·S, d) record (the MoE router's) is reshaped to
    (P, B, S, d) by the batch size, not guessed: here P == B, where a
    (P, B·S, d) record is shape-ambiguous with (B, S, d)."""
    rng = np.random.default_rng(5)
    p, b, s = 3, 3, 7
    x = rng.standard_normal((p, b * s, 16)).astype(np.float32)
    d = rng.standard_normal((p, b * s, 4)).astype(np.float32)
    want = jscorer._contribution(jnp.asarray(x), jnp.asarray(d), b, False,
                                 scanned=True)
    got = tscorer._contribution(torch.from_numpy(x), torch.from_numpy(d), b,
                                False, scanned=True)
    _close(got, want)
    manual = sum(
        tscorer._contribution(torch.from_numpy(x[i]).reshape(b, s, 16),
                              torch.from_numpy(d[i]).reshape(b, s, 4), b,
                              False, scanned=False) for i in range(p))
    _close(got, _np(manual))


# ------------------------------------------------------------ a train step
@pytest.mark.parametrize("with_aux", [False, True])
def test_moe_train_step_matches_reference(dbrx, with_aux):
    """One relaxed logit_grad step of dbrx-132b-smoke (the scorer's ghost
    strategies are held above), the port replaying the
    reference's draws; with ``aux_loss=`` the load-balance loss joins the
    master's loss (and moves the router), as in the reference."""
    jcfg, cfg, jparams, tparams, _ = dbrx
    n = 32
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (n, S + 1)).astype(np.int32)
    kw = dict(batch_size=4, score_batch_size=8, refresh_every=1,
              mode="relaxed")
    jaux = (lambda p, b: jtf.per_example_loss(p, jcfg, b)[1].aux_loss) \
        if with_aux else None
    taux = (lambda p, b: ttf.per_example_loss(p, cfg, b)[1].aux_loss) \
        if with_aux else None
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jtf.per_example_loss(p, jcfg, b)[0],
        jscorer.make_lm_scorer(jcfg, "logit_grad"), j_sgd(0.1),
        jissgd.ISSGDConfig(**kw), n, aux_loss=jaux))
    tstep = issgd.make_train_step(
        lambda p, b: ttf.per_example_loss(p, cfg, b)[0],
        tscorer.make_lm_scorer(cfg, "logit_grad"), sgd(0.1),
        issgd.ISSGDConfig(**kw), n, aux_loss=taux)
    jstate, jm = jstep(jissgd.init_train_state(jparams, j_sgd(0.1), n),
                       {"tokens": jnp.asarray(toks)})
    tstate, tm = tstep(issgd.init_train_state(tparams, sgd(0.1), n, "cpu"),
                       {"tokens": torch.from_numpy(toks)},
                       sample_indices=torch.tensor(
                           np.asarray(jm.sample_indices)))
    for field in ("loss", "grad_norm", "trace_ideal", "trace_stale"):
        _close(getattr(tm, field), getattr(jm, field), field)
    _close(tstate.store.weights, jstate.store.weights, "store")
    jr = np.asarray(jstate.params["layers"]["l0"]["ff"]["router"])
    _close(tstate.params["layers"]["l0"]["ff"]["router"], jr, "router")
    for k in ("w_in", "w_gate", "w_out"):
        _close(tstate.params["layers"]["l0"]["ff"][k],
               np.asarray(jstate.params["layers"]["l0"]["ff"][k]), k)


def test_sgd_updates_large_leaves_by_slices(monkeypatch):
    """A leaf larger than ``_SLICE`` (an MoE expert leaf at full width) is
    updated a slice at a time: the same bits as the whole-leaf update and
    the reference's sgd at rtol 1e-5."""
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as topt
    monkeypatch.setattr(topt, "_SLICE", 1000)
    rng = np.random.default_rng(7)
    p = {"w": rng.standard_normal((2, 4, 33, 17)).astype(np.float32),
         "b": rng.standard_normal(9).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    tg = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()}
    got, _ = topt.sgd(0.3).update(tg, (), tp, 0)
    for k in tp:
        whole = (tp[k].float() - 0.3 * tg[k].float()).to(torch.bfloat16)
        assert torch.equal(got[k], whole), k
    want, _ = jopt.sgd(0.3).update(
        {k: jnp.asarray(v) for k, v in g.items()}, (),
        {k: jnp.asarray(v) for k, v in p.items()}, 0)
    f32, _ = topt.sgd(0.3).update(
        {k: torch.from_numpy(v) for k, v in g.items()}, (),
        {k: torch.from_numpy(v) for k, v in p.items()}, 0)
    for k in p:
        _close(f32[k], want[k], k)
