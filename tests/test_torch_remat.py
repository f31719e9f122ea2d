"""Rematerialisation in the port (``ModelConfig.remat``, the chunked loss
head, the attention query chunks) against the port without it and
against the JAX reference.

* remat on ≡ remat off, bitwise (``torch.equal``): losses, MoE aux
  losses, parameter gradients, the taps' gradients and records, ghost
  scores and the parameters after one ISSGD step, for a dense GQA stack
  at a sequence above ``attention.KEEP_LOGITS_S`` (its query chunks
  recompute too), jamba's period (mamba, MoE and attention), minicpm3's
  MLA, llava's frontend embeds and fused mode's
  ``per_example_loss_and_score``;
* the port at ``remat=True`` against the reference at ``remat=True``
  (the counterparts of ``test_remat_equivalence`` and
  ``test_lm_ghost_with_remat_scan``), weights from ``params_from_jax``:
  f32 rtol 1e-5 / atol 1e-6 (matmuls and softmax in another order);
* ``loss_chunk > 0`` against the full head under grad (rtol 1e-5), and
  no (·, ·, V) logits saved for the backward;
* the bytes saved for the backward (``saved_tensors_hooks``, distinct
  storages) from 2 to 4 periods: with remat they grow by each period's
  carry (the boundary (B, S, D) and the aux-loss scalar) and records at
  most, without it by a whole layer's activations;
* GQA's and MLA's query chunks: their softmax saved at or below
  ``KEEP_LOGITS_S``, recomputed above it.

Each bitwise case also checks that layers ran inside a recompute with
remat on (``remat.recomputing()``) and never with it off.

The CPU backward of the embedding gather is not bitwise run to run with
several threads, so the module runs on one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import scorer as jscorer  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core.scorer import make_lm_scorer  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import remat as remat_mod  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd, tree_leaves, tree_map  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
B = 4
N_EXAMPLES = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


# ---------------------------------------------- remat on ≡ off, bitwise
# arch, config overrides, text positions, frontend embeds
CASES = {
    # S = 80 > KEEP_LOGITS_S with chunks of 32: the query chunks recompute
    "dense": ("glm4-9b", dict(attn_chunk=32), 80, False),
    "jamba": ("jamba-v0.1-52b", {}, 16, False),
    "mla": ("minicpm3-4b", dict(attn_chunk=32), 80, False),
    "frontend": ("llava-next-34b", {}, 16, True),
}


def _case(name):
    arch, kw, s, front = CASES[name]
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **kw)
    gen = torch.Generator().manual_seed(7)
    params = ttf.init_transformer(gen, cfg, "cpu")
    rng = np.random.default_rng(3)
    data = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (N_EXAMPLES, s + 1)).astype(np.int32))}
    if front:
        data["embeds"] = torch.from_numpy(0.02 * rng.standard_normal(
            (N_EXAMPLES, cfg.num_frontend_tokens, cfg.d_model)).astype(
                np.float32))
    return cfg, params, data


def _batch(data):
    return {k: v[:B] for k, v in data.items()}


def _live(params):
    """Fresh leaves that require grad: the master's view of its params."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def _grads(cfg, params, batch):
    """Losses, aux loss and every parameter's gradient of the master's
    objective (the mean loss plus the MoE aux loss)."""
    live = _live(params)
    losses, aux = ttf.per_example_loss(live, cfg, batch)
    loss = torch.mean(losses) + aux.aux_loss
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return [losses.detach(), aux.aux_loss.detach(), *grads]


def _tap_grads(cfg, params, batch):
    """The ghost scorer's pass: records and dL/dtap of every tap."""
    b, s = batch["tokens"].shape
    n_front = batch["embeds"].shape[1] if "embeds" in batch else 0
    shapes = ttf.tap_structure(cfg, b, n_front + s - 1)
    taps = {k: torch.zeros(v, requires_grad=True) for k, v in shapes.items()}
    losses, aux = ttf.per_example_loss(params, cfg, batch, taps=taps,
                                       collect=True)
    names = sorted(taps)
    grads = torch.autograd.grad(losses.sum(), [taps[k] for k in names])
    return [losses.detach(), *grads,
            *(aux.records[k].detach() for k in sorted(aux.records))]


def _step(cfg, params, data, fused=False):
    """One ISSGD step (ghost scorer, or fused mode) on injected indices:
    the metrics and the parameters after it."""
    opt = sgd(0.1)
    step = issgd.make_train_step(
        lambda p, b: ttf.per_example_loss(p, cfg, b)[0],
        make_lm_scorer(cfg, "ghost"), opt,
        issgd.ISSGDConfig(batch_size=B, score_batch_size=8,
                          mode="fused" if fused else "relaxed"),
        N_EXAMPLES,
        fused_score=(lambda p, b: ttf.per_example_loss_and_score(p, cfg, b))
        if fused else None)
    state = issgd.init_train_state(params, opt, N_EXAMPLES, "cpu")
    state, m = step(state, data, sample_indices=torch.tensor([3, 0, 9, 12]))
    return [m.loss, m.grad_norm, state.store.weights,
            *tree_leaves(state.params)]


def _run_counting_recomputes(fn, cfg, *args):
    """``fn(cfg, *args)`` and the layers it ran inside a recompute."""
    real, recomputed = ttf._apply_layer, []

    def spy(*a, **kw):
        recomputed.append(remat_mod.recomputing())
        return real(*a, **kw)

    ttf._apply_layer = spy
    try:
        return fn(cfg, *args), sum(recomputed)
    finally:
        ttf._apply_layer = real


def _equal_both_ways(fn, cfg, *args):
    """``fn`` with remat off and on: bitwise equal results, and layers
    re-run in the backward only with remat on."""
    off, n_off = _run_counting_recomputes(
        fn, dataclasses.replace(cfg, remat=False), *args)
    on, n_on = _run_counting_recomputes(
        fn, dataclasses.replace(cfg, remat=True), *args)
    assert n_off == 0 and n_on > 0, (n_off, n_on)
    assert len(on) == len(off)
    for i, (a, b) in enumerate(zip(on, off)):
        assert torch.equal(a, b), f"result {i} differs with remat"
    return on


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_bitwise_master_grads(name):
    cfg, params, data = _case(name)
    _equal_both_ways(_grads, cfg, params, _batch(data))


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_bitwise_taps_and_ghost(name):
    cfg, params, data = _case(name)
    _equal_both_ways(_tap_grads, cfg, params, _batch(data))
    _equal_both_ways(lambda c, p, b: [make_lm_scorer(c, "ghost")(p, b)],
                     cfg, params, _batch(data))


@pytest.mark.parametrize("name", ["dense", "jamba"])
def test_remat_bitwise_train_step(name):
    cfg, params, data = _case(name)
    _equal_both_ways(_step, cfg, params, data)


@pytest.mark.parametrize("name", ["dense", "frontend"])
def test_remat_bitwise_fused_loss_and_score(name):
    """Fused mode: the master's forward scores its minibatch through the
    chunked head; losses, scores, gradients and the step, bitwise."""
    cfg, params, data = _case(name)
    cfg = dataclasses.replace(cfg, loss_chunk=8)

    def fused(c, p, b):
        live = _live(p)
        losses, scores = ttf.per_example_loss_and_score(live, c, b)
        grads = torch.autograd.grad(torch.mean(losses), tree_leaves(live))
        return [losses.detach(), scores.detach(), *grads]

    _equal_both_ways(fused, cfg, params, _batch(data))
    _equal_both_ways(lambda c, p, d: _step(c, p, d, fused=True), cfg, params,
                     data)


# ------------------------------------------------ against the reference
def _from_reference(jcfg, seed):
    jparams = jax.jit(lambda k: jtf.init_transformer(k, jcfg))(
        jax.random.key(seed))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def test_remat_equivalence_matches_reference():
    """The counterpart of ``test_remat_equivalence``: jamba's smoke stack
    at remat=True, losses and gradients against the reference's."""
    jcfg = jconfigs.get_smoke_config("jamba-v0.1-52b")
    cfg = configs.get_smoke_config("jamba-v0.1-52b")
    assert jcfg.remat and cfg.remat
    jparams, tparams = _from_reference(jcfg, 1)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)

    def jloss(p):
        return jnp.sum(jtf.per_example_loss(p, jcfg, {"tokens": toks})[0])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    live = _live(tparams)
    tl = torch.sum(ttf.per_example_loss(
        live, cfg, {"tokens": torch.from_numpy(toks)})[0])
    tg = torch.autograd.grad(tl, tree_leaves(live))
    _close(tl, jl, "loss")
    want = jax.tree_util.tree_leaves(jg)
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jg)[0]}
    tflat = dict(zip(_paths(tparams), tg))
    assert len(want) == len(tg) and set(jflat) == set(tflat)
    for k, v in jflat.items():
        v = np.asarray(v, np.float32)
        np.testing.assert_allclose(_np(tflat[k]), v, rtol=2e-4,
                                   atol=1e-5 * max(1.0, np.abs(v).max()),
                                   err_msg=k)


def _paths(tree, prefix=""):
    """The reference's key paths of a tree's leaves, in ``tree_leaves``'
    order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _paths(v, f"{prefix}['{k}']")]
    return [prefix]


def test_lm_ghost_with_remat_scan_matches_reference():
    """The counterpart of ``test_lm_ghost_with_remat_scan``: the ghost taps
    flow through the checkpointed periods (4 of them) on both sides."""
    kw = dict(name="d", arch_type="dense", num_layers=4, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=50,
              dtype="float32", remat=True)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jparams, tparams = _from_reference(jcfg, 3)
    toks = np.random.default_rng(4).integers(0, 50, (3, 11)).astype(
        np.int32)
    want = jax.jit(jscorer.make_lm_scorer(jcfg, "ghost"))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = make_lm_scorer(cfg, "ghost")(tparams,
                                       {"tokens": torch.from_numpy(toks)})
    _close(got, want, "ghost scores")


# ----------------------------------------------------- the chunked head
def test_loss_chunk_matches_full_head_under_grad():
    """``loss_chunk`` > 0 (each chunk checkpointed) against the full head:
    losses and gradients at rtol 1e-5, and no tensor as wide as the vocab
    saved for the backward outside the chunks' recompute."""
    cfg, params, data = _case("dense")
    batch = _batch(data)
    full = _grads(dataclasses.replace(cfg, loss_chunk=0), params, batch)
    chunked_cfg = dataclasses.replace(cfg, loss_chunk=16)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        chunked = _grads(chunked_cfg, params, batch)
    for i, (a, b) in enumerate(zip(chunked, full)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL,
                                   atol=ATOL * max(1.0, _np(b).max()),
                                   err_msg=f"result {i}")
    assert not [s for s in saved if s and s[-1] == cfg.vocab_size
                and len(s) == 3], saved


# -------------------------------------------- saved bytes per period
def _saved_bytes(cfg, params, batch, collect):
    """Distinct storage bytes packed for the backward by one forward."""
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    b, s = batch["tokens"].shape
    taps = None
    if collect:
        taps = {k: torch.zeros(v, requires_grad=True) for k, v in
                ttf.tap_structure(cfg, b, s - 1).items()}
    live = _live(params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        losses, aux = ttf.per_example_loss(live, cfg, batch, taps=taps,
                                           collect=collect)
    rec = sum(r.numel() * r.element_size() for k, r in aux.records.items()
              if k != "unembed") if collect else 0
    del losses
    return sum(storages.values()), rec


@pytest.mark.parametrize("collect", [False, True])
def test_saved_bytes_grow_by_boundaries_only_with_remat(collect):
    """From P = 2 to P = 4 periods: with remat the saved bytes grow by no
    more than the two periods' carries (the boundary (B, S, D) and the
    f32 aux-loss scalar) plus their records; without it by at least two
    whole layers' activations, which hold many boundaries each."""
    base, _, data = _case("dense")
    batch = _batch(data)
    s = batch["tokens"].shape[1] - 1
    boundary = B * s * base.d_model * 4
    grow = {}
    for remat in (False, True):
        out = []
        for layers in (2, 4):
            cfg = dataclasses.replace(base, num_layers=layers, remat=remat)
            params = ttf.init_transformer(torch.Generator().manual_seed(0),
                                          cfg, "cpu")
            out.append(_saved_bytes(cfg, params, batch, collect))
        grow[remat] = (out[1][0] - out[0][0], out[1][1] - out[0][1])
    saved_on, rec_on = grow[True]
    assert saved_on <= 2 * (boundary + 4) + rec_on, (grow, boundary)
    saved_off, _ = grow[False]
    assert saved_off >= 2 * 8 * boundary, (grow, boundary)


@pytest.mark.parametrize("attention", ["gqa", "mla"])
@pytest.mark.parametrize("s", [64, 80])
def test_query_chunks_recompute_above_keep_logits_s(attention, s):
    """One rule for both attentions: at or below ``KEEP_LOGITS_S`` the
    query chunks' f32 softmax is saved for the backward, above it the
    chunks are recomputed and nothing (·, S)-wide is saved."""
    arch = "glm4-9b" if attention == "gqa" else "minicpm3-4b"
    cfg = configs.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    fn = tattn.attn if attention == "gqa" else tattn.mla
    params = (tattn.init_attn if attention == "gqa" else tattn.init_mla)(
        gen, cfg, "cpu")
    x = torch.randn(2, s, cfg.d_model, generator=gen, requires_grad=True)
    pos = torch.arange(s)[None].expand(2, s)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        fn(params, x, cfg, pos, q_chunk=32)
    wide = [sh for sh in saved if len(sh) >= 4 and sh[-1] == s]
    assert bool(wide) == (s <= tattn.KEEP_LOGITS_S), saved
