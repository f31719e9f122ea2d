"""The port's mamba serving path against the JAX reference.

``kernels/ref.selective_scan_step_ref`` and ``models/ssm.mamba_decode``
against the reference's; the prefill collector of ``models/ssm.mamba``
with and without ``pad_mask``; within the port, a bucketed (right-padded)
prefill leaving the decode state of the unpadded one bitwise; the
engine's prefill and decode steps (with an ``active`` mask) for
falcon-mamba-7b (pure mamba) and jamba-v0.1-52b (mamba + GQA attention +
MoE) against the reference engine; the continuous batcher against the
reference's batcher; and the decode runner, whose CUDA-graph warm-up
must leave the recurrent state as it found it.

Inputs are made with numpy from a seed; the weights come from the
reference (``params_from_jax``).  Tolerances: f32 rtol 1e-5 / atol 1e-5
(the same arithmetic in another order over values of order 1).  Greedy
token chains are compared exactly, in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import batcher as jbatcher  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.serving import batcher as tbatcher  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().cpu().numpy()


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _model(name, seed):
    """(jcfg, cfg, jparams, tparams, jitted reference prefill, jitted
    reference decode step) of ``name``'s smoke config."""
    jcfg = jconfigs.get_smoke_config(name)
    cfg = configs.get_smoke_config(name)
    jparams = jax.jit(lambda k: jtf.init_transformer(k, jcfg))(
        jax.random.key(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jprefill = jax.jit(
        lambda p, t, tl, max_len: jengine.prefill(p, jcfg, t, max_len,
                                                  true_len=tl),
        static_argnames="max_len")
    jdecode = jax.jit(
        lambda p, t, st, a: jengine.decode_step(p, jcfg, t, st, active=a))
    return jcfg, cfg, jparams, tparams, jprefill, jdecode


@pytest.fixture(scope="module")
def falcon():
    return _model("falcon-mamba-7b", 0)


@pytest.fixture(scope="module")
def jamba():
    return _model("jamba-v0.1-52b", 1)


def _assert_state(st, jst, **tol):
    assert set(st.caches) == set(jst.caches)
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))
    for k, buf in st.caches.items():
        assert tuple(buf.shape) == jst.caches[k].shape, k
        assert buf.dtype == getattr(torch, str(jst.caches[k].dtype)), k
        np.testing.assert_allclose(_np(buf), np.asarray(jst.caches[k]),
                                   err_msg=k, **tol)


def _layer(tparams, jparams, i=0):
    tp = ttf._period(tparams["layers"], 0)[f"l{i}"]["mixer"]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][f"l{i}"]["mixer"])
    return tp, jp


# ------------------------------------------------------------ the recurrence
def test_selective_scan_step_matches_reference():
    rng = np.random.default_rng(0)
    b, di, ds = 3, 24, 8
    h = rng.standard_normal((b, di, ds)).astype(np.float32)
    u = rng.standard_normal((b, di)).astype(np.float32)
    dl = np.abs(rng.standard_normal((b, di))).astype(np.float32) * 0.1
    a = -np.exp(rng.standard_normal((di, ds))).astype(np.float32)
    bt, ct = (rng.standard_normal((b, ds)).astype(np.float32)
              for _ in range(2))
    d = rng.standard_normal(di).astype(np.float32)
    jh, jy = jref.selective_scan_step_ref(*map(jnp.asarray,
                                               (h, u, dl, a, bt, ct, d)))
    th, ty = tref.selective_scan_step_ref(*map(torch.from_numpy,
                                               (h, u, dl, a, bt, ct, d)))
    assert th.dtype == torch.float32 and ty.dtype == torch.float32
    np.testing.assert_allclose(_np(th), np.asarray(jh), **F32)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **F32)
    # y takes u's dtype, the state stays f32
    th, ty = tref.selective_scan_step_ref(
        torch.from_numpy(h), torch.from_numpy(u).bfloat16(),
        *map(torch.from_numpy, (dl, a, bt, ct, d)))
    assert th.dtype == torch.float32 and ty.dtype == torch.bfloat16


def test_mamba_decode_matches_reference(falcon):
    jcfg, cfg, jparams, tparams, _, _ = falcon
    tp, jp = _layer(tparams, jparams)
    rng = np.random.default_rng(1)
    b, di = 3, cfg.resolved_d_inner
    x = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((b, cfg.conv_width - 1, di)).astype(np.float32)
    h = rng.standard_normal((b, di, cfg.ssm_state)).astype(np.float32)
    jout, jst = jax.jit(lambda p, x, s: jssm.mamba_decode(p, x, jcfg, s))(
        jp, jnp.asarray(x), jssm.MambaState(jnp.asarray(conv),
                                            jnp.asarray(h)))
    st0 = tssm.MambaState(torch.from_numpy(conv), torch.from_numpy(h))
    out, st = tssm.mamba_decode(tp, torch.from_numpy(x), cfg, st0)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **F32)
    np.testing.assert_allclose(_np(st.conv), np.asarray(jst.conv), **F32)
    np.testing.assert_allclose(_np(st.h), np.asarray(jst.h), **F32)
    # the state given is only read
    assert np.array_equal(st0.conv.numpy(), conv)
    assert np.array_equal(st0.h.numpy(), h)
    init = tssm.init_mamba_state(cfg, 2, torch.bfloat16, "cpu")
    jinit = jssm.init_mamba_state(jcfg, 2, jnp.bfloat16)
    assert tuple(init.conv.shape) == jinit.conv.shape
    assert tuple(init.h.shape) == jinit.h.shape
    assert init.conv.dtype == torch.bfloat16 and init.h.dtype == torch.float32


@pytest.mark.parametrize("padded", [False, True])
def test_mamba_collector_matches_reference(falcon, padded):
    """The prefill collector's output, conv window and final state, with
    rows of true lengths 9, 2 (shorter than the conv window) and 12 under
    a pad mask, and without one."""
    jcfg, cfg, jparams, tparams, _, _ = falcon
    tp, jp = _layer(tparams, jparams)
    b, s = 3, 12
    x = np.random.default_rng(2).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    mask = (np.arange(s)[None] < np.array([9, 2, 12])[:, None]
            if padded else None)

    def jrun(p, x, m):
        c = {}
        y = jssm.mamba(p, x, jcfg, collector=c, pad_mask=m)
        return y, c
    jy, jc = jax.jit(jrun)(jp, jnp.asarray(x),
                           None if mask is None else jnp.asarray(mask))
    c = {}
    y = tssm.mamba(tp, torch.from_numpy(x), cfg, collector=c,
                   pad_mask=None if mask is None else torch.from_numpy(mask))
    assert set(c) == set(jc) == {"mamba.conv", "mamba.h"}
    assert c["mamba.h"].dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    for k in c:
        assert tuple(c[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(_np(c[k]), np.asarray(jc[k]), err_msg=k,
                                   **F32)
    if padded:            # row 1's window is left-padded with zeros
        assert torch.count_nonzero(c["mamba.conv"][1, 0]) == 0


@pytest.mark.parametrize("true_len", [1, 5, 11])
def test_bucketed_prefill_state_is_the_unpadded_states_bitwise(falcon,
                                                              true_len):
    """Δ is zero at pad positions, so the padded scan's state is the
    unpadded one's, bitwise, and so is the conv window."""
    _, cfg, _, tparams, _, _ = falcon
    toks = _tokens((2, 16), seed=3)
    toks[:, true_len:] = 7               # pad tokens: any value
    want_l, want = tengine.prefill(tparams, cfg,
                                   torch.from_numpy(toks[:, :true_len]), 32)
    got_l, got = tengine.prefill(tparams, cfg, torch.from_numpy(toks), 32,
                                 true_len=true_len)
    for k, buf in want.caches.items():
        assert torch.equal(got.caches[k], buf), k
    assert torch.equal(got.lengths, want.lengths)
    torch.testing.assert_close(got_l, want_l, **F32)


# ------------------------------------------------------------------ engine
def _state_to_torch(jst):
    return tengine.ServeState(
        caches={k: torch.from_numpy(np.array(v)) for k, v in
                jst.caches.items()},
        lengths=torch.from_numpy(np.array(jst.lengths)))


@pytest.mark.parametrize("which", ["falcon", "jamba"])
@pytest.mark.parametrize("s,true_len,max_len", [(12, None, 32),
                                                 (16, 11, 32), (12, None, 8)])
def test_prefill_matches_reference(which, s, true_len, max_len, request):
    """Last logits, every cache buffer (dtype included) and the lengths:
    a plain prefill, a bucketed one and a ring placement (jamba's GQA
    layer; falcon-mamba's states are constant-size)."""
    _, cfg, jparams, tparams, jprefill, _ = request.getfixturevalue(which)
    toks = _tokens((2, s), seed=s + 4)
    jl = None if true_len is None else jnp.asarray(true_len, jnp.int32)
    want, jst = jprefill(jparams, jnp.asarray(toks), jl, max_len=max_len)
    got, st = tengine.prefill(tparams, cfg, torch.from_numpy(toks), max_len,
                              attn_impl="pallas", true_len=true_len)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    _assert_state(st, jst, **F32)


@pytest.mark.parametrize("which", ["falcon", "jamba"])
def test_decode_steps_match_reference_with_active_mask(which, request):
    """Three teacher-forced decode steps from the reference's own prefill
    state, row 1 frozen by ``active``: the live rows' logits, every cache
    buffer (the frozen row's conv and h untouched) and the lengths."""
    _, cfg, jparams, tparams, jprefill, jdecode = request.getfixturevalue(
        which)
    toks = _tokens((3, 12), seed=5)
    _, jst = jprefill(jparams, jnp.asarray(toks[:, :9]), None, max_len=16)
    st = _state_to_torch(jst)
    frozen = {k: v[:, 1].clone() for k, v in st.caches.items()}
    active = np.array([True, False, True])
    for t in range(9, 12):
        want, jst = jdecode(jparams, jnp.asarray(toks[:, t]), jst,
                            jnp.asarray(active))
        got, st = tengine.decode_step(tparams, cfg,
                                      torch.from_numpy(toks[:, t]), st,
                                      decode_kernel="pallas",
                                      active=torch.from_numpy(active))
        np.testing.assert_allclose(_np(got)[active],
                                   np.asarray(want)[active], **F32)
        _assert_state(st, jst, **F32)
    assert st.lengths.tolist() == [12, 9, 12]
    for k, v in st.caches.items():
        assert torch.equal(v[:, 1], frozen[k]), k


@pytest.mark.parametrize("which", ["falcon", "jamba"])
def test_teacher_forced_decode_matches_forward(which, request):
    """Teacher-forced decode reproduces the training forward.  jamba's
    capacity factor is raised to E so that no replica is dropped in the
    forward or the prefill (decode routes dropless)."""
    _, cfg, _, tparams, _, _ = request.getfixturevalue(which)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
        max(cfg.num_experts, 1)))
    b, s = 2, 16
    toks = torch.from_numpy(_tokens((b, s), seed=6))
    full, _ = ttf.forward(tparams, cfg, toks)
    last, st = tengine.prefill(tparams, cfg, toks[:, :s // 2], max_len=32,
                               attn_impl="pallas")
    errs = [(last - full[:, s // 2 - 1]).abs().max().item()]
    for t in range(s // 2, s):
        lg, st = tengine.decode_step(tparams, cfg, toks[:, t], st, "pallas")
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("which", ["falcon", "jamba"])
def test_runner_warm_up_leaves_the_state_and_steps_equal_decode_steps(
        which, request):
    """The snapshot the card's runner takes around its warm-up puts back
    every buffer a step writes (ring slots, conv windows, f32 states);
    and on the CPU the runner's steps are decode_step's."""
    _, cfg, _, tparams, _, _ = request.getfixturevalue(which)
    toks = torch.from_numpy(_tokens((2, 10), seed=7))
    logits, st = tengine.prefill(tparams, cfg, toks, 16)
    before = {k: v.clone() for k, v in st.caches.items()}
    restore = tengine._snapshot(st)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(tengine.DECODE_WARMUP):
        tengine.decode_step(tparams, cfg, tok, st, "pallas")
    assert any(not torch.equal(v, before[k]) for k, v in st.caches.items())
    restore()
    for k, v in st.caches.items():
        assert torch.equal(v, before[k]), k

    twin = tengine.ServeState({k: v.clone() for k, v in st.caches.items()},
                              st.lengths.clone())
    runner = tengine.make_decode_runner(tparams, cfg, st, "pallas")
    a = b = tok
    for _ in range(3):
        la, _ = runner(a)
        lb, twin = tengine.decode_step(tparams, cfg, b, twin, "pallas")
        assert torch.equal(la, lb)
        a = b = torch.argmax(la, -1).to(torch.int32)


# ----------------------------------------------------------------- batcher
@pytest.mark.parametrize("which", ["falcon", "jamba"])
def test_batcher_matches_reference_batcher(which, request):
    """The port's finished tokens equal the reference batcher's for the
    same params and prompts (f32, greedy, bucketed pad-masked prefills),
    with more requests than slots and a request that meets the max_len
    reject (applied to a pure-mamba stack too, as the reference does)."""
    jcfg, cfg, jparams, tparams, _, _ = request.getfixturevalue(which)
    prompts = [_tokens((5 + 3 * i,), seed=20 + i) for i in range(4)]
    specs = [5, 4, 20, 3]
    jb = jbatcher.ContinuousBatcher(jparams, jcfg, num_slots=2, max_len=24)
    want = jb.run([jbatcher.Request(uid=i, prompt=jnp.asarray(p),
                                    max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, specs))])
    tb = tbatcher.ContinuousBatcher(tparams, cfg, num_slots=2, max_len=24,
                                    decode_kernel="pallas",
                                    attn_impl="pallas")
    got = tb.run([tbatcher.Request(uid=i, prompt=torch.from_numpy(p),
                                   max_new_tokens=n)
                  for i, (p, n) in enumerate(zip(prompts, specs))])
    assert got == want
    assert len(got[2]) < 20          # finished by the max_len reject
    assert tb.prefill_traces == jb.prefill_traces
    assert tb.state.caches[next(k for k in tb.state.caches
                                if k.endswith(".mamba.h"))].dtype \
        == torch.float32
