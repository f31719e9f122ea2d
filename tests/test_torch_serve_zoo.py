"""The port's serving engine on the MLA, MoE and frontend archs against
the JAX reference, and the serve launcher on every arch.

``models/attention.mla_decode`` (the absorbed one-token decode over the
compressed cache) against the reference's; the engine's prefill and
decode steps (with an ``active`` mask) for minicpm3-4b (MLA), dbrx-132b
and grok-1-314b (MoE: capacity-routed prefill, dropless decode),
llava-next-34b and musicgen-medium (frontend embeds before the prompt)
against the reference engine; the MLA ring past its capacity; per-buffer
cache dtypes (a bf16 rope cache beside an f32 mamba state);
``generate(embeds=)``; and ``launch/serve.py --smoke --device cpu`` for
all ten archs.

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
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=1e-5, atol=1e-5)
ALL_ARCHS = ("glm4-9b", "deepseek-7b", "internlm2-20b", "falcon-mamba-7b",
             "jamba-v0.1-52b", "minicpm3-4b", "dbrx-132b", "grok-1-314b",
             "llava-next-34b", "musicgen-medium")
ZOO = {"minicpm3-4b": 2, "dbrx-132b": 3, "grok-1-314b": 4,
       "llava-next-34b": 5, "musicgen-medium": 6}


def _np(t):
    return t.detach().float().cpu().numpy()


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _embeds(cfg, b, seed):
    if cfg.frontend == "none":
        return None
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.num_frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _model(name, seed, **replace):
    """(jcfg, cfg, jparams, tparams, jitted reference prefill, jitted
    reference decode step) of ``name``'s smoke config."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), **replace)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **replace)
    jparams = jax.jit(lambda k: jtf.init_transformer(k, jcfg))(
        jax.random.key(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jprefill = jax.jit(
        lambda p, t, e, tl, max_len: jengine.prefill(
            p, jcfg, t, max_len, embeds=e, true_len=tl),
        static_argnames="max_len")
    jdecode = jax.jit(
        lambda p, t, st, a: jengine.decode_step(p, jcfg, t, st, active=a))
    return jcfg, cfg, jparams, tparams, jprefill, jdecode


@pytest.fixture(scope="module", params=list(ZOO))
def zoo(request):
    return _model(request.param, ZOO[request.param])


@pytest.fixture(scope="module")
def minicpm():
    return _model("minicpm3-4b", 7)


def _state_to_torch(jst):
    return tengine.ServeState(
        caches={k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
                    getattr(torch, str(v.dtype))) for k, v in
                jst.caches.items()},
        lengths=torch.from_numpy(np.array(jst.lengths)))


def _assert_state(st, jst, **tol):
    assert set(st.caches) == set(jst.caches)
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))
    for k, buf in st.caches.items():
        assert tuple(buf.shape) == jst.caches[k].shape, k
        assert buf.dtype == getattr(torch, str(jst.caches[k].dtype)), k
        np.testing.assert_allclose(
            _np(buf), np.asarray(jst.caches[k], dtype=np.float32),
            err_msg=k, **tol)


def _opt(a):
    return None if a is None else jnp.asarray(a)


# --------------------------------------------------------------------- MLA
@pytest.mark.parametrize("active", [None, (True, False, True)])
def test_mla_decode_matches_reference(minicpm, active):
    """The absorbed decode's output and new rows against the reference's,
    over a cache of ring slots; the port writes the new rows in place (of
    the active rows only) before attending."""
    jcfg, cfg, jparams, tparams, _, _ = minicpm
    tp = ttf._period(tparams["layers"], 0)["l0"]["mixer"]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["l0"]["mixer"])
    rng = np.random.default_rng(8)
    b, w = 3, 8
    x = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
    lat = rng.standard_normal((b, w, cfg.kv_lora_rank)).astype(np.float32)
    rp = rng.standard_normal((b, w, cfg.qk_rope_dim)).astype(np.float32)
    pos = np.array([3, 7, 12], np.int32)
    lengths = np.minimum(pos + 1, w).astype(np.int32)
    slot = pos % w
    jout, jlat, jrp = jax.jit(
        lambda p, x, lc, rc, ps, ln, sl: jattn.mla_decode(
            p, x, jcfg, lc, rc, ps, ln, slot=sl))(
        jp, *map(jnp.asarray, (x, lat, rp, pos, lengths, slot)))
    tl, trp = torch.from_numpy(lat.copy()), torch.from_numpy(rp.copy())
    act = None if active is None else torch.tensor(active)
    out, nlat, nrp = tattn.mla_decode(
        tp, torch.from_numpy(x), cfg, tl, trp, torch.from_numpy(pos),
        torch.from_numpy(lengths), slot=torch.from_numpy(slot), active=act)
    live = np.ones(b, bool) if active is None else np.array(active)
    np.testing.assert_allclose(_np(out)[live], np.asarray(jout)[live], **F32)
    np.testing.assert_allclose(_np(nlat), np.asarray(jlat), **F32)
    np.testing.assert_allclose(_np(nrp), np.asarray(jrp), **F32)
    for got, old, new in ((tl, lat, jlat), (trp, rp, jrp)):
        want = old.copy()
        for r in range(b):
            if live[r]:
                want[r, slot[r]] = np.asarray(new)[r]
        np.testing.assert_allclose(got.numpy(), want, **F32)


def test_mla_decode_ring_past_capacity(minicpm):
    """The counterpart of the reference's regression: with a sliding
    window of 8 the latent cache holds 8 slots, decode rings over it, and
    teacher-forced decode past the wrap matches the windowed forward and
    the reference's decode step by step."""
    jcfg, cfg, jparams, tparams, jprefill, jdecode = minicpm
    w = 8
    jcfg, cfg = (dataclasses.replace(c, sliding_window=w)
                 for c in (jcfg, cfg))
    jdecode = jax.jit(lambda p, t, st: jengine.decode_step(p, jcfg, t, st))
    toks = _tokens((2, 14), seed=9)
    _, jst = jax.jit(lambda p, t: jengine.prefill(p, jcfg, t, 16))(
        jparams, jnp.asarray(toks[:, :4]))
    _, st = tengine.prefill(tparams, cfg, torch.from_numpy(toks[:, :4]), 16)
    assert st.caches["l0.attn.latent"].shape[2] == w
    for t in range(4, 14):
        want, jst = jdecode(jparams, jnp.asarray(toks[:, t]), jst)
        got, st = tengine.decode_step(tparams, cfg,
                                      torch.from_numpy(toks[:, t]), st)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    _assert_state(st, jst, **F32)
    full, _ = ttf.forward(tparams, cfg, torch.from_numpy(toks))
    assert (got - full[:, -1]).abs().max().item() < 2e-4


def test_per_buffer_dtypes_bf16_rope_beside_f32_h():
    """An MLA + mamba stack with its rope caches in bf16 beside f32
    latents and mamba states: each write keeps its buffer's dtype, the
    result does not depend on the caches' dict order, and it equals the
    reference's decode step on the same mixed caches."""
    extra = dict(ssm_state=8, d_inner=512, conv_width=4, attn_every=2,
                 attn_offset=1)
    jcfg, cfg, jparams, tparams, jprefill, _ = _model("minicpm3-4b", 10,
                                                      **extra)
    assert [s.mixer for s in cfg.layer_specs()] == ["mamba", "attn"]
    toks = _tokens((2, 5), seed=11)
    _, jst = jprefill(jparams, jnp.asarray(toks[:, :4]), None, None,
                      max_len=8)

    def mixed(caches, order):
        return {k: (caches[k].astype(jnp.bfloat16) if "rope" in k
                    else caches[k]) for k in order}
    keys = list(jst.caches)
    jst = jengine.ServeState(mixed(jst.caches, keys), jst.lengths)
    want, jout = jax.jit(lambda p, t, s: jengine.decode_step(p, jcfg, t, s))(
        jparams, jnp.asarray(toks[:, 4]), jst)
    outs = []
    for order in (keys, keys[::-1]):
        st = _state_to_torch(jst)
        st = tengine.ServeState({k: st.caches[k] for k in order}, st.lengths)
        logits, st = tengine.decode_step(tparams, cfg,
                                         torch.from_numpy(toks[:, 4]), st)
        outs.append((logits, st))
    (lf, sf), (lr, sr) = outs
    assert torch.equal(lf, lr)
    assert sf.caches["l1.attn.rope"].dtype == torch.bfloat16
    assert sf.caches["l0.mamba.h"].dtype == torch.float32
    for k in keys:
        assert sf.caches[k].dtype == sr.caches[k].dtype
        assert torch.equal(sf.caches[k], sr.caches[k]), k
    np.testing.assert_allclose(_np(lf), np.asarray(want), **F32)
    _assert_state(sf, jout, **F32)


# ------------------------------------------------------ MoE and frontends
def test_prefill_and_decode_match_reference(zoo):
    """Prefill (with the frontend's embeds before the prompt), a ring
    placement where the prompt outgrows the cache, and three
    teacher-forced decode steps with row 1 frozen by ``active``: the last
    and the live rows' logits, every cache buffer and the lengths."""
    _, cfg, jparams, tparams, jprefill, jdecode = zoo
    b = 3
    toks = _tokens((b, 12), seed=12)
    emb = _embeds(cfg, b, seed=13)
    temb = None if emb is None else torch.from_numpy(emb)
    n_front = 0 if emb is None else emb.shape[1]
    # ring: a 16-slot cache under the 9 + N_front prompt positions + 3
    for max_len in (32, n_front + 10):
        want, jst = jprefill(jparams, jnp.asarray(toks[:, :9]), _opt(emb),
                             None, max_len=max_len)
        got, st = tengine.prefill(tparams, cfg, torch.from_numpy(toks[:, :9]),
                                  max_len, embeds=temb,
                                  attn_impl=tengine.prefill_attn_impl(
                                      cfg, "pallas"))
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
        _assert_state(st, jst, **F32)
        assert st.lengths.tolist() == [9 + n_front] * b
    active = np.array([True, False, True])
    frozen = {k: v[:, 1].clone() for k, v in st.caches.items()}
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
    for k, v in st.caches.items():
        assert torch.equal(v[:, 1], frozen[k]), k


def test_bucketed_prefill_matches_reference(zoo):
    """A right-padded prompt with ``true_len`` (capacity-routed MoE lets
    the pad tokens compete for capacity, as in the reference); with
    embeds it raises, as the reference does."""
    _, cfg, jparams, tparams, jprefill, _ = zoo
    toks = _tokens((2, 16), seed=14)
    emb = _embeds(cfg, 2, seed=15)
    if emb is not None:
        with pytest.raises(ValueError, match="frontend embeds"):
            tengine.prefill(tparams, cfg, torch.from_numpy(toks), 32,
                            embeds=torch.from_numpy(emb), true_len=11)
    want, jst = jprefill(jparams, jnp.asarray(toks), None,
                         jnp.asarray(11, jnp.int32), max_len=32)
    got, st = tengine.prefill(tparams, cfg, torch.from_numpy(toks), 32,
                              true_len=11)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    _assert_state(st, jst, **F32)


def test_generate_with_embeds_matches_reference():
    jcfg, cfg, jparams, tparams, _, _ = _model("musicgen-medium", 16)
    toks = _tokens((2, 6), seed=17)
    emb = _embeds(cfg, 2, seed=18)
    want = jax.jit(lambda p, t, e: jengine.generate(
        p, jcfg, t, steps=5, max_len=24, embeds=e))(
        jparams, jnp.asarray(toks), jnp.asarray(emb))
    got = tengine.generate(tparams, cfg, torch.from_numpy(toks), steps=5,
                           max_len=24, decode_kernel="pallas",
                           embeds=torch.from_numpy(emb))
    assert got.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("name", ALL_ARCHS)
def test_serve_launcher_serves_every_arch_on_cpu(name, capsys):
    """``--smoke --device cpu`` prefills and decodes every arch: a
    frontend arch after min(num_frontend_tokens, 8) embeds, an MLA stack
    on the materialised prefill attention."""
    result = tserve.main(["--arch", name, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "6", "--steps",
                          "3"])
    cfg = configs.get_smoke_config(name)
    n_front = min(cfg.num_frontend_tokens, 8)
    assert result.tokens.shape == (2, 4)
    assert result.state.lengths.tolist() == [n_front + 9] * 2
    assert result.prefill_route == ("ref" if cfg.attention == "mla"
                                    else "pallas")
    out = capsys.readouterr().out
    assert f"attention route {result.prefill_route}" in out
    assert ("frontend embeds" in out) == (n_front > 0)
    for k, buf in result.state.caches.items():
        assert torch.isfinite(buf).all(), k


def test_serve_launcher_lists_every_arch(capsys):
    with pytest.raises(SystemExit):
        tserve.parse_args(["--help"])
    help_text = "".join(capsys.readouterr().out.split())  # wraps at "-"
    for name in ALL_ARCHS:
        assert name in help_text, name
    with pytest.raises(SystemExit) as e:
        tserve.parse_args(["--arch", "no-such-arch", "--device", "cpu"])
    assert e.value.code == 2
