"""The port's serving path against the JAX reference.

The prefill and the decode step of ``repro_torch.serving.engine`` against
``repro.serving.engine`` on glm4-9b-smoke from the reference's params:
plain, bucketed and ring prefills, teacher-forced decode steps with an
``active`` mask; the kernel route against the plain one; the port's own
contracts (decode equals the training forward, the sliding-window ring is
exact); the continuous batcher against isolated generation and against
the reference's batcher; and the launcher.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: f32 rtol 1e-5 / atol 1e-5 where both sides do the same
arithmetic in another order (two layers of matmuls and softmax sums on
values of order 1).  Greedy token chains are compared exactly, in f32
only: ``torch.argmax`` and ``jnp.argmax`` both return the first maximum,
while in bf16 a last-bit difference could flip an argmax.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving import batcher as jbatcher  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.serving import batcher as tbatcher  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def glm():
    """glm4-9b-smoke: the reference's params (numpy and torch), configs,
    and the reference's prefill / decode step jitted once."""
    jcfg = jconfigs.get_smoke_config("glm4-9b")
    cfg = configs.get_smoke_config("glm4-9b")
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jprefill = jax.jit(
        lambda p, t, tl, max_len: jengine.prefill(p, jcfg, t, max_len,
                                                  true_len=tl),
        static_argnames="max_len")
    jdecode = jax.jit(
        lambda p, t, st, a: jengine.decode_step(p, jcfg, t, st, active=a))
    return jcfg, cfg, jparams, tparams, jprefill, jdecode


def _tokens(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _state_to_torch(jst):
    return tengine.ServeState(
        caches={k: torch.from_numpy(np.array(v)) for k, v in
                jst.caches.items()},
        lengths=torch.from_numpy(np.array(jst.lengths)))


def _assert_state(st, jst, **tol):
    assert set(st.caches) == set(jst.caches)
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))
    for k, buf in st.caches.items():
        assert tuple(buf.shape) == jst.caches[k].shape, k
        np.testing.assert_allclose(_np(buf), np.asarray(jst.caches[k]),
                                   err_msg=k, **tol)


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("window", [0, 5])
def test_attn_pallas_route_equals_ref_and_collects_the_cache(glm, window):
    """impl="pallas" (the kernel's plain version on the CPU) equals the
    chunked impl="ref", and the collector holds the roped K and V."""
    _, cfg, _, tparams, _, _ = glm
    cfg = dataclasses.replace(cfg, sliding_window=window)
    lp = ttf._period(tparams["layers"], 0)["l0"]["mixer"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32))
    pos = torch.arange(13)[None].expand(2, 13)
    c_ref, c_pal = {}, {}
    want = tattn.attn(lp, x, cfg, pos, q_chunk=4, collector=c_ref)
    got = tattn.attn(lp, x, cfg, pos, collector=c_pal, impl="pallas")
    torch.testing.assert_close(got, want, **F32)
    assert set(c_ref) == {"attn.k", "attn.v"}
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    for name in c_ref:
        assert c_ref[name].shape == (2, 13, hkv, hd)
        assert torch.equal(c_ref[name], c_pal[name])
    # the trainable route (the kernels' plain versions on the CPU) too
    torch.testing.assert_close(tattn.attn(lp, x, cfg, pos, impl="flash"),
                               want, **F32)


def test_forward_collects_stacked_cache(glm):
    jcfg, cfg, jparams, tparams, _, _ = glm
    toks = _tokens((2, 9), seed=2)
    _, jaux = jtf.forward(jparams, jcfg, jnp.asarray(toks),
                          collect_cache=True)
    logits, aux = ttf.forward(tparams, cfg, torch.from_numpy(toks),
                              collect_cache=True, attn_impl="pallas")
    assert set(aux.cache) == set(jaux.cache)
    for k, v in aux.cache.items():
        assert tuple(v.shape) == (cfg.num_periods, 2, 9, 2, 32)
        np.testing.assert_allclose(_np(v), np.asarray(jaux.cache[k]), **F32)
    plain, _ = ttf.forward(tparams, cfg, torch.from_numpy(toks))
    torch.testing.assert_close(logits, plain, **F32)


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("mode,s,true_len,max_len", [
    ("plain", 12, None, 32),
    ("bucketed", 16, 11, 32),
    ("ring", 12, None, 8),
    ("bucketed ring", 16, 11, 8),
])
@pytest.mark.parametrize("attn_impl", ["ref", "pallas"])
def test_prefill_matches_reference(glm, mode, s, true_len, max_len,
                                   attn_impl):
    """Last logits, every cache buffer and the lengths against the
    reference's prefill, for a plain copy, a bucketed (right-padded)
    prompt and a ring placement (prompt longer than the cache)."""
    _, cfg, jparams, tparams, jprefill, _ = glm
    toks = _tokens((2, s), seed=s)
    jl = None if true_len is None else jnp.asarray(true_len, jnp.int32)
    want, jst = jprefill(jparams, jnp.asarray(toks), jl, max_len=max_len)
    got, st = tengine.prefill(tparams, cfg, torch.from_numpy(toks), max_len,
                              attn_impl=attn_impl, true_len=true_len)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    _assert_state(st, jst, **F32)


def test_decode_steps_match_reference_with_active_mask(glm):
    """Three teacher-forced decode steps from the reference's own prefill
    state, row 1 frozen by ``active``: logits of the live rows, every
    cache buffer and the lengths against the reference's decode_step."""
    jcfg, cfg, jparams, tparams, jprefill, jdecode = glm
    toks = _tokens((3, 12), seed=3)
    _, jst = jprefill(jparams, jnp.asarray(toks[:, :9]), None, max_len=16)
    st = _state_to_torch(jst)
    active = np.array([True, False, True])
    for t in range(9, 12):
        want, jst = jdecode(jparams, jnp.asarray(toks[:, t]), jst,
                            jnp.asarray(active))
        got, st = tengine.decode_step(tparams, cfg,
                                      torch.from_numpy(toks[:, t]), st,
                                      active=torch.from_numpy(active))
        np.testing.assert_allclose(_np(got)[active],
                                   np.asarray(want)[active], **F32)
        _assert_state(st, jst, **F32)
    assert st.lengths.tolist() == [12, 9, 12]


def test_decode_kernel_route_equals_ref(glm):
    """decode_kernel="pallas" (the kernel's plain version on the CPU)
    equals the reference's oracle route within the port."""
    _, cfg, _, tparams, _, _ = glm
    toks = torch.from_numpy(_tokens((2, 8), seed=4))
    logits, st = tengine.prefill(tparams, cfg, toks, 32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    snap = tengine.ServeState({k: v.clone() for k, v in st.caches.items()},
                              st.lengths.clone())
    l_ref, st_ref = tengine.decode_step(tparams, cfg, tok, st, "ref")
    l_pal, st_pal = tengine.decode_step(tparams, cfg, tok, snap, "pallas")
    torch.testing.assert_close(l_pal, l_ref, **F32)
    for k in st_ref.caches:       # later periods see the routes' outputs
        torch.testing.assert_close(st_pal.caches[k], st_ref.caches[k], **F32)
    with pytest.raises(ValueError, match="decode_kernel"):
        tengine.decode_step(tparams, cfg, tok, st, "flash")


@pytest.mark.parametrize("window", [0, 8])
def test_teacher_forced_decode_matches_forward(glm, window):
    """Teacher-forced decode reproduces the training forward, with a full
    cache and with a sliding-window ring that wraps (window 8, 24
    tokens)."""
    _, cfg, _, tparams, _, _ = glm
    cfg = dataclasses.replace(cfg, sliding_window=window)
    b, s = 2, 24
    toks = torch.from_numpy(_tokens((b, s), seed=5))
    full, _ = ttf.forward(tparams, cfg, toks)
    last, st = tengine.prefill(tparams, cfg, toks[:, :s // 2], max_len=64,
                               attn_impl="pallas")
    if window:
        assert st.caches["l0.attn.k"].shape[2] == window
    errs = [(last - full[:, s // 2 - 1]).abs().max().item()]
    for t in range(s // 2, s):
        lg, st = tengine.decode_step(tparams, cfg, toks[:, t], st, "pallas")
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 1e-4, errs


# ----------------------------------------------------------------- batcher
def _prompts(n, seed, lo=6):
    return [_tokens((lo + i,), seed=seed + i) for i in range(n)]


def test_batched_requests_match_isolated_generation(glm):
    _, cfg, _, tparams, _, _ = glm
    prompts = _prompts(3, seed=10)
    want = {i: tengine.generate(tparams, cfg, torch.from_numpy(p)[None],
                                steps=5, max_len=32)[0].tolist()
            for i, p in enumerate(prompts)}
    batcher = tbatcher.ContinuousBatcher(tparams, cfg, num_slots=2,
                                         max_len=32, decode_kernel="pallas",
                                         attn_impl="pallas")
    got = batcher.run([tbatcher.Request(uid=i, prompt=torch.from_numpy(p),
                                        max_new_tokens=5)
                       for i, p in enumerate(prompts)])
    assert got == want
    assert batcher.state.lengths.tolist() == [0, 0]


def test_batcher_matches_reference_batcher(glm):
    """The port's finished tokens equal the reference batcher's for the
    same params and prompts (f32, greedy), with more requests than slots,
    an EOS and a request that meets the max_len reject."""
    _, cfg, jparams, tparams, _, _ = glm
    prompts = _prompts(4, seed=20)
    specs = [(5, -1), (4, -1), (20, -1), (3, -1)]
    jb = jbatcher.ContinuousBatcher(jparams, glm[0], num_slots=2, max_len=24)
    want = jb.run([jbatcher.Request(uid=i, prompt=jnp.asarray(p),
                                    max_new_tokens=n, eos_id=e)
                   for i, (p, (n, e)) in enumerate(zip(prompts, specs))])
    tb = tbatcher.ContinuousBatcher(tparams, cfg, num_slots=2, max_len=24)
    got = tb.run([tbatcher.Request(uid=i, prompt=torch.from_numpy(p),
                                   max_new_tokens=n, eos_id=e)
                  for i, (p, (n, e)) in enumerate(zip(prompts, specs))])
    assert got == want
    assert len(got[2]) < 20       # finished by the max_len reject
    assert tb.prefill_traces == jb.prefill_traces


def test_freed_slot_stays_frozen(glm):
    _, cfg, _, tparams, _, _ = glm
    batcher = tbatcher.ContinuousBatcher(tparams, cfg, num_slots=2,
                                         max_len=32)
    p0, p1 = (torch.from_numpy(p) for p in _prompts(2, seed=30, lo=8))
    assert batcher.try_insert(tbatcher.Request(0, p0, max_new_tokens=8))
    assert batcher.try_insert(tbatcher.Request(1, p1, max_new_tokens=2))
    while 1 not in batcher.finished:
        batcher.step()
    dead = {k: v[:, 1].clone() for k, v in batcher.state.caches.items()}
    for _ in range(3):
        batcher.step()
    assert int(batcher.state.lengths[1]) == 0
    for k, v in batcher.state.caches.items():
        assert torch.equal(v[:, 1], dead[k]), k
    assert batcher.try_insert(tbatcher.Request(2, p0, max_new_tokens=2))


def test_prefill_traces_count_buckets(glm):
    """Buckets pin the count of distinct prefill shapes, as the
    reference's trace count: 3,4 → 4; 5,6,7 → 8; 9 → 16."""
    _, cfg, _, tparams, _, _ = glm
    lengths = [3, 4, 5, 6, 7, 9]
    for buckets, want in ((True, 3), (False, len(set(lengths)))):
        b = tbatcher.ContinuousBatcher(tparams, cfg, num_slots=6, max_len=32,
                                       min_bucket=4, prefill_buckets=buckets)
        for i, n in enumerate(lengths):
            assert b.try_insert(tbatcher.Request(
                uid=i, prompt=torch.from_numpy(_tokens((n,), seed=40 + i)),
                max_new_tokens=2))
        assert b.prefill_traces == want
    # the reference's mesh= is the port's model_group=
    with pytest.raises(TypeError, match="mesh"):
        tbatcher.ContinuousBatcher(tparams, cfg, 2, 32, mesh=object())


# ---------------------------------------------------------------- launcher
def test_serve_launcher_runs_on_cpu(capsys):
    result = tserve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--steps",
                          "4"])
    assert result.tokens.shape == (2, 5) and len(result.step_ms) == 4
    assert result.state.lengths.tolist() == [12, 12]
    out = capsys.readouterr().out
    for word in ("prefill: 2x8", "decode: 4 steps", "sample:"):
        assert word in out


def test_serve_launcher_defaults_to_the_card_and_pallas(capsys):
    args = tserve.parse_args(["--device", "cpu"])
    assert args.kernel == "pallas" and args.arch == "glm4-9b"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(SystemExit) as e:
        tserve.parse_args(["--smoke"])
    assert e.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err

