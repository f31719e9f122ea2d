"""The port's async scoring pipeline (``core/async_pipeline.py``) and the
buffered store against the JAX reference, and against its own invariant.

Within the port, bitwise: an async run with swap cadence K equals a
relaxed run, built from the same scoring and master passes over one
store, whose master at step t reads the store as written through step
K⌊t/K⌋ − 1; the published serving snapshot decodes as the params of the
step it was taken at.  Against the reference: the same numpy params and
data, the reference's sampled indices injected, f32 at rtol 1e-5 (matmul
sums in another order).  Checkpoints of a buffered TrainState cross
between the packages in both directions, bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.core import async_pipeline as japipe  # noqa: E402
from repro.core.importance import ISConfig as JISConfig  # noqa: E402
from repro.core.issgd import ISSGDConfig as JISSGDConfig  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_make_scorer  # noqa: E402
from repro.data import make_svhn_like as j_make_svhn_like  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import async_pipeline as apipe  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.core.importance import ISConfig  # noqa: E402
from repro_torch.core.issgd import (ISSGDConfig, init_train_state,  # noqa
                                    make_master_pass, make_scoring_pass)
from repro_torch.core.scorer import make_lm_scorer, make_mlp_scorer  # noqa
from repro_torch.data import make_token_dataset  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.serving.engine import generate  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
N = 512


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def setup():
    """The reference's async test setup, shared by both packages: an MLP
    16→32→4, 512 examples, batch 16, score batch 64, W = 4."""
    jcfg = jmlp.MLPConfig(input_dim=16, hidden=(32,), num_classes=4)
    train, _ = j_make_svhn_like(jax.random.key(0), n=N, dim=16, classes=4)
    jparams = jmlp.init_mlp_classifier(jax.random.key(1), jcfg)
    tcfg = tmlp.MLPConfig(input_dim=16, hidden=(32,), num_classes=4)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, train, jparams, tcfg, data, tparams


def _port_parts(tcfg, mode="relaxed"):
    cfg = ISSGDConfig(batch_size=16, score_batch_size=64, mode=mode,
                      is_cfg=ISConfig(smoothing=0.1), score_shards=4)
    pel = lambda p, b: tmlp.per_example_loss(p, b, tcfg)
    return cfg, pel, make_mlp_scorer(tcfg, "ghost"), sgd(0.05)


def _same_params(a, b):
    return all(torch.equal(a[k][j], b[k][j]) for k in a for j in a[k])


@pytest.mark.parametrize("swap_every", [1, 3])
def test_async_equals_lagged_relaxed(setup, swap_every):
    """async(K) ≡ relaxed with the proposal of K⌊t/K⌋ − 1, bitwise: same
    draws, losses, params and both buffers."""
    _, _, _, tcfg, data, tparams = setup
    cfg, pel, scorer, opt = _port_parts(tcfg)
    K, T = swap_every, 8
    pipe = apipe.AsyncPipeline(*apipe.make_async_steps(pel, scorer, opt,
                                                       cfg, N), K)
    state = apipe.init_async_state(tparams, opt, N, "cpu", seed=3)
    alog = []
    for _ in range(T):
        state, m = pipe.step(state, data)
        alog.append((m.sample_indices.clone(), m.loss.clone()))

    scoring = make_scoring_pass(scorer, cfg, N)
    master = make_master_pass(pel, opt, cfg, N)
    ref = init_train_state(tparams, opt, N, "cpu", seed=3)
    store, hist = ref.store, [ref.store]
    p, o, sp, g = ref.params, ref.opt_state, ref.stale_params, ref.rng
    for t in range(T):
        store, _, _ = scoring(sp, store, t, data)
        hist.append(store)
        p, o, sp, _, m = master(p, o, sp, hist[(t // K) * K], t, g, data)
        assert torch.equal(alog[t][0], m.sample_indices), t
        assert torch.equal(alog[t][1], m.loss), t
    assert _same_params(state.params, p)
    assert torch.equal(state.store.write_buf.weights, store.weights)
    assert torch.equal(state.store.read_buf.weights,
                       hist[(T // K) * K].weights)
    assert pipe.swaps == T // K


def test_async_steps_match_reference(setup):
    """The port's scoring and master steps against the reference's jitted
    ``make_async_steps``, K = 2, the reference's draws injected."""
    jcfg, train, jparams, tcfg, data, tparams = setup
    K, T = 2, 6
    jtcfg = JISSGDConfig(batch_size=16, score_batch_size=64,
                         mode="relaxed", is_cfg=JISConfig(smoothing=0.1),
                         score_shards=4)
    jopt = j_sgd(0.05)
    js, jm = japipe.make_async_steps(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg),
        j_make_scorer(jcfg, "ghost"), jopt, jtcfg, N)
    jpipe = japipe.AsyncPipeline(js, jm, swap_every=K)
    jstate = japipe.init_async_state(jparams, jopt, N)

    cfg, pel, scorer, opt = _port_parts(tcfg)
    sstep, mstep = apipe.make_async_steps(pel, scorer, opt, cfg, N)
    st = apipe.init_async_state(tparams, opt, N, "cpu")
    bs = st.store
    p, o, sp = st.params, st.opt_state, st.stale_params
    for t in range(T):
        jstate, jmet = jpipe.step(jstate, train.arrays)
        write_buf, smet = sstep(sp, bs.write_buf, t, data)
        p, o, sp, _, _, met = mstep(
            p, o, sp, bs.read_buf, t, st.rng, data,
            sample_indices=torch.from_numpy(
                np.array(jmet.sample_indices)))
        bs = ws.BufferedWeightStore(bs.read_buf, write_buf, bs.synced_at)
        if (t + 1) % K == 0:
            bs = ws.publish(bs, t)
        for f in ("loss", "grad_norm", "ess_frac"):
            np.testing.assert_allclose(_np(getattr(met, f)),
                                       np.asarray(getattr(jmet, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f)
        for f in ScoreFields:
            np.testing.assert_allclose(_np(getattr(smet, f)),
                                       np.asarray(getattr(jmet, f)),
                                       rtol=RTOL, atol=ATOL, err_msg=f)
    jbs = jstate.store
    assert bs.synced_at == int(jbs.synced_at)
    for buf in ("read_buf", "write_buf"):
        np.testing.assert_array_equal(
            _np(getattr(bs, buf).scored_at),
            np.asarray(getattr(jbs, buf).scored_at))
        np.testing.assert_allclose(_np(getattr(bs, buf).weights),
                                   np.asarray(getattr(jbs, buf).weights),
                                   rtol=RTOL, atol=ATOL)
    for k in p:
        for j in p[k]:
            np.testing.assert_allclose(_np(p[k][j]),
                                       np.asarray(jstate.params[k][j]),
                                       rtol=RTOL, atol=ATOL)


ScoreFields = ("trace_ideal", "trace_stale", "trace_unif")


@pytest.mark.parametrize("monitor", [True, False])
def test_score_trace_metrics_match_reference(monitor):
    rng = np.random.default_rng(5)
    fresh = np.abs(rng.standard_normal(64)).astype(np.float32) * 3
    stale = np.abs(rng.standard_normal(64)).astype(np.float32) + 0.1
    want = japipe.score_trace_metrics(jnp.asarray(fresh), jnp.asarray(stale),
                                      (), n_total=64, monitor=monitor)
    got = apipe.score_trace_metrics(torch.from_numpy(fresh),
                                    torch.from_numpy(stale), n_total=64,
                                    monitor=monitor)
    for f in ScoreFields:
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=RTOL, equal_nan=True)
        assert np.isnan(_np(getattr(got, f))) == (not monitor)


@pytest.mark.parametrize("mode", ["exact", "fused"])
def test_async_refuses_exact_and_fused(setup, mode):
    tcfg = setup[3]
    cfg, pel, scorer, opt = _port_parts(tcfg)
    with pytest.raises(ValueError, match="relaxed'/'uniform"):
        apipe.make_async_steps(pel, scorer, opt,
                               dataclasses.replace(cfg, mode=mode), N)


def test_scored_at_exposes_lag(setup):
    """After step t the snapshot holds writes through K⌊(t+1)/K⌋ − 1 and
    write_buf through t; a uniform-mode pipeline runs too."""
    _, _, _, tcfg, data, tparams = setup
    K = 4
    for mode in ("relaxed", "uniform"):
        cfg, pel, scorer, opt = _port_parts(tcfg, mode)
        pipe = apipe.make_async_pipeline(pel, scorer, opt, cfg, N,
                                         swap_every=K)
        state = apipe.init_async_state(tparams, opt, N, "cpu")
        assert state.store.synced_at == -1
        for t in range(10):
            state, m = pipe.step(state, data)
            synced = ((t + 1) // K) * K - 1
            assert state.store.synced_at == synced, t
            assert int(state.store.read_buf.scored_at.max()) == synced, t
            assert int(state.store.write_buf.scored_at.max()) == t, t
            assert torch.isfinite(m.trace_stale)


def test_swap_every_is_read_each_step(setup):
    """A controller's cadence change applies from the next step."""
    _, _, _, tcfg, data, tparams = setup
    cfg, pel, scorer, opt = _port_parts(tcfg)
    pipe = apipe.make_async_pipeline(pel, scorer, opt, cfg, N, swap_every=1)
    state = apipe.init_async_state(tparams, opt, N, "cpu")
    state, _ = pipe.step(state, data)
    pipe.swap_every = 3
    for _ in range(5):
        state, _ = pipe.step(state, data)
    # swaps when the host counter reaches 1, then 3 and 6
    assert pipe.swaps == 3 and state.store.synced_at == 5


@pytest.mark.parametrize("publish_every", [1, 3])
def test_published_params_equal_explicit_stale_checkpoint(publish_every):
    """A serve tick decoding against ``PublishedParams`` under cadence K
    equals a decode against a host copy of the params of step K⌊t/K⌋;
    the snapshot holds the step's tensors, which no later step writes, so
    it keeps the bits of its step and does not follow the live params."""
    cfg = get_smoke_config("glm4-9b")
    n, K, T = 64, publish_every, 5
    gen = lambda s: torch.Generator().manual_seed(s)
    data = make_token_dataset(gen(0), n=n, seq=17, vocab=cfg.vocab_size)
    params = transformer.init_transformer(gen(1), cfg, "cpu")
    opt = sgd(0.05)
    icfg = ISSGDConfig(batch_size=4, score_batch_size=16, mode="relaxed",
                       is_cfg=ISConfig(smoothing=0.1))
    pel = lambda p, b: transformer.per_example_loss(p, cfg, b)[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, 4), generator=gen(9))
    hist, served, stamps, published = [], [], [], [None]

    def serve_tick(state):
        t = len(hist)
        hist.append(_np_tree(state.params))
        if published[0] is None or t % K == 0:
            published[0] = ws.publish_params(state.params, state.step)
        stamps.append(published[0].synced_at)
        served.append(generate(published[0].params, cfg, prompt, steps=3,
                               max_len=8)[0].tolist())

    pipe = apipe.AsyncPipeline(*apipe.make_async_steps(
        pel, make_lm_scorer(cfg, "loss"), opt, icfg, n), 1,
        serve_tick=serve_tick)
    state = apipe.init_async_state(params, opt, n, "cpu")
    for _ in range(T):
        state, _ = pipe.step(state, data.arrays)
    for t in range(T):
        assert stamps[t] == K * (t // K), (t, stamps[t])
        want = generate(hist[K * (t // K)], cfg, prompt, steps=3,
                        max_len=8)[0].tolist()
        assert served[t] == want, t
    assert _same_tree(published[0].params, hist[published[0].synced_at])
    assert not _same_tree(published[0].params, state.params)


def _np_tree(tree):
    """A deep copy of a params tree (the checkpoint of a step)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _same_tree(a, b):
    if isinstance(a, dict):
        return all(_same_tree(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_buffered_checkpoint_crosses_packages(setup, tmp_path):
    """A TrainState whose store is a BufferedWeightStore saves and restores
    in the reference's layout (read_buf/write_buf/synced_at as plain
    leaves), port → reference and reference → port, bitwise."""
    jcfg, train, jparams, tcfg, data, tparams = setup
    cfg, pel, scorer, opt = _port_parts(tcfg)
    pipe = apipe.make_async_pipeline(pel, scorer, opt, cfg, N, swap_every=3)
    state = apipe.init_async_state(tparams, opt, N, "cpu")
    for _ in range(4):
        state, _ = pipe.step(state, data)
    path = tmp_path / "port.npz"
    save_checkpoint(path, state, step=state.step)
    jopt = j_sgd(0.05)
    jtemplate = japipe.init_async_state(jparams, jopt, N)
    jback, jstep = j_restore(path, jtemplate)
    assert jstep == 4 and int(jback.step) == 4
    assert int(jback.store.synced_at) == state.store.synced_at == 2
    for buf in ("read_buf", "write_buf"):
        for f in ("weights", "scored_at"):
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(jback.store, buf), f)),
                _np(getattr(getattr(state.store, buf), f)))

    # reference → port: a reference run saved, restored into a cold port
    # template
    jtcfg = JISSGDConfig(batch_size=16, score_batch_size=64,
                         mode="relaxed", is_cfg=JISConfig(smoothing=0.1),
                         score_shards=4)
    jpipe = japipe.AsyncPipeline(*japipe.make_async_steps(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg),
        j_make_scorer(jcfg, "ghost"), jopt, jtcfg, N), swap_every=2)
    jstate = jtemplate
    for _ in range(3):
        jstate, _ = jpipe.step(jstate, train.arrays)
    jpath = tmp_path / "ref.npz"
    j_save(jpath, jstate, step=int(jstate.step))
    back, step = restore_checkpoint(jpath, apipe.init_async_state(
        tparams, opt, N, "cpu"))
    assert step == 3 and back.step == 3 and back.store.synced_at == 1
    for buf in ("read_buf", "write_buf"):
        for f in ("weights", "scored_at"):
            np.testing.assert_array_equal(
                _np(getattr(getattr(back.store, buf), f)),
                np.asarray(getattr(getattr(jstate.store, buf), f)))
    for k in back.params:
        for j in back.params[k]:
            np.testing.assert_array_equal(_np(back.params[k][j]),
                                          np.asarray(jstate.params[k][j]))
    # the restored state trains on
    back, m = apipe.make_async_pipeline(pel, scorer, opt, cfg, N).step(
        back, data)
    assert torch.isfinite(m.loss)


@pytest.mark.parametrize("dtype,chunk", [("bf16", 0), ("int8", 64)])
def test_quantized_tables_buffer_unchanged(dtype, chunk):
    """bf16 and int8 tables go through to_buffered/publish as they are,
    the int8 scales included, and the copies share no storage."""
    store = ws.init_store(N, "cpu", table_dtype=dtype, chunk_size=chunk)
    store = ws.write_scores(store, torch.arange(0, N, 7),
                            torch.rand(len(range(0, N, 7))) * 5, 3)
    bs = ws.to_buffered(store)
    pub = ws.publish(bs, 3)
    for buf in (bs.read_buf, bs.write_buf, pub.read_buf):
        assert buf.weights.dtype == store.weights.dtype
        assert torch.equal(buf.weights, store.weights)
        if dtype == "int8":
            assert torch.equal(buf.qscale, store.qscale)
    assert pub.read_buf.weights.data_ptr() != pub.write_buf.weights.data_ptr()
    assert pub.synced_at == 3
