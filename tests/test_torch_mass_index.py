"""The port's billion-row sampling structures against the JAX reference:
the chunk mass index, the bf16/int8 tables, the TTL decay and the
partial tail chunk; and, inside the port, refresh ≡ rebuild and tree ≡
dense draws bitwise, for the sampler and for whole train steps.

Tolerances: on a dyadic table (small integers over a power of two) every
sum is exact in f32, so masses, trees and drawn indices must be equal;
on a random table the masses agree to rtol 1e-6 (f32 sums in another
order: the port's leaf reduction is a fixed pairwise halving, the
reference's one XLA sum).  int8 codes and scales are bitwise (both round
half to even); dequantized, requantized and decayed values rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core import mass_index as jmi  # noqa: E402
from repro.core import sampler as jsampler  # noqa: E402
from repro.core import weight_store as jws  # noqa: E402
from repro.core.importance import ISConfig as JISConfig  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_make_scorer  # noqa: E402
from repro.data import make_svhn_like as j_make_svhn_like  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro.telemetry import MonitorSet as JMonitorSet  # noqa: E402
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core import mass_index as mi  # noqa: E402
from repro_torch.core import sampler  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.core.importance import ISConfig  # noqa: E402
from repro_torch.core.scorer import make_mlp_scorer  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.telemetry import MonitorSet  # noqa: E402

RTOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


def _table(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "dyadic":
        t = rng.integers(0, 9, n).astype(np.float32) / 4
        t[rng.choice(n, n // 5, replace=False)] = 0.0
        return t
    return rng.uniform(0.0, 3.0, n).astype(np.float32)


def _check(got, want, kind):
    if kind == "dyadic":
        assert np.array_equal(_np(got), np.asarray(want))
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL)


# ---------------------------------------------------------- the leaf masses
@pytest.mark.parametrize("kind", ["dyadic", "random"])
@pytest.mark.parametrize("n,cs", [(96, 8), (100, 7), (100, 128), (4096, 64)])
def test_chunk_and_block_masses_match_reference(kind, n, cs):
    t = _table(kind, n, seed=n + cs)
    tt = torch.from_numpy(t)
    _check(mi.chunk_masses(tt, cs), jmi.chunk_masses(jnp.asarray(t), cs),
           kind)
    # chunk_proposal_mass is the leaf reduction itself: bitwise
    assert torch.equal(sampler.chunk_proposal_mass(tt, cs),
                       mi.chunk_masses(tt, cs))
    for w in (1, 4):
        if n % w == 0:
            _check(mi.block_masses(tt, w),
                   jmi.block_masses(jnp.asarray(t), w), kind)


@pytest.mark.parametrize("kind", ["dyadic", "random"])
def test_build_and_refresh_match_reference(kind):
    n, cs = 200, 8           # 25 chunks: a tree of 32 leaves
    t = _table(kind, n, 3)
    jidx = jmi.build_index(jnp.asarray(t), cs)
    idx = mi.build_index(torch.from_numpy(t), cs)
    _check(idx.mass, jidx.mass, kind)
    _check(idx.tree, jidx.tree, kind)
    _check(mi.total_mass(idx), jmi.total_mass(jidx), kind)
    t2 = t.copy()
    t2[[3, 4, 90, 199]] = [2.0, 0.5, 1.25, 3.0]
    ids = np.array([0, 11, 24, 0])
    _check(mi.refresh_chunks(idx, torch.from_numpy(t2), cs,
                             torch.from_numpy(ids)).tree,
           jmi.refresh_chunks(jidx, jnp.asarray(t2), cs,
                              jnp.asarray(ids)).tree, kind)


@pytest.mark.parametrize("n,cs", [(1000, 16), (1003, 16), (64, 64),
                                  (50, 1), (333, 10)])
def test_refresh_equals_rebuild_bitwise(n, cs):
    """Refreshing the chunks a write touched, repeats and the partial
    tail included, is bitwise a rebuild of the written table."""
    g = torch.Generator().manual_seed(n)
    t = torch.rand(n, generator=g) * 5
    idx = mi.build_index(t, cs)
    rows = torch.randint(0, n, (12,), generator=g)
    rows[-1] = n - 1                                  # the tail chunk
    t2 = t.clone()
    t2[rows] = torch.rand(12, generator=g) * 7
    chunks, _ = sampler.index_to_chunk(rows, cs)
    fresh = mi.refresh_chunks(idx, t2, cs, chunks)
    again = mi.build_index(t2, cs)
    assert torch.equal(fresh.mass, again.mass)
    assert torch.equal(fresh.tree, again.tree)
    assert not torch.equal(idx.tree, again.tree)


def test_pairwise_leaf_sum_ignores_the_row_count():
    g = torch.Generator().manual_seed(1)
    rows = torch.rand(300, 1000, generator=g)
    full = mi._row_sums(rows)
    for ids in ([5], [7, 7, 299], list(range(0, 300, 13))):
        assert torch.equal(mi._row_sums(rows[ids]), full[ids])
    torch.testing.assert_close(full, rows.double().sum(1).float(),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------- the draws
def test_sample_chunks_and_indexed_sample_match_reference():
    n, cs, m = 200, 8, 512
    t = _table("dyadic", n, 7)
    jidx = jmi.build_index(jnp.asarray(t), cs)
    idx = mi.build_index(torch.from_numpy(t), cs)
    key = jax.random.key(3)
    want = jmi.indexed_sample(key, jnp.asarray(t), jidx, cs, m)
    u01 = np.array(jax.random.uniform(key, (m,), jnp.float32))
    got = mi.indexed_sample(torch.from_numpy(t), idx, cs, m,
                            uniforms=torch.from_numpy(u01))
    assert got.dtype == torch.int64
    assert np.array_equal(_np(got), np.asarray(want))
    assert (t[_np(got)] > 0).all()
    u = torch.from_numpy(u01) * mi.total_mass(idx)
    assert np.array_equal(_np(mi.sample_chunks(idx, u)),
                          np.asarray(jmi.sample_chunks(jidx, jnp.asarray(
                              _np(u)))))
    # the flat searchsorted draw over the same uniforms
    flat = np.searchsorted(np.cumsum(t), _np(u), side="right")
    assert np.array_equal(_np(got), np.clip(flat, 0, n - 1))


def test_indexed_sample_partial_tail_and_generator():
    t = torch.zeros(37)
    t[[2, 35, 36]] = torch.tensor([1.0, 2.0, 4.0])
    idx = mi.build_index(t, 8)
    draws = mi.indexed_sample(t, idx, 8, 3000,
                              generator=torch.Generator().manual_seed(0))
    counts = torch.bincount(draws, minlength=37)
    assert set(torch.nonzero(counts).flatten().tolist()) == {2, 35, 36}
    assert counts[36] > counts[35] > counts[2]
    with pytest.raises(ValueError, match="uniforms shape"):
        mi.indexed_sample(t, idx, 8, 4, uniforms=torch.zeros(3))


@pytest.mark.parametrize("w", [1, 4, 8, 16])
def test_tree_draws_equal_dense_draws_bitwise(w):
    g = torch.Generator().manual_seed(w)
    t = torch.rand(1024, generator=g) + 1e-3
    for s in range(3):
        dense = sampler.two_stage_sample(
            t, 64, num_shards=w, generator=torch.Generator().manual_seed(s))
        tree = sampler.two_stage_sample(
            t, 64, num_shards=w, generator=torch.Generator().manual_seed(s),
            block_sums=mi.block_masses(t, w))
        assert torch.equal(dense, tree)
    with pytest.raises(ValueError, match="block_sums"):
        sampler.two_stage_sample(t, 8, num_shards=4,
                                 block_sums=torch.ones(3))


def test_two_stage_with_block_sums_replays_reference():
    t = _table("dyadic", 512, 9)
    key = jax.random.key(11)
    want = jsampler.two_stage_sample(key, jnp.asarray(t), 128,
                                     shards_per_device=4,
                                     block_sums=jmi.block_masses(
                                         jnp.asarray(t), 4))
    u01 = np.array(jax.random.uniform(key, (128,), jnp.float32))
    got = sampler.two_stage_sample(torch.from_numpy(t), 128, num_shards=4,
                                   uniforms=torch.from_numpy(u01),
                                   block_sums=mi.block_masses(
                                       torch.from_numpy(t), 4))
    assert np.array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------- quantized tables
def _raw(n=256, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n).astype(np.float32) * 2
    w[:16] = 0.0                        # an all-zero chunk (scale 1)
    w[40] = 0.5 + 0.5 / 127             # a code on a rounding boundary
    return w


def test_quantize_codes_and_scales_match_reference_bitwise():
    w = _raw()
    codes, scale = ws.quantize_weights(torch.from_numpy(w), 16)
    jcodes, jscale = jws.quantize_weights(jnp.asarray(w), 16)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert np.array_equal(_np(codes), np.asarray(jcodes))
    assert np.array_equal(_np(scale), np.asarray(jscale))
    assert scale[0] == 1.0
    with pytest.raises(ValueError, match="must divide"):
        ws.quantize_weights(torch.from_numpy(w), 24)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_store_reads_and_writes_match_reference(dtype):
    n, cs = 256, 16
    w = np.abs(_raw(n, 1))
    scored = np.random.default_rng(2).integers(-1, 6, n).astype(np.int32)
    scored[[7, 100]] = ws.EMPTY
    jstore = jws._requantize(
        jws.init_store(n, table_dtype=dtype, chunk_size=cs)._replace(
            scored_at=jnp.asarray(scored)), jnp.asarray(w))
    tstore = ws._requantize(
        ws.init_store(n, "cpu", table_dtype=dtype, chunk_size=cs)._replace(
            scored_at=torch.from_numpy(scored)), torch.from_numpy(w))
    assert np.array_equal(_np(tstore.weights.float()),
                          np.asarray(jstore.weights.astype(jnp.float32)))
    np.testing.assert_allclose(_np(ws.dequantize_weights(tstore)),
                               np.asarray(jws.dequantize_weights(jstore)),
                               rtol=RTOL)
    idx = np.array([3, 50, 51, 200], np.int32)
    vals = np.array([9.0, 0.25, 4.0, 1.5], np.float32)
    dup = np.array([5, 5, 9, 5], np.int32)
    for jw, tw, ix in ((jws.write_scores, ws.write_scores, idx),
                       (jws.write_scores_global, ws.write_scores_global,
                        dup)):
        js = jw(jstore, jnp.asarray(ix), jnp.asarray(vals), 6)
        ts = tw(tstore, torch.from_numpy(ix), torch.from_numpy(vals), 6)
        assert ts.weights.dtype == tstore.weights.dtype
        assert np.array_equal(_np(ts.scored_at), np.asarray(js.scored_at))
        assert np.array_equal(_np(ts.weights.float()),
                              np.asarray(js.weights.astype(jnp.float32)))
        for thr in (0, 3):
            np.testing.assert_allclose(
                _np(ws.read_proposal(ts, 7, ISConfig(
                    smoothing=0.1, staleness_threshold=thr))),
                np.asarray(jws.read_proposal(js, 7, JISConfig(
                    smoothing=0.1, staleness_threshold=thr))), rtol=RTOL)
    if dtype == "int8":
        assert ws.store_chunk_size(tstore) == cs
        np.testing.assert_allclose(_np(tstore.qscale),
                                   np.asarray(jstore.qscale), rtol=0)


def test_init_store_refusals():
    with pytest.raises(ValueError, match="unknown table_dtype"):
        ws.init_store(64, "cpu", table_dtype="f16")
    with pytest.raises(ValueError, match="chunk_size"):
        ws.init_store(64, "cpu", table_dtype="int8", chunk_size=24)
    with pytest.raises(ValueError, match="not int8"):
        ws.store_chunk_size(ws.init_store(64, "cpu"))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_tv_bound_holds_and_matches_reference(dtype):
    n, cs = 4096, 64
    rng = np.random.default_rng(5)
    w = rng.uniform(0.0, 6.0, n).astype(np.float32)
    scored = rng.integers(-1, 3, n).astype(np.int32)
    cfg, jcfg = ISConfig(smoothing=0.05), JISConfig(smoothing=0.05)
    f32 = ws.WeightStore(torch.from_numpy(w), torch.from_numpy(scored))
    q = ws._requantize(ws.init_store(n, "cpu", table_dtype=dtype,
                                     chunk_size=cs)._replace(
        scored_at=f32.scored_at), f32.weights)
    p = ws.read_proposal(f32, 1, cfg).double()
    pq = ws.read_proposal(q, 1, cfg).double()
    tv = 0.5 * torch.sum(torch.abs(p / p.sum() - pq / pq.sum())).item()
    bound = ws.quantization_tv_bound(f32, 1, cfg, cs, dtype)
    want = jws.quantization_tv_bound(
        jws.WeightStore(jnp.asarray(w), jnp.asarray(scored)), 1, jcfg, cs,
        dtype)
    np.testing.assert_allclose(_np(bound), np.asarray(want), rtol=RTOL)
    assert 0 < tv <= bound.item() < 0.02
    with pytest.raises(ValueError, match="no quantization bound"):
        ws.quantization_tv_bound(f32, 1, cfg, cs, "f32")


@pytest.mark.parametrize("n,cs,ttl", [(50, 8, 4), (64, 16, 20), (64, 64, 1)])
def test_decay_proposal_matches_reference(n, cs, ttl):
    rng = np.random.default_rng(n + ttl)
    step = 20
    prop = rng.uniform(0.1, 3.0, n).astype(np.float32)
    scored = rng.integers(-1, step, n).astype(np.int32)
    scored[:cs] = -1                    # a chunk never scored keeps d = 1
    scored[rng.choice(n, 8, replace=False)] = ws.EMPTY
    cfg, jcfg = ISConfig(smoothing=0.1), JISConfig(smoothing=0.1)
    got = ws.decay_proposal(torch.from_numpy(prop), torch.from_numpy(scored),
                            step, ttl, cfg, cs)
    want = jws.decay_proposal(jnp.asarray(prop), jnp.asarray(scored), step,
                              ttl, jcfg, cs)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL)
    live = scored > ws.EMPTY
    assert (_np(got)[~live] == 0).all()
    np.testing.assert_allclose(_np(got)[:cs][live[:cs]],
                               prop[:cs][live[:cs]], rtol=RTOL)
    with pytest.raises(ValueError, match="ttl"):
        ws.decay_proposal(torch.from_numpy(prop), torch.from_numpy(scored),
                          step, 0, cfg, cs)


def test_read_sampling_proposal_matches_reference():
    n, w = 256, 4
    rng = np.random.default_rng(8)
    wts = rng.uniform(0.0, 5.0, n).astype(np.float32)
    scored = rng.integers(-1, 12, n).astype(np.int32)
    for kw in ({}, {"score_ttl": 5}, {"score_ttl": 5,
                                      "index_chunk_size": 16}):
        jcfg = jissgd.ISSGDConfig(is_cfg=JISConfig(smoothing=0.1), **kw)
        tcfg = issgd.ISSGDConfig(is_cfg=ISConfig(smoothing=0.1), **kw)
        want = jissgd.read_sampling_proposal(
            jws.WeightStore(jnp.asarray(wts), jnp.asarray(scored)), 15,
            jcfg, n // w)
        got = issgd.read_sampling_proposal(
            ws.WeightStore(torch.from_numpy(wts), torch.from_numpy(scored)),
            15, tcfg, n // w)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL)
    assert issgd.stage1_block_sums(torch.ones(8), 2,
                                   issgd.ISSGDConfig()) is None
    with pytest.raises(ValueError, match="unknown index"):
        issgd.make_train_step(None, None, sgd(0.1),
                              issgd.ISSGDConfig(index="bogus"), 64)


# ---------------------------------------------------------- partial tails
def test_partial_tail_chunk():
    w = torch.arange(10, dtype=torch.float32)
    assert sampler.chunk_proposal_mass(w, 4).tolist() == [6.0, 22.0, 17.0]
    assert mi.chunk_masses(w, 4).tolist() == [6.0, 22.0, 17.0]
    c, o = sampler.index_to_chunk(np.asarray([0, 3, 8, 9]), 4)
    assert c.tolist() == [0, 0, 2, 2] and o.tolist() == [0, 3, 0, 1]
    jc, jo = jsampler.index_to_chunk(np.asarray([0, 3, 8, 9]), 4)
    assert c.tolist() == jc.tolist() and o.tolist() == jo.tolist()
    with pytest.raises(ValueError, match="positive"):
        sampler.index_to_chunk(torch.arange(3), 0)


def test_staleness_stats_match_reference():
    rng = np.random.default_rng(12)
    for scored in (rng.integers(-1, 30, 100).astype(np.int32),
                   np.full(20, -1, np.int32)):
        got = ws.staleness_stats(
            ws.WeightStore(torch.zeros(scored.shape[0]),
                           torch.from_numpy(scored)), 31)
        want = jws.staleness_stats(
            jws.WeightStore(jnp.zeros(scored.shape[0]),
                            jnp.asarray(scored)), 31)
        assert int(got["max_age"]) == int(want["max_age"])
        for k in ("frac_scored", "mean_age"):
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=RTOL)


# ---------------------------------------------------------- whole steps
@pytest.fixture(scope="module")
def mlp_setup():
    jcfg = j_smoke()
    train, _ = j_make_svhn_like(jax.random.key(0), n=512, dim=jcfg.input_dim)
    jparams = jmlp.init_mlp_classifier(jax.random.key(1), jcfg)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, train, jparams, data, tparams


def _port(mode="relaxed", gated=False, monitors=None, **kw):
    cfg = smoke()
    opt = sgd(0.05)
    tcfg = issgd.ISSGDConfig(batch_size=16, score_batch_size=64,
                             refresh_every=2, score_shards=4, mode=mode,
                             is_cfg=ISConfig(smoothing=0.1), **kw)
    step = issgd.make_train_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg),
        make_mlp_scorer(cfg, "ghost"), opt, tcfg, 512, gated=gated,
        monitors=monitors)
    return step, opt, tcfg


@pytest.mark.parametrize("kw", [
    {}, {"table_dtype": "int8", "index_chunk_size": 32, "score_ttl": 3},
    {"table_dtype": "bf16", "score_ttl": 2}])
@pytest.mark.parametrize("gated", [False, True])
def test_tree_steps_equal_dense_steps_bitwise(mlp_setup, kw, gated):
    *_, data, tparams = mlp_setup
    runs = {}
    for index in ("dense", "tree"):
        step, opt, tcfg = _port(gated=gated, index=index, **kw)
        state = issgd.init_train_state(
            tparams, opt, 512, "cpu", seed=2, table_dtype=tcfg.table_dtype,
            index_chunk_size=tcfg.index_chunk_size)
        draws = []
        for _ in range(4):
            state, m = step(state, data, True) if gated else \
                step(state, data)
            draws.append(m.sample_indices)
        runs[index] = (state, draws)
    (a, da), (b, db) = runs["dense"], runs["tree"]
    assert all(torch.equal(x, y) for x, y in zip(da, db))
    assert torch.equal(a.store.weights, b.store.weights)
    assert torch.equal(a.store.scored_at, b.store.scored_at)
    if kw.get("table_dtype") == "int8":
        assert a.store.weights.dtype == torch.int8
        assert torch.equal(a.store.qscale, b.store.qscale)
    for name, leaves in a.params.items():
        for k, v in leaves.items():
            assert torch.equal(v, b.params[name][k]), (name, k)


def test_three_steps_with_tree_and_ttl_match_reference(mlp_setup):
    """The slice as a whole: tree index, TTL decay and chunk size in the
    reference's step and the port's (the reference's draws injected),
    with the ess and staleness monitors on the decayed proposal."""
    jcfg, train, jparams, data, tparams = mlp_setup
    kw = dict(batch_size=16, score_batch_size=64, refresh_every=2,
              score_shards=4, index="tree", score_ttl=2,
              index_chunk_size=32)
    jopt = j_sgd(0.05)
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg),
        j_make_scorer(jcfg, "ghost"), jopt,
        jissgd.ISSGDConfig(is_cfg=JISConfig(smoothing=0.1), **kw), 512,
        monitors=JMonitorSet(("ess", "staleness"))))
    jstate = jissgd.init_train_state(jparams, jopt, 512)
    kw.pop("batch_size"), kw.pop("score_batch_size")
    kw.pop("refresh_every"), kw.pop("score_shards")
    tstep, topt, _ = _port(monitors=MonitorSet(("ess", "staleness")), **kw)
    tstate = issgd.init_train_state(tparams, topt, 512, "cpu")
    for _ in range(3):
        jstate, jm, jmon = jstep(jstate, train.arrays)
        tstate, tm, tmon = tstep(tstate, data, sample_indices=torch.tensor(
            np.asarray(jm.sample_indices)))
        for f in ("loss", "ess_frac", "mean_weight", "trace_stale"):
            np.testing.assert_allclose(_np(getattr(tm, f)),
                                       np.asarray(getattr(jm, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(_np(tmon["ess"]), np.asarray(jmon["ess"]),
                                   rtol=1e-5)
        assert int(tmon["staleness"]) == int(jmon["staleness"])
    np.testing.assert_allclose(_np(tstate.store.weights),
                               np.asarray(jstate.store.weights), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv,match", [
    (["--table-dtype", "int8"], "needs --index-chunk-size"),
    (["--table-dtype", "int8", "--index-chunk-size", "100"],
     "needs --index-chunk-size"),
    (["--index-chunk-size", "100"], "must divide"),
    (["--adaptive-is", "--mode", "fused"], "requires --mode relaxed"),
    (["--monitors", "ess,bogus"], "--monitors: unknown monitor"),
    (["--profile-steps", "2"], "START:COUNT"),
    (["--index", "bogus"], "invalid choice"),
    (["--table-dtype", "f16"], "invalid choice"),
    (["--proposal-strategy", "bogus"], "invalid choice"),
])
def test_launcher_refuses_bad_flag_combinations(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args(argv + ["--device", "cpu", "--examples", "4096"])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_launcher_carries_the_slice_flags():
    for flag in ("--metrics-out", "--metrics-jsonl", "--metrics-every",
                 "--monitors", "--profile-dir", "--profile-steps",
                 "--telemetry-blocking", "--proposal-strategy",
                 "--adaptive-is", "--adapt-every", "--index",
                 "--index-chunk-size", "--table-dtype", "--score-ttl"):
        assert flag not in ttrain.LATER_FLAGS
    assert "--no-trace-monitors" in ttrain.LATER_FLAGS
    args = ttrain.parse_args(["--device", "cpu", "--index", "tree",
                              "--table-dtype", "int8", "--index-chunk-size",
                              "64", "--score-ttl", "9"])
    built = ttrain.build(ttrain.parse_args([
        "--device", "cpu", "--smoke", "--examples", "512", "--table-dtype",
        "int8", "--index-chunk-size", "64"]))
    assert built.state.store.weights.dtype == torch.int8
    assert built.state.store.qscale.shape == (8,)
    assert args.index == "tree" and args.score_ttl == 9
