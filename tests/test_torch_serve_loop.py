"""The port's train/serve loop (``serving/loop.py``), the reserved-row
discipline of the WeightStore, the batcher's hooks and the launcher's
async, streamed and serve-loop paths, against the single-device JAX
reference (its mesh serve loop is red there: the port's is held to the
reference's single-device engine in ``tests/test_torch_mesh_serving.py``).

Against the reference, exactly: ``reserve_tail``/``mark_live`` and the
inert reserved rows under a scoring pass; ``TrafficIngest``'s watermark,
padding, labels, truncation and capacity for the same finished requests;
the synthetic traffic's prompts; the closed loop run beside the
reference's on the same data, params, traffic and draws (its schedule,
the ingested token rows and ``scored_at`` over the reserved tail; the
losses and the proposal at f32 rtol 1e-5).  Within the port: the loop
closes (traffic → ingest → live rows → scored, with proposal mass), and
the launcher's streamed and async runs equal its resident run bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import weight_store as jws  # noqa: E402
from repro.data.store import ChunkedExampleStore as JStore  # noqa: E402
from repro.serving import TrafficIngest as JIngest  # noqa: E402
from repro.serving import make_synthetic_traffic as j_traffic  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.core.importance import ISConfig  # noqa: E402
from repro_torch.core.issgd import (ISSGDConfig, init_train_state,  # noqa
                                    make_scoring_pass)
from repro_torch.core.scorer import make_lm_scorer, make_mlp_scorer  # noqa
from repro_torch.data import make_svhn_like  # noqa: E402
from repro_torch.data.store import ChunkedExampleStore  # noqa: E402
from repro_torch.data.streaming import (StreamedISSGD,  # noqa: E402
                                        StreamingDataPlane,
                                        make_streamed_steps)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, Request,  # noqa: E402
                                 ServeLoop, TrafficIngest,
                                 make_synthetic_traffic)
from _torch_threads import one_torch_thread  # noqa: E402,F401


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# reserved rows
# ---------------------------------------------------------------------------

def test_reserve_and_mark_live_match_reference():
    sa = np.random.default_rng(0).integers(-1, 9, 40).astype(np.int32)
    w = np.random.default_rng(1).random(40).astype(np.float32)
    jstore = jws.reserve_tail(jws.WeightStore(jnp.asarray(w),
                                              jnp.asarray(sa)), 31)
    tstore = ws.reserve_tail(ws.WeightStore(torch.from_numpy(w),
                                            torch.from_numpy(sa)), 31)
    np.testing.assert_array_equal(_np(tstore.scored_at),
                                  np.asarray(jstore.scored_at))
    idx = np.asarray([33, 31, 39])
    jstore = jws.mark_live(jstore, jnp.asarray(idx))
    tstore = ws.mark_live(tstore, idx)
    np.testing.assert_array_equal(_np(tstore.scored_at),
                                  np.asarray(jstore.scored_at))
    jb = jws.mark_live_buffered(jws.to_buffered(jstore), jnp.asarray([32]))
    tb = ws.mark_live_buffered(ws.to_buffered(tstore), [32])
    for buf in ("read_buf", "write_buf"):
        np.testing.assert_array_equal(
            _np(getattr(tb, buf).scored_at),
            np.asarray(getattr(jb, buf).scored_at))


def test_reserved_rows_inert_until_marked_live():
    cfg = tmlp.MLPConfig(input_dim=16, hidden=(32,), num_classes=4)
    train, _ = make_svhn_like(torch.Generator().manual_seed(0), n=64, dim=16,
                              classes=4)
    params = tmlp.init_mlp_classifier(torch.Generator().manual_seed(1), cfg,
                                      "cpu")
    tcfg = ISSGDConfig(batch_size=8, score_batch_size=32, mode="relaxed",
                       is_cfg=ISConfig(smoothing=0.1))
    scoring = make_scoring_pass(make_mlp_scorer(cfg, "ghost"), tcfg, 64)
    store = ws.reserve_tail(ws.init_store(64, "cpu"), 48)
    assert (_np(store.scored_at[48:]) == ws.EMPTY).all()
    for t in range(4):            # two full round-robin sweeps
        store, fresh, _ = scoring(params, store, t, train.arrays)
    sa = _np(store.scored_at)
    assert (sa[:48] >= 0).all() and (sa[48:] == ws.EMPTY).all()
    q = _np(ws.read_proposal(store, 4, tcfg.is_cfg))
    assert (q[:48] > 0).all() and (q[48:] == 0).all()
    store = ws.mark_live(store, torch.tensor([48, 49]))
    assert _np(store.scored_at)[48] == -1
    for t in range(4, 8):
        store, _, _ = scoring(params, store, t, train.arrays)
    sa = _np(store.scored_at)
    assert sa[48] >= 0 and sa[49] >= 0 and (sa[50:] == ws.EMPTY).all()
    q = _np(ws.read_proposal(store, 8, tcfg.is_cfg))
    assert q[48] > 0 and q[49] > 0 and (q[50:] == 0).all()


# ---------------------------------------------------------------------------
# traffic ingest and the batcher's hooks
# ---------------------------------------------------------------------------

def test_traffic_ingest_matches_reference():
    """Watermark, zero padding, truncation, next-token labels and the
    capacity's drops, for the same finished requests."""
    base = {"tokens": np.arange(320, dtype=np.int32).reshape(32, 10),
            "labels": np.ones((32, 10), np.int32),
            "w": np.ones((32, 2), np.float32)}
    stores = [JStore.from_arrays(base, 8), ChunkedExampleStore.from_arrays(
        {k: torch.from_numpy(v) for k, v in base.items()}, 8)]
    ingests = []
    for st in stores:
        st.append_chunk()
        ingests.append((JIngest if isinstance(st, JStore) else TrafficIngest)(
            st, seq_len=10, start_row=32, capacity_rows=5,
            label_key="labels"))
    batches = [[(np.asarray([5, 6, 7]), [8, 9])],
               [(np.arange(8), list(range(8)))],
               [(np.asarray([1]), [2])] * 5, []]
    for batch in batches:
        got = []
        for ing in ingests:
            for prompt, gen in batch:
                ing.add(prompt, gen)
            got.append(_np(ing.flush()))
        np.testing.assert_array_equal(got[1], got[0])
    assert [(i.ingested, i.dropped) for i in ingests] == [(5, 2)] * 2
    every = np.arange(40)
    for k in base:
        np.testing.assert_array_equal(_np(stores[1].fetch_rows(every)[k]),
                                      stores[0].fetch_rows(every)[k])


@pytest.mark.parametrize("world", [2, 5])
def test_sharded_ingest_writes_each_ranks_rows(world):
    """The reserved chunks laid out before the split (``reserve_chunks``):
    each rank's store writes the served rows of its chunks, and together
    the ranks hold the reference's whole store after the same ingest;
    ``local_rows`` maps them into each rank's rows."""
    base = {"tokens": np.arange(320, dtype=np.int32).reshape(32, 10)}
    ref = JStore.from_arrays(base, 4)
    ref.append_chunk()
    ref.append_chunk()
    ring = JIngest(ref, seq_len=10, start_row=32, capacity_rows=8)
    ranks = [ChunkedExampleStore.from_arrays(
        {"tokens": torch.from_numpy(base["tokens"])}, 4, shard=(r, world),
        reserve_chunks=2) for r in range(world)]
    ings = [TrafficIngest(st, seq_len=10, start_row=32, capacity_rows=8)
            for st in ranks]
    for prompt, gen in [(np.asarray([5, 6]), [7]), (np.arange(4), [1, 2]),
                        (np.asarray([9]), [3, 4, 5])]:
        for ing in [ring] + ings:
            ing.add(prompt, gen)
    want = ring.flush()
    per = 40 // world
    for r, (st, ing) in enumerate(zip(ranks, ings)):
        idx = _np(ing.flush())
        np.testing.assert_array_equal(idx, want)
        np.testing.assert_array_equal(
            ing.local_rows(idx), want[(want >= r * per)
                                      & (want < (r + 1) * per)] - r * per)
        held = np.arange(r * per, (r + 1) * per)
        np.testing.assert_array_equal(_np(st.fetch_rows(held)["tokens"]),
                                      ref.fetch_rows(held)["tokens"])
    with pytest.raises(ValueError, match="reserve chunks before"):
        ranks[0].append_chunk()


def test_synthetic_traffic_matches_reference():
    mine = make_synthetic_traffic(512, 6, rate=2, max_new_tokens=3, seed=7)
    ref = j_traffic(512, 6, rate=2, max_new_tokens=3, seed=7)
    for tick in range(3):
        a, b = mine(tick), ref(tick)
        assert [r.uid for r in a] == [r.uid for r in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.prompt, y.prompt)
            assert x.max_new_tokens == y.max_new_tokens == 3


def test_batcher_sample_and_drain_completed():
    cfg = get_smoke_config("glm4-9b")
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          cfg, "cpu")
    picks = []

    def last_token(logits):
        picks.append(logits.shape)
        return torch.full(logits.shape[:-1], cfg.vocab_size - 1)

    b = ContinuousBatcher(params, cfg, num_slots=2, max_len=16,
                          sample=last_token)
    reqs = [Request(uid=i, prompt=np.arange(3 + i, dtype=np.int32),
                    max_new_tokens=2 + i) for i in range(3)]
    b.run(reqs)
    done = b.drain_completed()
    assert [r.uid for r, _ in done] == [0, 1, 2]     # the order they ended
    assert all(g == [cfg.vocab_size - 1] * r.max_new_tokens
               for r, g in done)
    assert b.drain_completed() == [] and len(b.finished) == 3 and picks


# ---------------------------------------------------------------------------
# the loop closes
# ---------------------------------------------------------------------------

LOOP_STEPS = 16


def _ref_loop():
    """The reference's single-device loop, as ``tests/test_serving_loop.py``'s
    fixture builds it: 64 live rows of 17 tokens in chunks of 8, 2 reserved
    chunks, window 2, 2 slots, prompts of 4, 4 new tokens."""
    from repro.configs import get_smoke_config as j_smoke
    from repro.core.issgd import ISSGDConfig as JISSGDConfig
    from repro.core.issgd import init_train_state as j_init_state
    from repro.core.importance import ISConfig as JISConfig
    from repro.core.scorer import make_lm_scorer as j_lm_scorer
    from repro.data import make_token_dataset as j_tokens
    from repro.data.streaming import StreamedISSGD as JStreamed
    from repro.data.streaming import StreamingDataPlane as JPlane
    from repro.data.streaming import make_streamed_steps as j_steps
    from repro.models.transformer import init_transformer as j_init
    from repro.models.transformer import per_example_loss as j_pel
    from repro.optim import sgd as j_sgd
    from repro.serving import ContinuousBatcher as JBatcher
    from repro.serving import ServeLoop as JServeLoop

    cfg = j_smoke("glm4-9b")
    train = j_tokens(jax.random.key(0), n=64, seq=17, vocab=cfg.vocab_size)
    store = JStore.from_arrays(train.arrays, chunk_size=8)
    n_live = store.num_examples
    store.append_chunk()
    store.append_chunk()
    n = store.num_examples
    params = j_init(jax.random.key(1), cfg)
    opt = j_sgd(0.05)
    tcfg = JISSGDConfig(batch_size=4, score_batch_size=16, mode="relaxed",
                        is_cfg=JISConfig(smoothing=0.1))
    steps = j_steps(lambda p, b: j_pel(p, cfg, b)[0],
                    j_lm_scorer(cfg, "loss"), opt, tcfg, n, 8)
    pipe = JStreamed(JPlane(store, window_chunks=2), *steps, tcfg, n)
    state = j_init_state(params, opt, n)._replace(
        store=jws.reserve_tail(jws.init_store(n), n_live))
    serve = JServeLoop(
        JBatcher(params, cfg, num_slots=2, max_len=8),
        JIngest(store, seq_len=17, start_row=n_live,
                capacity_rows=n - n_live),
        j_traffic(cfg.vocab_size, prompt_len=4, rate=1, max_new_tokens=4,
                  seed=3))
    pipe.serve_tick = serve.on_train_step
    return tcfg, store, pipe, state, serve, train.arrays, params


def _loop(arrays, jparams, draws):
    """The launcher's --serve-loop wiring by hand, at the reference
    fixture's sizes, on the reference's data and params.  The sample step
    hands the master ``draws[0]`` (the reference's draw of the step) in
    place of its own, so that both loops train on the same rows."""
    cfg = get_smoke_config("glm4-9b")
    store = ChunkedExampleStore.from_arrays(
        {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()},
        chunk_size=8)
    n_live = store.num_examples
    store.append_chunk()
    store.append_chunk()
    n = store.num_examples
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    opt = sgd(0.05)
    tcfg = ISSGDConfig(batch_size=4, score_batch_size=16, mode="relaxed",
                       is_cfg=ISConfig(smoothing=0.1))
    pel = lambda p, b: transformer.per_example_loss(p, cfg, b)[0]
    scoring, sample, master = make_streamed_steps(
        pel, make_lm_scorer(cfg, "loss"), opt, tcfg, n, 8)

    def injected(store, step, generator):
        idx, mass = sample(store, step, generator)
        return draws[0].to(idx.dtype).reshape(idx.shape), mass

    pipe = StreamedISSGD(StreamingDataPlane(store, 2, device="cpu"),
                         scoring, injected, master, tcfg, n)
    state = init_train_state(params, opt, n, "cpu")._replace(
        store=ws.reserve_tail(ws.init_store(n, "cpu"), n_live))
    serve = ServeLoop(
        ContinuousBatcher(params, cfg, num_slots=2, max_len=8),
        TrafficIngest(store, seq_len=17, start_row=n_live,
                      capacity_rows=n - n_live),
        make_synthetic_traffic(cfg.vocab_size, prompt_len=4, rate=1,
                               max_new_tokens=4, seed=3))
    pipe.serve_tick = serve.on_train_step
    return tcfg, store, pipe, state, serve, n_live, n


def test_serve_loop_closes_single_device():
    """The port's loop and the reference's, run side by side for 16 steps
    on the same data, params, traffic and draws: the same losses, the
    same schedule (requests finished, rows ingested, publishes, requests
    waiting), the same ingested token rows, and the same ``scored_at``
    and proposal over the reserved tail.  A served row lands in the
    store verbatim, is scored and carries proposal mass; untouched
    reserved rows stay inert."""
    from repro.core.weight_store import read_proposal as j_read_proposal
    jtcfg, jstore, jpipe, jstate, jserve, arrays, jparams = _ref_loop()
    draws = [None]
    tcfg, store, pipe, state, serve, n_live, n = _loop(arrays, jparams,
                                                       draws)
    prompts, gens, order = {}, {}, []
    inner, drain = serve.traffic, serve.batcher.drain_completed

    def recording_traffic(tick):
        reqs = inner(tick)
        prompts.update({r.uid: np.asarray(r.prompt) for r in reqs})
        return reqs

    def recording_drain():
        done = drain()
        for req, g in done:
            gens[req.uid] = list(g)
            order.append(req.uid)
        return done

    serve.traffic, serve.batcher.drain_completed = (recording_traffic,
                                                    recording_drain)
    for t in range(LOOP_STEPS):
        jstate, jmet = jpipe.step(jstate)
        jstate = jserve.ingest_into(jstate)
        draws[0] = torch.from_numpy(np.array(jmet.sample_indices))
        state, met = pipe.step(state)
        state = serve.ingest_into(state)
        np.testing.assert_allclose(_np(met.loss), np.asarray(jmet.loss),
                                   rtol=1e-5, atol=1e-6, err_msg=str(t))
    ingested = serve.ingest.ingested
    assert 1 <= ingested < n - n_live and serve.ingest.dropped == 0
    assert (serve.finished, ingested, serve.publishes, len(serve.pending),
            serve.ingest.dropped) == (
        jserve.finished, jserve.ingest.ingested, jserve.publishes,
        len(jserve.pending), jserve.ingest.dropped)
    tail = np.arange(n_live, n)
    np.testing.assert_array_equal(
        _np(store.fetch_rows(tail)["tokens"]),
        jstore.fetch_rows(tail)["tokens"])
    for j, uid in enumerate(order[:3]):
        toks = np.concatenate([prompts[uid], gens[uid]])
        row = _np(store.fetch_rows(np.asarray([n_live + j]))["tokens"][0])
        np.testing.assert_array_equal(row[:toks.size], toks)
        assert not row[toks.size:].any()
    sa = _np(state.store.scored_at)
    q = _np(ws.read_proposal(state.store, state.step, tcfg.is_cfg))
    np.testing.assert_array_equal(
        sa[n_live:], np.asarray(jstate.store.scored_at)[n_live:])
    np.testing.assert_allclose(
        q[n_live:], np.asarray(j_read_proposal(
            jstate.store, jstate.step, jtcfg.is_cfg))[n_live:],
        rtol=1e-5, atol=1e-6)
    assert sa[n_live] >= 0, "served row never scored"
    assert q[n_live] > 0, "served row carries no proposal mass"
    assert sa[n - 1] == ws.EMPTY and q[n - 1] == 0, "reserve leaked"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_MLP = ["--smoke", "--steps", "6", "--examples", "512", "--batch", "16",
        "--score-batch", "64", "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["--stream", "--chunk-size", "64", "--window-chunks", "2"],
    ["--stream", "--prefetch-every", "2"],
    ["--async-scoring", "--swap-every", "2", "--no-trace-monitors"],
    ["--stream", "--async-scoring", "--swap-every", "2"],
])
def test_launcher_async_and_streamed_paths(extra, capsys):
    """The launcher's streamed runs equal its resident run bitwise (losses
    and params), and its async streamed run its async resident one."""
    resident = ttrain.run(ttrain.parse_args(
        _MLP + (["--async-scoring", "--swap-every", "2"]
                if "--async-scoring" in extra else [])))
    got = ttrain.run(ttrain.parse_args(_MLP + extra))
    assert [r["loss"] for r in got.history] == \
        [r["loss"] for r in resident.history]
    for k in got.state.params:
        for j in got.state.params[k]:
            assert torch.equal(got.state.params[k][j],
                               resident.state.params[k][j])
    out = capsys.readouterr().out
    if "--stream" in extra:
        assert "streaming: 8 chunks x 64 rows host-resident" in out
        assert "streaming stats: window hit rate" in out
        assert all("stream_hit_rate" in r for r in got.history)
    if "--no-trace-monitors" in extra:
        assert np.isnan(got.history[-1]["trace_stale"])


def test_launcher_serve_loop_and_adaptive_swap(tmp_path, capsys):
    """--serve-loop on an LM ingests served rows; --adaptive-is with
    --async-scoring lets the controller set the swap cadence."""
    res = ttrain.run(ttrain.parse_args([
        "--arch", "glm4-9b", "--smoke", "--device", "cpu", "--steps", "8",
        "--examples", "128", "--seq", "16", "--batch", "8", "--score-batch",
        "32", "--stream", "--async-scoring", "--swap-every", "2",
        "--serve-loop", "--serve-slots", "2", "--serve-max-new", "2",
        "--log-every", "4", "--metrics-jsonl", str(tmp_path / "r.jsonl")]))
    out = capsys.readouterr().out
    assert "serve-loop: 2 slots, max_len 6, 32 reserved rows" in out
    assert res.built.serve.ingest.ingested > 0
    assert res.history[-1]["served_rows"] == res.built.serve.ingest.ingested
    assert res.state.store.write_buf.scored_at.shape == (160,)
    res = ttrain.run(ttrain.parse_args(
        ["--smoke", "--steps", "20", "--examples", "512", "--device", "cpu",
                    "--log-every", "5", "--async-scoring", "--swap-every",
                    "3", "--adaptive-is", "--adapt-every", "10"]))
    assert len(res.decisions) == 2
    assert res.built.pipe.swap_every == res.decisions[-1].swap_every
    assert "swap_every=" in capsys.readouterr().out


@pytest.mark.parametrize("argv,match", [
    (["--async-scoring", "--mode", "fused"], "--async-scoring requires"),
    (["--async-scoring", "--mode", "exact"], "--async-scoring requires"),
    (["--stream", "--mode", "exact"], "--stream does not support"),
    (["--serve-loop", "--arch", "glm4-9b"], "--serve-loop requires --stream"),
    (["--serve-loop", "--stream"], "needs a token arch"),
    (["--serve-loop", "--stream", "--arch", "glm4-9b", "--mode", "uniform"],
     "--serve-loop requires --mode relaxed|fused"),
    (["--stream", "--table-dtype", "int8", "--index-chunk-size", "64"],
     "does not compose with --stream"),
    (["--async-scoring", "--swap-every", "0"], "must be >= 1"),
    (["--arch", "falcon-mamba-7b", "--model-parallel", "3"],
     "does not divide d_inner"),
])
def test_launcher_refuses_bad_combinations(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("flag,value", [
    ("--async-scoring", None), ("--swap-every", "3"),
    ("--no-trace-monitors", None), ("--stream", None), ("--chunk-size", "8"),
    ("--window-chunks", "3"), ("--prefetch-every", "2"),
    ("--serve-slots", "3"), ("--serve-prompt-len", "5"),
    ("--serve-max-new", "6"), ("--serve-rate", "2"), ("--serve-every", "2"),
    ("--serve-publish-every", "2"), ("--serve-decode-steps", "3"),
    ("--serve-reserve-chunks", "1")])
def test_slice_flags_left_later_flags(flag, value):
    assert flag not in ttrain.LATER_FLAGS
    args = ttrain.parse_args([flag] + ([value] if value else [])
                             + ["--device", "cpu"])
    got = getattr(args, flag[2:].replace("-", "_"))
    assert got == (True if value is None else int(value))
