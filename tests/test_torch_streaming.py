"""The port's streaming data plane (``data/store.py``,
``data/streaming.py``) and gather modes against the JAX reference, and
streamed ≡ resident within the port.

Against the reference, exactly: the host store's layout and every row it
fetches, writes and appends; ``take_rows``' three modes and
``ArrayDataset.slice``; the window's chunk choice (top chunks by mass,
ties toward lower ids, evictions) and its hit/miss counts for the same
masses; the host replay of the scoring slice.  Within the port, bitwise:
a streamed run equals the resident run of the same seed in relaxed,
uniform, fused and async modes, and an async streamed run resumes from a
checkpoint as if it had not stopped.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import issgd as jissgd  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data.store import ChunkedExampleStore as JStore  # noqa: E402
from repro.data.streaming import StreamingDataPlane as JPlane  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core.async_pipeline import (AsyncPipeline,  # noqa: E402
                                             init_async_state,
                                             make_async_steps)
from repro_torch.core.importance import ISConfig  # noqa: E402
from repro_torch.core.scorer import make_mlp_scorer  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.store import ChunkedExampleStore  # noqa: E402
from repro_torch.data.streaming import (StreamedISSGD,  # noqa: E402
                                        StreamingDataPlane,
                                        host_score_slice,
                                        make_streamed_issgd,
                                        make_streamed_steps)
from repro_torch.data import make_svhn_like  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

N = 512


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _arrays(n=96, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 5)).astype(np.float32),
            "y": rng.integers(0, 9, size=(n,)).astype(np.int32)}


# ---------------------------------------------------------------------------
# host store and gathers against the reference
# ---------------------------------------------------------------------------

def test_store_matches_reference_row_for_row():
    arrays = _arrays()
    ref = JStore.from_arrays(arrays, chunk_size=16)
    got = ChunkedExampleStore.from_arrays(
        {k: torch.from_numpy(v) for k, v in arrays.items()}, chunk_size=16)
    assert (got.num_chunks, got.num_examples, got.keys) == \
        (ref.num_chunks, ref.num_examples, ref.keys)
    assert got.row_shape("x") == ref.row_shape("x") == (5,)
    assert got.nbytes() == ref.nbytes()
    for d in (1, 2, 3, 6):
        assert [got.shard_chunks(s, d) for s in range(d)] == \
            [ref.shard_chunks(s, d) for s in range(d)]
        assert np.array_equal(got.owner_shard(np.arange(6), d),
                              ref.owner_shard(np.arange(6), d))
    idx = np.random.default_rng(1).integers(0, 96, 40)
    for k in arrays:
        assert np.array_equal(_np(got.fetch_rows(idx)[k]),
                              ref.fetch_rows(idx)[k])
        assert np.array_equal(_np(got.stack_chunks([4, 1])[k]),
                              ref.stack_chunks([4, 1])[k])
    # growth and the ingest write path
    assert got.append_chunk() == ref.append_chunk() == 6
    extra = _arrays(16, seed=2)
    assert got.append_chunk({k: torch.from_numpy(v)
                             for k, v in extra.items()}) == \
        ref.append_chunk(extra) == 7
    rows = _arrays(5, seed=3)
    widx = np.asarray([3, 97, 100, 115, 120])
    got.write_rows(widx, rows)
    ref.write_rows(widx, rows)
    every = np.arange(ref.num_examples)
    for k in arrays:
        assert np.array_equal(_np(got.fetch_rows(every)[k]),
                              ref.fetch_rows(every)[k])
    assert [c for c, _ in got.iter_chunks(range(2, 4))] == [2, 3]
    with pytest.raises(IndexError, match="out of range"):
        got.fetch_rows(np.asarray([128]))
    with pytest.raises(ValueError, match="chunk keys"):
        got.append_chunk({"x": torch.zeros(16, 5)})
    with pytest.raises(ValueError, match="must divide"):
        ChunkedExampleStore.from_arrays(arrays, chunk_size=20)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8,
                                   "bfloat16"])
def test_take_rows_modes_match_reference(dtype):
    base = np.arange(24).reshape(6, 4)
    jarr = jnp.asarray(base).astype(jnp.bfloat16 if dtype == "bfloat16"
                                    else dtype)
    tarr = (torch.from_numpy(base).to(torch.bfloat16) if dtype == "bfloat16"
            else torch.from_numpy(base.astype(dtype)))
    inside = np.asarray([0, 5, 2, -1, -6, 3])
    outside = np.asarray([0, 6, -7, 100, -1, 5])
    for mode, idx in (("promise_in_bounds", inside), ("clip", outside),
                      ("fill", outside), ("fill", inside)):
        want = np.asarray(jpipeline.take_rows(jarr, jnp.asarray(idx),
                                              mode=mode).astype(jnp.float32))
        got = _np(pipeline.take_rows(tarr, torch.from_numpy(idx),
                                     mode=mode).float())
        np.testing.assert_array_equal(got, want, err_msg=mode)
    with pytest.raises(ValueError, match="mode"):
        pipeline.take_rows(tarr, torch.from_numpy(inside), mode="wrap")


def test_dataset_batch_and_slice_match_reference():
    arrays = _arrays(10)
    jd = jpipeline.ArrayDataset({k: jnp.asarray(v) for k, v in arrays.items()})
    td = pipeline.ArrayDataset({k: torch.from_numpy(v)
                                for k, v in arrays.items()})
    idx = np.asarray([9, 0, 12, -2])
    for mode in ("clip", "fill"):
        for k in arrays:
            np.testing.assert_array_equal(
                _np(td.batch(torch.from_numpy(idx), mode=mode)[k]),
                np.asarray(jd.batch(jnp.asarray(idx), mode=mode)[k]))
    for start, count in ((0, 4), (8, 4), (-3, 4), (-20, 3), (3, 10)):
        for k in arrays:
            np.testing.assert_array_equal(
                _np(td.slice(start, count)[k]),
                np.asarray(jd.slice(start, count)[k]), err_msg=(start, count))


def test_window_choice_and_gathers_match_reference():
    """The same masses through both planes: the same windows (cold start,
    top chunks by mass, ties toward lower ids, evictions), the same hit
    and miss counts, the same rows."""
    n, cs = 256, 32
    arrays = {"x": np.arange(n, dtype=np.float32)[:, None]}
    ref = JPlane(JStore.from_arrays(arrays, cs), window_chunks=3)
    got = StreamingDataPlane(ChunkedExampleStore.from_arrays(arrays, cs), 3,
                             device="cpu")
    rng = np.random.default_rng(4)
    masses = [np.zeros(8), np.eye(8)[6] * 3 + np.eye(8)[2], np.ones(8),
              rng.random(8), rng.random(8), rng.integers(0, 3, 8) * 1.0]
    for mass in masses:
        assert got.prefetch(mass) == ref.prefetch(mass)
        idx = rng.integers(0, n, 24)
        np.testing.assert_array_equal(_np(got.gather_global(idx)["x"]),
                                      np.asarray(ref.gather_global(idx)["x"]))
        assert got.swap_window() == ref.swap_window()
        np.testing.assert_array_equal(got.window_ids, ref.window_ids)
        assert got.stats == ref.stats
        np.testing.assert_array_equal(_np(got.gather_global(idx)["x"]),
                                      np.asarray(ref.gather_global(idx)["x"]))
    assert got.stats.hits > 0 and got.stats.misses > 0
    with pytest.raises(ValueError, match="window_chunks"):
        StreamingDataPlane(ChunkedExampleStore.from_arrays(arrays, cs), 9,
                           device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        StreamingDataPlane(ChunkedExampleStore.from_arrays(arrays, cs), 2,
                           device="cpu", mesh=object())


def test_window_is_a_snapshot_as_in_the_reference():
    """Reference caveat: a row written on the host after the window that
    holds its chunk was built is served stale to the master's gather (a
    hit reads the device window) until a prefetch rebuilds that window;
    the host path (the scoring stream, a miss) reads it fresh.  Both
    packages do the same."""
    arrays = {"x": np.arange(64, dtype=np.float32)[:, None]}
    new = {"x": np.full((1, 1), -5.0, np.float32)}
    planes = (JPlane(JStore.from_arrays(arrays, 16), window_chunks=4),
              StreamingDataPlane(ChunkedExampleStore.from_arrays(arrays, 16),
                                 4, device="cpu"))
    for plane in planes:
        plane.store.write_rows(np.asarray([20]), new)
        hit = _np(plane.gather_global(np.asarray([20]))["x"]).item()
        streamed = _np(plane.fetch_sharded(np.asarray([[20]]))["x"]).item()
        assert (hit, streamed) == (20.0, -5.0)
        # every chunk resident: no prefetch rebuilds the window
        assert not plane.prefetch(np.arange(4.0))


def test_rebuild_serves_rows_written_since_the_last_build():
    """A rebuild serves every chunk as the host holds it: row 5 (chunk 0,
    resident before and after) written after the window was built is
    served fresh once a prefetch moves the window from chunks 0,1 to
    0,2, as the reference's ``prefetch`` stacks every chunk from the
    host."""
    arrays = {"x": np.arange(64, dtype=np.float32)[:, None]}
    new = {"x": np.full((1, 1), -5.0, np.float32)}
    planes = (JPlane(JStore.from_arrays(arrays, 16), window_chunks=2),
              StreamingDataPlane(ChunkedExampleStore.from_arrays(arrays, 16),
                                 2, device="cpu"))
    got = []
    for plane in planes:
        plane.store.write_rows(np.asarray([5]), new)
        assert plane.prefetch(np.asarray([3.0, 0.0, 2.0, 0.0], np.float32))
        plane.swap_window()
        np.testing.assert_array_equal(plane.window_ids, [[0, 2]])
        before = plane.stats.hits
        got.append(_np(plane.gather_global(np.asarray([5, 37]))["x"])
                   .reshape(-1).tolist())
        assert plane.stats.hits - before == 2
    assert got[0] == got[1] == [-5.0, 37.0]


def test_grown_rows_route_through_the_host():
    arrays = {"x": np.random.default_rng(1).normal(size=(64, 4))
              .astype(np.float32)}
    store = ChunkedExampleStore.from_arrays(arrays, 16)
    plane = StreamingDataPlane(store, 2, device="cpu")
    store.append_chunk()
    want = np.full((1, 4), 7.0, np.float32)
    store.write_rows(np.asarray([70]), {"x": want})
    got = plane.gather_global(np.asarray([70, 0]))["x"]
    np.testing.assert_array_equal(_np(got[0]), want[0])
    np.testing.assert_array_equal(_np(got[1]), arrays["x"][0])
    assert plane.prefetch(np.asarray([0, 0, 1, 2], np.float32))
    plane.swap_window()
    np.testing.assert_array_equal(plane.window_ids, [[2, 3]])


def test_host_score_slice_replays_the_device_schedule():
    cfg = issgd.ISSGDConfig(score_batch_size=48, score_shards=4)
    jcfg = jissgd.ISSGDConfig(score_batch_size=48, score_shards=4)
    layout = issgd.scoring_layout(cfg, N)
    assert layout == jissgd.scoring_layout(jcfg, N, 1) == (4, 128, 12)
    for t in (0, 1, 7, 30):
        np.testing.assert_array_equal(
            host_score_slice(t, *layout),
            _np(issgd._score_slice(t, 4, 128, 12, "cpu")))
    # a rank of two scores half the shards, as the reference lays it out
    assert issgd.scoring_layout(cfg, N, 2) == \
        jissgd.scoring_layout(jcfg, N, 2) == (2, 128, 12)


# ---------------------------------------------------------------------------
# streamed ≡ resident within the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp():
    tcfg = tmlp.MLPConfig(input_dim=16, hidden=(32,), num_classes=4)
    train, _ = make_svhn_like(torch.Generator().manual_seed(0), n=N, dim=16,
                              classes=4)
    params = tmlp.init_mlp_classifier(torch.Generator().manual_seed(1), tcfg,
                                      "cpu")
    return tcfg, train.arrays, params


def _parts(tcfg, mode="relaxed"):
    cfg = issgd.ISSGDConfig(batch_size=16, score_batch_size=64, mode=mode,
                            is_cfg=ISConfig(smoothing=0.1), score_shards=4)
    pel = lambda p, b: tmlp.per_example_loss(p, b, tcfg)
    fused = lambda p, b: tmlp.per_example_loss_and_score(p, b, tcfg)
    return cfg, pel, make_mlp_scorer(tcfg, "ghost"), sgd(0.05), fused


def _same_state(a, b):
    for k in a.params:
        for j in a.params[k]:
            assert torch.equal(a.params[k][j], b.params[k][j]), (k, j)
    bufs = (("read_buf", "write_buf") if hasattr(a.store, "read_buf")
            else (None,))
    for buf in bufs:
        sa = getattr(a.store, buf) if buf else a.store
        sb = getattr(b.store, buf) if buf else b.store
        assert torch.equal(sa.weights, sb.weights), buf
        assert torch.equal(sa.scored_at, sb.scored_at), buf
    assert a.step == b.step


@pytest.mark.parametrize("mode,swap_every", [
    ("relaxed", 0), ("uniform", 0), ("fused", 0), ("relaxed", 1),
    ("relaxed", 3)])
def test_streamed_equals_resident(mlp, mode, swap_every):
    """Same draws, losses, traces, params, store and publishes, bitwise;
    swap_every 0 is the sync composition, else async with that cadence."""
    tcfg, data, params = mlp
    cfg, pel, scorer, opt, fused = _parts(tcfg, mode)
    fs = fused if mode == "fused" else None
    async_mode = swap_every > 0
    pipe = None
    if async_mode:
        pipe = AsyncPipeline(*make_async_steps(pel, scorer, opt, cfg, N),
                             swap_every)
        resident = pipe.step
        st_r = init_async_state(params, opt, N, "cpu", seed=5)
        st_s = init_async_state(params, opt, N, "cpu", seed=5)
    else:
        resident = issgd.make_train_step(pel, scorer, opt, cfg, N,
                                         fused_score=fs)
        st_r = issgd.init_train_state(params, opt, N, "cpu", seed=5)
        st_s = issgd.init_train_state(params, opt, N, "cpu", seed=5)
    probe = issgd.make_score_step(scorer, cfg, N) if fs else None
    drv = make_streamed_issgd(pel, scorer, opt, cfg, data, chunk_size=64,
                              window_chunks=3, device="cpu", fused_score=fs,
                              async_mode=async_mode,
                              swap_every=max(swap_every, 1))
    for t in range(8):
        st_r, mr = resident(st_r, data)
        st_s, ms = drv.step(st_s)
        assert torch.equal(mr.sample_indices, ms.sample_indices), t
        for f in ("loss", "trace_stale", "grad_norm", "ess_frac"):
            assert torch.equal(getattr(mr, f), getattr(ms, f)), (t, f)
        if probe is not None and t % 3 == 0:
            st_r = probe(st_r, data)
            st_s = drv.probe(st_s)
    _same_state(st_r, st_s)
    assert torch.equal(st_r.rng.get_state(), st_s.rng.get_state())
    assert drv.swaps == (pipe.swaps if pipe else 0)
    s = drv.plane.stats
    assert s.hits > 0 and s.misses > 0 and s.prefetches == 8
    if mode != "fused":
        assert s.streamed_rows == 8 * 64


def test_streamed_async_checkpoint_resume_bitwise(mlp, tmp_path):
    """Save an async streamed run at step 5, restore into a fresh driver
    (cold window), continue: the uninterrupted run's params, buffers,
    stamps and generator, bitwise."""
    tcfg, data, params = mlp
    cfg, pel, scorer, opt, _ = _parts(tcfg)
    K, T, T0 = 2, 10, 5

    def fresh():
        return make_streamed_issgd(pel, scorer, opt, cfg, data,
                                   chunk_size=64, window_chunks=3,
                                   device="cpu", async_mode=True,
                                   swap_every=K)

    drv, st = fresh(), init_async_state(params, opt, N, "cpu")
    for t in range(T):
        if t == T0:
            save_checkpoint(tmp_path / "mid.npz", st, step=t)
        st, _ = drv.step(st)
    st2, step0 = restore_checkpoint(
        tmp_path / "mid.npz", init_async_state(params, opt, N, "cpu",
                                               seed=99))
    assert step0 == T0 == st2.step
    drv2 = fresh()
    for _ in range(T0, T):
        st2, _ = drv2.step(st2)
    _same_state(st, st2)
    assert st.store.synced_at == st2.store.synced_at == 9
    assert torch.equal(st.rng.get_state(), st2.rng.get_state())


def test_streamed_steps_refuse_what_the_reference_refuses(mlp):
    tcfg = mlp[0]
    cfg, pel, scorer, opt, fused = _parts(tcfg)
    with pytest.raises(ValueError, match="exact"):
        make_streamed_steps(pel, scorer, opt,
                            dataclasses.replace(cfg, mode="exact"), N, 64)
    with pytest.raises(ValueError, match="async"):
        make_streamed_steps(pel, scorer, opt,
                            dataclasses.replace(cfg, mode="fused"), N, 64,
                            fused_score=fused, async_mode=True)
    with pytest.raises(ValueError, match="chunk_size"):
        make_streamed_steps(pel, scorer, opt, cfg, N, 100)
    master = issgd.make_master_pass(pel, opt, cfg, N, streaming=True)
    st = issgd.init_train_state(mlp[2], opt, N, "cpu")
    with pytest.raises(ValueError, match="sample_indices"):
        master(st.params, st.opt_state, st.stale_params, st.store, 0,
               st.rng, {})


def test_quickstart_stream_half_on_cpu():
    """``examples/torch_quickstart.py --stream`` prints the resident run's
    losses and monitors, then its window's statistics."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    outs = []
    for extra in ([], ["--stream"]):
        proc = subprocess.run(
            [sys.executable, str(root / "examples" / "torch_quickstart.py"),
             "--device", "cpu", "--steps", "51", *extra],
            capture_output=True, text=True, timeout=300,
            env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
                 "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout.splitlines())
    assert outs[1][:-1] == outs[0] and len(outs[0]) == 3
    assert outs[1][-1].startswith("streaming: window hit rate")


@pytest.mark.parametrize("async_mode", [False, True])
def test_streamed_gated_with_monitors_equals_resident(mlp, async_mode):
    """The controller's gate reaches the sample and the master step alike
    (a closed gate draws uniformly, an open one by the proposal), and the
    monitors are the resident step's, bitwise."""
    from repro_torch.telemetry import MonitorSet
    tcfg, data, params = mlp
    cfg, pel, scorer, opt, _ = _parts(tcfg)
    gates = [False, False, True, True, False, True]

    class Schedule:
        t = 0

        def gate(self):
            return gates[self.t]

    ctl, mons = Schedule(), MonitorSet.all()
    if async_mode:
        resident = AsyncPipeline(*make_async_steps(
            pel, scorer, opt, cfg, N, monitors=mons, gated=True), 2,
            controller=ctl)
        st_r = init_async_state(params, opt, N, "cpu", seed=2)
        st_s = init_async_state(params, opt, N, "cpu", seed=2)
    else:
        step = issgd.make_train_step(pel, scorer, opt, cfg, N,
                                     monitors=mons, gated=True)
        st_r = issgd.init_train_state(params, opt, N, "cpu", seed=2)
        st_s = issgd.init_train_state(params, opt, N, "cpu", seed=2)
    steps = make_streamed_steps(pel, scorer, opt, cfg, N, 64,
                                async_mode=async_mode, monitors=mons,
                                gated=True)
    drv = StreamedISSGD(
        StreamingDataPlane(ChunkedExampleStore.from_arrays(data, 64), 3,
                           device="cpu"),
        *steps, cfg, N, async_mode=async_mode, swap_every=2, controller=ctl)
    for t in range(len(gates)):
        ctl.t = t
        if async_mode:
            st_r, mr = resident.step(st_r, data)
            mon_r = resident.last_monitors
        else:
            st_r, mr, mon_r = step(st_r, data, gates[t])
        st_s, ms = drv.step(st_s)
        assert torch.equal(mr.sample_indices, ms.sample_indices), t
        assert torch.equal(mr.loss, ms.loss), t
        assert mon_r.keys() == drv.last_monitors.keys()
        assert all(torch.equal(mon_r[k], drv.last_monitors[k])
                   for k in mon_r), t
    _same_state(st_r, st_s)
