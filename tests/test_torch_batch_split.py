"""The batch-split master (``split_batch``, the reference's
``make_train_step(..., constrain_batch=)``) on gloo worlds of 1, 2 and 3
data ranks and a (2, 2) (data, model) world, against world 1 and
against the reference's single-device MoE layer.

Each world is spawned once for the module (``_torch_batch_split_rank.py``,
one process a rank) and runs every case through ``launch/train.py``'s
``run`` with the sharded step factories building the split master; the
tests below compare what the ranks saved.  With the split off, or with a
data world of one rank, a step is the unsplit step bitwise.  Split
worlds of 2 and 3 ranks (B = 8 over 3 ranks: blocks of 3, 3 and 2 rows)
are world 1 within f32 rtol 1e-5 / atol 1e-6 in every step's loss and
grad norm and in the final params, with the same draws (no refresh of
the stale params within the run), for the sync, async, streamed and
fused mlp_svhn trainers and for a glm4-9b smoke step at
``--model-parallel 2`` on 2 data ranks; two split runs are bitwise
equal.  An MoE layer under a split routes as the whole batch: on fixed
router logits the capacity, each replica's position and the dropped set
are world 1's exactly, and the dbrx smoke layer in f32 is the
reference's ``moe`` at the global token count (its capacity, its drops)
within rtol 1e-5.  The dry run's train step gives rank 0 its block of
the minibatch.
"""
import dataclasses
import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _helpers import REPO  # noqa: E402
from _torch_batch_split_rank import MLP_CASES  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import async_pipeline, distributed, issgd  # noqa: E402
from repro_torch.core.issgd import ISSGDConfig  # noqa: E402
from repro_torch.data import streaming  # noqa: E402
from repro_torch.dist import DataGroup, batch_block  # noqa: E402
from repro_torch.dist.sharding import shard_tree  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import sgd, tree_leaves  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

WORLDS = ((1, 1), (2, 1), (3, 1), (2, 2))
SPLIT_WORLDS = (2, 3)
RTOL, ATOL = 1e-5, 1e-6
ROUTE_ROWS, ROUTE_SEQ = 4, 8
MOE_B, MOE_S = 4, 8


def _np(t):
    return t.detach().float().cpu().numpy()


def _plan(tmp):
    """The MoE cases' inputs: router logits that overflow expert 0, and
    the reference's dbrx smoke MoE layer (its params, an input leaning
    on expert 0, its output and dropped share at the whole batch)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(ROUTE_ROWS * ROUTE_SEQ, 4)).astype(np.float32)
    logits[:, 0] += 1.5
    jcfg = jconfigs.get_smoke_config("dbrx-132b")
    jparams = jax.tree.map(np.asarray,
                           jmoe.init_moe(jax.random.PRNGKey(3), jcfg))
    lean = jparams["router"][:, 0] / np.linalg.norm(jparams["router"][:, 0])
    x = (rng.normal(size=(MOE_B, MOE_S, jcfg.d_model))
         + 2.0 * lean).astype(np.float32)
    out = jax.jit(lambda p, x: jmoe.moe(p, x, jcfg))(jparams, x)
    plan = {"route": {"logits": torch.from_numpy(logits), "rows": ROUTE_ROWS,
                      "seq": ROUTE_SEQ},
            "moe": {"params": jparams, "x": torch.from_numpy(x)}}
    path = os.path.join(tmp, "plan.pt")
    torch.save(plan, path)
    return plan, path, {"y": np.asarray(out.y),
                        "dropped_frac": float(out.dropped_frac)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world spawned at once, each rank a process; the results by
    world and rank, the plan and the reference's MoE layer."""
    tmp = str(tmp_path_factory.mktemp("batch_split"))
    from repro_torch.launch.mesh import free_port
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    plan, path, ref = _plan(tmp)
    for n, m in WORLDS:
        out = os.path.join(tmp, f"world{n}x{m}")
        os.makedirs(out)
        port = free_port()
        for r in range(n * m):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests",
                                              "_torch_batch_split_rank.py"),
                 str(r), str(n), str(m), str(port), path, out],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs[0]
    res = {w: [torch.load(os.path.join(tmp, f"world{w[0]}x{w[1]}",
                                       f"rank{r}.pt"), weights_only=False)
               for r in range(w[0] * w[1])]
           for w in WORLDS}
    return res, plan, ref


def _close(a, b, what):
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b), strict=True))


# ------------------------------------------------------------ partition
@pytest.mark.parametrize("rows,size", [(8, 1), (8, 2), (8, 3), (7, 4),
                                       (256, 16), (40, 16)])
def test_batch_block_is_tensor_split(rows, size):
    blocks = torch.tensor_split(torch.arange(rows), size)
    for r in range(size):
        lo, hi = batch_block(rows, DataGroup(None, r, size))
        assert torch.equal(torch.arange(lo, hi), blocks[r])
    assert batch_block(rows, None) == (0, rows)


# ------------------------------------------------------------ the switch
@pytest.mark.parametrize("factory", [
    issgd.make_master_pass, issgd.make_train_step,
    async_pipeline.make_async_steps, streaming.make_streamed_steps,
    distributed.make_sharded_train_step,
    distributed.make_sharded_async_steps,
    distributed.make_sharded_streamed_steps])
def test_split_batch_defaults_off(factory):
    assert inspect.signature(factory).parameters[
        "split_batch"].default is False


def test_split_refusals_name_the_cause():
    cfg = ISSGDConfig(batch_size=8, score_batch_size=16, score_shards=2)
    two = DataGroup(None, 0, 2)
    pel = lambda p, b: b["y"].float()
    with pytest.raises(ValueError, match="aux_loss"):
        issgd.make_master_pass(pel, sgd(0.1), cfg, 64, group=two,
                               aux_loss=lambda p, b: 0.0, split_batch=True)
    with pytest.raises(ValueError, match="no row"):
        issgd.make_master_pass(pel, sgd(0.1),
                               dataclasses.replace(cfg, batch_size=1), 64,
                               group=two, split_batch=True)
    # one rank, or the split off: the aux term is the unsplit step's
    issgd.make_master_pass(pel, sgd(0.1), cfg, 64, group=two,
                           aux_loss=lambda p, b: 0.0)


# ------------------------------------------------------------ world 1
@pytest.mark.parametrize("case", list(MLP_CASES))
def test_world1_split_is_the_unsplit_step_bitwise(worlds, case):
    res, _, _ = worlds
    got, want = res[(1, 1)][0][case], res[(1, 1)][0][f"{case}/unsplit"]
    for k in ("idx", "loss", "grad_norm"):
        assert torch.equal(got[k], want[k]), k
    assert _same(got["params"], want["params"])


# ------------------------------------------------------------ split worlds
@pytest.mark.parametrize("case", list(MLP_CASES))
@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_split_world_matches_world1(worlds, world, case):
    res, _, _ = worlds
    want = res[(1, 1)][0][case]
    for r, ranks in enumerate(res[(world, 1)]):
        got = ranks[case]
        assert torch.equal(got["idx"], want["idx"]), (r, "draws")
        for k in ("loss", "grad_norm"):
            _close(got[k], want[k], f"rank {r} {k}")
        for a, b in zip(tree_leaves(got["params"]),
                        tree_leaves(want["params"]), strict=True):
            _close(a, b, f"rank {r} params")
        # the split's own messages: a leaf's gradient and the loss a step,
        # and in fused mode the scores' one-owner sum
        per_step = len(tree_leaves(want["params"])) + 1 + (case == "fused")
        assert got["all_reduce"] - want["all_reduce"] == \
            per_step * len(want["loss"]), r


@pytest.mark.parametrize("case", list(MLP_CASES))
@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_split_ranks_agree_bitwise(worlds, world, case):
    res, _, _ = worlds
    first = res[(world, 1)][0][case]
    for ranks in res[(world, 1)][1:]:
        got = ranks[case]
        for k in ("idx", "loss", "grad_norm"):
            assert torch.equal(got[k], first[k]), k
        assert _same(got["params"], first["params"])


@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_split_runs_are_bitwise_run_to_run(worlds, world):
    res, _, _ = worlds
    for ranks in res[(world, 1)]:
        a, b = ranks["sync"], ranks["sync/again"]
        for k in ("idx", "loss", "grad_norm"):
            assert torch.equal(a[k], b[k]), k
        assert _same(a["params"], b["params"])


def test_model_parallel_split_matches_world1(worlds):
    """glm4-9b smoke at (data, model) = (2, 2), split over the data
    ranks, against world 1's unsplit step on one rank."""
    res, _, _ = worlds
    want = res[(1, 1)][0]["lm"]
    for r, ranks in enumerate(res[(2, 2)]):
        got = ranks["lm"]
        assert torch.equal(got["idx"], want["idx"]), r
        for k in ("loss", "grad_norm"):
            _close(got[k], want[k], f"rank {r} {k}")
        shard = shard_tree(want["params"], got["specs"], r % 2, 2)
        for a, b in zip(tree_leaves(got["params"]), tree_leaves(shard),
                        strict=True):
            _close(a, b, f"rank {r} params")


# ------------------------------------------------------------ MoE
@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_moe_routing_under_a_split_is_world1s(worlds, world):
    res, plan, _ = worlds
    cfg = configs.get_smoke_config("dbrx-132b")
    whole = moe.route(plan["route"]["logits"], cfg)
    tk = whole.order.shape[0]
    assert whole.cap == moe.capacity(cfg, ROUTE_ROWS * ROUTE_SEQ)
    assert not bool(whole.keep.all())        # the case drops replicas

    def by_replica(order, v):
        out = torch.empty_like(v)
        out[order] = v
        return out
    keep = by_replica(whole.order, whole.keep)
    pos = by_replica(whole.order, whole.pos)
    got_keep, got_pos = [], []
    for r, ranks in enumerate(res[(world, 1)]):
        rt = ranks["moe"]["route"]
        lo, hi = batch_block(ROUTE_ROWS, DataGroup(None, r, world))
        t = (hi - lo) * ROUTE_SEQ
        assert rt["cap"] == min(whole.cap, t * cfg.num_experts_per_tok)
        got_keep.append(by_replica(rt["order"], rt["keep"]))
        got_pos.append(by_replica(rt["order"], rt["pos"]))
        assert torch.equal(rt["fill"], torch.sum(
            (rt["dst"] < cfg.num_experts * rt["cap"])[:, None]
            & (rt["dst"][:, None] // rt["cap"]
               == torch.arange(cfg.num_experts)), dim=0))
        assert torch.equal(rt["dropped"], 1.0 - torch.mean(
            whole.keep.float()))
    assert torch.equal(torch.cat(got_keep), keep)
    assert torch.equal(torch.cat(got_pos), pos)
    assert sum(len(k) for k in got_keep) == tk


@pytest.mark.parametrize("world", SPLIT_WORLDS)
def test_moe_layer_under_a_split_is_the_reference_at_global_t(worlds,
                                                              world):
    res, plan, ref = worlds
    cfg = configs.get_smoke_config("dbrx-132b")
    from repro_torch.models.layers import params_from_jax
    one = moe.moe(params_from_jax(plan["moe"]["params"]), plan["moe"]["x"],
                  cfg)
    assert float(one.dropped_frac) > 0.0     # the case drops replicas
    np.testing.assert_allclose(_np(one.y), ref["y"], rtol=RTOL, atol=ATOL)
    y = torch.cat([ranks["moe"]["y"] for ranks in res[(world, 1)]])
    np.testing.assert_allclose(_np(y), ref["y"], rtol=RTOL, atol=ATOL)
    for ranks in res[(world, 1)]:
        assert torch.equal(ranks["moe"]["dropped_frac"], one.dropped_frac)
        assert float(ranks["moe"]["dropped_frac"]) == pytest.approx(
            ref["dropped_frac"], rel=0, abs=1e-7)


# ------------------------------------------------------------ dry run
@pytest.mark.parametrize("batch", [32, 48])
def test_dry_run_train_step_takes_the_rank_block(monkeypatch, batch):
    """Rank 0 of 16×16 runs the master on ⌈B/16⌉ rows (its block); the
    scorer still sees the whole score slice of its shard."""
    from repro_torch.models import transformer
    seen = []
    real = transformer.per_example_loss

    def spy(p, cfg, b, **kw):
        if kw.get("batch_split") is not None:     # the master's loss
            seen.append((b["tokens"].shape[0], kw["batch_split"]))
        return real(p, cfg, b, **kw)
    monkeypatch.setattr(transformer, "per_example_loss", spy)
    shape = shapes.InputShape("train_smoke", "train", 64, batch)
    cfg, shape = dryrun.config_for("glm4-9b", shape, smoke=True)
    with dryrun.fake_world(0, 16, 16) as (group, mg):
        dryrun.fake_run(cfg, shape, group, mg)
    lo, hi = batch_block(batch, group)
    assert (hi - lo) == -(-batch // 16)
    assert seen and all(rows == hi - lo for rows, _ in seen)
    assert all(s.rows == batch and s.group.size == 16 for _, s in seen)
