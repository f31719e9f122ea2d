"""The port's model parallelism (``--model-parallel``) on gloo worlds of
(data, model) = (1, 2), (2, 2) and (1, 4) ranks, against the reference
and within the port.

Each world is spawned once for the module (``_torch_model_parallel_rank
.py``, one process a rank), beside one process that runs every case on
one device; the tests below compare what they saved.  Against the
reference: the logical→mesh rules give its specs, spec for spec, for the
MLP and every smoke arch; the model-sharded scorers' ω̃ equal its
one-device scorers at rtol 1e-5 (the MLP's and glm4-9b-smoke's ghost,
glm4's ghost_rev and fused flash score, MoE, mamba, MLA and the hybrid);
every world replays its one-device draws for the MLP in relaxed, fused,
async (swap 2) and streamed modes and for glm4-9b-smoke (sequence
parallel) in relaxed mode, at its bounds (``tests/test_model_parallel.py``:
losses rtol 1e-5 / atol 1e-6, grad norms 1e-4, params 1e-4 / atol 1e-6
for the MLP and 1e-5 for the LMs); the kernels on column-sharded dY,
summed over the ranks, equal the full-width result.  The dense LM's
other modes and the other families (the hybrid without sequence
parallelism) are held at the same bounds to the port's one-device run
on the same draws, which the families' own test files hold to the
reference.  Within the port, bitwise: a data world of 2 equals data
world 1 at the same M; the ranks of a model group agree on every
replicated value; M = 1 is the run without the flag.  A rank holds 1/M
of every sharded parameter and of its optimizer state, no model-axis
message is parameter-sized, remat on ≡ off at (1, 2) (the recompute's
model-axis messages counted), M = 4 replicates the MLP's 10-class layer
with one warning a parameter and a step makes one single-tap and one
multi-tap sq-norm call a rank.  A gather-free file of the (2, 2) world
restores into the reference and the port's one-device state bit for
bit, and the launcher's ``--mesh 2 --model-parallel 2`` prints the
one-device losses.
"""
import os
import re
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _helpers import REPO  # noqa: E402
from _torch_model_parallel_rank import (CASES, REFERENCE_CASES,  # noqa: E402
                                        REMAT_MODELS, REMAT_WORLD, SWAP,
                                        models_for)
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import async_pipeline as japipe  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core.importance import ISConfig as JISConfig  # noqa: E402
from repro.core.scorer import make_lm_scorer as j_lm_scorer  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_mlp_scorer  # noqa: E402
from repro.data.streaming import make_streamed_issgd as j_streamed  # noqa
from repro.dist import sharding as jsharding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core import weight_store as ws  # noqa: E402
from repro_torch.data import make_svhn_like, make_token_dataset  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import free_port  # noqa: E402
from repro_torch.models.mlp import init_mlp_classifier, mlp_specs  # noqa
from repro_torch.models.transformer import (init_transformer,  # noqa: E402
                                            transformer_specs)
from repro_torch.optim import sgd, tree_leaves  # noqa: E402

WORLDS = ((1, 2), (2, 2), (1, 4))
CKPT_WORLD = (2, 2)
MLP_N, LM_N = 480, 64
MLP_STEPS, LM_STEPS = 3, 2
SCORE_RTOL = 1e-5
LOSS = dict(rtol=1e-5, atol=1e-6)
GNORM = dict(rtol=1e-4, atol=1e-6)
PARAMS = {"mlp": dict(rtol=1e-4, atol=1e-6), "lm": dict(rtol=1e-4,
                                                         atol=1e-5)}
LM_ARCHS = {"glm4": "glm4-9b", "moe": "dbrx-132b", "mla": "minicpm3-4b",
            "ssm": "falcon-mamba-7b", "hybrid": "jamba-v0.1-52b"}
SCORERS = {
    "mlp/ghost": ("mlp", {"strategy": "ghost"}),
    "glm4/ghost": ("glm4", {"strategy": "ghost"}),
    "glm4/ghost_rev": ("glm4", {"strategy": "ghost_rev"}),
    "glm4/flash_fused": ("glm4", {"strategy": "ghost", "attn_impl": "flash",
                                  "attn_scores": "fused"}),
    "moe/ghost": ("moe", {"strategy": "ghost"}),
    "mla/ghost": ("mla", {"strategy": "ghost"}),
    "ssm/ghost": ("ssm", {"strategy": "ghost"}),
    "hybrid/ghost": ("hybrid", {"strategy": "ghost"}),
}


def _np(t):
    return t.detach().float().cpu().numpy()


def _jax_tree(tree):
    """The port's tree (the reference's layout) as the reference's."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _named(sub, f"{prefix}{name}/").items()}
    return {prefix: tree}


def _plan(tmp):
    """The inputs of every case, made by the port's own recipes."""
    gen = lambda s: torch.Generator().manual_seed(s)
    rng = np.random.default_rng(7)
    cfg = smoke()
    models = {"mlp": {
        "kind": "mlp", "cfg": cfg, "n": MLP_N, "chunk": 40,
        "params": init_mlp_classifier(gen(1), cfg, "cpu"),
        "data": make_svhn_like(gen(0), n=MLP_N, dim=cfg.input_dim)[0].arrays,
        "step": dict(batch_size=16, score_batch_size=48, refresh_every=2,
                     score_shards=4)}}
    for i, (name, arch) in enumerate(LM_ARCHS.items()):
        lcfg = configs.get_smoke_config(arch)
        models[name] = {
            "kind": "lm", "cfg": lcfg, "n": LM_N, "chunk": 16,
            "params": init_transformer(gen(10 + i), lcfg, "cpu"),
            "data": make_token_dataset(gen(20 + i), n=LM_N, seq=9,
                                       vocab=lcfg.vocab_size).arrays,
            "step": dict(batch_size=4, score_batch_size=16, refresh_every=2,
                         score_shards=4)}
    indices = {"mlp/traffic": [torch.from_numpy(rng.integers(
        0, MLP_N, 16).astype(np.int64)) for _ in range(2)]}
    batches = {"mlp": {k: v[100:116] for k, v in models["mlp"]["data"]
                       .items()}}
    for name in LM_ARCHS:
        batches[name] = {"tokens": models[name]["data"]["tokens"][8:12]}
    steps = {m: MLP_STEPS if m == "mlp" else LM_STEPS for m in models}
    plan = {"models": models, "indices": indices, "batches": batches,
            "steps": steps,
            "scorers": SCORERS, "checkpoint_world": CKPT_WORLD,
            "ckpt": os.path.join(tmp, "mp.npz")}
    path = os.path.join(tmp, "plan.pt")
    torch.save(plan, path)
    return plan, path


def _j_parts(model):
    if model == "mlp":
        jcfg = j_smoke()
        return (lambda p, b: jmlp.per_example_loss(p, b, jcfg),
                j_mlp_scorer(jcfg, "ghost"),
                lambda p, b: jmlp.per_example_loss_and_score(p, b, jcfg))
    jcfg = jconfigs.get_smoke_config(LM_ARCHS[model])
    return (lambda p, b: jtf.per_example_loss(p, jcfg, b)[0],
            j_lm_scorer(jcfg, "ghost"),
            lambda p, b: jtf.per_example_loss_and_score(p, jcfg, b))


def _reference(plan):
    """The reference's one-device runs of the reference cases (each
    step's metrics and the final state) and its scorers' ω̃."""
    runs = {}
    for case in REFERENCE_CASES:
        model, overrides, pipe, _ = CASES[case]
        spec = plan["models"][model]
        steps = MLP_STEPS if model == "mlp" else LM_STEPS
        pel, scorer, fused = _j_parts(model)
        tcfg = jissgd.ISSGDConfig(is_cfg=JISConfig(smoothing=0.1),
                                  **dict(spec["step"], **overrides))
        opt, n = j_sgd(0.05, momentum=0.9 if model == "mlp" else 0.0), \
            spec["n"]
        params, arrays = _jax_tree(spec["params"]), _jax_tree(spec["data"])
        if pipe == "sync":
            step = jax.jit(jissgd.make_train_step(
                pel, scorer, opt, tcfg, n,
                fused_score=fused if tcfg.mode == "fused" else None))
            st = jissgd.init_train_state(params, opt, n)
            fn = lambda s: step(s, arrays)
        elif pipe == "async":
            pipe_ = japipe.AsyncPipeline(*japipe.make_async_steps(
                pel, scorer, opt, tcfg, n), swap_every=SWAP)
            st = japipe.init_async_state(params, opt, n)
            fn = lambda s: pipe_.step(s, arrays)
        else:
            drv = j_streamed(pel, scorer, opt, tcfg,
                             {k: np.asarray(v) for k, v in arrays.items()},
                             spec["chunk"], 2)
            st = jissgd.init_train_state(params, opt, n)
            fn = drv.step
        mets = []
        for _ in range(steps):
            st, m = fn(st)
            mets.append(jax.tree.map(np.asarray, m))
        runs[case] = (mets, st)
    scores = {}
    for name, (model, kw) in SCORERS.items():
        spec = plan["models"][model]
        batch = _jax_tree(plan["batches"][model])
        if model == "mlp":
            fn = j_mlp_scorer(j_smoke(), **kw)
        else:
            fn = j_lm_scorer(jconfigs.get_smoke_config(LM_ARCHS[model]), **kw)
        scores[name] = np.asarray(jax.jit(fn)(_jax_tree(spec["params"]),
                                              batch))
    return runs, scores


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world and the one-device process spawned at once; the
    reference's draws written while they run; the results by world and
    rank, the plan and the reference."""
    tmp = str(tmp_path_factory.mktemp("model_parallel"))
    plan, path = _plan(tmp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "tests", "_torch_model_parallel_rank.py")
    procs = []
    jobs = [("one", 1, 1, os.path.join(tmp, "one"))] + [
        (str(r), n, m, os.path.join(tmp, f"world{n}x{m}"))
        for n, m in WORLDS for r in range(n * m)]
    ports = {(n, m): free_port() for n, m in WORLDS}
    for rank, n, m, out in jobs:
        os.makedirs(out, exist_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, script, rank, str(n), str(m),
             str(ports.get((n, m), 0)), path, out],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        runs, scores = _reference(plan)
        draws = {case: [torch.from_numpy(m.sample_indices.astype(np.int64))
                        for m in mets] for case, (mets, _) in runs.items()}
        part = os.path.join(tmp, "reference.part")
        torch.save(draws, part)
        os.replace(part, os.path.join(tmp, "reference.pt"))
    finally:
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=300)
            if p.returncode:
                errs.append(err[-3000:])
    assert not errs, errs[0]
    res = {(n, m): [torch.load(os.path.join(tmp, f"world{n}x{m}",
                                            f"rank{r}.pt"),
                               weights_only=False) for r in range(n * m)]
           for n, m in WORLDS}
    res["one"] = torch.load(os.path.join(tmp, "one", "one.pt"),
                            weights_only=False)
    return res, plan, runs, scores


def _gathered(ranks, m_size, case):
    """Data rank 0's model ranks' shards of a case's params, whole."""
    specs = ranks[0][case]["specs"]
    trees = [ranks[m][case]["params"] for m in range(m_size)]

    def rec(parts, sp):
        if isinstance(parts[0], dict):
            return {k: rec([p[k] for p in parts], sp[k]) for k in parts[0]}
        if not sharding.is_sharded(sp):
            return parts[0]
        return torch.cat(parts, dim=sp.index("model"))
    return rec(trees, specs)


def _kind(case):
    return "mlp" if case.startswith("mlp") else "lm"


def _check_steps(got, want_steps, want_params, case, params):
    want_steps = [w if isinstance(w, dict) else w._asdict()
                  for w in want_steps]
    for i, (g, w) in enumerate(zip(got, want_steps, strict=True)):
        assert np.array_equal(_np(g["sample_indices"]).astype(np.int64),
                              np.asarray(w["sample_indices"]))
        np.testing.assert_allclose(_np(g["loss"]), np.asarray(w["loss"]),
                                   **LOSS, err_msg=f"{case} {i}")
        np.testing.assert_allclose(_np(g["grad_norm"]),
                                   np.asarray(w["grad_norm"]), **GNORM,
                                   err_msg=f"{case} {i}")
    want = _named(want_params)
    have = _named(params)
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(_np(have[k]), np.asarray(v),
                                   **PARAMS[_kind(case)], err_msg=k)


# ------------------------------------------------------ against the reference
class _Mesh:
    """A stand-in mesh: the rules read axis names and sizes only."""

    def __init__(self, m):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": m}


@pytest.mark.parametrize("m_size", [2, 4])
@pytest.mark.parametrize("arch", ["mlp_svhn"] + list(configs.ARCH_NAMES))
def test_param_specs_match_reference(arch, m_size):
    """``logical_to_pspec``/``param_pspecs`` over the port's logical specs
    give the reference's PartitionSpecs, divisibility fallbacks included."""
    if arch == "mlp_svhn":
        cfg = smoke()
        params = init_mlp_classifier(torch.Generator().manual_seed(0), cfg,
                                     "meta")
        ours, theirs = mlp_specs(cfg), jmlp.mlp_specs(j_smoke())
    else:
        cfg = configs.get_smoke_config(arch)
        params = init_transformer(torch.Generator().manual_seed(0), cfg,
                                  "meta")
        ours = transformer_specs(cfg)
        theirs = jtf.transformer_specs(jconfigs.get_smoke_config(arch))
    shapes = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                         jnp.float32),
                          params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = sharding.param_pspecs(ours, params, _Mesh(m_size))
        want = jsharding.param_pspecs(theirs, shapes, _Mesh(m_size))
    flat_want = {jax.tree_util.keystr(p): tuple(s) for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda x: isinstance(
                         x, jax.sharding.PartitionSpec))[0]}
    flat_got = {"".join(f"[{part!r}]" for part in path.split("/")[:-1]):
                spec for path, spec in _named(got).items()}
    assert flat_got == flat_want


@pytest.mark.parametrize("m_size", [2, 4])
@pytest.mark.parametrize("kernel", ["per_example_sqnorm", "ghost_norm"])
def test_kernels_on_column_sharded_dy(kernel, m_size):
    """As the reference's model-sharded-dY leg: the ops on each rank's dY
    columns (the full input), summed over the ranks, give the full-width
    result, and the reference's full-width op agrees."""
    rng = np.random.default_rng(3)
    shape = (6, 24) if kernel == "per_example_sqnorm" else (3, 10, 24)
    x = rng.standard_normal(shape).astype(np.float32)
    d = rng.standard_normal(shape[:-1] + (32,)).astype(np.float32) * 0.1
    fn = getattr(ops, kernel)
    kw = {"with_bias": False} if kernel == "per_example_sqnorm" else {}
    xt, dt = torch.from_numpy(x), torch.from_numpy(d)
    parts = [fn(xt, c.contiguous(), **kw)
             for c in torch.chunk(dt, m_size, dim=-1)]
    full = fn(xt, dt, **kw)
    np.testing.assert_allclose(_np(sum(parts)), _np(full), rtol=1e-5)
    want = getattr(jops, kernel)(jnp.asarray(x), jnp.asarray(d), **kw)
    np.testing.assert_allclose(_np(full), np.asarray(want), rtol=1e-5)


SCORE_CASES = [(name, w) for w in WORLDS for name, (model, _) in
               SCORERS.items() if model in models_for(w[1])]


@pytest.mark.parametrize("name,world", SCORE_CASES)
def test_scores_match_reference(worlds, name, world):
    """Every rank's ω̃ from its shards equals the reference's one-device
    scorer at rtol 1e-5; the ranks agree bitwise."""
    res, _, _, scores = worlds
    ranks = res[world]
    for r in ranks[1:]:
        assert torch.equal(r["scores"][name], ranks[0]["scores"][name])
    np.testing.assert_allclose(_np(ranks[0]["scores"][name]), scores[name],
                               rtol=SCORE_RTOL)


STEP_CASES = [(case, w) for w in WORLDS for case in CASES
              if CASES[case][0] in models_for(w[1])]


@pytest.mark.parametrize("case,world", [c for c in STEP_CASES
                                        if c[0] in REFERENCE_CASES])
def test_steps_replay_reference(worlds, case, world):
    """The world on the reference's one-device draws: its losses, grad
    norms and final params at the reference's bounds."""
    res, _, runs, _ = worlds
    mets, state = runs[case]
    ranks = res[world]
    _check_steps(ranks[0][case]["steps"], mets, state.params, case,
                 _gathered(ranks, world[1], case))


@pytest.mark.parametrize("case,world", [c for c in STEP_CASES
                                        if c[0] not in REFERENCE_CASES])
def test_steps_match_one_device(worlds, case, world):
    """The world against the port's one-device run on the same draws, at
    the reference's bounds."""
    res, _, _, _ = worlds
    one = res["one"][case]
    ranks = res[world]
    want = [{k: v.numpy() for k, v in s.items()} for s in one["steps"]]
    _check_steps(ranks[0][case]["steps"], want,
                 jax.tree.map(lambda t: t.numpy(), one["params"]), case,
                 _gathered(ranks, world[1], case))


# ----------------------------------------------------------- within the port
def _same_store(a, b):
    if isinstance(a, ws.BufferedWeightStore):
        return (a.synced_at == b.synced_at
                and _same_store(a.read_buf, b.read_buf)
                and _same_store(a.write_buf, b.write_buf))
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b, strict=True))


def _cat_store(a, b):
    if isinstance(a, ws.BufferedWeightStore):
        return ws.BufferedWeightStore(_cat_store(a.read_buf, b.read_buf),
                                      _cat_store(a.write_buf, b.write_buf),
                                      a.synced_at)
    return ws.WeightStore(*(None if x is None else torch.cat([x, y])
                            for x, y in zip(a, b)))


def _same_tree(a, b):
    if not isinstance(a, (dict, torch.Tensor)):     # plain SGD's ()
        return a == b
    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a), tree_leaves(b), strict=True))


def _same_steps(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b, strict=True)
               for k in x)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if CASES[c][0] in models_for(2)])
def test_data_world_is_bitwise_data_world_1(worlds, case):
    """At M = 2 the (2, 2) world is the (1, 2) world bit for bit: each
    model rank's metrics, params, stale params and optimizer state, and
    the store, whose rows the two data ranks split."""
    res, _, _, _ = worlds
    one, two = res[(1, 2)], res[(2, 2)]
    for m in range(2):
        a, lo, hi = one[m][case], two[m][case], two[2 + m][case]
        for r in (lo, hi):
            assert _same_steps(r["steps"], a["steps"])
            for key in ("params", "stale", "opt"):
                assert _same_tree(r[key], a[key]), key
        assert _same_store(_cat_store(lo["store"], hi["store"]),
                           a["store"])


@pytest.mark.parametrize("model", REMAT_MODELS)
def test_remat_is_bitwise_on_a_model_group(worlds, model):
    """At (data, model) = (1, 2), sequence parallel: every rank's losses,
    aux loss, shard gradients and ghost ω̃ are bitwise the same with
    remat on and off; the recompute sends its model-axis messages again,
    and ``COUNTS`` counts them."""
    res, *_ = worlds
    for r, got in enumerate(res[REMAT_WORLD]):
        off, on = got["remat"][(model, False)], got["remat"][(model, True)]
        assert len(on["results"]) == len(off["results"])
        for i, (a, b) in enumerate(zip(on["results"], off["results"])):
            assert torch.equal(a, b), f"rank {r} result {i}"
        assert on["model_all_reduce"] > off["model_all_reduce"]


@pytest.mark.parametrize("world", WORLDS)
def test_model_group_agrees_on_replicated_values(worlds, world):
    """The ranks of a model group agree bitwise on every replicated value:
    metrics, the store and the parameters no spec splits."""
    res, _, _, _ = worlds
    n, m = world
    for case in (c for c in CASES if CASES[c][0] in models_for(m)):
        for d in range(n):
            group = res[world][d * m:(d + 1) * m]
            base = group[0][case]
            for r in group[1:]:
                got = r[case]
                assert _same_steps(got["steps"], base["steps"]), case
                assert _same_store(got["store"], base["store"]), case
                for k, v in _named(base["params"]).items():
                    spec = _named(base["specs"])[k]
                    if not sharding.is_sharded(spec):
                        assert torch.equal(_named(got["params"])[k], v), k


def test_model_parallel_1_is_the_run_without_the_flag():
    argv = ["--smoke", "--steps", "4", "--examples", "256", "--device",
            "cpu", "--log-every", "1"]
    a = ttrain.run(ttrain.parse_args(argv))
    b = ttrain.run(ttrain.parse_args(argv + ["--model-parallel", "1"]))
    assert [(r["loss"], r["grad_norm"]) for r in a.history] == \
        [(r["loss"], r["grad_norm"]) for r in b.history]
    assert _same_tree(a.state.params, b.state.params)


@pytest.mark.parametrize("world", WORLDS)
def test_rank_holds_its_shard_and_no_message_is_parameter_sized(worlds,
                                                                 world):
    """A rank holds 1/M of each sharded MLP weight and of its momentum
    (the 10-class layer, which M = 4 does not divide, whole); no
    model-axis message of a step has a parameter's shape, and the
    largest is smaller than the largest parameter."""
    res, plan, _, _ = worlds
    m = world[1]
    params = plan["models"]["mlp"]["params"]
    full = {tuple(t.shape) for t in tree_leaves(params)}
    for r in res[world]:
        t = r["traffic"]
        for name, shape in t["param_shapes"].items():
            din, dout = params[name]["w"].shape
            want = (din, dout // m) if dout % m == 0 else (din, dout)
            assert shape == want and t["opt_shapes"][name] == want, name
        assert t["messages"] and not set(t["messages"]) & full
        assert t["counts"]["model_max_elements"] < max(
            p.numel() for p in tree_leaves(params))
        assert t["counts"]["model_all_reduce"] == len(t["messages"])


@pytest.mark.parametrize("world", [(1, 2), (1, 4)])
def test_replicated_tap_takes_the_single_tap_kernel(worlds, world):
    """At M = 4 the 10-class layer stays replicated, warned about once a
    parameter by name; a relaxed step then scores with one multi-tap call
    (the sharded layers) and one single-tap call (the replicated one) a
    rank.  At M = 2 every layer is sharded: one multi-tap call."""
    res, _, _, _ = worlds
    m = world[1]
    for r in res[world]:
        t = r["traffic"]
        if m == 4:
            assert len(t["warnings"]) == 2
            assert all("dim 10" in w and "'fc2'" in w
                       for w in t["warnings"])
            assert {"['fc2']['w']", "['fc2']['b']"} == {
                re.search(r"parameter (\S+):", w).group(1)
                for w in t["warnings"]}
            assert t["calls"] == {"per_example_sqnorm": 1,
                                  "per_example_sqnorm_multi": 1}
        else:
            assert t["warnings"] == []
            assert t["calls"] == {"per_example_sqnorm": 0,
                                  "per_example_sqnorm_multi": 1}


# ------------------------------------------------------------- checkpoint
def _world_state(res, plan):
    """The (2, 2) world's relaxed MLP state, whole: data rank 0's model
    ranks' shards joined, the store's rows of both data ranks."""
    ranks = res[CKPT_WORLD]
    case = "mlp/relaxed"
    specs = ranks[0][case]["specs"]

    def join(key):
        return {k: {w: (torch.cat([ranks[m][case][key][k][w]
                                   for m in range(2)],
                                  dim=specs[k][w].index("model"))
                        if sharding.is_sharded(specs[k][w])
                        else ranks[0][case][key][k][w])
                    for w in ranks[0][case][key][k]}
                for k in ranks[0][case][key]}
    store = _cat_store(ranks[0][case]["store"], ranks[2][case]["store"])
    return {"params": join("params"), "stale": join("stale"),
            "opt": join("opt"), "store": store}


def test_gather_free_file_holds_shards_only(worlds):
    """Each sharded parameter is in the file as its M chunks (one a model
    rank, the data-axis replicas dropped), the store as one row block a
    data rank: no rank wrote a whole parameter or table."""
    _, plan, _, _ = worlds
    with np.load(plan["ckpt"]) as z:
        names = set(z.files)
        assert "params/fc0/w" not in names
        assert z["params/fc0/w::shard0"].shape == (64, 64)
        assert z["opt_state/fc1/w::shard1"].shape == (128, 64)
        assert "params/fc0/w::shard2" not in names
        assert z["store/weights::shard1"].shape == (MLP_N // 2,)


@pytest.mark.parametrize("into", ["reference", "port"])
def test_gather_free_file_restores_bitwise(worlds, into):
    """The (2, 2) file restores through the reference into its whole
    state, and through the port into a one-device state, with the
    world's values bit for bit."""
    res, plan, runs, _ = worlds
    want = _world_state(res, plan)
    spec = plan["models"]["mlp"]
    if into == "reference":
        _, jstate = runs["mlp/relaxed"]
        got, step = j_restore(plan["ckpt"], jstate)
        as_np = lambda t: np.asarray(t)
    else:
        template = issgd.init_train_state(spec["params"],
                                          sgd(0.05, momentum=0.9),
                                          spec["n"], "cpu")
        got, step = restore_checkpoint(plan["ckpt"], template)
        as_np = lambda t: t.numpy()
    assert step == MLP_STEPS
    for key, field in (("params", "params"), ("stale", "stale_params"),
                       ("opt", "opt_state")):
        have = _named(getattr(got, field))
        for k, v in _named(want[key]).items():
            assert np.array_equal(as_np(have[k]), v.numpy()), (key, k)
    for f in ("weights", "scored_at"):
        assert np.array_equal(as_np(getattr(got.store, f)),
                              getattr(want["store"], f).numpy()), f


# ---------------------------------------------------------------- launcher
def test_launcher_mesh_2_model_parallel_2_prints_one_device_losses():
    base = ["--smoke", "--steps", "4", "--examples", "512", "--device",
            "cpu", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *base, "--mesh", "2", "--model-parallel", "2"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh: (2, 2) (data, model) over 4 devices" in r.stdout
    got = [float(x) for x in re.findall(r"loss (\S+)", r.stdout)]
    one = ttrain.run(ttrain.parse_args(base + ["--score-shards", "2"]))
    want = [rec["loss"] for rec in one.history]
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
