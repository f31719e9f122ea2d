"""Serving on the (data, model) groups (``serving/sharded_decode.py``, the
engine's and the batcher's ``model_group``, the launcher's ``--mesh``/
``--model-parallel`` with ``--serve-loop``) on gloo worlds of (data,
model) = (1, 2), (2, 2) and (1, 4) ranks, against the reference.

Each world is spawned once for the module (``_torch_mesh_serving_rank
.py``, one process a rank) while the test process runs the reference.
Against the reference: ``sharded_decode_attention`` over worlds of 1, 2
and 4 ranks equals ``decode_attention_ref`` on the whole cache at rtol
2e-5 / atol 2e-6 (the reference test's shapes, one rank without a valid
slot); ``decode_cache_specs`` is ``decode_cache_pspecs``, spec for spec,
for every arch (smoke and full configs) at M = 2 and 4, and raises where
it raises, naming the same field; the model-group batcher on the smoke
configs of glm4-9b, minicpm3-4b, falcon-mamba-7b and jamba-v0.1-52b in
f32 (at M = 4 where the config admits it) gives the tokens of the
reference's single-device generation, and its teacher-forced logits are
within rtol 1e-5 (atol 1e-5 of the largest logit) of the reference's
``prefill``/``decode_step``.  Within the port: at a fixed M, data world 2
is data world 1 bit for bit, and every rank of a model group agrees; the
launcher's ``--mesh 2 --model-parallel 2 --stream --serve-loop`` run
meets the reference's mesh-loop invariants (a served row ingested,
scored and carrying mass, the last reserved row EMPTY without mass, the
sharded store refusing growth).  The reference's own mesh-serving tests
cannot run under the installed jax, so none of their bounds is copied.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _helpers import REPO  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving.sharded_decode import decode_cache_pspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import DataGroup  # noqa: E402
from repro_torch.launch.mesh import free_port  # noqa: E402
from repro_torch.models.transformer import init_transformer  # noqa: E402
from repro_torch.serving import decode_cache_specs  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

WORLDS = ((1, 2), (2, 2), (1, 4))
LOOP_WORLD = (2, 2)
ARCHS = {"glm4": "glm4-9b", "mla": "minicpm3-4b", "ssm": "falcon-mamba-7b",
         "hybrid": "jamba-v0.1-52b"}
N_REQ, PROMPT, NEW, MAX_LEN = 4, 8, 4, 16
ATTN = dict(rtol=2e-5, atol=2e-6)
LOGITS_RTOL = 1e-5
LOOP_ARGV = ["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--mesh",
             "2", "--model-parallel", "2", "--stream", "--serve-loop",
             "--steps", "8", "--examples", "256", "--seq", "16", "--batch",
             "8", "--score-batch", "32", "--log-every", "100"]


def _np(t):
    return t.detach().float().cpu().numpy()


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _plan(tmp):
    rng = np.random.default_rng(11)
    models = {}
    for i, (name, arch) in enumerate(ARCHS.items()):
        cfg = configs.get_smoke_config(arch)
        prompts = rng.integers(0, cfg.vocab_size, (N_REQ, PROMPT))
        teacher = rng.integers(0, cfg.vocab_size, (NEW - 1, N_REQ))
        models[name] = {
            "cfg": cfg, "new_tokens": NEW,
            "params": init_transformer(torch.Generator().manual_seed(30 + i),
                                       cfg, "cpu"),
            "prompts": [torch.from_numpy(p.astype(np.int32))
                        for p in prompts],
            "teacher": [torch.from_numpy(t.astype(np.int32))
                        for t in teacher]}
    attention = {}
    for cname, lengths in (("lengths_100_256", (100, 256)),
                           ("lengths_10_60", (10, 60))):
        b, w, h, hkv, hd = 2, 256, 8, 2, 32
        attention[cname] = {
            "q": torch.from_numpy(rng.standard_normal((b, h, hd))
                                  .astype(np.float32)),
            "k": torch.from_numpy(rng.standard_normal((b, w, hkv, hd))
                                  .astype(np.float32)),
            "v": torch.from_numpy(rng.standard_normal((b, w, hkv, hd))
                                  .astype(np.float32)),
            "lengths": torch.tensor(lengths, dtype=torch.int32)}
    plan = {"models": models, "attention": attention, "max_len": MAX_LEN,
            "loop_world": LOOP_WORLD, "loop_argv": LOOP_ARGV}
    path = os.path.join(tmp, "plan.pt")
    torch.save(plan, path)
    return plan, path


def _reference(plan):
    """The reference's single-device greedy tokens (``generate``, one
    request at a time) and teacher-forced logits (prefill and decode_step
    jitted) of every arch."""
    out = {}
    for name, spec in plan["models"].items():
        jcfg = jconfigs.get_smoke_config(ARCHS[name])
        params = _jax_tree(spec["params"])
        pre = jax.jit(lambda p, t: jengine.prefill(p, jcfg, t, MAX_LEN))
        dec = jax.jit(lambda p, t, s: jengine.decode_step(p, jcfg, t, s))
        prompts = jnp.asarray(np.stack([p.numpy() for p in spec["prompts"]]))
        logits, st0 = pre(params, prompts)
        forced = [np.asarray(logits)]
        st = st0
        for tok in spec["teacher"]:
            lg, st = dec(params, jnp.asarray(tok.numpy()), st)
            forced.append(np.asarray(lg))
        # generation one request at a time, as the batcher prefills them
        # (a capacity-routed MoE prefill depends on its batch's tokens)
        gen = []
        for p in spec["prompts"]:
            lg, st = pre(params, jnp.asarray(p.numpy())[None])
            toks = []
            for _ in range(NEW):
                tok = jnp.argmax(lg, -1).astype(jnp.int32)
                toks.append(int(tok[0]))
                lg, st = dec(params, tok, st)
            gen.append(toks)
        out[name] = {"logits": np.stack(forced), "tokens": np.asarray(gen)}
    attn = {c: np.asarray(jref.decode_attention_ref(
        jnp.asarray(a["q"].numpy()), jnp.asarray(a["k"].numpy()),
        jnp.asarray(a["v"].numpy()), jnp.asarray(a["lengths"].numpy())))
        for c, a in plan["attention"].items()}
    return out, attn


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world spawned at once, the reference computed while they
    run; the results by world and rank, the plan and the reference."""
    tmp = str(tmp_path_factory.mktemp("mesh_serving"))
    plan, path = _plan(tmp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "tests", "_torch_mesh_serving_rank.py")
    procs = []
    for n, m in WORLDS:
        out = os.path.join(tmp, f"world{n}x{m}")
        os.makedirs(out, exist_ok=True)
        port = free_port()
        for r in range(n * m):
            procs.append(subprocess.Popen(
                [sys.executable, script, str(r), str(n), str(m), str(port),
                 path, out], env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LOOP_ARGV],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ref, attn = _reference(plan)
    finally:
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=300)
            if p.returncode:
                errs.append(err[-3000:])
        cli = launcher.communicate(timeout=300) + (launcher.returncode,)
    assert not errs, errs[0]
    res = {(n, m): [torch.load(os.path.join(tmp, f"world{n}x{m}",
                                            f"rank{r}.pt"), weights_only=False)
                    for r in range(n * m)] for n, m in WORLDS}
    res["launcher"] = cli
    return res, plan, ref, attn


# ---------------------------------------------------- sharded_decode_attention
@pytest.mark.parametrize("case", ["lengths_100_256", "lengths_10_60"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_decode_attention_matches_reference(worlds, world, case):
    """Over a group of 1, 2 or 4 ranks (each holding W/size slots; at 2
    and 4 some rank holds no valid slot of a sequence) every rank returns
    the reference oracle's attention over the whole cache."""
    res, _, _, attn = worlds
    src = {1: (res[(1, 2)], "one"), 2: (res[(1, 2)], "world"),
           4: (res[(2, 2)], "world")}[world]
    ranks, gname = src
    for r in ranks:
        np.testing.assert_allclose(_np(r["attention"][(gname, case)]),
                                   attn[case], **ATTN)
    # (1, 4) is a second world of four: the same bits
    if world == 4:
        for r in res[(1, 4)]:
            assert torch.equal(r["attention"][("world", case)],
                               ranks[0]["attention"][("world", case)])


# --------------------------------------------------------- decode cache specs
class _Mesh:
    """A stand-in mesh: the reference's rules read axis names and sizes."""

    def __init__(self, m):
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": m}


def _ref_specs(jcfg, m):
    """The reference's specs as tuples padded to each cache's rank."""
    shapes = jengine.cache_shapes(jcfg, 1, 8)
    want = decode_cache_pspecs(jcfg, _Mesh(m))
    return {k: tuple(want[k]) + (None,) * (len(shapes[k].shape)
                                           - len(tuple(want[k])))
            for k in want}


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", list(configs.ARCH_NAMES))
def test_decode_cache_specs_match_reference(arch, m, size):
    """Spec for spec the reference's ``decode_cache_pspecs`` (its
    ``"model"`` entries where the port writes ``"model"``), or the same
    ValueError naming the same config field."""
    get = "get_smoke_config" if size == "smoke" else "get_config"
    cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    mg = DataGroup(None, 0, m)
    try:
        want = _ref_specs(jcfg, m)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            decode_cache_specs(cfg, mg)
        assert str(got.value) == str(e)
        return
    got = decode_cache_specs(cfg, mg)
    assert got == want


def test_decode_cache_specs_replicate_and_one_rank():
    """M = 1 splits nothing; ``replicate`` replicates a layer type M
    cannot split (glm4-9b's 2 KV heads at M = 16) and splits the rest."""
    cfg = configs.get_config("jamba-v0.1-52b")
    assert all(s == (None,) * len(s)
               for s in decode_cache_specs(cfg, None).values())
    got = decode_cache_specs(cfg, DataGroup(None, 0, 16), replicate=True)
    assert got["l4.attn.k"] == (None,) * 5
    assert got["l0.mamba.conv"] == (None, None, None, "model")
    with pytest.raises(ValueError, match="num_kv_heads"):
        decode_cache_specs(cfg, DataGroup(None, 0, 16))


# -------------------------------------------------------- model-group batcher
SERVE_CASES = [(name, w) for w in WORLDS for name in ARCHS
               if w[1] == 2 or name in ("mla", "ssm")]


@pytest.mark.parametrize("name,world", SERVE_CASES)
def test_batcher_matches_reference_generate(worlds, name, world):
    """The model-group batcher (4 requests through 2 slots) gives every
    request the reference's single-device greedy tokens, on every rank."""
    res, _, ref, _ = worlds
    want = ref[name]["tokens"]
    for r in res[world]:
        got = r["serve"][name]["tokens"]
        assert sorted(got) == list(range(N_REQ))
        for uid, toks in got.items():
            assert toks == want[uid].tolist(), (uid, toks, want[uid])


@pytest.mark.parametrize("name,world", SERVE_CASES)
def test_teacher_forced_logits_match_reference(worlds, name, world):
    """Prefill and 3 teacher-forced decode steps on the shards: within
    f32 rtol 1e-5 of the reference's prefill/decode_step, the ranks of
    the world bitwise alike."""
    res, _, ref, _ = worlds
    want = ref[name]["logits"]
    ranks = res[world]
    for r in ranks[1:]:
        assert torch.equal(r["serve"][name]["logits"],
                           ranks[0]["serve"][name]["logits"])
    np.testing.assert_allclose(_np(ranks[0]["serve"][name]["logits"]), want,
                               rtol=LOGITS_RTOL,
                               atol=LOGITS_RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", list(ARCHS))
def test_data_world_two_is_data_world_one(worlds, name):
    """At M = 2, each model rank of data world 2 is the same model rank of
    data world 1 bit for bit (tokens, logits), and holds the local cache
    shapes: KV heads and mamba channels split, MLA latents whole."""
    res, plan, _, _ = worlds
    one, two = res[(1, 2)], res[(2, 2)]
    for d in range(2):
        for m in range(2):
            a, b = one[m]["serve"][name], two[d * 2 + m]["serve"][name]
            assert a["tokens"] == b["tokens"]
            assert torch.equal(a["logits"], b["logits"])
            assert a["cache_shapes"] == b["cache_shapes"]
    cfg = plan["models"][name]["cfg"]
    for k, shape in one[0]["serve"][name]["cache_shapes"].items():
        if k.endswith((".k", ".v")):
            assert shape[3] == cfg.num_kv_heads // 2
        elif ".mamba." in k:
            assert cfg.resolved_d_inner // 2 in shape
        else:
            assert shape[3] in (cfg.kv_lora_rank, cfg.qk_rope_dim)


# ----------------------------------------------------------- the serve loop
def test_mesh_serve_loop_invariants(worlds):
    """``--mesh 2 --model-parallel 2 --stream --serve-loop`` (glm4-9b
    smoke): every rank serves the same traffic; the first served row is
    ingested, scored (scored_at ≥ 0) and carries proposal mass on its
    owner, the last reserved row stays EMPTY with no mass, its tokens are
    the finished request's prompt and generation, and a sharded store
    refuses growth after layout (reserve chunks before)."""
    res, _, _, _ = worlds
    ranks = [r["loop"] for r in res[LOOP_WORLD]]
    first = ranks[0]
    assert first["ingested"] >= 1
    for r in ranks[1:]:
        assert r["ingested"] == first["ingested"]
        assert r["finished"] == first["finished"]
    rows = {}
    for r in ranks:
        rows.update(r["rows"])
        assert "reserve chunks before" in (r["growth_refused"] or "")
    n_live, n = first["n_live"], first["n"]
    sa, q, toks = rows[n_live]
    assert sa >= 0 and q > 0
    assert toks[4:4 + NEW].tolist() in [list(t) for t in
                                        first["finished"].values()]
    sa_end, q_end, _ = rows[n - 1]
    assert sa_end == first["empty"] and q_end == 0


# ------------------------------------------------------------- the launcher
def test_launcher_serve_loop_on_both_axes(worlds):
    """The launcher line the docs give, as the user runs it (started with
    the worlds): exit 0 and rows ingested."""
    stdout, stderr, rc = worlds[0]["launcher"]
    assert rc == 0, stderr[-3000:]
    assert "mesh: (2, 2) (data, model)" in stdout
    got = [int(line.split()[2]) for line in stdout.splitlines()
           if line.startswith("serve-loop: ingested")]
    assert got and got[0] >= 1
