"""The port's checkpoints against the JAX reference's file format.

A whole ``TrainState`` crosses in both directions: reference-saved →
port-restored and port-saved → reference-restored, values bitwise (a
checkpoint moves bits, no arithmetic).  Also bf16 leaves, keys missing
from the file, the atomic write, the generator's stream across a resume,
a gather-free (per-shard) reference file restoring on one device, and the
launcher's --save-checkpoint / --restore-checkpoint.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save  # noqa: E402
from repro.configs.mlp_svhn import smoke as j_smoke  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core.scorer import make_mlp_scorer as j_make_scorer  # noqa: E402
from repro.data import make_svhn_like as j_make_svhn_like  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs.mlp_svhn import smoke  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core.scorer import make_mlp_scorer  # noqa: E402
from repro_torch.data import make_svhn_like  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
N = 128
OPTS = {"sgd": (jopt.sgd, topt.sgd), "adam": (jopt.adam, topt.adam)}


def _np(t):
    return t.detach().cpu().numpy()


def _leaves(tree, prefix=""):
    """{flat key: numpy array} of a JAX or port TrainState, rng left out."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            if k != "rng":
                out.update(_leaves(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
    elif isinstance(tree, int):        # the port's host step: an int32
        out[prefix.rstrip("/")] = np.asarray(tree, np.int32)
    elif tree is not None:
        out[prefix.rstrip("/")] = (_np(tree) if isinstance(tree, torch.Tensor)
                                   else np.asarray(tree))
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert np.array_equal(la[k], lb[k]), k


@pytest.fixture(scope="module", params=sorted(OPTS))
def states(request):
    """(JAX state, port state) after two relaxed steps from the same
    params, data and draws, with the named optimizer."""
    jo, to = (f(0.05) for f in OPTS[request.param])
    jcfg, cfg = j_smoke(), smoke()
    train, _ = j_make_svhn_like(jax.random.key(0), n=N, dim=jcfg.input_dim)
    jparams = jmlp.init_mlp_classifier(jax.random.key(1), jcfg)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    kw = dict(batch_size=8, score_batch_size=32, refresh_every=2)
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jmlp.per_example_loss(p, b, jcfg),
        j_make_scorer(jcfg, "ghost"), jo, jissgd.ISSGDConfig(**kw), N))
    tstep = issgd.make_train_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg),
        make_mlp_scorer(cfg, "ghost"), to, issgd.ISSGDConfig(**kw), N)
    jstate = jissgd.init_train_state(jparams, jo, N)
    tstate = issgd.init_train_state(
        params_from_jax(jax.tree.map(np.asarray, jparams)), to, N, "cpu",
        seed=5)
    for _ in range(2):
        jstate, jm = jstep(jstate, train.arrays)
        tstate, _ = tstep(tstate, data, sample_indices=torch.tensor(
            np.asarray(jm.sample_indices)))
    return request.param, jo, to, jstate, tstate, jparams


def _port_template(to, seed=11):
    """A fresh port TrainState from other params (another seed)."""
    params = tmlp.init_mlp_classifier(torch.Generator().manual_seed(seed),
                                      smoke(), "cpu")
    return issgd.init_train_state(params, to, N, "cpu", seed=seed)


def test_reference_file_restores_into_port_state(states, tmp_path):
    _, jo, to, jstate, _, _ = states
    path = tmp_path / "ref.npz"
    j_save(path, jstate, step=int(jstate.step))
    template = _port_template(to)
    rng_before = template.rng.get_state()
    got, step = restore_checkpoint(path, template)
    assert step == 2 and got.step == 2 and isinstance(got.step, int)
    _assert_same(got, jstate)
    # a reference PRNG key means nothing to a generator: the template's
    assert got.rng is template.rng
    assert torch.equal(got.rng.get_state(), rng_before)


def test_port_file_restores_into_reference_state(states, tmp_path):
    _, jo, to, jstate, tstate, jparams = states
    path = tmp_path / "port.npz"
    save_checkpoint(path, tstate, step=tstate.step)
    jtemplate = jissgd.init_train_state(
        jmlp.init_mlp_classifier(jax.random.key(7), j_smoke()), jo, N,
        seed=3)
    got, step = j_restore(path, jtemplate)
    assert step == 2
    _assert_same(got, tstate)
    # the port's generator tag breaks nothing; the template key stays
    assert np.array_equal(jax.random.key_data(got.rng),
                          jax.random.key_data(jtemplate.rng))


def test_opt_state_flat_keys_line_up(states, tmp_path):
    name, jo, to, jstate, tstate, _ = states
    j_save(tmp_path / "a.npz", jstate, step=2)
    save_checkpoint(tmp_path / "b.npz", tstate, step=2)
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        ka = {k for k in a.files if k.startswith("opt_state")}
        kb = {k for k in b.files if k.startswith("opt_state")}
    assert ka == kb
    assert bool(ka) == (name == "adam")


def test_port_resume_continues_the_run(tmp_path):
    """K steps, save, restore into a template of other params and seed, K
    more steps drawn from the restored generator: bitwise the 2K-step
    run, sampled indices included."""
    cfg = smoke()
    train, _ = make_svhn_like(torch.Generator().manual_seed(0), n=N,
                              dim=cfg.input_dim)
    to = topt.adam(0.01)
    step = issgd.make_train_step(
        lambda p, b: tmlp.per_example_loss(p, b, cfg),
        make_mlp_scorer(cfg, "ghost"), to,
        issgd.ISSGDConfig(batch_size=8, score_batch_size=32,
                          refresh_every=3), N)

    def fresh(seed):
        return _port_template(to, seed)

    full, idx_full = fresh(1), []
    for _ in range(6):
        full, m = step(full, train.arrays)
        idx_full.append(m.sample_indices)
    half = fresh(1)
    for _ in range(3):
        half, _ = step(half, train.arrays)
    save_checkpoint(tmp_path / "k.npz", half, step=half.step)
    resumed, _ = restore_checkpoint(tmp_path / "k.npz", fresh(2))
    assert resumed.rng is not half.rng
    for i in range(3):
        resumed, m = step(resumed, train.arrays)
        assert torch.equal(m.sample_indices, idx_full[3 + i])
    _assert_same(resumed, full)


def test_bf16_leaves_cross_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**16, (6, 5), dtype=np.uint16)
    bits[0, :3] = [0x7FC0, 0xFF80, 0x0001]          # NaN, -inf, subnormal
    jtree = {"w": jnp.asarray(bits.view(jnp.bfloat16))}
    j_save(tmp_path / "ref.npz", jtree, step=1)
    template = {"w": torch.zeros(6, 5, dtype=torch.bfloat16)}
    got, _ = restore_checkpoint(tmp_path / "ref.npz", template)
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(_np(got["w"].view(torch.int16)).view(np.uint16),
                          bits)
    save_checkpoint(tmp_path / "port.npz", got, step=1)
    back, _ = j_restore(tmp_path / "port.npz", jtree)
    assert back["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["w"]).view(np.uint16), bits)
    with np.load(tmp_path / "port.npz") as z:
        assert z["w"].dtype == np.uint16


def _bits(tree) -> dict:
    """{flat key: (dtype name, shape, raw bytes)} of a JAX or port tree."""
    out = {}
    for k, v in tck._flatten(tree).items():
        if isinstance(v, torch.Tensor):
            name = str(v.dtype).removeprefix("torch.")
            v = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
            a = v.detach().cpu().numpy()
        else:
            a = np.asarray(v)
            name = a.dtype.name
        out[k] = (name, a.shape, a.tobytes())
    return out


@pytest.mark.parametrize("arch", ["dbrx-132b", "minicpm3-4b"])
def test_zoo_param_trees_cross_bitwise(arch, tmp_path):
    """The MoE tree (f32 router, 3-D bf16 expert weights) and the MLA
    tree (wq_a/q_norm/wq_b, wkv_a/kv_norm/wkv_b, wo) of the smoke configs
    in bf16: a reference file restores into a port template and a port
    file into a reference template, bitwise, with the same npz keys."""
    import dataclasses

    from repro import configs as jconfigs
    from repro.models import transformer as jtf
    from repro_torch import configs
    from repro_torch.models import transformer as ttf
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="bfloat16")
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    tparams = ttf.init_transformer(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
    j_save(tmp_path / "ref.npz", jparams, step=3)
    got, step = restore_checkpoint(
        tmp_path / "ref.npz",
        ttf.init_transformer(torch.Generator().manual_seed(1), cfg, "cpu"))
    assert step == 3
    assert _bits(got) == _bits(jparams)
    save_checkpoint(tmp_path / "port.npz", tparams, step=4)
    back, _ = j_restore(tmp_path / "port.npz",
                        jtf.init_transformer(jax.random.key(1), jcfg))
    assert _bits(back) == _bits(tparams)
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_missing_keys_keep_the_template(tmp_path):
    save_checkpoint(tmp_path / "a.npz", {"a": torch.ones(3)}, step=4)
    template = {"a": torch.zeros(3, dtype=torch.float64),
                "b": {"c": torch.full((2,), 7.0)}, "n": None}
    got, step = restore_checkpoint(tmp_path / "a.npz", template)
    assert step == 4
    assert got["a"].dtype == torch.float64 and torch.equal(
        got["a"], torch.ones(3, dtype=torch.float64))
    assert got["b"]["c"] is template["b"]["c"] and got["n"] is None


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails midway leaves the previous file and no temporary
    file behind; a good save leaves only the target."""
    path = tmp_path / "ck.npz"
    save_checkpoint(path, {"a": torch.ones(2)}, step=1)
    before = path.read_bytes()

    def broken(f, **_kw):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(tck.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, {"a": torch.zeros(2)}, step=2)
    monkeypatch.undo()
    assert path.read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    save_checkpoint(path, {"a": torch.zeros(2)}, step=2)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]
    assert restore_checkpoint(path, {"a": torch.ones(2)})[1] == 2


def test_generator_of_another_device_keeps_the_template(tmp_path):
    gen = torch.Generator().manual_seed(1)
    save_checkpoint(tmp_path / "g.npz", {"rng": gen}, step=0)
    with np.load(tmp_path / "g.npz") as z:
        assert z["rng"].dtype == np.uint8
    tmpl = torch.Generator().manual_seed(2)
    got, _ = restore_checkpoint(tmp_path / "g.npz", {"rng": tmpl})
    assert torch.equal(torch.rand(4, generator=got["rng"]),
                       torch.rand(4, generator=gen))
    # a state saved from another device type is not this generator's
    got = tck._from_numpy(_np(gen.get_state()), "torch.Generator:cuda",
                          tmpl)
    assert got is tmpl


_SHARDED = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.checkpoint import save_checkpoint
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    put = lambda a, spec: jax.device_put(a, NamedSharding(mesh, spec))
    w = np.arange(16 * 6, dtype=np.float32).reshape(16, 6)
    b = (np.arange(12, dtype=np.float32) / 3).astype(jnp.bfloat16)
    tree = {"params": {"w": put(w, P("data", "model")),
                       "b": put(b, P("model"))},
            "store": {"weights": put(np.linspace(0, 1, 16, dtype=np.float32),
                                     P("data")),
                      "scored_at": put(np.arange(16, dtype=np.int32),
                                       P("data"))},
            "step": jnp.int32(9)}
    save_checkpoint(sys.argv[1], tree, step=9, gather=False)
"""


def test_gather_free_reference_file_restores_on_one_device(tmp_path):
    path = tmp_path / "sharded.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_SHARDED),
                        str(path)], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        keys = set(z.files)
    assert "params/w::shard0" in keys and "params/w" not in keys
    template = {"params": {"w": torch.zeros(16, 6),
                           "b": torch.zeros(12, dtype=torch.bfloat16)},
                "store": {"weights": torch.zeros(16),
                          "scored_at": torch.zeros(16, dtype=torch.int32)},
                "step": 0}
    got, step = restore_checkpoint(path, template)
    assert step == 9 and got["step"] == 9
    assert np.array_equal(_np(got["params"]["w"]),
                          np.arange(96, dtype=np.float32).reshape(16, 6))
    want_b = torch.arange(12, dtype=torch.float32).div(3).to(torch.bfloat16)
    assert torch.equal(got["params"]["b"], want_b)
    assert np.array_equal(_np(got["store"]["weights"]),
                          np.linspace(0, 1, 16, dtype=np.float32))
    assert torch.equal(got["store"]["scored_at"],
                       torch.arange(16, dtype=torch.int32))


def test_launcher_save_then_restore(tmp_path, capsys):
    """--save-checkpoint after the loop, --restore-checkpoint before it:
    3 + 3 steps equal 6 in params, store and step (the same seed's
    generator draws, continued from the file)."""
    base = ["--smoke", "--device", "cpu", "--examples", "256", "--batch",
            "16", "--score-batch", "32", "--log-every", "1"]
    full = ttrain.main(base + ["--steps", "6"])
    ck = str(tmp_path / "ck.npz")
    ttrain.main(base + ["--steps", "3", "--save-checkpoint", ck])
    resumed = ttrain.main(base + ["--steps", "3", "--restore-checkpoint",
                                  ck, "--seed", "0"])
    out = capsys.readouterr().out
    assert f"saved checkpoint to {ck}" in out
    assert f"restored {ck} (step 3)" in out
    assert resumed.state.step == 6
    _assert_same(resumed.state, full.state)
