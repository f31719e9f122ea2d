"""The port's dry-run tools (``launch/shapes.py``, ``launch/op_cost.py``,
``launch/dryrun.py``) against the reference's ``shapes.py`` tables and
``hlo_cost.analyze``, and within the port.

Against the reference: the shape table, the long-context window and
``arch_for_shape`` for every arch and shape; ``op_cost.analyze`` of a
smoke forward (deepseek-7b, batch 4, seq 64) counts the FLOPs that
``hlo_cost.analyze`` walks in the compiled JAX forward, exactly.  Within
the port: the live-byte tracker's peak and write bytes on a function whose
allocations are known, remat's recompute counted in the FLOPs and the
written bytes of a fake training step, the all-reduce bytes on the fake
backend, the
smoke dry run of the reference test's two combinations (glm4-9b train_4k
at 16×16, jamba-v0.1-52b decode_32k at 2×16×16) and the CLI, and at full
size glm4-9b decode_32k at 16×16, whose argument bytes are the rank's
params plus caches worked out from the config by hand.  The reference's
own dry-run test cannot run under the installed jax, so none of its
bounds is copied.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.collectives import psum  # noqa: E402
from repro_torch.launch import dryrun, op_cost, shapes  # noqa: E402
from repro_torch.models.transformer import forward, init_transformer  # noqa


def test_shape_table_is_the_reference():
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
@pytest.mark.parametrize("arch", list(configs.ARCH_NAMES))
def test_arch_for_shape_is_the_reference(arch, shape):
    got = shapes.arch_for_shape(configs.get_config(arch),
                                shapes.SHAPES[shape])
    want = jshapes.arch_for_shape(jconfigs.get_config(arch),
                                  jshapes.SHAPES[shape])
    assert (got.loss_chunk, got.sliding_window) == \
        (want.loss_chunk, want.sliding_window)


def test_forward_flops_match_the_hlo_walker():
    """deepseek-7b smoke forward, batch 4, seq 64: the FLOPs counted on a
    fake run equal the reference walker's over the compiled forward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_smoke_config("deepseek-7b")
    jcfg = jconfigs.get_smoke_config("deepseek-7b")
    jparams = jtf.init_transformer(jax.random.key(0), jcfg)
    toks = jnp.zeros((4, 64), jnp.int32)
    hlo = jax.jit(lambda p, t: jtf.forward(p, jcfg, t)[0]).lower(
        jparams, toks).compile().as_text()
    want = hlo_cost.analyze(hlo).flops
    with FakeTensorMode():
        params = init_transformer(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
        with torch.no_grad():
            got = op_cost.analyze(lambda p, t: forward(p, cfg, t), params,
                                  torch.zeros(4, 64, dtype=torch.int32))
    assert got.flops == want == 771_751_936


def test_live_bytes_of_a_known_function():
    """x (1 MiB) → y = 2x → z = y + 1, y freed: the peak holds x, y and z
    (3 MiB), the ops write 2 MiB, the argument is 1 MiB; a view writes
    nothing."""
    x = torch.zeros(256 * 1024)

    def fn(x):
        y = x * 2
        z = y + 1
        del y
        return z.view(-1, 4)
    c = op_cost.analyze(fn, x)
    mib = 2 ** 20
    assert (c.argument_bytes, c.peak_bytes, c.io_bytes) == (mib, 3 * mib,
                                                            2 * mib)
    assert c.flops == 0 and c.collective_by_op == {}


def test_all_reduce_bytes_on_the_fake_backend():
    """One psum of 10 f32 over a fake world of 256 ranks: 40 bytes of
    all-reduce, and the collectives' counters left as they were."""
    from repro_torch.core import collectives
    before = dict(collectives.COUNTS)
    with dryrun.fake_world(3, 16, 16) as (group, mg):
        assert (group.rank, group.size, mg.rank, mg.size) == (0, 16, 3, 16)
        c = op_cost.analyze(lambda t: psum(t, group), torch.ones(10))
    assert c.collective_bytes == 40 and c.collective_by_op == {
        "all-reduce": 40.0}
    assert collectives.COUNTS == before


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("glm4-9b", "train_4k", False), ("jamba-v0.1-52b", "decode_32k", True)])
def test_smoke_dry_run_of_the_reference_combinations(arch, shape,
                                                     multi_pod):
    r = dryrun.run_one(arch, shape, multi_pod, smoke=True)
    assert r["ok"] and r["flops_per_device"] > 0
    assert r["chips"] == (512 if multi_pod else 256)
    assert r["layout"] == {"data": 32 if multi_pod else 16, "model": 16}
    mem = r["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert r["collective_by_op"]["all-reduce"] == \
        r["collective_bytes_per_device"] > 0


def test_dry_run_cli_writes_one_json(tmp_path):
    assert dryrun.main(["--arch", "falcon-mamba-7b", "--shape",
                        "prefill_32k", "--multi-pod", "yes", "--smoke",
                        "--out", str(tmp_path)]) == 0
    got = json.loads((tmp_path / "falcon-mamba-7b__prefill_32k__pod2.json")
                     .read_text())
    assert got["mesh"] == "2x16x16" and got["kind"] == "prefill"
    assert got["fits_80gb"] and got["flops_per_device"] > 0


def test_full_size_decode_argument_bytes_from_the_config():
    """glm4-9b decode_32k at 16×16, rank 0: the params' shards (the vocab
    and the ffn split 16 ways, the attention whole: 2 KV heads do not
    split over 16) plus the caches of its 8 rows (both KV heads, 32,768
    slots), bf16, worked out by hand; beside them the rows' int32 token
    ids and lengths (the step's other arguments, 64 bytes)."""
    cfg = configs.get_config("glm4-9b")
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    v, f, m = cfg.vocab_size, cfg.d_ff, 16
    layer = (2 * d + d * h * hd * 2 + d * kv * hd * 2 + 3 * d * f // m)
    params = 2 * (v // m) * d + d + cfg.num_layers * layer
    caches = 2 * cfg.num_layers * 8 * 32_768 * kv * hd
    r = dryrun.run_one("glm4-9b", "decode_32k", False)
    assert r["memory"]["argument_bytes"] == 2 * (params + caches) + 2 * 8 * 4
    assert r["fits_80gb"]
    np.testing.assert_array_less(r["memory"]["argument_bytes"],
                                 r["memory"]["peak_bytes"])


def test_remat_recompute_is_counted_under_fake_tensors():
    """A training forward and backward of glm4-9b-smoke × 4 on fake
    tensors, remat off and on: with remat the FLOPs and the written bytes
    count the backward's re-run of each period (more than without, less
    than twice the forward's more), and the peak holds less."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.transformer import per_example_loss
    from repro_torch.optim import tree_leaves
    base = dataclasses.replace(configs.get_smoke_config("glm4-9b"),
                               num_layers=4)

    def step(cfg):
        def fn(params, toks):
            live = [p.requires_grad_(True) for p in tree_leaves(params)]
            loss = per_example_loss(params, cfg, {"tokens": toks})[0].sum()
            return torch.autograd.grad(loss, live)
        return fn

    cost = {}
    with FakeTensorMode():
        toks = torch.zeros(4, 129, dtype=torch.int32)
        for remat in (False, True):
            cfg = dataclasses.replace(base, remat=remat)
            params = init_transformer(torch.Generator().manual_seed(0), cfg,
                                      "cpu")
            cost[remat] = op_cost.analyze(step(cfg), params, toks)
        with torch.no_grad():
            fwd = op_cost.analyze(lambda p, t: forward(p, base, t), params,
                                  toks[:, :-1])
    off, on = cost[False], cost[True]
    assert off.flops < on.flops <= off.flops + fwd.flops
    assert off.io_bytes < on.io_bytes <= off.io_bytes + fwd.io_bytes
    assert on.peak_bytes < off.peak_bytes
