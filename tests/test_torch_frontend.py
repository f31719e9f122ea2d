"""The port's frontend-embeds stub (llava-next-34b, musicgen-medium)
against the JAX reference, and the new archs through the port's
entry points.

Embeds (B, N_front, D) are prepended to the token embeddings and the
loss covers the token positions: the forward's logits, the per-example
loss and the fused objective; every LM strategy's scores with embeds.
The reference's ``ghost`` refuses embeds (its taps are shaped for the
text positions only) and its ``full`` drops them, so the port's
``ghost`` is held to the reference's ``ghost_rev`` (the same exact
quantity) and its ``full`` to ``vmap(grad)`` of the reference's
per-example loss with the embeds.  Then, for each of the six new archs:
``tap_structure`` against the records one forward writes, and the train
launcher on the CPU with ``ghost`` and ``ghost_rev`` (their serving is
held to the reference in ``test_torch_serve_zoo.py``).

Inputs are made with numpy from a seed; the weights come from the
reference (``params_from_jax``).  Tolerance: f32 rtol 1e-5 / atol 1e-6
(matmuls, softmax and Gram sums in another order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import scorer as jscorer  # noqa: E402
from repro.core.strategies import make_proposal as j_make_proposal  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import scorer as tscorer  # noqa: E402
from repro_torch.core.strategies import make_proposal  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
B, S = 3, 10
NEW_ARCHS = ("minicpm3-4b", "dbrx-132b", "grok-1-314b", "jamba-v0.1-52b",
             "llava-next-34b", "musicgen-medium")


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, msg="", atol=ATOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=msg)


def _batch(cfg, seed):
    """(numpy tokens (B, S+1), numpy embeds (B, N_front, D) or None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    embeds = (rng.standard_normal((B, cfg.num_frontend_tokens, cfg.d_model))
              .astype(np.float32) if cfg.num_frontend_tokens else None)
    return toks, embeds


def _both(toks, embeds):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if embeds is not None:
        jb["embeds"] = jnp.asarray(embeds)
        tb["embeds"] = torch.from_numpy(embeds)
    return jb, tb


def _arch(name, seed=1):
    jcfg = jconfigs.get_smoke_config(name)
    cfg = configs.get_smoke_config(name)
    jparams = jax.jit(lambda k: jtf.init_transformer(k, jcfg))(
        jax.random.key(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jcfg, cfg, jparams, tparams) + _both(*_batch(cfg, seed))


@pytest.fixture(scope="module")
def musicgen():
    return _arch("musicgen-medium")


@pytest.fixture(scope="module")
def llava():
    return _arch("llava-next-34b", seed=2)


# ------------------------------------------------------- forward and loss
@pytest.mark.parametrize("which", ["musicgen", "llava"])
def test_embeds_forward_loss_and_fused_objective_match_reference(
        which, request):
    jcfg, cfg, jparams, tparams, jb, tb = request.getfixturevalue(which)
    n_front = cfg.num_frontend_tokens

    @jax.jit
    def ref(p, b):
        logits, _ = jtf.forward(p, jcfg, b["tokens"][:, :-1],
                                embeds=b["embeds"])
        loss, _ = jtf.per_example_loss(p, jcfg, b)
        return logits, loss, jtf.per_example_loss_and_score(p, jcfg, b)

    jlog, jl, (jfl, jfs) = ref(jparams, jb)
    tlog, aux = ttf.forward(tparams, cfg, tb["tokens"][:, :-1],
                            embeds=tb["embeds"])
    assert tlog.shape == (B, n_front + S, cfg.vocab_size)
    assert float(aux.aux_loss) == 0.0
    _close(tlog, jlog, "logits", atol=1e-5)
    tl, _ = ttf.per_example_loss(tparams, cfg, tb)
    _close(tl, jl, "losses")
    tfl, tfs = ttf.per_example_loss_and_score(tparams, cfg, tb)
    _close(tfl, jfl, "fused losses")
    _close(tfs, jfs, "fused scores")
    # the embeds matter: without them the losses differ
    tl0, _ = ttf.per_example_loss(tparams, cfg, {"tokens": tb["tokens"]})
    assert not torch.allclose(tl0, tl)


def _reference_full(jcfg, jparams, jb):
    """ω̃ of vmap(grad) over the reference's per-example loss, embeds
    included (the reference's own ``full`` drops them)."""
    def loss_one(p, tokens, embeds):
        return jtf.per_example_loss(
            p, jcfg, {"tokens": tokens[None], "embeds": embeds[None]})[0][0]

    grads = jax.vmap(jax.grad(loss_one), in_axes=(None, 0, 0))(
        jparams, jb["tokens"], jb["embeds"])
    return jnp.sqrt(sum(jnp.sum(jnp.square(g), axis=tuple(range(1, g.ndim)))
                        for g in jax.tree.leaves(grads)))


@pytest.mark.parametrize("strategy", ["loss", "logit_grad", "ghost",
                                      "ghost_rev", "full", "upper_bound"])
def test_embeds_scores_match_reference(musicgen, strategy):
    jcfg, cfg, jparams, tparams, jb, tb = musicgen
    if strategy == "ghost":
        ref = jscorer.make_lm_scorer(jcfg, "ghost_rev")
    elif strategy == "full":
        ref = lambda p, b: _reference_full(jcfg, p, b)  # noqa: E731
    else:
        ref = j_make_proposal(jscorer.make_lm_scorer, jcfg, strategy)
    want = jax.jit(ref)(jparams, jb)
    got = make_proposal(tscorer.make_lm_scorer, cfg, strategy)(tparams, tb)
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("strategy", ["ghost", "logit_grad"])
def test_vision_embeds_scores_match_reference(llava, strategy):
    jcfg, cfg, jparams, tparams, jb, tb = llava
    ref = "ghost_rev" if strategy == "ghost" else strategy
    want = jax.jit(jscorer.make_lm_scorer(jcfg, ref))(jparams, jb)
    _close(tscorer.make_lm_scorer(cfg, strategy)(tparams, tb), want)


# ------------------------------------------------------ the six new archs
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_tap_structure_equals_the_records_a_forward_writes(name):
    """Names in the forward's order, and each tap shaped as the output
    its record feeds: the forward adds every tap, and each gets a
    gradient.  The frontend's positions are part of the sequence."""
    cfg = configs.get_smoke_config(name)
    params = ttf.init_transformer(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    toks, embeds = _batch(cfg, 3)
    _, tb = _both(toks, embeds)
    shapes = ttf.tap_structure(cfg, B, cfg.num_frontend_tokens + S)
    taps = {k: torch.zeros(v, requires_grad=True) for k, v in shapes.items()}
    losses, aux = ttf.per_example_loss(params, cfg, tb, taps=taps,
                                       collect=True)
    assert list(aux.records) == list(shapes)
    grads = torch.autograd.grad(losses.sum(), list(taps.values()))
    for (k, rec), g in zip(aux.records.items(), grads):
        assert rec.shape[:-1] == g.shape[:-1], k
        assert torch.count_nonzero(g) > 0, k
    routers = [k for k in shapes if k.endswith(".moe.router")]
    assert bool(routers) == (cfg.num_experts > 0)
    for k in routers:
        assert shapes[k] == (cfg.num_periods, B * S, cfg.num_experts)


@pytest.mark.parametrize("strategy", ["ghost", "ghost_rev"])
@pytest.mark.parametrize("name", NEW_ARCHS)
def test_launcher_trains_the_new_archs_on_cpu(name, strategy):
    """``--arch <a> --smoke`` on tokens alone (the frontends' archs too,
    as the reference's launcher trains them)."""
    result = ttrain.main(["--arch", name, "--smoke", "--strategy", strategy,
                          "--steps", "2", "--examples", "32", "--batch",
                          "4", "--score-batch", "8", "--seq", "8",
                          "--log-every", "1", "--device", "cpu"])
    assert result.state.step == 2
    assert all(math.isfinite(r["loss"]) for r in result.history)
