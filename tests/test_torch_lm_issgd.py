"""The port's LM ISSGD slice against the JAX reference: the LM scorers,
three whole relaxed/ghost train steps of glm4-9b-smoke, the token data
recipe and the launcher's LM path.

Inputs (params and data) come from the reference and are handed to the
port as numpy arrays; the port replays the reference's sampled indices.
Tolerances: f32 rtol 1e-5 / atol 1e-6 for scores, losses and monitors
(matmuls and S² Gram sums taken in another order, on positive values);
params after three steps rtol 1e-5 / atol 1e-6 as in the MLP slice; the
store's ``scored_at`` stamps and the sampled indices must be equal.
"""
import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import issgd as jissgd  # noqa: E402
from repro.core.scorer import make_lm_scorer as j_make_lm_scorer  # noqa: E402
from repro.data import make_token_dataset as j_make_token_dataset  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as j_sgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import issgd  # noqa: E402
from repro_torch.core.scorer import make_lm_scorer  # noqa: E402
from repro_torch.data import make_token_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
N_EXAMPLES = 128


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def lm_setup():
    jcfg = jconfigs.get_smoke_config("glm4-9b")
    cfg = configs.get_smoke_config("glm4-9b")
    train = j_make_token_dataset(jax.random.key(0), n=N_EXAMPLES, seq=17,
                                 vocab=jcfg.vocab_size)
    jparams = jtf.init_transformer(jax.random.key(1), jcfg)
    data = {k: torch.from_numpy(np.array(v)) for k, v in train.arrays.items()}
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, train, jparams, data, tparams


# ----------------------------------------------------------------- scorers
@pytest.mark.parametrize("strategy", ["ghost", "loss", "logit_grad"])
def test_lm_scores_match_reference(lm_setup, strategy):
    jcfg, cfg, train, jparams, data, tparams = lm_setup
    toks = train.arrays["tokens"][:6]
    want = j_make_lm_scorer(jcfg, strategy)(jparams, {"tokens": toks})
    got = make_lm_scorer(cfg, strategy)(tparams, {"tokens": data["tokens"][:6]})
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_lm_ghost_equals_autograd_norm_over_tapped_linears(lm_setup):
    """Ghost scores are the exact per-example gradient norm over the
    tapped linears (every attention and MLP projection, and the unembed),
    here against per-example autograd.  Gram and direct paths both."""
    _, cfg, _, _, data, tparams = lm_setup
    toks = data["tokens"][:3]
    want = []
    for n in range(3):
        live = {k: v for k, v in _leaves(tparams).items()}
        for t in live.values():
            t.requires_grad_(True)
        loss, _ = ttf.per_example_loss(_unflatten(live), cfg,
                                       {"tokens": toks[n:n + 1]})
        names = [k for k in live if _tapped(k)]
        grads = torch.autograd.grad(loss[0], [live[k] for k in names])
        want.append(torch.sqrt(sum(torch.sum(g ** 2) for g in grads)))
    want = torch.stack(want)
    scorer = make_lm_scorer(cfg, "ghost")
    got = scorer(tparams, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    # the smoke shapes take the Gram path for every tap; force direct
    real = ops.ghost_norm
    try:
        ops.ghost_norm = lambda x, d, symmetric=True: real(x, d,
                                                           force="direct")
        direct = scorer(tparams, {"tokens": toks})
    finally:
        ops.ghost_norm = real
    torch.testing.assert_close(direct, want, rtol=1e-4, atol=0)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_leaves(v, name + "."))
        else:
            out[name] = v.detach().clone()
    return out


def _unflatten(flat):
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def _tapped(name):
    return name.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo", "w_in",
                                       "w_gate", "w_out", "unembed")


def test_lm_full_oracle_matches_reference(lm_setup):
    """The port's ``full`` oracle (torch.func per-example gradients over
    every parameter) against the reference's vmap-of-grad oracle."""
    jcfg, cfg, train, jparams, data, tparams = lm_setup
    toks = train.arrays["tokens"][:3]
    want = j_make_lm_scorer(jcfg, "full")(jparams, {"tokens": toks})
    got = make_lm_scorer(cfg, "full")(tparams, {"tokens": data["tokens"][:3]})
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------ the slice, 3 steps
def test_three_lm_train_steps_match_reference(lm_setup):
    """The slice as a whole: relaxed mode, ghost scorer, glm4-9b-smoke.
    The port replays the reference's sampled indices and must follow its
    losses, grad norms, monitors, store and params (refresh_every=2 puts
    a stale-param push inside the run)."""
    jcfg, cfg, train, jparams, data, tparams = lm_setup
    kw = dict(batch_size=4, score_batch_size=16, refresh_every=2,
              mode="relaxed")
    jopt = j_sgd(0.05)
    jstep = jax.jit(jissgd.make_train_step(
        lambda p, b: jtf.per_example_loss(p, jcfg, b)[0],
        j_make_lm_scorer(jcfg, "ghost"), jopt, jissgd.ISSGDConfig(**kw),
        N_EXAMPLES))
    jstate = jissgd.init_train_state(jparams, jopt, N_EXAMPLES)
    topt = sgd(0.05)
    tstep = issgd.make_train_step(
        lambda p, b: ttf.per_example_loss(p, cfg, b)[0],
        make_lm_scorer(cfg, "ghost"), topt, issgd.ISSGDConfig(**kw),
        N_EXAMPLES)
    tstate = issgd.init_train_state(tparams, topt, N_EXAMPLES, "cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, train.arrays)
        tstate, tm = tstep(tstate, data, sample_indices=torch.tensor(
            np.asarray(jm.sample_indices)))
        for field in ("loss", "grad_norm", "trace_ideal", "trace_stale",
                      "trace_unif", "ess_frac", "mean_weight"):
            np.testing.assert_allclose(_np(getattr(tm, field)),
                                       np.asarray(getattr(jm, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=field)
    assert tstate.step == int(jstate.step) == 3
    np.testing.assert_allclose(_np(tstate.store.weights),
                               np.asarray(jstate.store.weights),
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(_np(tstate.store.scored_at),
                          np.asarray(jstate.store.scored_at))
    for which in ("params", "stale_params"):
        want = _leaves(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                    getattr(jstate, which)))
        got = _leaves(getattr(tstate, which))
        assert list(got) == list(want)
        for name, v in want.items():
            np.testing.assert_allclose(_np(got[name]), _np(v), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{which} {name}")


def test_bf16_params_train_and_stay_bf16():
    """glm4-9b-smoke in its production dtype: sgd upcasts, updates and
    casts back, so params stay bf16 and the step stays finite."""
    cfg = dataclasses.replace(configs.get_smoke_config("glm4-9b"),
                              dtype="bfloat16", num_layers=1)
    gen = torch.Generator().manual_seed(0)
    params = ttf.init_transformer(gen, cfg, "cpu")
    data = make_token_dataset(torch.Generator().manual_seed(1), n=64,
                              seq=9, vocab=cfg.vocab_size).arrays
    opt = sgd(0.05)
    step = issgd.make_train_step(
        lambda p, b: ttf.per_example_loss(p, cfg, b)[0],
        make_lm_scorer(cfg, "ghost"), opt,
        issgd.ISSGDConfig(batch_size=4, score_batch_size=16), 64)
    state = issgd.init_train_state(params, opt, 64, "cpu")
    for _ in range(2):
        state, m = step(state, data)
    assert all(t.dtype == torch.bfloat16
               for t in _leaves(state.params).values())
    assert math.isfinite(m.loss.item()) and math.isfinite(m.grad_norm.item())
    assert torch.all(state.store.weights[:32] > 0)


def test_make_token_dataset_recipe():
    ds = make_token_dataset(torch.Generator().manual_seed(0), n=300, seq=40,
                            vocab=97)
    toks = ds.arrays["tokens"]
    assert toks.shape == (300, 40) and toks.dtype == torch.int32
    assert 0 <= toks.min() and toks.max() < 97
    # every example repeats a 16-token motif, corrupted at a rate < 0.5
    agree = (toks[:, :16] == toks[:, 16:32]).float().mean(1)
    assert agree.mean() > 0.4
    again = make_token_dataset(torch.Generator().manual_seed(0), n=300,
                               seq=40, vocab=97)
    assert torch.equal(again.arrays["tokens"], toks)


# ----------------------------------------------------------------- launcher
def test_launcher_runs_an_lm_on_cpu_when_asked(capsys):
    result = ttrain.main(["--arch", "glm4-9b", "--smoke", "--steps", "2",
                          "--examples", "64", "--batch", "4",
                          "--score-batch", "16", "--seq", "8",
                          "--log-every", "1", "--device", "cpu"])
    assert [r["step"] for r in result.history] == [0, 1]
    assert result.state.step == 2
    leaf = result.state.params["layers"]["l0"]["mixer"]["wq"]
    assert leaf.shape == (2, 256, 256)      # two periods, stacked
    lines = capsys.readouterr().out.splitlines()
    pat = re.compile(r"step +\d+ loss \d+\.\d{4} √TrΣ ideal/stale/unif = "
                     r"\d+\.\d{3}/\d+\.\d{3}/\d+\.\d{3} ess \d+\.\d{3}$")
    assert all(pat.match(line) for line in lines[:2]), lines
    assert lines[2].startswith("done: 2 steps on cpu")


def test_launcher_takes_a_config_override():
    args = ttrain.parse_args(["--arch", "glm4_9b", "--smoke", "--examples",
                              "32", "--batch", "2", "--score-batch", "8",
                              "--seq", "4", "--steps", "1", "--device",
                              "cpu"])
    cfg = dataclasses.replace(configs.get_smoke_config("glm4-9b"),
                              num_layers=1, d_ff=64)
    result = ttrain.run(args, cfg)
    assert result.state.params["layers"]["l0"]["ff"]["w_in"].shape == \
        (1, 256, 64)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "dbrx-132b", "--model-parallel", "5", "--device", "cpu"],
     "does not divide num_heads"),
    (["--arch", "jamba-v0.1-52b", "--model-parallel", "16", "--device",
      "cpu"], "does not divide num_kv_heads"),
    (["--arch", "no-such-arch", "--device", "cpu"], "unknown arch"),
])
def test_launcher_refuses_unported_archs(argv, match, capsys):
    """Every arch of the reference is ported; an unknown one is refused
    by name, and so is a model-parallel degree that does not divide an
    arch's heads or kv heads (the reference's refusals)."""
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args(argv)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_launcher_lm_defaults_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(SystemExit) as e:
        ttrain.parse_args(["--arch", "glm4-9b", "--smoke"])
    assert e.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err
