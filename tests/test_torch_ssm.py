"""The port's mamba slice against the JAX reference: the kernel and the
block (the falcon-mamba-7b model, scorers, steps, refusals and launcher
are ``tests/test_torch_ssm_falcon.py``).

The selective-scan kernel's plain version (the CPU path of
``repro_torch.kernels.ops.selective_scan``) against the reference's Pallas
kernel in interpret mode, ragged S and d_inner included; the scan oracle
``selective_scan_ref`` against the reference's at both scan dtypes; the
mamba block in both modes.  CUDA legs (skipped
without a card) hold the kernel against its plain version.  Inputs are
made with numpy from a seed and handed to both frameworks; weights come
from the reference through ``params_from_jax``.

Tolerances: f32 rtol 1e-5 where both sides run the same f32 recurrence
(exp and the state sums in another order, on a contractive recurrence,
exp(Δ·A) < 1), with an atol of 1e-6 of the largest output for a scan's y
(y sums signed terms over the states, which can cancel) and 1e-6 for the
scores, losses and monitors (positive); blocks and models f32 rtol 1e-5 / atol 1e-5
(``tests/test_torch_transformer.py``: matmul sums in another order);
bf16 rtol 2e-2, with an atol of 2e-2 of the largest value where the two
frameworks round bf16 intermediates at different places
(``docs/KERNELS.md``).  On the card the kernel is held to its plain
version at f32 rtol 1e-5 with an atol of 1e-5 of the largest output (y
sums signed terms over the states, which can cancel), bf16 outputs within
one bf16 ulp of the plain version's f32 result, and two launches bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import params_from_jax  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=1e-5, atol=1e-6)
MODEL_F32 = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL = 2e-2
N_EXAMPLES = 64
# (B, S, d_inner, d_state) of tests/test_kernels.py::test_selective_scan;
# the reference's kernel with chunk 32 and block_d 16 pads (2, 100, 30, 8)
# in S and d_inner, which the port's plain version takes as they are
SCAN_SHAPES = [(2, 16, 32, 4), (1, 64, 48, 16), (2, 100, 30, 8),
               (3, 128, 256, 16)]


def _np(t):
    return t.detach().float().cpu().numpy()


def _scan_inputs(b, s, di, ds, seed):
    """u, Δ = softplus(N), A = −exp(0.5·N), B, C, D as numpy f32."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, di)).astype(np.float32)
    delta = np.logaddexp(rng.standard_normal((b, s, di)), 0).astype(
        np.float32)
    a = -np.exp(0.5 * rng.standard_normal((di, ds))).astype(np.float32)
    bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    c = rng.standard_normal((b, s, ds)).astype(np.float32)
    d = rng.standard_normal(di).astype(np.float32)
    return u, delta, a, bm, c, d


def _both(arrays, dtype):
    """(jax, torch) operands: u, Δ, B, C in ``dtype``; A, D in f32."""
    j, t = [], []
    for i, x in enumerate(arrays):
        dt = dtype if i in (0, 1, 3, 4) else "float32"
        j.append(jnp.asarray(x, getattr(jnp, dt)))
        t.append(torch.from_numpy(x).to(getattr(torch, dt)))
    return j, t


def _f32(a):
    return _np(a) if isinstance(a, torch.Tensor) else np.asarray(a,
                                                                 np.float32)


def _close_f32(got, want):
    """f32 rtol 1e-5 with an atol of 1e-6 of the largest value."""
    want = _f32(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _close_bf16(got, want):
    """bf16 rtol 2e-2 with an atol of 2e-2 of the largest value."""
    want = _f32(want)
    np.testing.assert_allclose(_np(got), want, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(want).max())


# --------------------------------------------------------- the kernel's plain
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,ds", SCAN_SHAPES)
def test_selective_scan_plain_matches_pallas_kernel(b, s, di, ds, dtype):
    """ops.selective_scan on CPU tensors (the plain version, at ragged S
    and d_inner as they are) against the reference's ops.selective_scan,
    whose Pallas kernel runs in interpret mode here."""
    jx, tx = _both(_scan_inputs(b, s, di, ds, seed=s * di), dtype)
    want = jops.selective_scan(*jx, chunk=32, block_d=16)
    got = ops.selective_scan(*tx)
    assert got.shape == (b, s, di) and got.dtype == tx[0].dtype
    close = _close_f32 if dtype == "float32" else _close_bf16
    close(got, want)
    # the CPU route is the kernel's plain version, nothing around it
    assert torch.equal(got, ref.selective_scan_kernel_ref(*tx))


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_ref_matches_reference_oracle(dtype, scan_dtype):
    jx, tx = _both(_scan_inputs(2, 40, 24, 8, seed=3), dtype)
    want, jh = jref.selective_scan_ref(*jx, return_state=True,
                                       scan_dtype=getattr(jnp, scan_dtype))
    got, th = ref.selective_scan_ref(*tx, return_state=True,
                                     scan_dtype=getattr(torch, scan_dtype))
    assert got.dtype == tx[0].dtype and th.dtype == getattr(torch, scan_dtype)
    if dtype == scan_dtype == "float32":
        _close_f32(got, want)
        _close_f32(th, jh)
    else:
        _close_bf16(got, want)
        _close_bf16(th, jh)


def test_scan_oracle_and_kernel_plain_agree():
    """The oracle (the model's ref path) and the kernel's plain version
    compute one function, here at an S and d_inner no tile divides."""
    _, tx = _both(_scan_inputs(2, 70, 20, 4, seed=4), "float32")
    _close_f32(ref.selective_scan_ref(*tx), ops.selective_scan(*tx))


# ------------------------------------------------------------ mamba block
def _mamba_cfg(dtype="float32", **kw):
    base = dict(name="m", arch_type="ssm", num_layers=2, d_model=32,
                num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=40,
                attention="none", ssm_state=8, d_inner=48, dtype=dtype)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["ref", "pallas"])
def test_mamba_block_matches_reference(mode, dtype):
    """Both modes; the bf16 pallas leg hands the kernel a bf16 Δ, as the
    reference does, where the ref leg scans an f32 Δ."""
    jcfg, cfg = _mamba_cfg(dtype)
    jp = jssm.init_mamba(jax.random.key(7), jcfg)
    x = np.random.default_rng(7).standard_normal((2, 21, 32)).astype(
        np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jssm.mamba(jp, jx, jcfg, mode=mode)
    with torch.no_grad():
        got = tssm.mamba(params_from_jax(jax.tree.map(np.asarray, jp)), tx,
                         cfg, mode=mode)
    assert got.dtype == tx.dtype and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want), **MODEL_F32)
    else:
        _close_bf16(got, want)


def test_init_mamba_layout_and_dtypes():
    """The port's init draws the reference's tree: same names, shapes and
    dtypes (bf16 projections and conv; f32 dt_proj, dt_bias, a_log and
    d_skip), A = −[1..d_state] per channel, Δ's bias softplus⁻¹ of
    [1e-3, 1e-1]."""
    jcfg, cfg = _mamba_cfg("bfloat16")
    jp = jssm.init_mamba(jax.random.key(0), jcfg)
    tp = tssm.init_mamba(torch.Generator().manual_seed(0), cfg, "cpu")
    assert list(tp) == list(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype)[6:] == str(v.dtype), k
    np.testing.assert_allclose(_np(tp["a_log"]), np.asarray(jp["a_log"]),
                               **F32)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)


# --------------------------------------------------------------- the card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,ds", [(2, 100, 30, 8), (2, 300, 520, 16)])
def test_cuda_selective_scan_matches_plain(b, s, di, ds, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python3 chip_smoke.py)")
    _, tx = _both(_scan_inputs(b, s, di, ds, seed=11), dtype)
    tx = [t.cuda() for t in tx]
    y = tss.selective_scan(*tx)
    assert torch.equal(y, tss.selective_scan(*tx))
    want = ref.selective_scan_kernel_ref(*[t.float() for t in tx])
    if dtype == "float32":
        torch.testing.assert_close(y, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    else:
        rounded = want.to(torch.bfloat16).float()
        ulp = torch.exp2(torch.floor(torch.log2(rounded.abs())) - 7)
        err = (y.float() - rounded).abs()
        assert bool((err <= ulp + 1e-5 * want.abs().max()).all())
