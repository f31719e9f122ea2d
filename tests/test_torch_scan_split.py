"""The arithmetic of the CUDA selective scan, argued on the CPU before the
card.

``selective_scan.cu`` gives one thread a (b, channel) and its d_state
states; each decay is ``ex2.approx.ftz.f32`` of Δ·(A·log₂e) on the SFU
(documented within 2 ulp; results below 2⁻¹²⁶ flushed to 0), and y_t is
summed in two chains (the even and the odd states, each in order) added at
the end.  ``ref.selective_scan_exp2_emulation`` repeats that order in f32,
with the flush, and with ``ulps`` = ±2 moves every decay 2 ulp the same way
at once, the worst case of the approximation.  These tests hold it:

- at falcon-mamba-7b's init (Δ log-uniform in [1e-3, 1e-1] and rounded to
  bf16, A = −[1 .. 16]), S = 2048 (the state remembers ~1000 steps), and
  with |Δ·A| up to 100 (decays flushed), for ulps ∈ {0, +2, −2}, to a
  float64 oracle (``selective_scan_ref`` at scan dtype float64) within
  rtol 1e-5 and an atol of 1e-5 of the largest output: the card's f32
  tolerance for the kernel (``chip_smoke.py`` phase 19; y sums signed
  terms over the states, which can cancel);
- to the JAX package's Pallas kernel, run in interpret mode as its tests
  run it, within the f32 tolerance ``tests/test_torch_ssm.py`` holds the
  plain version to (rtol 1e-5, atol 1e-6 of the largest output);

and check the emulated ex2 and the wrapper's lane constants.  What the
card's ex2.approx really returns is only seen on the card: phase 19's f32
cases are that evidence.  Inputs are numpy draws from a seed.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.selective_scan import selective_scan as j_scan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-5        # chip_smoke.SCAN_RTOL: rtol and atol over max|y|
JAX_RTOL = 1e-5    # tests/test_torch_ssm.py: f32 rtol 1e-5 ...
JAX_ATOL = 1e-6    # ... and an atol of 1e-6 of the largest output


def _bf16(x):
    """Round an f32 numpy array to bf16 and back."""
    return torch.from_numpy(x).bfloat16().float().numpy()


@functools.cache
def _inputs(b, s, di, ds, init, seed):
    """u, Δ, A, B, C, D as numpy f32.  ``falcon``: Δ log-uniform in [1e-3,
    1e-1] rounded to bf16, A = −[1 .. d_state]; ``steep``: Δ log-uniform in
    [1e-2, 6.25], so |Δ·A| reaches 100 and decays underflow; ``test``: the
    reference kernel test's Δ = softplus(N), A = −exp(N/2).  u, B, C ~
    N(0,1) rounded to bf16, D ~ N(0,1)."""
    rng = np.random.default_rng(seed)
    u = _bf16(rng.standard_normal((b, s, di)).astype(np.float32))
    if init == "test":
        delta = np.logaddexp(rng.standard_normal((b, s, di)), 0).astype(
            np.float32)
        a = -np.exp(0.5 * rng.standard_normal((di, ds))).astype(np.float32)
    else:
        lo, hi = (1e-3, 1e-1) if init == "falcon" else (1e-2, 6.25)
        delta = _bf16(np.exp(rng.uniform(np.log(lo), np.log(hi),
                                         (b, s, di))).astype(np.float32))
        a = -np.tile(np.arange(1, ds + 1, dtype=np.float32), (di, 1))
    bm = _bf16(rng.standard_normal((b, s, ds)).astype(np.float32))
    c = _bf16(rng.standard_normal((b, s, ds)).astype(np.float32))
    d = rng.standard_normal(di).astype(np.float32)
    return u, delta, a, bm, c, d


def _torch(arrays):
    return [torch.from_numpy(x) for x in arrays]


@functools.cache
def _oracle(key):
    """The float64 scan of the inputs ``_inputs(*key)``."""
    tx = [t.double() for t in _torch(_inputs(*key))]
    return ref.selective_scan_ref(*tx, scan_dtype=torch.float64).numpy()


@pytest.mark.parametrize("ulps", [0, 2, -2])
@pytest.mark.parametrize("key", [
    (2, 2048, 64, 16, "falcon", 18),    # the longest memory
    (2, 256, 64, 16, "steep", 19),      # |Δ·A| to 100, decays flush
])
def test_emulation_matches_float64_oracle(key, ulps):
    got = ref.selective_scan_exp2_emulation(*_torch(_inputs(*key)),
                                            ulps=ulps).numpy()
    want = _oracle(key)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [
    (2, 64, 32, 16), (1, 128, 16, 16), (3, 32, 64, 16),
    (1, 96, 48, 8), (2, 64, 32, 8), (2, 32, 16, 4),
])
@pytest.mark.parametrize("init", ["falcon", "test"])
def test_emulation_matches_pallas_kernel(shape, init):
    """Against ``src/repro/kernels/selective_scan.py::selective_scan`` in
    interpret mode (chunk 32, block_d 16: several chunks carry h)."""
    arrays = _inputs(*shape, init, sum(shape))
    want = np.asarray(j_scan(*[jnp.asarray(x) for x in arrays], chunk=32,
                             block_d=16, interpret=True))
    got = ref.selective_scan_exp2_emulation(*_torch(arrays)).numpy()
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL,
                               atol=JAX_ATOL * np.abs(want).max())


def test_emulation_keeps_dtype():
    """bf16 in, bf16 out, the shape of u; f32 in, f32 out."""
    tx = [t.bfloat16() if i in (0, 1, 3, 4) else t
          for i, t in enumerate(_torch(_inputs(1, 40, 8, 16, "test", 7)))]
    y = ref.selective_scan_exp2_emulation(*tx)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 40, 8)
    y32 = ref.selective_scan_exp2_emulation(*[t.float() for t in tx])
    assert y32.dtype == torch.float32 and torch.isfinite(y32).all()


def test_ex2_flushes_and_moves_by_ulps():
    """Results below 2⁻¹²⁶ become 0 (2⁻¹²⁶ itself stays); ``ulps`` moves
    each result that many f32 steps, up or down."""
    x = torch.tensor([0.0, -1.0, -126.0, -126.5, -127.0, -140.0, -3.3])
    got = ref.ex2_ftz(x)
    want = torch.exp2(x)
    assert got[2].item() == 2.0 ** -126
    assert (got[3:6] == 0).all() and (want[3:6] > 0).all()
    torch.testing.assert_close(got[[0, 1, 6]], want[[0, 1, 6]], rtol=0,
                               atol=0)
    for ulps in (2, -2):
        moved = ref.ex2_ftz(x[[0, 1, 6]], ulps)
        step = torch.full_like(moved, math.inf if ulps > 0 else -math.inf)
        back = moved
        for _ in range(abs(ulps)):
            back = torch.nextafter(back, -step)
        assert (moved != want[[0, 1, 6]]).all()
        torch.testing.assert_close(back, want[[0, 1, 6]], rtol=0, atol=0)


def test_lanes_are_one_thread_a_channel():
    """The wrapper's copy of the build's ``ss_lanes``: one thread owns a
    channel at every supported d_state (chip_smoke phase 1 compares it
    with the build)."""
    assert tss.LANES == {ds: 1 for ds in tss.STATE_SIZES}
