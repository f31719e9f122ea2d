"""The port's per-example squared-norm kernels against the JAX reference.

CPU legs: the plain PyTorch versions (``repro_torch.kernels.ref``) against
the reference's ``repro.kernels.ops`` (Pallas interpret mode on the CPU),
the exact-order emulators against the plain versions, and the dispatch
rules of ``repro_torch.kernels.ops``.  CUDA legs (skipped without a card)
hold the CUDA kernels against their plain versions and emulators.

Tolerances: f32 rtol 1e-5 — the two frameworks sum the same ≤300 squares
in different orders (a few ulps each), and the product of two such sums
doubles the relative error; bf16 inputs are upcast exactly, so the same
bound holds.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import per_example_sqnorm as pes  # noqa: E402

RTOL = 1e-5

# ragged widths: odd, below and above the kernel's 256-thread stride
TAP_SETS = {
    "one": ((64, 128),),
    "mlp_smoke": ((64, 128), (128, 128), (128, 10)),
    "ragged": ((300, 7), (10, 257), (1, 33)),
}


def _taps(b, widths, seed, bf16=False):
    """numpy f32 taps (bf16-representable values when ``bf16``)."""
    rng = np.random.default_rng(seed)
    xs, ds = [], []
    for din, dout in widths:
        x = rng.standard_normal((b, din)).astype(np.float32)
        d = (rng.standard_normal((b, dout)) * 1e-2).astype(np.float32)
        if bf16:
            x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
            d = np.asarray(jnp.asarray(d, jnp.bfloat16).astype(jnp.float32))
        xs.append(x)
        ds.append(d)
    return xs, ds


def _to_jax(a, bf16):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)


def _to_torch(a, bf16):
    return torch.tensor(a, dtype=torch.bfloat16 if bf16 else torch.float32)


@pytest.mark.parametrize("taps,b,bf16", [("one", 1, False),
                                         ("mlp_smoke", 33, False),
                                         ("ragged", 33, False),
                                         ("ragged", 33, True)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_sqnorm_matches_reference(taps, b, bf16, with_bias):
    xs, ds = _taps(b, TAP_SETS[taps], seed=b, bf16=bf16)
    jx = [_to_jax(a, bf16) for a in xs]
    jd = [_to_jax(a, bf16) for a in ds]
    tx = [_to_torch(a, bf16) for a in xs]
    td = [_to_torch(a, bf16) for a in ds]
    for x0, d0, x1, d1 in zip(jx, jd, tx, td):
        want = np.asarray(jops.per_example_sqnorm(x0, d0, with_bias=with_bias))
        got = ops.per_example_sqnorm(x1, d1, with_bias=with_bias)
        assert got.dtype == torch.float32 and got.shape == (b,)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    want = np.asarray(jops.per_example_sqnorm_multi(jx, jd,
                                                    with_bias=with_bias))
    got = ops.per_example_sqnorm_multi(tx, td, with_bias=with_bias)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("taps", list(TAP_SETS))
@pytest.mark.parametrize("with_bias", [True, False])
def test_blocked_emulator(taps, with_bias):
    """The exact-order emulator is the same function as the plain version
    (rtol: another summation order), and its multi-tap form is bitwise the
    chained single-tap form — the contract the CUDA kernels keep."""
    xs, ds = _taps(17, TAP_SETS[taps], seed=3)
    tx = [torch.from_numpy(a) for a in xs]
    td = [torch.from_numpy(a) for a in ds]
    singles = [ref.per_example_sqnorm_blocked(x, d, with_bias)
               for x, d in zip(tx, td)]
    for s, x, d in zip(singles, tx, td):
        np.testing.assert_allclose(
            s.numpy(), ref.per_example_sqnorm_ref(x, d, with_bias).numpy(),
            rtol=RTOL)
    chained = singles[0]
    for s in singles[1:]:
        chained = chained + s
    assert torch.equal(ref.per_example_sqnorm_multi_blocked(tx, td, with_bias),
                       chained)


def test_dispatch_cpu_takes_plain_and_refuses_mixes():
    x, d = (torch.from_numpy(a[0]) for a in _taps(4, ((8, 8),), seed=0))
    assert torch.equal(ops.per_example_sqnorm(x, d),
                       ref.per_example_sqnorm_ref(x, d))
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.per_example_sqnorm(x, d.to("meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU: the plain path is only
    reached through ops for CPU tensors."""
    x, d = (torch.from_numpy(a[0]) for a in _taps(4, ((8, 8),), seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        pes.per_example_sqnorm(x, d)
    with pytest.raises(ValueError, match="CUDA"):
        pes.per_example_sqnorm_multi([x], [d])


def test_build_is_keyed_on_source_and_refuses_without_nvcc(monkeypatch,
                                                            tmp_path):
    path = _build.library_path("per_example_sqnorm")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("per_example_sqnorm")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="no nvcc"):
        _build.build("per_example_sqnorm")


# ------------------------------------------------------------- CUDA legs
def _cuda_taps(b, widths, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python3 chip_smoke.py)")
    xs, ds = _taps(b, widths, seed)
    return ([torch.from_numpy(a).to("cuda", dtype) for a in xs],
            [torch.from_numpy(a).to("cuda", dtype) for a in ds])


@pytest.mark.parametrize("taps", list(TAP_SETS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_and_emulator(taps, dtype):
    xs, ds = _cuda_taps(33, TAP_SETS[taps], getattr(torch, dtype), seed=5)
    for with_bias in (True, False):
        singles = []
        for x, d in zip(xs, ds):
            k = pes.per_example_sqnorm(x, d, with_bias=with_bias)
            torch.testing.assert_close(
                k, ref.per_example_sqnorm_ref(x, d, with_bias),
                rtol=RTOL, atol=0)
            assert torch.equal(k, ref.per_example_sqnorm_blocked(
                x, d, with_bias))
            singles.append(k)
        multi = pes.per_example_sqnorm_multi(xs, ds, with_bias=with_bias)
        chained = singles[0]
        for s in singles[1:]:
            chained = chained + s
        assert torch.equal(multi, chained)
