"""The exact-order emulators of the bf16 score sweep and of the multi-tap
per-example squared-norm kernel, against the plain versions and the JAX
package.

``ref.attn_score_sweep_bf16_blocked`` repeats the bf16 sweep kernel's
order (each example's dq, dk, dv as flat spans in chunks of
``ref.SWEEP16_CHUNK`` elements, 8-element pieces a thread, the block
trees, then the partials in one fixed order);
``ref.per_example_sqnorm_multi_blocked`` the multi-tap kernel's (each
tap's row in the single-tap order, the rows chained in tap order).  CPU
legs hold them to the oracles and to the Pallas kernels in interpret
mode; CUDA legs (skipped without a card) hold the kernels to them bitwise
and each kernel to itself launch to launch.  Inputs are made with numpy
and handed to both frameworks.

Tolerances: rtol 1e-5 everywhere but the bitwise legs: each side sums the
same squares (no cancellation, bf16 inputs upcast exactly) in another f32
order, a few ulps of the sum, and a row of the multi-tap score is a
product of two such sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention_bwd import \
    attn_score_sweep as j_sweep  # noqa: E402
from repro.kernels.per_example_sqnorm import \
    per_example_sqnorm_multi as j_multi  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import per_example_sqnorm as pes  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

RTOL = 1e-5
# (B, S, rep, hd): every B in {1, 3}, S in {1, 17, 100}, rep in {1, 6, 16},
# hd in {32, 64, 128}; rep 16 on one KV head, the others on two
SWEEP_SHAPES = [(b, s, rep, hd) for b in (1, 3) for s in (1, 17, 100)
                for rep in (1, 6, 16) for hd in (32, 64, 128)]
# ragged widths around the 256-thread stride, a 3072-wide tap, 33 taps (two
# launches of the kernel's 32-tap table)
TAP_SETS = {
    "ragged": ((10, 3072), (3072, 10), (300, 7)),
    "odd": ((1, 3), (777, 1023), (2049, 5)),
    "33_taps": ((40, 24),) * 33,
}


def _bf16_grads(b, s, rep, hd, seed):
    """numpy f32 dq, dk, dv of bf16-representable values ~ N(0,1)·1e-2."""
    hkv = 1 if rep == 16 else 2
    rng = np.random.default_rng(seed)
    out = []
    for heads in (rep * hkv, hkv, hkv):
        a = (rng.standard_normal((b, s, heads, hd)) * 1e-2).astype(np.float32)
        out.append(np.array(jnp.asarray(a, jnp.bfloat16)
                            .astype(jnp.float32)))
    return out


def _taps(b, widths, seed, bf16=False):
    rng = np.random.default_rng(seed)
    xs, ds = [], []
    for din, dout in widths:
        x = rng.standard_normal((b, din)).astype(np.float32)
        d = (rng.standard_normal((b, dout)) * 1e-2).astype(np.float32)
        if bf16:
            x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
            d = np.array(jnp.asarray(d, jnp.bfloat16).astype(jnp.float32))
        xs.append(x)
        ds.append(d)
    return xs, ds


# --------------------------------------------------------------- the sweep
@pytest.mark.parametrize("b,s,rep,hd", SWEEP_SHAPES)
def test_sweep_emulator_matches_oracle_and_reference(b, s, rep, hd):
    grads = _bf16_grads(b, s, rep, hd, seed=b * 1000 + s * 10 + rep + hd)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in grads)
    got = ref.attn_score_sweep_bf16_blocked(tq, tk, tv)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(
        got.numpy(), ref.attn_grad_sqnorm_ref(tq, tk, tv).numpy(), rtol=RTOL)
    # the CPU path's plain version (the f32 kernels' tile order)
    np.testing.assert_allclose(
        got.numpy(), ref.attn_score_sweep_kernel_ref(tq, tk, tv).numpy(),
        rtol=RTOL)
    want = j_sweep(*(jnp.asarray(a, jnp.bfloat16) for a in grads),
                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("n", [13, 16_384 + 3, 3 * 16_384 - 5])
def test_sweep_partials_of_ragged_spans(n):
    """A span whose length is no multiple of 8 (the kernel's scalar tail):
    its chunk partials sum to the span's squares, and they equal those of
    the span padded with zeros to whole pieces and chunks, bitwise."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    a = a.bfloat16()
    parts = ref._sweep16_partials(a)
    assert parts.shape == (2, -(-n // ref.SWEEP16_CHUNK))
    want = (a.double() ** 2).sum(dim=1)
    np.testing.assert_allclose(parts.double().sum(dim=1).numpy(),
                               want.numpy(), rtol=RTOL)
    padded = torch.nn.functional.pad(a, (0, parts.shape[1] *
                                         ref.SWEEP16_CHUNK - n))
    assert torch.equal(ref._sweep16_partials(padded), parts)


def test_sweep_order_is_the_documented_one():
    """The emulator, written out by hand for one example: thread t adds
    its pieces t, t+256, ... of each chunk element by element, the block
    trees give one partial a chunk, and thread t of the last block adds
    partials t, t+256, ... before the trees."""
    b, s, rep, hd = 1, 100, 16, 128
    tq, tk, tv = (torch.from_numpy(a).bfloat16()
                  for a in _bf16_grads(b, s, rep, hd, seed=7))
    threads, piece = ref.SQNORM_THREADS, ref.SWEEP16_PIECE
    parts = []
    for a in (tq, tk, tv):
        flat = a.float().reshape(-1)
        for lo in range(0, flat.numel(), ref.SWEEP16_CHUNK):
            chunk = flat[lo:lo + ref.SWEEP16_CHUNK]
            acc = torch.zeros(threads)
            for k in range(ref.SWEEP16_PIECES):
                for j in range(piece):
                    e = (k * threads + torch.arange(threads)) * piece + j
                    v = torch.where(e < chunk.numel(),
                                    chunk[e.clamp(max=chunk.numel() - 1)], 0.)
                    acc = acc + v * v
            parts.append(ref._thread_tree(acc[None])[0])
    acc = torch.zeros(threads)
    for i, p in enumerate(parts):
        acc[i % threads] = acc[i % threads] + p
    want = ref._thread_tree(acc[None])
    assert torch.equal(ref.attn_score_sweep_bf16_blocked(tq, tk, tv), want)


# ------------------------------------------------------- multi-tap sq-norms
@pytest.mark.parametrize("taps", list(TAP_SETS))
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_bias", [True, False])
def test_multi_emulator_matches_oracle_chain_and_reference(taps, bf16,
                                                           with_bias):
    b = 17
    xs, ds = _taps(b, TAP_SETS[taps], seed=len(taps) + 2 * bf16, bf16=bf16)
    dt = torch.bfloat16 if bf16 else torch.float32
    tx = [torch.from_numpy(a).to(dt) for a in xs]
    td = [torch.from_numpy(a).to(dt) for a in ds]
    got = ref.per_example_sqnorm_multi_blocked(tx, td, with_bias)
    np.testing.assert_allclose(
        got.numpy(),
        ref.per_example_sqnorm_multi_ref(tx, td, with_bias).numpy(),
        rtol=RTOL)
    chained = ref.per_example_sqnorm_blocked(tx[0], td[0], with_bias)
    for x, d in zip(tx[1:], td[1:]):
        chained = chained + ref.per_example_sqnorm_blocked(x, d, with_bias)
    assert torch.equal(got, chained)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = j_multi([jnp.asarray(a, jdt) for a in xs],
                   [jnp.asarray(a, jdt) for a in ds], with_bias=with_bias,
                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


# ------------------------------------------------------------- the card
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python3 chip_smoke.py)")


def _off_16(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("b,s,rep,hd", [(3, 100, 6, 128), (1, 17, 16, 64),
                                        (3, 1, 1, 32), (16, 512, 16, 128)])
def test_cuda_sweep_equals_emulator_bitwise(b, s, rep, hd):
    _need_card()
    grads = [torch.from_numpy(a).to("cuda", torch.bfloat16)
             for a in _bf16_grads(b, s, rep, hd, seed=11)]
    got = fab.attn_score_sweep(*grads)
    assert torch.equal(got, ref.attn_score_sweep_bf16_blocked(*grads))
    assert torch.equal(got, fab.attn_score_sweep(*grads))
    assert torch.equal(got, fab.attn_score_sweep(*map(_off_16, grads)))


@pytest.mark.parametrize("taps", list(TAP_SETS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_multi_equals_emulator_bitwise(taps, dtype):
    _need_card()
    xs, ds = _taps(33, TAP_SETS[taps], seed=5)
    dt = getattr(torch, dtype)
    tx = [torch.from_numpy(a).to("cuda", dt) for a in xs]
    td = [torch.from_numpy(a).to("cuda", dt) for a in ds]
    for with_bias in (True, False):
        got = pes.per_example_sqnorm_multi(tx, td, with_bias=with_bias)
        assert torch.equal(got, ref.per_example_sqnorm_multi_blocked(
            tx, td, with_bias))
        assert torch.equal(got, pes.per_example_sqnorm_multi(
            tx, td, with_bias=with_bias))
