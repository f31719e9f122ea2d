"""The port's kernels against the JAX reference.

CPU legs: the plain PyTorch versions (``repro_torch.kernels.ref``) against
the reference's ``repro.kernels.ops`` and Pallas kernels (interpret mode on
the CPU), the exact-order emulators against the plain versions, and the
dispatch rules of ``repro_torch.kernels.ops``.  CUDA legs (skipped without
a card) hold the CUDA kernels against their plain versions and emulators.

Tolerances: attention f32 rtol 2e-5 / atol 2e-6 and bf16 the reference's
own kernel-test bounds (``tests/test_kernels.py``), since both sides run
the same f32 online-softmax arithmetic in another order.  Per-example
squared norms f32 rtol 1e-5 — the two frameworks
sum the same ≤300 squares in different orders (a few ulps each), and the
product of two such sums doubles the relative error; bf16 inputs are
upcast exactly, so the same bound holds.  Ghost norms rtol 1e-4, as the
reference's own kernel test: Σ_{s,t} (x_s·x_t)(d_s·d_t) sums S² products
of signed dot products, so cancellation costs more digits than a sum of
squares; bf16 inputs are again upcast exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as j_decode_kernel  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash_kernel  # noqa: E402
from repro.kernels.ghost_norm import ghost_norm as j_ghost_kernel  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ghost_norm as gn  # noqa: E402
from repro_torch.kernels import per_example_sqnorm as pes  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

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


def test_build_key_covers_the_headers(monkeypatch, tmp_path):
    """A library is keyed on its source and every csrc/*.cuh: editing a
    shared header (hopper.cuh) rebuilds each library that may include it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "a.cuh"\n')
    (csrc / "a.cuh").write_text("// a\n")
    (csrc / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    assert first.parent == tmp_path / "build"
    assert _build.library_path("k") == first
    keys = {first}
    for name, text in (("b.cuh", "// b, edited\n"), ("a.cuh", "// a2\n"),
                       ("k.cu", '#include "a.cuh"\n// edited\n')):
        (csrc / name).write_text(text)
        keys.add(_build.library_path("k"))
        assert len(keys) == 1 + ("b.cuh", "a.cuh", "k.cu").index(name) + 1
    (csrc / "c.cuh").write_text("// a new header\n")
    assert _build.library_path("k") not in keys


# --------------------------------------------------------------- ghost norm
GN_RTOL = 1e-4

# (rows, S, din, dout): ragged S around the reference's 32-row test tile
# and the CUDA kernel's 64-row tile, din != dout both ways
GN_SHAPES = ((2, 16, 32, 32), (3, 100, 64, 24), (2, 70, 20, 90))


def _gram_inputs(shape, seed, bf16=False):
    rows, s, din, dout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, s, din)).astype(np.float32)
    d = (rng.standard_normal((rows, s, dout)) * 1e-2).astype(np.float32)
    return _to_jax(x, bf16), _to_jax(d, bf16), _to_torch(x, bf16), \
        _to_torch(d, bf16)


@pytest.mark.parametrize("shape", GN_SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_plain_ghost_norm_matches_reference_kernel(shape, bf16, symmetric):
    """Both plain versions against the reference's Pallas kernel, run as
    its own tests run it (interpret mode, small tiles), and its oracles."""
    jx, jd, tx, td = _gram_inputs(shape, seed=sum(shape), bf16=bf16)
    want = np.asarray(j_ghost_kernel(jx, jd, block_s=32, block_k=64,
                                     symmetric=symmetric, interpret=True))
    gram = ref.ghost_norm_ref(tx, td)
    direct = ref.ghost_norm_direct_ref(tx, td)
    assert gram.dtype == direct.dtype == torch.float32
    assert gram.shape == direct.shape == (shape[0],)
    np.testing.assert_allclose(gram.numpy(), want, rtol=GN_RTOL)
    np.testing.assert_allclose(direct.numpy(), want, rtol=GN_RTOL)
    np.testing.assert_allclose(gram.numpy(),
                               np.asarray(jref.ghost_norm_ref(jx, jd)),
                               rtol=GN_RTOL)
    np.testing.assert_allclose(direct.numpy(),
                               np.asarray(jref.ghost_norm_direct_ref(jx, jd)),
                               rtol=GN_RTOL)


def test_ghost_norm_equals_true_per_example_grad():
    """||∂L_n/∂W||²_F of a linear shared over S, from autograd, against
    both plain versions."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 8, 10)).astype(np.float32))
    tgt = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((10, 6)).astype(np.float32))
    want, ds = [], []
    for n in range(3):
        wn = w.clone().requires_grad_(True)
        y = x[n] @ wn
        (g,) = torch.autograd.grad(torch.sum((y - tgt[n]) ** 2), wn)
        want.append(torch.sum(g ** 2))
        ds.append(2 * (y.detach() - tgt[n]))
    d = torch.stack(ds)
    for fn in (ref.ghost_norm_ref, ref.ghost_norm_direct_ref):
        torch.testing.assert_close(fn(x, d), torch.stack(want), rtol=GN_RTOL,
                                   atol=0)


@pytest.mark.parametrize("s,din,dout,gram", [
    (64, 4096, 4096, True),       # glm4-9b wq/wo
    (64, 4096, 256, True),        # glm4-9b wk/wv
    (64, 4096, 151552, True),     # glm4-9b unembed
    (64, 64, 64, False),          # S(din+dout) > din·dout
    (8, 16, 16, True),            # S(din+dout) == din·dout: Gram
])
def test_ghost_norm_selection_rule(s, din, dout, gram):
    """The reference's FLOP rule: Gram when S(din+dout) ≤ din·dout."""
    assert (ops.ghost_cost(s, din, dout) <= ops.direct_cost(s, din, dout)) \
        == gram
    assert ops.ghost_cost(s, din, dout) == \
        jops.ghost_cost(s, din, dout)
    assert ops.direct_cost(s, din, dout) == \
        jops.direct_cost(s, din, dout)


def test_ghost_norm_dispatch_on_cpu(monkeypatch):
    """On CPU tensors the cost rule picks the plain Gram or the direct
    path, ``force`` pins either, and neither reaches the CUDA wrapper."""
    calls = []
    monkeypatch.setattr(ref, "ghost_norm_ref",
                        lambda x, d: calls.append("gram") or x.new_zeros(1))
    monkeypatch.setattr(ref, "ghost_norm_direct_ref",
                        lambda x, d: calls.append("direct") or x.new_zeros(1))
    gram_shape = (torch.zeros(1, 8, 64), torch.zeros(1, 8, 64))
    direct_shape = (torch.zeros(1, 64, 8), torch.zeros(1, 64, 8))
    ops.ghost_norm(*gram_shape)
    ops.ghost_norm(*direct_shape)
    ops.ghost_norm(*gram_shape, force="direct")
    ops.ghost_norm(*direct_shape, force="gram")
    assert calls == ["gram", "direct", "direct", "gram"]
    with pytest.raises(ValueError, match="force"):
        ops.ghost_norm(*gram_shape, force="fast")
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.ghost_norm(gram_shape[0], gram_shape[1].to("meta"))


def test_ghost_norm_wrapper_refuses_cpu_and_bad_input():
    x, d = torch.zeros(2, 8, 4), torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        gn.ghost_norm(x, d)
    assert gn.ghost_norm.launches == 0


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


@pytest.mark.parametrize("shape", GN_SHAPES)
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")])
def test_cuda_ghost_norm_matches_plain_and_is_deterministic(shape, dtypes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python3 chip_smoke.py)")
    _, _, tx, td = _gram_inputs(shape, seed=7)
    x = tx.to("cuda", getattr(torch, dtypes[0]))
    d = td.to("cuda", getattr(torch, dtypes[1]))
    want = ref.ghost_norm_ref(x, d)
    for symmetric in (False, True):
        a = gn.ghost_norm(x, d, symmetric=symmetric)
        b = gn.ghost_norm(x, d, symmetric=symmetric)
        torch.testing.assert_close(a, want, rtol=GN_RTOL, atol=0)
        assert torch.equal(a, b)



# ---------------------------------------------------------------- attention
ATTN_F32 = dict(rtol=2e-5, atol=2e-6)
# the reference's kernel tests: bf16 outputs may land one bf16 ulp apart
DECODE_BF16 = dict(rtol=3e-2, atol=3e-2)
FLASH_BF16 = dict(rtol=4e-2, atol=2e-2)


def _attn_inputs(shapes, seed, bf16=False):
    """numpy N(0,1) arrays of ``shapes`` as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    return ([_to_jax(a, bf16) for a in arrs],
            [_to_torch(a, bf16) for a in arrs])


def _f32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


@pytest.mark.parametrize("b,s,h,hkv,hd,win", [(1, 40, 4, 2, 32, 0),
                                              (1, 48, 4, 1, 16, 24)])
def test_plain_flash_attention_matches_reference_kernel(b, s, h, hkv, hd,
                                                        win):
    """The plain kernel version (and its lse) against the reference's
    Pallas kernel in interpret mode, at tiny shapes."""
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(
        [(b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)], seed=s + h)
    want_o, want_lse = j_flash_kernel(jq, jk, jv, window=win, block_q=16,
                                      block_k=16, interpret=True,
                                      return_lse=True)
    got_o, got_lse = ref.flash_attention_kernel_ref(tq, tk, tv, window=win,
                                                    return_lse=True,
                                                    q_chunk=17)
    assert got_o.dtype == torch.float32 and got_lse.shape == (b, h, s)
    np.testing.assert_allclose(_f32(got_o), _f32(want_o), **ATTN_F32)
    np.testing.assert_allclose(_f32(got_lse), _f32(want_lse), **ATTN_F32)


def test_plain_decode_attention_matches_reference_kernel():
    """The plain kernel version against the reference's Pallas kernel in
    interpret mode, with a row of length 0: zeros in both."""
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(
        [(3, 8, 32), (3, 40, 2, 32), (3, 40, 2, 32)], seed=9)
    lengths = np.array([0, 1, 37], np.int32)
    want = j_decode_kernel(jq, jk, jv, jnp.asarray(lengths), block_s=16,
                           interpret=True)
    got = ref.decode_attention_kernel_ref(tq, tk, tv,
                                          torch.from_numpy(lengths))
    np.testing.assert_allclose(_f32(got), _f32(want), **ATTN_F32)
    assert not got[0].any() and not np.asarray(want[0]).any()


@pytest.mark.parametrize("b,s,h,hkv,hd,win", [
    (2, 64, 4, 2, 32, 0), (1, 100, 8, 8, 16, 0), (2, 128, 4, 1, 32, 24),
    (1, 96, 6, 3, 64, 32),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_flash_attention_matches_oracles(b, s, h, hkv, hd, win, bf16):
    """Both plain versions against the reference's oracle, at the shapes
    of its own kernel test (windows, ragged S)."""
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(
        [(b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)], seed=s + h,
        bf16=bf16)
    want = _f32(jref.flash_attention_ref(jq, jk, jv, window=win))
    tol = FLASH_BF16 if bf16 else ATTN_F32
    for got in (ref.flash_attention_ref(tq, tk, tv, window=win),
                ref.flash_attention_kernel_ref(tq, tk, tv, window=win,
                                               q_chunk=48)):
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(_f32(got), want, **tol)


@pytest.mark.parametrize("b,s,h,hkv,hd", [
    (2, 64, 4, 4, 32), (2, 128, 8, 2, 64), (1, 100, 6, 1, 16),
    (3, 256, 16, 8, 128),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_plain_decode_attention_matches_oracle(b, s, h, hkv, hd, bf16):
    (jq, jk, jv), (tq, tk, tv) = _attn_inputs(
        [(b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)], seed=s + h,
        bf16=bf16)
    lengths = np.random.default_rng(s).integers(1, s + 1, b).astype(np.int32)
    want = _f32(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths)))
    tol = DECODE_BF16 if bf16 else ATTN_F32
    tl = torch.from_numpy(lengths)
    for got in (ref.decode_attention_ref(tq, tk, tv, tl),
                ref.decode_attention_kernel_ref(tq, tk, tv, tl)):
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(_f32(got), want, **tol)


def test_attention_dispatch_on_cpu(monkeypatch):
    """CPU tensors take the plain kernel versions; mixed devices raise."""
    calls = []
    monkeypatch.setattr(ref, "flash_attention_kernel_ref",
                        lambda *a, **k: calls.append("flash"))
    monkeypatch.setattr(ref, "decode_attention_kernel_ref",
                        lambda *a, **k: calls.append("decode"))
    q4, kv4 = torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32)
    q3, lens = torch.zeros(1, 2, 32), torch.ones(1, dtype=torch.int32)
    ops.flash_attention(q4, kv4, kv4)
    ops.decode_attention(q3, kv4, kv4, lens)
    assert calls == ["flash", "decode"]
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.flash_attention(q4, kv4.to("meta"), kv4)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.decode_attention(q3, kv4, kv4, lens.to("meta"))


def test_attention_wrappers_refuse_cpu_tensors():
    q4, kv4 = torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q4, kv4, kv4)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(torch.zeros(1, 2, 32), kv4, kv4,
                            torch.ones(1, dtype=torch.int32))
    assert fa.flash_attention.launches == 0
    assert da.decode_attention.launches == 0


@pytest.mark.parametrize("b,hkv,s", [(8, 2, 2112), (8, 2, 32768),
                                     (1, 1, 5), (64, 8, 4096)])
def test_decode_split_plan_covers_the_cache(b, hkv, s):
    """The split covers every slot once, in whole 32-slot units, and fills
    one wave of BLOCKS_PER_SM resident blocks an SM of a 132-SM card to at
    least 80% where S allows it, never more than that wave unless B·Hkv
    alone exceeds it."""
    chunk, n_split = da.split_plan(b, hkv, s, 132)
    assert chunk % da.SLOTS == 0 and chunk * n_split >= s
    assert chunk * (n_split - 1) < s
    units = -(-s // da.SLOTS)
    wave = da.BLOCKS_PER_SM * 132
    assert b * hkv * n_split <= max(wave, b * hkv)
    assert b * hkv * n_split >= min(wave, b * hkv * units) * 0.8


def _cuda_attn(shapes, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python3 chip_smoke.py)")
    _, ts = _attn_inputs(shapes, seed)
    return [t.to("cuda", dtype) for t in ts]


@pytest.mark.parametrize("b,s,h,hkv,hd,win", [(2, 100, 8, 2, 32, 0),
                                              (1, 130, 32, 2, 128, 24),
                                              (2, 90, 4, 1, 64, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain(b, s, h, hkv, hd, win, dtype):
    q, k, v = _cuda_attn([(b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)],
                         getattr(torch, dtype), seed=3)
    o, lse = fa.flash_attention(q, k, v, window=win, return_lse=True)
    po, plse = ref.flash_attention_kernel_ref(q, k, v, window=win,
                                              return_lse=True)
    tol = ATTN_F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(o, po, **tol)
    torch.testing.assert_close(lse, plse, **ATTN_F32)
    assert torch.equal(o, fa.flash_attention(q, k, v, window=win))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_attention_matches_plain(dtype):
    q, k, v = _cuda_attn([(4, 32, 128), (4, 300, 2, 128), (4, 300, 2, 128)],
                         getattr(torch, dtype), seed=4)
    lengths = torch.tensor([0, 1, 300, 177], dtype=torch.int32,
                           device="cuda")
    got = da.decode_attention(q, k, v, lengths)
    want = ref.decode_attention_kernel_ref(q, k, v, lengths)
    tol = ATTN_F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)
    assert not got[0].any()
    assert torch.equal(got, da.decode_attention(q, k, v, lengths))
