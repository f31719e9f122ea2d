"""The arithmetic of the ghost-norm kernel's tensor-core instance, argued on
the CPU before the card.

``ghost_norm.cu``'s tensor-core instance takes a bf16 x and an f32 or bf16
d.  It computes the x Gram tiles of the bf16 x exactly up to f32
accumulation, splits an f32 d into two bf16 parts (hi, lo) and takes the d
Gram as hi·hiᵀ + hi·loᵀ + lo·hiᵀ over each feature split, then sums the
scalars ⟨A_ij, B_ij,split⟩ over splits and tile pairs in a fixed order.
``ref.ghost_norm_split_emulation`` repeats that arithmetic; these tests hold
it at ``GN_RTOL`` (the reference's own ghost-norm bound,
``tests/test_torch_kernels.py``) to the JAX package's Pallas kernel, run as
its tests run it (interpret mode, ``block_s=32``, ``block_k=64``), and to
``ghost_norm_ref``.

Inputs are numpy draws from a seed: x ~ N(0,1) rounded to bf16, d ~
N(0,1)·1e-2 in f32 or rounded to bf16.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ghost_norm import ghost_norm as j_ghost_kernel  # noqa: E402
from repro_torch.kernels import ghost_norm as gn  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

GN_RTOL = 1e-4

# (rows, S, din, dout): tests/test_torch_kernels.py's GN_SHAPES (ragged S
# around the 32- and 64-row tiles, din != dout both ways), and S = 130,
# three 64-position tiles, over widths of 2 and 9 k-tiles
SHAPES = ((2, 16, 32, 32), (3, 100, 64, 24), (2, 70, 20, 90),
          (2, 130, 96, 520))


@functools.cache
def _case(shape, d_bf16, symmetric):
    """(x bf16, d, the JAX kernel's result) for one case."""
    rows, s, din, dout = shape
    rng = np.random.default_rng(sum(shape))
    x = jnp.asarray(rng.standard_normal((rows, s, din)).astype(np.float32),
                    jnp.bfloat16)
    d = jnp.asarray((rng.standard_normal((rows, s, dout)) * 1e-2).astype(
        np.float32), jnp.bfloat16 if d_bf16 else jnp.float32)
    want = np.asarray(j_ghost_kernel(x, d, block_s=32, block_k=64,
                                     symmetric=symmetric, interpret=True))
    tx = torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
    td = torch.tensor(np.asarray(d.astype(jnp.float32)))
    return tx, (td.bfloat16() if d_bf16 else td), want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d_bf16", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("splits", [1, 3, 7])
def test_split_emulation_matches_reference(shape, d_bf16, symmetric, splits):
    x, d, want = _case(shape, d_bf16, symmetric)
    got = ref.ghost_norm_split_emulation(x, d, splits=splits,
                                         symmetric=symmetric)
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=GN_RTOL)
    np.testing.assert_allclose(got.numpy(), ref.ghost_norm_ref(x, d).numpy(),
                               rtol=GN_RTOL)


def test_split_emulation_one_part_of_bf16_d():
    """A bf16 d is one part: its Gram takes one product, and the emulation
    with ``d_parts=1`` of its f32 image is the same arithmetic."""
    x, d, _ = _case(SHAPES[3], True, True)
    a = ref.ghost_norm_split_emulation(x, d, splits=3, symmetric=True)
    b = ref.ghost_norm_split_emulation(x, d.float(), splits=3,
                                       symmetric=True, d_parts=1)
    assert torch.equal(a, b)


def test_two_parts_hold_where_one_would_not():
    """Every d value rounds to bf16 in the same direction: d = 1e-2·(b +
    0.45·2^-7) with b bf16 in [1, 2), so each value's single bf16 part errs
    by about the same fraction, and the Gram's errors add up instead of
    cancelling.  Against the exact (float64) value, over Σ_st |A_st·B_st|:
    one bf16 part errs 4.6e-5 (half of GN_RTOL, too close), two parts
    1.3e-6."""
    rng = np.random.default_rng(0)
    rows, s, din, dout = 2, 64, 256, 4096
    x = torch.from_numpy(rng.standard_normal((rows, s, din)).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy((1 + rng.random((rows, s, dout))).astype(
        np.float32)).bfloat16().float()
    d = 1e-2 * (b + 0.45 * 2.0 ** -7)
    xd, dd = x.double(), d.double()
    ga = torch.einsum("bsk,btk->bst", xd, xd)
    gb = torch.einsum("bsk,btk->bst", dd, dd)
    exact = torch.sum(ga * gb, dim=(1, 2))
    mag = torch.sum((ga * gb).abs(), dim=(1, 2))

    def err(parts):
        got = ref.ghost_norm_split_emulation(x, d, splits=3, symmetric=True,
                                             d_parts=parts)
        return torch.max((got.double() - exact).abs() / mag).item()

    one, two = err(1), err(2)
    assert two <= GN_RTOL / 10, two
    assert one >= GN_RTOL / 5, one


# the feature widths of every main-path ghost_norm call (glm4-9b, falcon-
# mamba-7b): d_model, d_ff, vocabularies, KV width, x_proj's output, mamba's
# in_proj output and d_inner
MAIN_WIDTHS = (4096, 13696, 151552, 256, 288, 16384, 65024, 8192)


@pytest.mark.parametrize("width", MAIN_WIDTHS)
def test_main_path_widths_take_the_tensor_cores(width):
    """bf16 x with f32 d at every main-path width meets TMA's 16-byte row
    pitch, as x or as d."""
    a = torch.empty(1, 1, width, dtype=torch.bfloat16, device="meta")
    b = torch.empty(1, 1, width, dtype=torch.float32, device="meta")
    assert gn.uses_tensor_cores(a, b)


def test_instance_rule():
    """f32 x, a row pitch that is not a multiple of 16 bytes, a base
    address that is not, or an empty width: the SIMT instance."""
    bf16 = torch.bfloat16
    x = torch.zeros(2, 8, 64, dtype=bf16)
    assert gn.uses_tensor_cores(x, torch.zeros(2, 8, 24))
    assert gn.uses_tensor_cores(x, torch.zeros(2, 8, 24, dtype=bf16))
    assert not gn.uses_tensor_cores(x.float(), torch.zeros(2, 8, 24))
    assert not gn.uses_tensor_cores(torch.zeros(2, 8, 20, dtype=bf16),
                                    torch.zeros(2, 8, 24))    # 40-byte rows
    assert not gn.uses_tensor_cores(x, torch.zeros(2, 8, 77))  # 308-byte rows
    assert not gn.uses_tensor_cores(x, torch.zeros(2, 8, 4, dtype=bf16))
    assert not gn.uses_tensor_cores(x, torch.zeros(2, 8, 0))
    shifted = torch.zeros(2 * 8 * 64 + 1, dtype=bf16)[1:].view(2, 8, 64)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert not gn.uses_tensor_cores(shifted, torch.zeros(2, 8, 24))
