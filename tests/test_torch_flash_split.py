"""The arithmetic of the bf16 tensor-core attention kernels, argued on the
CPU before the card.

``flash_fwd_tc``, ``dkdv_tc`` and ``dq_tc`` (``kernels/csrc/``) run their
products on bf16 tensor cores with f32 accumulation.  The products of two
bf16 tensors are exact up to that accumulation; P and dS are f32, and each
is split into bf16 parts and multiplied once a part: two parts for the
forward's P, three for the backward's P (dV), two for its dS (dK, dQ).  ``ref``'s split
emulations repeat that arithmetic, and these tests hold them to the plain
f32 versions at the tolerances ``chip_smoke.py`` holds the kernels to:
ATTN_BF16 for the forward's bf16 output, ATTN_F32 for its lse, BWD_BF16
for the bf16 gradients against the plain version's f32 ones.  A single
bf16 P errs by 2^-9 a term and fails both; two parts for the backward's P
fail where P is large (rep 64 with a window of 3).

Inputs are numpy draws from a seed (N(0,1) for the forward, N(0,1)·0.5 for
the backward's q, k, v as in ``chip_smoke.bwd_inputs``), rounded to bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

ATTN_F32 = dict(rtol=2e-5, atol=2e-6)
ATTN_BF16 = dict(rtol=2 ** -7, atol=1e-5)
BWD_BF16 = dict(rtol=2 ** -8 + 1e-4, atol=1e-5)

# (S, H, Hkv, hd, window): rep 16 and hd 32 over three key tiles; rep 6
# (60 live rows a tile) with a window; MHA; rep 16 at hd 128 with a window;
# rep 64 with a window of 3 (P ~ 1/3: the largest terms)
CASES = [(130, 16, 1, 32, 0), (100, 6, 1, 128, 24), (70, 2, 2, 128, 0),
         (130, 16, 1, 128, 24), (130, 64, 1, 64, 3)]


def _bf16(rng, shape, mul=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * mul).astype(np.float32)).bfloat16()


def _qkv(s, h, hkv, hd, seed, mul=1.0):
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (2, s, h, hd), mul), _bf16(rng, (2, s, hkv, hd), mul),
            _bf16(rng, (2, s, hkv, hd), mul), _bf16(rng, (2, s, h, hd)))


@pytest.mark.parametrize("parts,bound", [(2, 2.0 ** -16), (3, 2.0 ** -25)])
def test_split_reconstructs(parts, bound):
    """Two bf16 parts keep every normal f32 value to 2^-16 of itself, three
    to 2^-25: over values spread across 60 binades, and over the P and dS
    of a backward."""
    rng = np.random.default_rng(0)
    spread = rng.standard_normal(100_000) * np.exp2(rng.uniform(-30, 30,
                                                                100_000))
    q, k, v, do = _qkv(130, 16, 1, 128, seed=1, mul=0.5)
    o, lse = ref.flash_attention_kernel_ref(q, k, v, return_lse=True)
    qf = q.float().reshape(2, 130, 1, 16, 128)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float()) * 128 ** -0.5
    p = torch.exp(logits - lse.reshape(2, 1, 16, 130)[..., None])
    dp = torch.einsum("bqgrd,bkgd->bgrqk",
                      do.float().reshape(2, 130, 1, 16, 128), v.float())
    for x in (torch.from_numpy(spread.astype(np.float32)), p.flatten(),
              (p * dp).flatten()):
        # normal values whose parts are normal too
        x = x[x.abs() >= 2.0 ** (-126 + 8 * parts)]
        err = (sum(p.double() for p in ref.split_bf16(x, parts))
               - x.double()).abs()
        assert (err <= bound * x.abs().double()).all(), \
            (err / x.abs()).max().item()


@pytest.mark.parametrize("s,h,hkv,hd,win", CASES)
def test_split_forward_meets_the_card_tolerance(s, h, hkv, hd, win):
    q, k, v, _ = _qkv(s, h, hkv, hd, seed=2)
    got, got_lse = ref.flash_attention_split_emulation(q, k, v, window=win)
    want, want_lse = ref.flash_attention_kernel_ref(q, k, v, window=win,
                                                    return_lse=True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **ATTN_BF16)
    torch.testing.assert_close(got_lse, want_lse, **ATTN_F32)


@pytest.mark.parametrize("s,h,hkv,hd,win", CASES)
def test_split_backward_meets_the_card_tolerance(s, h, hkv, hd, win):
    q, k, v, do = _qkv(s, h, hkv, hd, seed=3, mul=0.5)
    o, lse = ref.flash_attention_kernel_ref(q, k, v, window=win,
                                            return_lse=True)
    got = ref.flash_attention_bwd_split_emulation(q, k, v, o, lse, do,
                                                  window=win)
    want = ref.flash_attention_bwd_kernel_ref(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        window=win)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, **BWD_BF16)
