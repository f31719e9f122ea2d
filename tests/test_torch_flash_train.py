"""The port's trainable flash-attention path against the JAX reference:
the kernels (the autograd Functions and the LM path are
``tests/test_torch_flash_train_lm.py``).

The flash backward's plain version and the score sweep's (the CPU path of
``repro_torch.kernels.ops``) against the reference's Pallas kernels in
interpret mode; fused == sweep == the probe's tap gradient; the score's
order.  CUDA legs (skipped without a card) hold the kernels against the
plain versions.  Inputs are made with numpy and handed to both
frameworks.

Tolerances: gradients rtol 1e-4 / atol 1e-5, the reference's own bound for
its backward (``tests/test_kernels.py``: the same f32 products summed in
another order); a score against ``attn_grad_sqnorm_ref`` of the same
gradients rtol 1e-5 / atol 1e-6 (one sum of squares in two orders); the
scorers, losses, monitors and params f32 rtol 1e-5 / atol 1e-6, as
``tests/test_torch_lm_issgd.py``.  fused == separate is bitwise for f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as j_flash_kernel  # noqa: E402
from repro.kernels.flash_attention_bwd import \
    flash_attention_bwd as j_flash_bwd  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

GRAD = dict(rtol=1e-4, atol=1e-5)
SCORE = dict(rtol=1e-5, atol=1e-6)
RTOL, ATOL = 1e-5, 1e-6
N_EXAMPLES = 64
# (B, S, H, Hkv, hd, window): GQA, ragged S, windows, MHA, rep 3
SHAPES = [(2, 40, 4, 2, 16, 0), (1, 37, 4, 1, 32, 0), (2, 48, 4, 2, 16, 8),
          (1, 33, 6, 3, 16, 5), (2, 20, 4, 4, 16, 0)]


def _np(t):
    return t.detach().float().cpu().numpy()


def _inputs(b, s, h, hkv, hd, seed):
    """numpy q, k, v ~ N(0,1)·0.5 and dO ~ N(0,1) (the reference's test)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32) * 0.5
    do = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, do


def _leaves(*arrs):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrs]


# --------------------------------------------------------------- kernels
@pytest.mark.parametrize("b,s,h,hkv,hd,win", SHAPES)
def test_plain_backward_matches_pallas_backward(b, s, h, hkv, hd, win):
    """The plain backward (grads and fused score) against the reference's
    Pallas backward in interpret mode, from the same o and lse."""
    q, k, v, do = _inputs(b, s, h, hkv, hd, seed=s + h + win)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = j_flash_kernel(jq, jk, jv, window=win, block_q=16, block_k=16,
                            interpret=True, return_lse=True)
    want = j_flash_bwd(jq, jk, jv, o, lse, jdo, window=win, block_q=16,
                       block_k=16, with_scores=True, interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))
    got = ref.flash_attention_bwd_kernel_ref(
        t(q), t(k), t(v), t(o), t(lse), t(do), window=win, with_scores=True)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(_np(g), np.asarray(w), **GRAD)
    np.testing.assert_allclose(_np(got[3]), np.asarray(want[3]), rtol=1e-4)
    oracle = jref.attn_grad_sqnorm_ref(*(jnp.asarray(_np(g))
                                         for g in got[:3]))
    np.testing.assert_allclose(_np(got[3]), np.asarray(oracle), **SCORE)
    np.testing.assert_allclose(_np(got[3]),
                               _np(ref.attn_grad_sqnorm_ref(*got[:3])),
                               **SCORE)
    chunked = ref.flash_attention_bwd_kernel_ref(
        t(q), t(k), t(v), t(o), t(lse), t(do), window=win, q_chunk=16)
    for a, c in zip(chunked, got[:3]):
        torch.testing.assert_close(a, c, **GRAD)


@pytest.mark.parametrize("b,s,h,hkv,hd,win", SHAPES)
def test_plain_fused_equals_sweep_and_probe_bitwise(b, s, h, hkv, hd, win):
    """f32: the fused score, the plain sweep over the materialized grads
    and the probe's tap gradient are one value, bitwise."""
    q, k, v, do = map(torch.from_numpy, _inputs(b, s, h, hkv, hd, seed=win))
    o, lse = ref.flash_attention_kernel_ref(q, k, v, window=win,
                                            return_lse=True)
    *grads, fused = ref.flash_attention_bwd_kernel_ref(
        q, k, v, o, lse, do, window=win, with_scores=True)
    assert torch.equal(fused, ref.attn_score_sweep_kernel_ref(*grads))
    assert torch.equal(fused, ops.attn_grad_sqnorm(*grads))
    lp = _leaves(*(t.numpy() for t in (q, k, v)))
    tap = torch.zeros(b, requires_grad=True)
    probed = ops.make_qkv_score_probe()(*lp, tap)
    assert all(p.data_ptr() == x.data_ptr() and p is not x
               for p, x in zip(probed, lp))
    got = torch.autograd.grad(
        ops.make_flash_attention_trainable(window=win)(*probed), lp + [tap],
        do)
    assert torch.equal(got[3], fused)
    assert all(torch.equal(a, c) for a, c in zip(got[:3], grads))


def test_blocked_score_order():
    """The score's order, spelled out: one 256-thread partial per tile —
    each (KV head, 64-key tile) of dK and dV, then each (KV head, 64-row
    tile) of dQ, rows (position, head) of one group — summed in that
    order, the two sums added last."""
    b, s, h, hkv, hd = 2, 70, 6, 2, 32
    rng = np.random.default_rng(0)
    dq, dk, dv = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((b, s, h, hd), (b, s, hkv, hd),
                                (b, s, hkv, hd)))
    rep, bq = h // hkv, ref.ATTN_ROWS // (h // hkv)
    kv, qp = [], []
    for g in range(hkv):
        for k0 in range(0, s, ref.ATTN_KEYS):
            tile = lambda a: a[:, k0:k0 + ref.ATTN_KEYS, g].reshape(b, -1)
            kv.append(ref._blocked_sumsq(tile(dk)) +
                      ref._blocked_sumsq(tile(dv)))
    for g in range(hkv):
        for q0 in range(0, s, bq):
            rows = dq[:, q0:q0 + bq, g * rep:(g + 1) * rep]
            qp.append(ref._blocked_sumsq(rows.reshape(b, -1)))
    skv, sq = torch.zeros(b), torch.zeros(b)
    for p in kv:
        skv = skv + p
    for p in qp:
        sq = sq + p
    assert torch.equal(ref.attn_score_sweep_kernel_ref(dq, dk, dv), skv + sq)
    torch.testing.assert_close(skv + sq, ref.attn_grad_sqnorm_ref(dq, dk, dv),
                               **SCORE)


def test_dispatch_on_cpu_and_wrappers_refuse_cpu(monkeypatch):
    """CPU tensors take the plain versions; the CUDA wrappers refuse them
    and count nothing; mixed devices raise."""
    calls = []
    monkeypatch.setattr(ref, "flash_attention_bwd_kernel_ref",
                        lambda *a, **k: calls.append("bwd"))
    monkeypatch.setattr(ref, "attn_score_sweep_kernel_ref",
                        lambda *a, **k: calls.append("sweep"))
    q, kv = torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32)
    lse = torch.zeros(1, 2, 4)
    ops.flash_attention_bwd(q, kv, kv, q, lse, q)
    ops.attn_grad_sqnorm(q, kv, kv)
    assert calls == ["bwd", "sweep"]
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.flash_attention_bwd(q, kv, kv, q, lse.to("meta"), q)
    with pytest.raises(ValueError, match="CUDA"):
        fab.flash_attention_bwd(q, kv, kv, q, lse, q)
    with pytest.raises(ValueError, match="CUDA"):
        fab.attn_score_sweep(q, kv, kv)
    assert fab.flash_attention_bwd.launches == 0
    assert fab.attn_score_sweep.launches == 0


# --------------------------------------------------------------- the card
def _cuda_inputs(b, s, h, hkv, hd, dtype, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python3 chip_smoke.py)")
    q, k, v, do = (torch.from_numpy(a).to("cuda", dtype)
                   for a in _inputs(b, s, h, hkv, hd, seed))
    return q, k, v, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,hd,win", [(2, 100, 8, 2, 32, 0),
                                              (1, 130, 32, 2, 128, 24),
                                              (2, 90, 4, 1, 64, 0)])
def test_cuda_flash_bwd_matches_plain(b, s, h, hkv, hd, win, dtype):
    q, k, v, do = _cuda_inputs(b, s, h, hkv, hd, getattr(torch, dtype), 7)
    o, lse = ops.flash_attention(q, k, v, window=win, return_lse=True)
    *got, sc = fab.flash_attention_bwd(q, k, v, o, lse, do, window=win,
                                       with_scores=True)
    *want, psc = ref.flash_attention_bwd_kernel_ref(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        window=win, with_scores=True)
    tol = GRAD if dtype == "float32" else dict(rtol=2 ** -8 + 1e-4,
                                               atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w, **tol)
    torch.testing.assert_close(sc, psc, rtol=1e-4, atol=0)
    # the f32 sweep repeats the fused tiles; the bf16 one reads flat spans
    exact = ref.attn_score_sweep_kernel_ref if dtype == "float32" else \
        ref.attn_score_sweep_bf16_blocked
    assert torch.equal(fab.attn_score_sweep(*got), exact(*got))


@pytest.mark.parametrize("win", [0, 8])
def test_cuda_fused_equals_sweep_bitwise(win):
    q, k, v, do = _cuda_inputs(2, 90, 8, 2, 64, torch.float32, 8)
    o, lse = ops.flash_attention(q, k, v, window=win, return_lse=True)
    *grads, sc = fab.flash_attention_bwd(q, k, v, o, lse, do, window=win,
                                         with_scores=True)
    assert torch.equal(sc, fab.attn_score_sweep(*grads))
    again = fab.flash_attention_bwd(q, k, v, o, lse, do, window=win)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
