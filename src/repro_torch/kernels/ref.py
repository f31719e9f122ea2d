"""Plain PyTorch versions of the port's kernels.

``*_ref`` mirror ``src/repro/kernels/ref.py``: the CPU path of
``kernels/ops.py`` and the oracle the CUDA kernels are held against.
``*_blocked`` repeat the CUDA kernel's own reduction order (thread
layout, shuffle trees, no FMA) with plain f32 tensor operations, so on
the card a kernel must equal its emulator bitwise.  The ghost-norm Gram
kernel has no such emulator: it is held to run-to-run bitwise equality
and to ``ghost_norm_ref`` at a stated tolerance.

The attention oracles ``flash_attention_ref`` and ``decode_attention_ref``
mask with ``-inf``, as the reference's do.  Beside them,
``flash_attention_kernel_ref`` and ``decode_attention_kernel_ref`` are the
plain versions of the two attention *kernels* (the CPU path of
``kernels/ops.py``): they mask as the Pallas kernels do, with ``_NEG``,
``p = exp(s - m)·mask`` and ``max(l, 1e-20)`` in the denominator, so a
decode row of length 0 gives zeros where the oracle gives NaN.
``flash_attention_bwd_kernel_ref`` and ``attn_score_sweep_kernel_ref`` are
the plain versions of the backward and score-sweep kernels; both reduce
the score through ``_attn_score_blocked``, the f32 CUDA kernels' tiles
and order, so the plain fused and separate scores are bitwise equal, and
on the card the f32 sweep kernel equals its plain version bitwise.  The
bf16 sweep kernel reads flat spans in another order, which
``attn_score_sweep_bf16_blocked`` repeats.

``flash_attention_split_emulation`` and
``flash_attention_bwd_split_emulation`` repeat the arithmetic of the bf16
tensor-core attention kernels (bf16 operands, f32 accumulation, the scale
after Q·Kᵀ, the f32 P split into bf16 parts, two in the forward and three
for the backward's dV, dS into two): the tests hold them to the plain
versions at the card's tolerances.  No path calls them.
``ghost_norm_split_emulation`` does the same for the ghost-norm kernel's
tensor-core instance (bf16 x, f32 d split into two bf16 parts, feature
splits summed as scalars), and ``decode_attention_split_emulation`` for
the bf16 flash-decode kernel (its slot partition over warps and splits,
base-2 softmax, P in two bf16 parts, the fixed-order merges).

``selective_scan_ref`` is the mamba oracle and the model's
``ssm_mode="ref"`` path; ``selective_scan_kernel_ref``, kept apart from
it, is the plain version of the selective-scan *kernel* (the CPU path of
``kernels/ops.py``); ``selective_scan_step_ref`` is its one-token step,
the serving engine's mamba decode.  ``selective_scan_exp2_emulation``
repeats the CUDA
scan's order of arithmetic (exp2 of Δ·(A·log₂e) with decays below 2⁻¹²⁶
flushed to 0, y in two chains over the states, FMA where the kernel
contracts), optionally with every decay off by a few ulp as ex2.approx
may be: the tests hold it to a float64 oracle and to the JAX package's
kernel.  No path calls it.
"""
from __future__ import annotations

import math

import torch

# threads per block of kernels/csrc/per_example_sqnorm.cu and of
# kernels/csrc/flash_attention_bwd.cu (kThreads)
SQNORM_THREADS = 256
# the flash-attention backward's tiles (flash_attention_bwd.cu kKeys, kRows):
# 64 keys of one KV head, and 64 query rows, (position, head) pairs of one KV
# group (64 // rep positions times its rep heads)
ATTN_KEYS = 64
ATTN_ROWS = 64
# the bf16 score sweep (flash_attention_bwd.cu sweep16): 8-element pieces
# (kPiece, one 16-byte load), SWEEP16_PIECES of them a thread a chunk
# (kPieces), so a chunk is 256 * 8 * 8 = 16,384 elements of one span
SWEEP16_PIECE = 8
SWEEP16_PIECES = 8
SWEEP16_CHUNK = SQNORM_THREADS * SWEEP16_PIECES * SWEEP16_PIECE
# positions a tile of the ghost-norm kernel (ghost_norm.cu kTile) and
# features a k-tile of its tensor-core instance (tc::kKT)
GN_TILE = 64
GN_KTILE = 64
# the attention kernels' mask value (src/repro/kernels/flash_attention.py)
_NEG = -1e30
# log2(e) as the selective-scan kernel rounds it to f32 (kLog2e)
LOG2E = 1.4426950408889634
# the least normal f32: ex2.approx.ftz flushes smaller results to 0
FLT_MIN = 2.0 ** -126
# the bf16 flash-decode kernel's slots a warp takes a step (tc::kTile) and
# warps a block (tc::kWarps): tile j of a block's range goes to warp j % 4
DECODE_TILE = 16
DECODE_WARPS = 4
LN2 = 0.6931471805599453


# ----------------------------------------------------- per-example sq-norms
def per_example_sqnorm_ref(x: torch.Tensor, d: torch.Tensor,
                           with_bias: bool = True) -> torch.Tensor:
    """Paper Proposition 1 (rank-1 / MLP case).

    x: (B, d_in) layer inputs, d: (B, d_out) = dL/dY.  Returns (B,) f32:
    ||x_n||² ||d_n||² (+ ||d_n||² for the bias)."""
    xs = torch.sum(torch.square(x.float()), dim=-1)
    ds = torch.sum(torch.square(d.float()), dim=-1)
    out = xs * ds
    if with_bias:
        out = out + ds
    return out


def ghost_norm_ref(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Ghost norm of a layer shared over the sequence, Gram form.

    x: (B, S, d_in), d: (B, S, d_out) = dL/dY.  The per-example gradient
    of the shared W is G_n = x_nᵀ d_n, and ||G_n||²_F = <x_n x_nᵀ, d_n d_nᵀ>_F.
    Returns (B,) float32."""
    x = x.float()
    d = d.float()
    gx = torch.einsum("bsk,btk->bst", x, x)
    gd = torch.einsum("bsk,btk->bst", d, d)
    return torch.sum(gx * gd, dim=(1, 2))


def ghost_norm_direct_ref(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The same quantity through the materialized per-example gradient
    (O(S·din·dout) work, a (B, din, dout) f32 buffer): the second oracle,
    and the path when S(d_in+d_out) > d_in·d_out."""
    g = torch.einsum("bsi,bso->bio", x.float(), d.float())
    return torch.sum(torch.square(g), dim=(1, 2))


def per_example_sqnorm_multi_ref(xs, ds, with_bias: bool = True
                                 ) -> torch.Tensor:
    """Multi-tap oracle: Σ_t per_example_sqnorm_ref(xs[t], ds[t]), chained
    in tap order."""
    out = torch.zeros(xs[0].shape[0], dtype=torch.float32,
                      device=xs[0].device)
    for x, d in zip(xs, ds):
        out = out + per_example_sqnorm_ref(x, d, with_bias=with_bias)
    return out


def _thread_tree(acc: torch.Tensor) -> torch.Tensor:
    """(R, 256) per-thread sums → (R,) as the CUDA kernels reduce a block:
    a shuffle-down tree inside each warp (lane offsets 16, 8, 4, 2, 1),
    then one over the 8 warps (4, 2, 1)."""
    v = acc.reshape(acc.shape[0], SQNORM_THREADS // 32, 32)
    while v.shape[-1] > 1:               # lanes: off = 16, 8, 4, 2, 1
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    v = v[..., 0]                        # (R, warps)
    while v.shape[-1] > 1:               # warps: off = 4, 2, 1
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def _blocked_sumsq(a: torch.Tensor) -> torch.Tensor:
    """(B, n) → (B,) Σa² in the CUDA kernels' order (``per_example_sqnorm.cu``
    and ``tile_sumsq`` of ``flash_attention_bwd.cu``, both 256 threads):
    thread t sums elements t, t+T, ... in sequence (zero padding adds exact
    +0), then a shuffle-down tree inside each warp and one over the warps."""
    b, n = a.shape
    a = torch.nn.functional.pad(a.float(), (0, (-n) % SQNORM_THREADS))
    a = a.reshape(b, -1, SQNORM_THREADS)
    acc = torch.zeros(b, SQNORM_THREADS, dtype=torch.float32, device=a.device)
    for j in range(a.shape[1]):
        v = a[:, j]
        acc = acc + v * v
    return _thread_tree(acc)


def per_example_sqnorm_blocked(x: torch.Tensor, d: torch.Tensor,
                               with_bias: bool = True) -> torch.Tensor:
    """``per_example_sqnorm_ref`` in the CUDA kernel's exact order."""
    xs, ds = _blocked_sumsq(x), _blocked_sumsq(d)
    out = xs * ds
    if with_bias:
        out = out + ds
    return out


def per_example_sqnorm_multi_blocked(xs, ds, with_bias: bool = True
                                     ) -> torch.Tensor:
    """The multi-tap kernel emulated: each tap's row in the single-tap
    kernel's order, then res = row_0 and res = res + row_t in tap order,
    the chain the kernel runs in its launch (and across its launches
    past 32 taps)."""
    res = per_example_sqnorm_blocked(xs[0], ds[0], with_bias)
    for x, d in zip(xs[1:], ds[1:]):
        res = res + per_example_sqnorm_blocked(x, d, with_bias)
    return res


# --------------------------------------------------------- flash attention
def _causal_window(q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: int) -> torch.Tensor:
    """(Q, K) bool: key k_pos visible from query q_pos."""
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0) -> torch.Tensor:
    """Causal GQA attention oracle. q:(B,S,H,hd) k,v:(B,S,Hkv,hd)."""
    bsz, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = hd ** -0.5
    qg = q.reshape(bsz, s, hkv, rep, hd).float() * scale
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    pos = torch.arange(s, device=q.device)
    mask = _causal_window(pos, pos, window)
    logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(bsz, s, h, hd).to(q.dtype)


def flash_attention_kernel_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, window: int = 0,
                               return_lse: bool = False,
                               q_chunk: int = 512):
    """The flash-attention kernel's function in plain PyTorch
    (``src/repro/kernels/flash_attention.py``): q in f32 times the scale
    before the dot, ``_NEG`` masking, p = exp(s − m)·mask, output
    o / max(l, 1e-20) in q's dtype and, with ``return_lse``, the (B, H, S)
    f32 logsumexp m + log(max(l, 1e-20)).  Query rows are independent, so
    they are taken ``q_chunk`` at a time: the (S, S) logits of all heads
    never exist at once."""
    bsz, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = hd ** -0.5
    qg = q.reshape(bsz, s, hkv, rep, hd).float() * scale
    kf, vf = k.float(), v.float()
    pos = torch.arange(s, device=q.device)
    outs, lses = [], []
    for lo in range(0, s, q_chunk):
        qc = qg[:, lo:lo + q_chunk]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qc, kf)
        mask = _causal_window(pos[lo:lo + q_chunk], pos, window)
        logits = torch.where(mask, logits, _NEG)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None]) * mask
        denom = torch.clamp(p.sum(dim=-1), min=1e-20)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p, vf)
        outs.append(o / denom.permute(0, 3, 1, 2)[..., None])
        lses.append(m + torch.log(denom))                    # (B,g,r,qc)
    o = torch.cat(outs, dim=1).reshape(bsz, s, h, hd).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.cat(lses, dim=-1).reshape(bsz, h, s)


def attn_grad_sqnorm_ref(dq: torch.Tensor, dk: torch.Tensor,
                         dv: torch.Tensor) -> torch.Tensor:
    """Oracle of the fused score tap: per-example ||dQ_n||² + ||dK_n||² +
    ||dV_n||² over the (S, H, hd) axes, (B,) f32."""
    def _sq(a):
        return torch.sum(torch.square(a.float()), dim=(1, 2, 3))
    return _sq(dq) + _sq(dk) + _sq(dv)


def _attn_score_blocked(dq: torch.Tensor, dk: torch.Tensor,
                        dv: torch.Tensor) -> torch.Tensor:
    """The (B,) score ||dQ||² + ||dK||² + ||dV||² in the order of
    ``flash_attention_bwd.cu``: one ``_blocked_sumsq`` partial per tile —
    ||dK tile||² + ||dV tile||² for each (KV head g, 64-key tile) and
    ||dQ tile||² for each (g, 64-row tile) — then the dK/dV partials summed
    in (g, tile) order, the dQ partials likewise, and the two sums added.
    Both plain versions reduce through it, so their scores are equal
    bitwise; on the card the two kernels share the same order."""
    bsz, s, h, hd = dq.shape
    hkv = dk.shape[2]
    rep = h // hkv
    nk = -(-s // ATTN_KEYS)
    bq = ATTN_ROWS // rep
    nq = -(-s // bq)

    def key_tiles(a):                   # (B,S,Hkv,hd) → (B·Hkv·nk, 64·hd)
        a = torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0,
                                                nk * ATTN_KEYS - s))
        a = a.reshape(bsz, nk, ATTN_KEYS, hkv, hd).permute(0, 3, 1, 2, 4)
        return a.reshape(bsz * hkv * nk, ATTN_KEYS * hd)

    kv = (_blocked_sumsq(key_tiles(dk)) + _blocked_sumsq(key_tiles(dv)))
    kv = kv.reshape(bsz, hkv * nk)
    # rows (position, head) of a tile; dead rows are the zero padding
    a = torch.nn.functional.pad(dq.float(), (0, 0, 0, 0, 0, nq * bq - s))
    a = a.reshape(bsz, nq, bq, hkv, rep, hd).permute(0, 3, 1, 2, 4, 5)
    qp = _blocked_sumsq(a.reshape(bsz * hkv * nq, bq * rep * hd))
    qp = qp.reshape(bsz, hkv * nq)
    skv = torch.zeros(bsz, dtype=torch.float32, device=dq.device)
    for t in range(kv.shape[1]):
        skv = skv + kv[:, t]
    sq = torch.zeros(bsz, dtype=torch.float32, device=dq.device)
    for t in range(qp.shape[1]):
        sq = sq + qp[:, t]
    return skv + sq


def flash_attention_bwd_kernel_ref(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor,
                                   window: int = 0, with_scores: bool = False,
                                   q_chunk: int = 512):
    """The flash-attention backward kernel's function in plain PyTorch
    (``src/repro/kernels/flash_attention_bwd.py::flash_attention_bwd``):
    D = rowsum(dO∘O) in f32, p = exp(where(mask, (q·scale)·kᵀ, _NEG) − lse)
    ·mask with q times the scale in f32 before the dot, dV = PᵀdO,
    dS = P∘(dO·Vᵀ − D), dQ = scale·dS·K, dK = scale·dSᵀ·Q, dK and dV summed
    over the rep query heads of each KV head.  Returns (dq, dk, dv) in the
    operands' dtypes and, with ``with_scores``, the (B,) f32 score of the
    f32 gradients before the cast (``_attn_score_blocked``).  Query rows
    are taken ``q_chunk`` at a time."""
    bsz, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = hd ** -0.5
    qf = q.reshape(bsz, s, hkv, rep, hd).float()
    dof = do.reshape(bsz, s, hkv, rep, hd).float()
    dvec = torch.sum(dof * o.reshape(bsz, s, hkv, rep, hd).float(), dim=-1)
    lse_g = lse.reshape(bsz, hkv, rep, s)
    kf, vf = k.float(), v.float()
    pos = torch.arange(s, device=q.device)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for lo in range(0, s, q_chunk):
        hi = min(lo + q_chunk, s)
        qc, doc = qf[:, lo:hi], dof[:, lo:hi]
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qc * scale, kf)
        mask = _causal_window(pos[lo:hi], pos, window)
        logits = torch.where(mask, logits, _NEG)
        p = torch.exp(logits - lse_g[..., lo:hi, None]) * mask
        dv = dv + torch.einsum("bgrqk,bqgrd->bkgd", p, doc)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", doc, vf)
        ds = p * (dp - dvec[:, lo:hi].permute(0, 2, 3, 1)[..., None])
        dq[:, lo:hi] = scale * torch.einsum("bgrqk,bkgd->bqgrd", ds, kf)
        dk = dk + scale * torch.einsum("bgrqk,bqgrd->bkgd", ds, qc)
    dq = dq.reshape(bsz, s, h, hd)
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if with_scores:
        return grads + (_attn_score_blocked(dq, dk, dv),)
    return grads


def attn_score_sweep_kernel_ref(dq: torch.Tensor, dk: torch.Tensor,
                                dv: torch.Tensor) -> torch.Tensor:
    """The score-sweep kernel's function in plain PyTorch
    (``flash_attention_bwd.py::attn_score_sweep``): the (B,) f32
    ||dQ||² + ||dK||² + ||dV||² of materialized gradients, reduced as the
    fused score is, so for f32 gradients the two are bitwise equal."""
    return _attn_score_blocked(dq, dk, dv)


def _sweep16_partials(a: torch.Tensor) -> torch.Tensor:
    """(B, n) spans → (B, chunks) partials of the bf16 sweep kernel: chunk
    c holds elements [c·C, (c+1)·C), C = ``SWEEP16_CHUNK``; thread t takes
    the 8-element pieces t, t+256, ... of its chunk and adds each piece's
    squares in element order (zero padding past n adds exact +0), then
    ``_thread_tree``."""
    b, n = a.shape
    nc = -(-n // SWEEP16_CHUNK)
    a = torch.nn.functional.pad(a.float(), (0, nc * SWEEP16_CHUNK - n))
    a = a.reshape(b * nc, SWEEP16_PIECES, SQNORM_THREADS, SWEEP16_PIECE)
    acc = torch.zeros(b * nc, SQNORM_THREADS, dtype=torch.float32,
                      device=a.device)
    for k in range(SWEEP16_PIECES):
        for j in range(SWEEP16_PIECE):
            v = a[:, k, :, j]
            acc = acc + v * v
    return _thread_tree(acc).reshape(b, nc)


def attn_score_sweep_bf16_blocked(dq: torch.Tensor, dk: torch.Tensor,
                                  dv: torch.Tensor) -> torch.Tensor:
    """The bf16 score-sweep kernel's (B,) ||dQ||² + ||dK||² + ||dV||² in its
    exact order: each example's dq, dk and dv as flat spans cut into
    chunks (``_sweep16_partials``), the partials concatenated (dq's, dk's,
    dv's), then thread t of one block sums partials t, t+256, ... in order
    and ``_thread_tree`` adds the threads.  No path calls it: on the card
    the bf16 sweep kernel equals it bitwise."""
    b = dq.shape[0]
    parts = torch.cat([_sweep16_partials(a.reshape(b, -1))
                       for a in (dq, dk, dv)], dim=1)
    n = parts.shape[1]
    parts = torch.nn.functional.pad(parts, (0, (-n) % SQNORM_THREADS))
    parts = parts.reshape(b, -1, SQNORM_THREADS)
    acc = torch.zeros(b, SQNORM_THREADS, dtype=torch.float32,
                      device=dq.device)
    for i in range(parts.shape[1]):
        acc = acc + parts[:, i]
    return _thread_tree(acc)


# ---------------------------------- the bf16 tensor-core kernels' arithmetic
def split_bf16(x: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """An f32 tensor as a sum of bf16 parts, each the bf16 rounding of what
    the earlier ones leave (the differences are exact in f32): two parts
    keep a normal x to about 2^-17 of its value, three to about 2^-26."""
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16))
        x = x - out[-1].float()
    return out


def _split_einsum(eq: str, x: torch.Tensor, y: torch.Tensor,
                  parts: int) -> torch.Tensor:
    """einsum(eq, x, y) for an f32 x and a bf16-exact y as the kernels take
    it: one product for each of x's bf16 parts, summed in f32."""
    return sum(torch.einsum(eq, p.float(), y) for p in split_bf16(x, parts))


def flash_attention_split_emulation(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, window: int = 0):
    """The bf16 forward kernel's arithmetic (``flash_fwd_tc``): S = q·kᵀ of
    the bf16 operands in f32, times the scale after the product; the online
    softmax over 64-key tiles in f32 with ``_NEG`` masking; O += P_hi·V +
    P_lo·V in f32 (P split in two); l sums the f32 P.  Returns the output
    in q's dtype and the (B, H, S) f32 logsumexp."""
    bsz, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = hd ** -0.5
    qf = q.float().reshape(bsz, s, hkv, rep, hd)
    kf, vf = k.float(), v.float()
    pos = torch.arange(s, device=q.device)
    m = torch.full((bsz, hkv, rep, s), _NEG, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(bsz, hkv, rep, s, hd, device=q.device)
    for k0 in range(0, s, ATTN_KEYS):
        kc, vc = kf[:, k0:k0 + ATTN_KEYS], vf[:, k0:k0 + ATTN_KEYS]
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qf, kc) * scale
        mask = _causal_window(pos, pos[k0:k0 + ATTN_KEYS], window)
        sc = torch.where(mask, sc, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + _split_einsum("bgrqk,bkgd->bgrqd", p, vc,
                                                 2)
        m = m_new
    denom = torch.clamp(l, min=1e-20)
    out = (o / denom[..., None]).permute(0, 3, 1, 2, 4).reshape(bsz, s, h, hd)
    return out.to(q.dtype), (m + torch.log(denom)).reshape(bsz, h, s)


def flash_attention_bwd_split_emulation(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor, o: torch.Tensor,
                                        lse: torch.Tensor, do: torch.Tensor,
                                        window: int = 0):
    """The bf16 backward kernels' arithmetic (``dkdv_tc``, ``dq_tc``): S and
    dP from the bf16 operands in f32, the scale after q·kᵀ, P = exp(S·scale −
    lse) and dS = P∘(dP − D) in f32 and masked, then dV = Pᵀ·dO (P split
    into three bf16 parts), dK = scale·dSᵀ·Q and dQ = scale·dS·K (dS split
    into two), one product a part, summed in f32.  Returns (dq, dk, dv) in
    the operands' dtypes."""
    bsz, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = hd ** -0.5
    qf = q.float().reshape(bsz, s, hkv, rep, hd)
    dof = do.float().reshape(bsz, s, hkv, rep, hd)
    dvec = torch.sum(dof * o.float().reshape(bsz, s, hkv, rep, hd), dim=-1)
    kf, vf = k.float(), v.float()
    pos = torch.arange(s, device=q.device)
    mask = _causal_window(pos, pos, window)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(sc - lse.reshape(bsz, hkv, rep, s)[
        ..., None]), 0.0)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dof, vf)
    ds = torch.where(mask, p * (dp - dvec.permute(0, 2, 3, 1)[..., None]),
                     0.0)
    dv = _split_einsum("bgrqk,bqgrd->bkgd", p, dof, 3)
    dk = scale * _split_einsum("bgrqk,bqgrd->bkgd", ds, qf, 2)
    dq = scale * _split_einsum("bgrqk,bkgd->bqgrd", ds, kf, 2)
    return (dq.reshape(bsz, s, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def ghost_norm_split_emulation(x: torch.Tensor, d: torch.Tensor,
                               splits: int = 1, symmetric: bool = False,
                               d_parts: int | None = None) -> torch.Tensor:
    """The ghost-norm tensor-core instance's arithmetic (``ghost_norm.cu``,
    namespace ``tc``) on a bf16 x: the x Gram tiles A_ij of the 64-position
    tiles of the bf16-exact x in f32; d as a sum of bf16 parts
    (``split_bf16``: two for an f32 d, one for a bf16 d, or ``d_parts``),
    the d Gram as the products p_a·p_bᵀ with a + b < parts (hi·hiᵀ + hi·loᵀ +
    lo·hiᵀ for two) over each of ``splits`` feature ranges (split c takes the
    64-feature k-tiles [c·n/splits, (c+1)·n/splits), empty when splits > n);
    then ⟨A_ij, B_ij,c⟩ summed over the splits of a pair in order and over
    the pairs in order, j > i counted twice when ``symmetric`` (which visits
    only j ≥ i).  Positions past S are zeros, as TMA reads them.  Returns
    (R,) f32."""
    rows, s, din = x.shape
    dout = d.shape[2]
    ns = -(-s // GN_TILE)
    pad = ns * GN_TILE - s

    def tiles(a):                          # (R, S, w) → (R, ns, 64, w)
        a = torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
        return a.reshape(rows, ns, GN_TILE, a.shape[-1])

    xt = tiles(x)
    gx = torch.einsum("bisk,bjtk->bijst", xt, xt)
    if d_parts is None:
        d_parts = 1 if d.dtype == torch.bfloat16 else 2
    parts = [tiles(p) for p in split_bf16(d.float(), d_parts)]
    n_kt = -(-dout // GN_KTILE)
    contrib = []
    for c in range(splits):
        k0 = c * n_kt // splits * GN_KTILE
        k1 = min((c + 1) * n_kt // splits * GN_KTILE, dout)
        gd = sum(torch.einsum("bisk,bjtk->bijst", parts[a][..., k0:k1],
                              parts[b][..., k0:k1])
                 for a in range(d_parts) for b in range(d_parts - a))
        contrib.append(torch.sum(gx * gd, dim=(3, 4)))   # (R, ns, ns)
    out = torch.zeros(rows, dtype=torch.float32, device=x.device)
    for i in range(ns):
        for j in range(i if symmetric else 0, ns):
            pair = contrib[0][:, i, j]
            for c in range(1, splits):
                pair = pair + contrib[c][:, i, j]
            out = out + (2.0 * pair if symmetric and j > i else pair)
    return out


# -------------------------------------------------------- decode attention
def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length=None) -> torch.Tensor:
    """One-token GQA attention against a KV cache (flash-decode oracle).
    q:(B,H,hd) k,v:(B,S,Hkv,hd) length:(B,) valid prefix lengths."""
    bsz, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = 1.0 / (hd ** 0.5)
    qg = (q.float() * scale).reshape(bsz, hkv, rep, hd)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k.float())
    if length is not None:
        pos = torch.arange(k.shape[1], device=q.device)
        mask = pos[None, None, None, :] < length[:, None, None, None]
        logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", p, v.float())
    return o.reshape(bsz, h, hd).to(q.dtype)


def decode_attention_kernel_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The flash-decode kernel's function in plain PyTorch
    (``src/repro/kernels/decode_attention.py``): ``_NEG`` masking,
    p = exp(s − m)·mask and o / max(l, 1e-20), so a row of length 0 gives
    zeros.  Returns (B, H, hd) in q's dtype."""
    bsz, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    scale = 1.0 / (hd ** 0.5)
    qg = (q.float() * scale).reshape(bsz, hkv, rep, hd)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k.float())
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, None, None, :] < lengths[:, None, None, None]
    logits = torch.where(mask, logits, _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    o = torch.einsum("bgrs,bsgd->bgrd", p, v.float()) / denom
    return o.reshape(bsz, h, hd).to(q.dtype)


def decode_attention_split_emulation(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, lengths: torch.Tensor,
                                     chunk: int) -> torch.Tensor:
    """The bf16 flash-decode kernel's arithmetic (``decode_attention.cu``,
    namespace ``tc``).  Block ``split`` of (b, g) takes slots [split·chunk,
    min((split + 1)·chunk, len_b)) in 16-slot tiles, tile j to warp j % 4.
    A warp: S = q·kᵀ of the bf16 operands in f32, times scale·log₂e after
    the product; an online softmax in base 2 with ``_NEG`` past the length;
    O = O·α + P_hi·V + P_lo·V (P split in two bf16 parts); l sums the f32
    P.  The block merges its warps in order (M = max m_w, c_w = 2^(m_w −
    M)) and keeps m = M·ln 2; the live splits merge in split order with
    e^(m_s − M) as the SIMT merge does; out = O / max(L, 1e-20) in q's
    dtype, zeros for a row of length 0."""
    bsz, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    dev = q.device
    n_split = -(-s // chunk)
    steps = -(-chunk // (DECODE_TILE * DECODE_WARPS))
    tiles = steps * DECODE_WARPS
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    scale_log2 = f32(1.0 / (hd ** 0.5)) * f32(LOG2E)
    lens = torch.clamp(lengths.to(dev).long(), 0, s)
    # slot of (split, tile, i) and whether the kernel reads it
    off = torch.arange(tiles * DECODE_TILE, device=dev)
    pos = (torch.arange(n_split, device=dev)[:, None] * chunk
           + off).reshape(n_split, tiles, DECODE_TILE)
    valid = ((off < chunk).reshape(tiles, DECODE_TILE)
             & (pos[None] < lens[:, None, None, None]))  # (B, n, T, 16)
    idx = torch.clamp(pos, max=s - 1)
    kz = torch.where(valid[..., None, None], k.float()[:, idx], 0.0)
    vz = torch.where(valid[..., None, None], v.float()[:, idx], 0.0)
    # (B, n, steps, warps, 16, Hkv, hd): step i of warp w is tile 4i + w
    shape = (bsz, n_split, steps, DECODE_WARPS, DECODE_TILE, hkv, hd)
    kz, vz = kz.reshape(shape), vz.reshape(shape)
    valid = valid.reshape(bsz, n_split, 1, steps, DECODE_WARPS, 1,
                          DECODE_TILE)
    qf = q.float().reshape(bsz, hkv, rep, hd)
    m = torch.full((bsz, n_split, hkv, DECODE_WARPS, rep), _NEG, device=dev)
    l = torch.zeros_like(m)
    o = torch.zeros(*m.shape, hd, device=dev)
    for i in range(steps):
        sc = torch.einsum("bgrd,bnwtgd->bngwrt", qf, kz[:, :, i])
        ok = valid[:, :, :, i]
        sc = torch.where(ok, sc * scale_log2, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + _split_einsum(
            "bngwrt,bnwtgd->bngwrd", p, vz[:, :, i], 2)
        m = m_new
    # the block: its warps in order
    mb = m.amax(dim=3)
    c = torch.exp2(m - mb[:, :, :, None])
    lb = torch.zeros_like(mb)
    ob = torch.zeros_like(o[:, :, :, 0])
    for w in range(DECODE_WARPS):
        lb = lb + l[:, :, :, w] * c[:, :, :, w]
        ob = ob + o[:, :, :, w] * c[:, :, :, w, :, None]
    mb = mb * f32(LN2)
    # the splits: the live ones, in order
    live = torch.minimum(torch.full_like(lens, n_split),
                         (lens + chunk - 1) // chunk)
    alive = (torch.arange(n_split, device=dev)[None] < live[:, None])[
        :, :, None, None]                                  # (B, n, 1, 1)
    mx = torch.where(alive, mb, _NEG).amax(dim=1)
    lsum = torch.zeros_like(mx)
    osum = torch.zeros_like(ob[:, 0])
    for sp in range(n_split):
        wgt = torch.where(alive[:, sp], torch.exp(mb[:, sp] - mx), 0.0)
        lsum = lsum + lb[:, sp] * wgt
        osum = osum + ob[:, sp] * wgt[..., None]
    out = osum / torch.clamp(lsum, min=1e-20)[..., None]
    return out.reshape(bsz, h, hd).to(q.dtype)


# --------------------------------------------------------- selective scan
def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                       return_state: bool = False,
                       scan_dtype: torch.dtype = torch.float32):
    """Mamba-1 selective SSM scan, the sequential oracle and the model's
    ``ssm_mode="ref"`` path (differentiable by autograd).

    u, delta: (B, S, d_inner) (delta already softplus'd, > 0); a:
    (d_inner, d_state) (negative, the continuous A); b, c:
    (B, S, d_state); d: (d_inner,) skip connection.
        h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + (Δ_t ⊙ u_t) ⊗ B_t
        y_t = (h_t · C_t) + D ⊙ u_t
    Returns y (B, S, d_inner) in u's dtype, and with ``return_state`` the
    final (B, d_inner, d_state) state.  ``scan_dtype`` is the precision
    of the recurrence and its inputs, as in the reference (whose
    ``lax.scan`` unroll has no counterpart in eager PyTorch)."""
    u32, dl32 = u.to(scan_dtype), delta.to(scan_dtype)
    b32, c32 = b.to(scan_dtype), c.to(scan_dtype)
    a32 = a.to(scan_dtype)
    bsz, s, di = u.shape
    h = torch.zeros(bsz, di, a.shape[-1], dtype=scan_dtype, device=u.device)
    ys = []
    for t in range(s):
        dl_t, u_t = dl32[:, t], u32[:, t]
        da = torch.exp(dl_t[..., None] * a32[None])
        h = h * da + (dl_t * u_t)[..., None] * b32[:, t, None, :]
        ys.append(torch.sum(h * c32[:, t, None, :], dim=-1))
    y = (torch.stack(ys, dim=1) + u32 * d.float()[None, None]).to(u.dtype)
    if return_state:
        return y, h
    return y


def selective_scan_step_ref(h: torch.Tensor, u_t: torch.Tensor,
                            delta_t: torch.Tensor, a: torch.Tensor,
                            b_t: torch.Tensor, c_t: torch.Tensor,
                            d: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the same recurrence. h: (B, d_inner, d_state)
    f32; u_t, delta_t: (B, d_inner); b_t, c_t: (B, d_state).  Returns the
    new f32 state and y_t (B, d_inner) in u_t's dtype."""
    dl = delta_t.float()
    da = torch.exp(dl[..., None] * a.float()[None])
    h = h * da + (dl * u_t.float())[..., None] * b_t.float()[:, None, :]
    y = torch.sum(h * c_t.float()[:, None, :], dim=-1)
    y = y + u_t.float() * d.float()[None]
    return h, y.to(u_t.dtype)


def selective_scan_kernel_ref(u: torch.Tensor, delta: torch.Tensor,
                              a: torch.Tensor, b: torch.Tensor,
                              c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The selective-scan kernel's function in plain PyTorch
    (``src/repro/kernels/selective_scan.py::_kernel``): the oracle at f32
    scan dtype.  A name of its own, so that the kernel's plain version can
    be told apart from the model's ref path."""
    return selective_scan_ref(u, delta, a, b, c, d)


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """f32 fused multiply-add: the product of two f32 values is exact in
    f64, so one f64 add and the f32 cast round as an FMA does (the double
    rounding differs only on ties that the f64 add leaves, which are rare)."""
    return (x.double() * y.double() + z.double()).float()


def ex2_ftz(x: torch.Tensor, ulps: int = 0) -> torch.Tensor:
    """The scan kernel's ``ex2.approx.ftz.f32`` of f32 ``x`` as the tests
    bound it: torch.exp2 moved ``ulps`` units in the last place (up where
    positive, down where negative; the instruction is documented within 2
    ulp), then results below 2⁻¹²⁶ flushed to 0.  (Subnormal inputs, which
    ftz also flushes, give 1 either way.)"""
    y = torch.exp2(x)
    towards = torch.full_like(y, math.inf if ulps > 0 else -math.inf)
    for _ in range(abs(ulps)):
        y = torch.nextafter(y, towards)
    return torch.where(y < FLT_MIN, torch.zeros_like(y), y)


def selective_scan_exp2_emulation(u: torch.Tensor, delta: torch.Tensor,
                                  a: torch.Tensor, b: torch.Tensor,
                                  c: torch.Tensor, d: torch.Tensor,
                                  ulps: int = 0) -> torch.Tensor:
    """The CUDA selective scan's arithmetic (``selective_scan.cu``) in f32
    on the CPU: A′ = A·log₂e once, each decay ``ex2_ftz(Δ_t·A′, ulps)``,
    h_k = FMA(h_k, decay, (Δ_t·u_t)·B_k); y's sum runs FMA(h_k, C_k, acc)
    in two partials, the even-indexed and the odd-indexed states each in
    order, added at the end; y_t = FMA(D, u_t, sum).  ``ulps`` = ±2 is the
    worst case of the card's ex2.approx for every decay at once; 0 is
    exact exp2 (the result is then the kernel's order, not its bits).
    Returns y (B, S, d_inner) in u's dtype."""
    bsz, s, di = u.shape
    ds = a.shape[-1]
    u32, dl32, b32, c32 = (t.float() for t in (u, delta, b, c))
    a2 = a.float() * torch.tensor(LOG2E, dtype=torch.float32)
    d32 = d.float()[None]
    h = torch.zeros(bsz, di, ds)
    ys = []
    for t in range(s):
        dl_t = dl32[:, t, :, None]
        du = (dl32[:, t] * u32[:, t])[..., None]
        h = _fma(h, ex2_ftz(dl_t * a2[None], ulps), du * b32[:, t, None, :])
        ct = c32[:, t, None, :].expand(bsz, di, ds)
        parts = []
        for first in (0, 1):
            part = h[..., first] * ct[..., first]
            for k in range(first + 2, ds, 2):
                part = _fma(h[..., k], ct[..., k], part)
            parts.append(part)
        ys.append(_fma(d32.expand(bsz, di), u32[:, t], parts[0] + parts[1]))
    return torch.stack(ys, dim=1).to(u.dtype)
