// FlashAttention-2 backward of causal (optionally sliding-window) GQA
// attention, with an optional per-example score, and the score's
// separate-pass twin:
//
//   D   = rowsum(dO o O)                      (the wrapper, in PyTorch)
//   P   = exp(q.k * scale - lse) * mask
//   dV  = P^T dO
//   dS  = P o (dO V^T - D)
//   dQ  = scale * dS K,   dK = scale * dS^T Q
//   score[b] = ||dQ_b||^2 + ||dK_b||^2 + ||dV_b||^2   (from the f32 values)
//
// q, dO, O (B, S, H, hd), k, v (B, S, Hkv, hd) with rope applied, lse (B, H, S)
// f32 from the forward kernel, rep = H / Hkv; dK and dV of a KV head sum over
// its rep query heads.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention_bwd.py:
//   flash_attention_bwd (_dkdv_kernel, _dq_kernel)    -> fab_launch
//   attn_score_sweep (_sweep_kv_kernel, _sweep_q_kernel) -> fab_sweep_launch
// and computes their functions: masked entries give p = 0, the score taken
// from the f32 gradients before they are cast to the operands' type.
//
// The score sweep is bound by bytes: it reads dQ, dK and dV once, 75.5 MB
// at the trainer's shape below in bf16, 22.5 us at 3.35 TB/s.  Its f32
// instance repeats the fused epilogues' tiles (below), for fused == sweep
// bitwise.  Its bf16 instance (sweep16) has no such contract, and reads
// each example's dq, dk and dv as three flat spans cut into chunks of
// 16,384 elements: each thread loads its 8 pieces of 16 bytes of a chunk
// at once (neighbouring threads on neighbouring pieces) and the next
// chunk's before it adds this one's; a grid of as many blocks as stay
// resident walks the chunks; each chunk's squares go through fixed trees
// into its own partial, and a second launch adds an example's partials in
// one fixed order.  The partials do not depend on the grid, so two
// launches are bitwise equal, and ref.attn_score_sweep_bf16_blocked
// repeats the order.  A span's ragged last chunk, or a base off 16 bytes,
// takes the same order in scalar loads.  No element pays a division.
//
// What bounds the function on an H100: operations.  At the glm4-9b trainer's
// shape (B = 16, S = 512, H = 32, Hkv = 2, hd = 128, bf16) the backward needs
// five causal-half products, 10 B H hd S(S+1)/2 = 86 GFLOP, 0.087 ms on the
// bf16 tensor cores, against 286 MB of q, k, v, O, dO, lse, dQ, dK, dV
// (0.085 ms).  The dQ kernel recomputes S and dP (seven products in all);
// f32 FMA on the CUDA cores (67 TFLOP/s) cannot run them below ~1.8 ms, so
// the bf16 instance runs them on the tensor cores.
//
// Shared by both instances:
//   * the TPU dK/dV kernel ran a grid (B, Hkv, key blocks, q blocks x rep),
//     summing the rep heads' contributions and the score by revisiting the
//     same output block along a sequential axis.  CUDA blocks run in no
//     order, so here a 64-key tile of one (b, KV group g) stays in shared
//     memory and a loop walks the query tiles that see it.  A query tile is
//     64 rows, (position, head) pairs of group g (64 / rep positions times
//     all rep heads), the row mapping of the forward kernel
//     (flash_attention.cu), so every K/V tile serves every head of the
//     group.  dK and dV accumulate in f32 registers and are written once.
//   * the dQ kernel owns a 64-row tile and walks the key tiles, as the
//     forward does; no float atomics.  Tiles wholly in the past of the
//     window or wholly before the key tile are skipped without being loaded
//     (the Pallas kernels' `live` test).  Blocks are issued longest first.
//   * with a score, each 64-key tile of the dK/dV kernel and each 64-row
//     tile of the dQ kernel writes the sum of squares of its finished f32
//     accumulators into its own slot of an f32 scratch of per-tile partials
//     (slots: Plan), and a last small kernel sums a row's partials in one
//     fixed order: the dK/dV partials by (g, key tile), then the dQ partials
//     by (g, row tile), then the two sums, as the reference adds kv_res[2] +
//     q_res[1].  Two launches are bitwise equal.
//
// bf16: dkdv_tc and dq_tc, wgmma on tiles that TMA brings into shared
//   memory.  A block is two consumer warpgroups (256 threads, up to 255
//   registers each); thread 0 also issues the TMA loads, refilling a stage
//   of the ring once both warpgroups have released it (hopper::Ring).  A
//   separate producer warp or warpgroup would make the block 288 or 384
//   threads, and ptxas then holds every thread to 168 registers:
//   setmaxnreg did not raise the consumers' budget (measured on the card,
//   -Xptxas -v and the SASS), and the dK/dV warpgroup needs ~200.
//   * dK/dV: each consumer owns 64 keys (the M of its products); the
//     block's K and V tiles are loaded once and thread 0 streams the Q
//     and dO tiles of the query tiles that see them through a ring of
//     kKvStages stages (full/empty mbarriers).  Per query tile a consumer
//     computes S^T = K Q^T and dP^T = V dO^T by SS wgmma, P^T and dS^T in
//     registers (lse, D and each row's position staged by the consumer's
//     threads), and dV += P^T dO, dK += dS^T Q by RS wgmma with dO and Q
//     read MN-major; dK is scaled once at the end.
//   * dQ: each consumer owns one 64-row query tile (Q and dO loaded once),
//     thread 0 streams K and V tiles; S = Q K^T, dP = dO V^T by SS
//     wgmma, dQ += dS K by RS wgmma with K read MN-major, scaled at the end.
//   * tensors are mapped for TMA as 4-D (hd, heads, S, B): a query tile is
//     one box (hd chunk, rep, 64 / rep, 1), a key tile (hd chunk, 1, 64, 1);
//     S is a true bound, so the ragged tail reads as zeros.  Rows past
//     64 / rep * rep are never written by TMA and are zeroed once, and P
//     and dS are masked by selection, so 0 * garbage never reaches dV or dK.
//   * numerics: products of bf16 inputs (K Q^T, V dO^T) are exact up to
//     the f32 accumulation.  P and dS are f32; each is split into bf16
//     parts (split_tile: each part the rounding of what the earlier leave)
//     and its product is one wgmma a part.  The bf16 gradients are held
//     to half a bf16 ulp plus 1e-4 of the value and 1e-5, which leaves the
//     kernel's own error ~1e-4 of the value and ~1e-5 absolute.  dV sums
//     P dO, terms up to |dO| (P <= 1): two parts (2^-17 a term) reach
//     1e-5 on gradients near zero where P is large (rep 64, window 3: 192
//     terms of P ~ 1/3), so P takes three parts (2^-26).  dK and dQ carry
//     the scale and a Q or K factor; two parts keep them at the f32
//     kernel's error (the split emulation, tests/test_torch_flash_split.py).
//     The tensor cores' f32 accumulation truncates, ~3x the error of f32
//     adds (measured on the card); over the 1024 products that sum dV of
//     an early key at S = 512 that too would exceed the budget, so each
//     tile's contribution is summed by wgmma in a fresh accumulator and
//     added to the running dV, dK, dQ with f32 adds (tile_product).  The
//     running dK of the dK/dV kernel lives in shared memory, each thread
//     owning its entries, to leave the registers to dV, S, dP and the
//     fragments.  The scale multiplies S after the product.
//   * the score: each consumer reduces its f32 accumulators in one fixed
//     order of its own (wg_sumsq).  It does not repeat tile_sumsq's order:
//     fused == sweep bitwise is a contract of f32 gradients only.
//
// f32: dkdv_kernel and dq_kernel, f32 FMA on the CUDA cores (the f32 parity
//   path; wgmma has no f32 input that keeps f32 accuracy).  q is multiplied
//   by the scale before the dot.  256 threads in a 16 x 16 grid: thread
//   (ty, tx) computes S and dP of rows ty*4..ty*4+3 against keys tx, tx+16,
//   tx+32, tx+48.  All staged tiles are row-major with a row stride of hd + 1
//   floats (conflict-free column reads); P and dS tiles have rows of 68
//   floats (float4 reads).  Each score partial is reduced with tile_sumsq()
//   (round-to-nearest intrinsics, a fixed shuffle tree: no FMA contraction
//   can differ between kernels).  The f32 sweep reads the materialized dQ,
//   dK, dV with the same tiles, the same tile_sumsq() and the same reducer,
//   so for f32 gradients fused == sweep bitwise.  The ragged tail of S is
//   masked in the loads (keys and queries past S read as 0).
//
// Each entry point returns cudaGetLastError(); the wrapper raises if it is
// not cudaSuccess.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                 // query (position, head) rows a tile
constexpr int kKeys = 64;                 // keys a tile
constexpr int kThreads = 256;             // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kPLd = kKeys + 4;           // row of a P / dS tile (floats)
constexpr unsigned kFull = 0xffffffffu;

// Sum of squares of a tile's n elements (row-major order, n a multiple of
// kThreads), valid in thread 0: thread t sums elements t, t + kThreads, ...
// in order, then a shuffle-down tree in each warp and one over the warps.
// The fused epilogues and the f32 sweep call it with the same tiles, so their
// partials are bitwise equal; ref._blocked_sumsq repeats it in PyTorch.
template <typename Get>
__device__ float tile_sumsq(Get get, int n, float* red) {
  float acc = 0.0f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float v = get(e);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();                        // red of an earlier call is read
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  float res = 0.0f;
  if (warp == 0) {
    res = lane < kWarps ? red[lane] : 0.0f;
    for (int off = kWarps / 2; off > 0; off >>= 1)
      res = __fadd_rn(res, __shfl_down_sync(kFull, res, off));
  }
  return res;
}

// Row i of a query tile: position q0 + i / rep, head g*rep + i % rep; live
// when i < 64 / rep * rep and the position is inside S.
struct RowTile {
  int rep, live_rows;
  __device__ bool live(int i, int pos, int s) const {
    return i < live_rows && pos < s;
  }
};

// Stage 64 query rows of tile q0 (positions) of group g from src into
// dst[row][d] (row stride hd + 1), times mul; dead rows as 0.
template <int HD>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int b,
                                           int g, int s, int h, int q0,
                                           RowTile rt, float mul, float* dst) {
  for (int e = threadIdx.x; e < kRows * HD; e += kThreads) {
    const int row = e / HD;
    const int d = e % HD;
    const int pos = q0 + row / rt.rep;
    float val = 0.0f;
    if (rt.live(row, pos, s))
      val = src[((static_cast<size_t>(b) * s + pos) * h + g * rt.rep +
                 row % rt.rep) * HD + d] * mul;
    dst[row * (HD + 1) + d] = val;
  }
}

// Stage keys [k0, k0 + 64) of group g into dst[j][d] (row stride hd + 1);
// keys at or past S as 0.
template <int HD>
__device__ __forceinline__ void stage_keys(const float* __restrict__ src, int b,
                                           int g, int s, int hkv, int k0,
                                           float* dst) {
  for (int e = threadIdx.x; e < kKeys * HD; e += kThreads) {
    const int j = e / HD;
    const int d = e % HD;
    const int kp = k0 + j;
    dst[j * (HD + 1) + d] =
        kp < s ? src[((static_cast<size_t>(b) * s + kp) * hkv + g) * HD + d]
               : 0.0f;
  }
}

// lse and D of the tile's rows (dead rows 0).
__device__ __forceinline__ void stage_row_stats(const float* __restrict__ lse,
                                                const float* __restrict__ dvec,
                                                int b, int g, int s, int h,
                                                int q0, RowTile rt,
                                                float* lse_s, float* dvec_s) {
  for (int row = threadIdx.x; row < kRows; row += kThreads) {
    const int pos = q0 + row / rt.rep;
    float l = 0.0f, dd = 0.0f;
    if (rt.live(row, pos, s)) {
      const size_t i =
          (static_cast<size_t>(b) * h + g * rt.rep + row % rt.rep) * s + pos;
      l = lse[i];
      dd = dvec[i];
    }
    lse_s[row] = l;
    dvec_s[row] = dd;
  }
}

// P and dS of rows ty*4+a against keys tx+16c of one (query tile, key tile)
// pair, from row-major staged q*scale, dO, K and V; masked entries are 0.
template <int HD>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* do_s,
                                         const float* k_s, const float* v_s,
                                         const float* lse_s,
                                         const float* dvec_s, int q0, int k0,
                                         int s, int window, RowTile rt,
                                         float pv[4][4], float dsv[4][4]) {
  constexpr int kLd = HD + 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = q_s[(ty * 4 + a) * kLd + d];
      da[a] = do_s[(ty * 4 + a) * kLd + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kb[c] = k_s[(tx + 16 * c) * kLd + d];
      vb[c] = v_s[(tx + 16 * c) * kLd + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[a][c] = fmaf(qa[a], kb[c], sc[a][c]);
        dp[a][c] = fmaf(da[a], vb[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = ty * 4 + a;
    const int pos = q0 + row / rt.rep;
    const bool live = rt.live(row, pos, s);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kp = k0 + tx + 16 * c;
      const bool ok = live && kp <= pos && kp < s &&
                      (window <= 0 || pos - kp < window);
      const float p = ok ? expf(sc[a][c] - lse_s[row]) : 0.0f;
      pv[a][c] = p;
      dsv[a][c] = p * (dp[a][c] - dvec_s[row]);
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(kKeys) * (HD + 1) +
                          2 * kRows * kPLd + 2 * kRows);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(kKeys) * (HD + 1) +
                          kKeys * kPLd + 2 * kRows);
}

// grid (n_ktiles, hkv, b).  partial: f32[b][n_parts] or null; this block
// writes slot g * n_ktiles + kt.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dvec,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ partial, int s, int h, int hkv,
                int window, float scale, int n_qtiles, int n_parts) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;          // dims a thread owns
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  float* k_s = smem;                      // [kKeys][kLd]
  float* v_s = k_s + kKeys * kLd;         // [kKeys][kLd]
  float* q_s = v_s + kKeys * kLd;         // [kRows][kLd], q * scale
  float* do_s = q_s + kRows * kLd;        // [kRows][kLd]
  float* p_s = do_s + kRows * kLd;        // [kRows][kPLd]
  float* ds_s = p_s + kRows * kPLd;       // [kRows][kPLd]
  float* lse_s = ds_s + kRows * kPLd;     // [kRows]
  float* dvec_s = lse_s + kRows;          // [kRows]

  const int rep = h / hkv;
  const int bq = kRows / rep;             // positions a query tile
  const RowTile rt{rep, bq * rep};
  const int kt = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kKeys;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  stage_keys<HD>(k, b, g, s, hkv, k0, k_s);
  stage_keys<HD>(v, b, g, s, hkv, k0, v_s);

  float dk_acc[4][kCols], dv_acc[4][kCols];  // keys ty*4+a, dims tx+16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.0f;

  // query tiles that see a key of this tile: positions >= k0 and, with a
  // window, <= the tile's last key + window - 1
  int qt_hi = n_qtiles - 1;
  if (window > 0) qt_hi = min(qt_hi, (k0 + kKeys - 1 + window - 1) / bq);
  for (int qt = k0 / bq; qt <= qt_hi; ++qt) {
    const int q0 = qt * bq;
    stage_rows<HD>(q, b, g, s, h, q0, rt, scale, q_s);
    stage_rows<HD>(dout, b, g, s, h, q0, rt, 1.0f, do_s);
    stage_row_stats(lse, dvec, b, g, s, h, q0, rt, lse_s, dvec_s);
    __syncthreads();

    float pv[4][4], dsv[4][4];
    p_and_ds<HD>(q_s, do_s, k_s, v_s, lse_s, dvec_s, q0, k0, s, window, rt,
                 pv, dsv);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p_s[(ty * 4 + a) * kPLd + tx + 16 * c] = pv[a][c];
        ds_s[(ty * 4 + a) * kPLd + tx + 16 * c] = dsv[a][c];
      }
    __syncthreads();

    // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] (q_i * scale)
    for (int i = 0; i < rt.live_rows; ++i) {
      const float4 pa = *reinterpret_cast<const float4*>(&p_s[i * kPLd + ty * 4]);
      const float4 sa = *reinterpret_cast<const float4*>(&ds_s[i * kPLd + ty * 4]);
      const float pw[4] = {pa.x, pa.y, pa.z, pa.w};
      const float sw[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float dov = do_s[i * kLd + tx + 16 * c];
        const float qv = q_s[i * kLd + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          dv_acc[a][c] = fmaf(pw[a], dov, dv_acc[a][c]);
          dk_acc[a][c] = fmaf(sw[a], qv, dk_acc[a][c]);
        }
      }
    }
    __syncthreads();                      // before the next tile overwrites
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + ty * 4 + a;
    if (kp < s) {
      const size_t base = ((static_cast<size_t>(b) * s + kp) * hkv + g) * HD;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dk[base + tx + 16 * c] = dk_acc[a][c];
        dv[base + tx + 16 * c] = dv_acc[a][c];
      }
    }
  }
  if (partial == nullptr) return;
  // the score: the f32 tiles row-major (key, dim) in q_s's space
  float* tile = q_s;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      tile[(ty * 4 + a) * HD + tx + 16 * c] = dk_acc[a][c];
  __syncthreads();
  const float sk = tile_sumsq([&](int e) { return tile[e]; }, kKeys * HD, red);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      tile[(ty * 4 + a) * HD + tx + 16 * c] = dv_acc[a][c];
  __syncthreads();
  const float sv = tile_sumsq([&](int e) { return tile[e]; }, kKeys * HD, red);
  if (threadIdx.x == 0)
    partial[static_cast<size_t>(b) * n_parts + g * gridDim.x + kt] =
        __fadd_rn(sk, sv);
}

// grid (n_qtiles, hkv, b).  partial: this block writes slot
// n_kv_parts + g * n_qtiles + qt.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dvec,
              float* __restrict__ dq, float* __restrict__ partial, int s, int h,
              int hkv, int window, float scale, int n_qtiles, int n_kv_parts,
              int n_parts) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;
  constexpr int kTLd = kPLd;              // dS transposed: [key][row]
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  float* q_s = smem;                      // [kRows][kLd], q * scale
  float* do_s = q_s + kRows * kLd;        // [kRows][kLd]
  float* k_s = do_s + kRows * kLd;        // [kKeys][kLd]
  float* v_s = k_s + kKeys * kLd;         // [kKeys][kLd]
  float* ds_t = v_s + kKeys * kLd;        // [kKeys][kTLd]
  float* lse_s = ds_t + kKeys * kTLd;     // [kRows]
  float* dvec_s = lse_s + kRows;          // [kRows]

  const int rep = h / hkv;
  const int bq = kRows / rep;
  const RowTile rt{rep, bq * rep};
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x);
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * bq;
  const int q_last = min(q0 + bq, s) - 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  stage_rows<HD>(q, b, g, s, h, q0, rt, scale, q_s);
  stage_rows<HD>(dout, b, g, s, h, q0, rt, 1.0f, do_s);
  stage_row_stats(lse, dvec, b, g, s, h, q0, rt, lse_s, dvec_s);

  float acc[4][kCols];                    // rows ty*4+a, dims tx+16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.0f;

  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = k_lo / kKeys; kt <= q_last / kKeys; ++kt) {
    const int k0 = kt * kKeys;
    stage_keys<HD>(k, b, g, s, hkv, k0, k_s);
    stage_keys<HD>(v, b, g, s, hkv, k0, v_s);
    __syncthreads();

    float pv[4][4], dsv[4][4];
    p_and_ds<HD>(q_s, do_s, k_s, v_s, lse_s, dvec_s, q0, k0, s, window, rt,
                 pv, dsv);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&ds_t[(tx + 16 * c) * kTLd + ty * 4]) =
          make_float4(dsv[0][c], dsv[1][c], dsv[2][c], dsv[3][c]);
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] K[j]
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 sa = *reinterpret_cast<const float4*>(&ds_t[j * kTLd + ty * 4]);
      const float sw[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = k_s[j * kLd + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(sw[a], kv, acc[a][c]);
      }
    }
    __syncthreads();                      // before the next tile overwrites
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = ty * 4 + a;
    const int pos = q0 + row / rep;
    const bool live = rt.live(row, pos, s);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      acc[a][c] = live ? acc[a][c] * scale : 0.0f;
      if (live)
        dq[((static_cast<size_t>(b) * s + pos) * h + g * rep + row % rep) *
               HD + tx + 16 * c] = acc[a][c];
    }
  }
  if (partial == nullptr) return;
  float* tile = q_s;                      // the f32 dQ tile, row-major
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      tile[(ty * 4 + a) * HD + tx + 16 * c] = acc[a][c];
  __syncthreads();
  const float sq = tile_sumsq([&](int e) { return tile[e]; }, kRows * HD, red);
  if (threadIdx.x == 0)
    partial[static_cast<size_t>(b) * n_parts + n_kv_parts + g * n_qtiles +
            qt] = sq;
}

// grid (n_parts, b): block (t, b) writes partial[b][t] from the
// materialized f32 gradients, with the tiles and order of the fused
// epilogues.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ dq, const float* __restrict__ dk,
                 const float* __restrict__ dv, float* __restrict__ partial,
                 int s, int h, int hkv, int n_ktiles, int n_qtiles) {
  __shared__ float red[kWarps];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int n_kv = hkv * n_ktiles;
  float res;
  if (t < n_kv) {
    const int g = t / n_ktiles;
    const int k0 = (t % n_ktiles) * kKeys;
    auto key_tile = [&](const float* src) {
      return [=](int e) {
        const int kp = k0 + e / HD;
        return kp < s ? src[((static_cast<size_t>(b) * s + kp) * hkv + g) *
                                HD + e % HD]
                      : 0.0f;
      };
    };
    const float sk = tile_sumsq(key_tile(dk), kKeys * HD, red);
    const float sv = tile_sumsq(key_tile(dv), kKeys * HD, red);
    res = __fadd_rn(sk, sv);
  } else {
    const int g = (t - n_kv) / n_qtiles;
    const int rep = h / hkv;
    const int bq = kRows / rep;
    const RowTile rt{rep, bq * rep};
    const int q0 = ((t - n_kv) % n_qtiles) * bq;
    res = tile_sumsq(
        [&](int e) {
          const int row = e / HD;
          const int pos = q0 + row / rep;
          return rt.live(row, pos, s)
                     ? dq[((static_cast<size_t>(b) * s + pos) * h +
                           g * rep + row % rep) * HD + e % HD]
                     : 0.0f;
        },
        kRows * HD, red);
  }
  if (threadIdx.x == 0)
    partial[static_cast<size_t>(b) * gridDim.x + t] = res;
}

// One thread a row: the dK/dV partials in order, the dQ partials in order,
// then their sum.
__global__ void reduce_kernel(const float* __restrict__ partial, int b,
                              int n_kv, int n_parts,
                              float* __restrict__ scores) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  const float* p = partial + static_cast<size_t>(row) * n_parts;
  float skv = 0.0f;
  for (int t = 0; t < n_kv; ++t) skv = __fadd_rn(skv, p[t]);
  float sq = 0.0f;
  for (int t = n_kv; t < n_parts; ++t) sq = __fadd_rn(sq, p[t]);
  scores[row] = __fadd_rn(skv, sq);
}

struct Plan {
  int n_ktiles, n_qtiles, n_kv, n_parts;
};

Plan plan(int s, int h, int hkv) {
  const int bq = kRows / (h / hkv);
  Plan p;
  p.n_ktiles = (s + kKeys - 1) / kKeys;
  p.n_qtiles = (s + bq - 1) / bq;
  p.n_kv = hkv * p.n_ktiles;
  p.n_parts = p.n_kv + hkv * p.n_qtiles;
  return p;
}

cudaError_t reduce(const float* partial, int b, const Plan& p, float* scores,
                   cudaStream_t stream) {
  reduce_kernel<<<(b + 127) / 128, 128, 0, stream>>>(partial, b, p.n_kv,
                                                     p.n_parts, scores);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dvec,
                       void* dq, void* dk, void* dv, float* partial,
                       float* scores, int b, int s, int h, int hkv,
                       int window, float scale, cudaStream_t stream) {
  const Plan p = plan(s, h, hkv);
  constexpr size_t kv_bytes = dkdv_smem_bytes<HD>();
  constexpr size_t q_bytes = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return err;
  dkdv_kernel<HD><<<dim3(p.n_ktiles, hkv, b), kThreads, kv_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dvec,
      static_cast<float*>(dk), static_cast<float*>(dv), partial, s, h, hkv,
      window, scale, p.n_qtiles, p.n_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<HD><<<dim3(p.n_qtiles, hkv, b), kThreads, q_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, dvec,
      static_cast<float*>(dq), partial, s, h, hkv, window, scale, p.n_qtiles,
      p.n_kv, p.n_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  return reduce(partial, b, p, scores, stream);
}

template <int HD>
cudaError_t launch_sweep(const void* dq, const void* dk, const void* dv,
                         float* partial, float* scores, int b, int s, int h,
                         int hkv, cudaStream_t stream) {
  const Plan p = plan(s, h, hkv);
  sweep_kernel<HD><<<dim3(p.n_parts, b), kThreads, 0, stream>>>(
      static_cast<const float*>(dq), static_cast<const float*>(dk),
      static_cast<const float*>(dv), partial, s, h, hkv, p.n_ktiles,
      p.n_qtiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, b, p, scores, stream);
}

// ------------------------------------------------ bf16: wgmma on TMA tiles
namespace tc {

// Two consumer warpgroups; thread 0 also issues the TMA loads.  (A separate
// producer warp or warpgroup makes a block of 288 or 384 threads, and ptxas
// then holds every thread to 168 registers: measured, setmaxnreg did not
// raise the consumers' budget.  256 threads leave them 255.)
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers;

// Sum of squares of this warpgroup's accumulators (each thread's in
// register order, a shuffle-down tree in each warp, the four warps in
// order), valid in every thread of the warpgroup.  red: 4 floats of this
// warpgroup; named barrier 1 + wg.
template <int N>
__device__ float wg_sumsq(const float (&acc)[N], float* red, int wg) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) v = __fadd_rn(v, __fmul_rn(acc[i], acc[i]));
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  const int wl = (threadIdx.x / 32) % 4;
  hopper::named_sync(1 + wg, 128);        // red of an earlier call is read
  if (threadIdx.x % 32 == 0) red[wl] = v;
  hopper::named_sync(1 + wg, 128);
  return __fadd_rn(__fadd_rn(red[0], red[1]), __fadd_rn(red[2], red[3]));
}

// P and dS of one (64 x 64) accumulator pair in place: st holds S (scores
// before the scale), dp holds dP; entry j of this thread is at accumulator
// row a = (j / 2) % 2 and column c = 8 (j / 4) + 2 (lane % 4) + j % 2.  The
// caller says for each entry whether it is visible and gives its lse and D.
// The memory clobber every four entries keeps the compiler from loading
// the statistics of all 32 entries at once.
template <typename Entry>
__device__ __forceinline__ void p_and_ds(float (&st)[32], float (&dp)[32],
                                         float scale, Entry entry) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if ((j & 3) == 0) asm volatile("" ::: "memory");
    float lse_e, d_e;
    const bool ok = entry(j, lse_e, d_e);
    const float p = ok ? expf(st[j] * scale - lse_e) : 0.0f;
    st[j] = p;
    dp[j] = ok ? p * (dp[j] - d_e) : 0.0f;
  }
}

// The split A fragments f (NP bf16 parts, split_tile) times the tile (64
// rows x HD, bf16) read MN-major.  Each slice of kSlice columns is summed
// by wgmma in a fresh accumulator, held in `scratch` (an accumulator the
// caller no longer needs), and handed to add(c, part) for slice c, which
// adds it to the running sum with f32 adds: the tensor cores'
// accumulation rounds less exactly than an f32 add, and over a long chain
// of tiles (dV and dK of an early key sum 8192 query rows at S = 512) its
// error would exceed the f32 kernel's.
template <int HD>
constexpr int kSlice = HD < 64 ? HD : 64;

template <int HD, int NP, typename Add>
__device__ __forceinline__ void tile_product(uint32_t (&f)[4][NP][4],
                                             uint32_t tile,
                                             float (&scratch)[32], Add add) {
  using Tl = hopper::Tile<HD>;
  constexpr int kN = kSlice<HD>;
  float (&part)[kN / 2] = *reinterpret_cast<float (*)[kN / 2]>(&scratch[0]);
#pragma unroll
  for (int c = 0; c < HD / kN; ++c) {
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) part[j] = 0.0f;
    hopper::fence_regs(part);
    hopper::fence_regs(f);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = hopper::mnmajor_desc<HD, 64>(
          tile + c * 64 * Tl::kRowBytes, kk);
#pragma unroll
      for (int p = 0; p < NP; ++p) hopper::wgmma_rs<kN>(part, f[kk][p], d);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    hopper::fence_regs(f);
    add(c, part);
  }
}

// S = A B^T and D = C E^T over HD (both m64 x n64): SS wgmma, A, C tiles of
// 64 rows and B, E tiles of 64 rows, all K-major; waits for both.
template <int HD>
__device__ __forceinline__ void two_products(float (&s)[32], uint32_t a,
                                             uint32_t b, float (&d)[32],
                                             uint32_t c, uint32_t e) {
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = d[j] = 0.0f;
  hopper::fence_regs(s);
  hopper::fence_regs(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    hopper::wgmma_ss_n64(s, hopper::kmajor_desc<HD, 64>(a, kk),
                         hopper::kmajor_desc<HD, 64>(b, kk), kk > 0);
    hopper::wgmma_ss_n64(d, hopper::kmajor_desc<HD, 64>(c, kk),
                         hopper::kmajor_desc<HD, 64>(e, kk), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  hopper::fence_regs(d);
}

// The dK/dV kernel's dynamic shared memory: K and V tiles of the
// consumers' keys, the Q and dO ring (kKvStages stages), each consumer's
// running dK (f32, entry j of thread t at j * 128 + t: a thread reads and
// writes only its own column), double-buffered row statistics (lse, D,
// position) and score scratch, the mbarriers (kv, full[kKvStages],
// empty[kKvStages]); 1024 bytes of slack align the base.
constexpr int kKvStages = 2;
template <int HD>
struct KvSmem {
  static constexpr int kT = hopper::Tile<HD>::bytes(64);
  static constexpr int kK = 0;
  static constexpr int kV = kK + kConsumers * kT;
  static constexpr int kQ = kV + kConsumers * kT;
  static constexpr int kDo = kQ + kKvStages * kT;
  static constexpr int kDk = kDo + kKvStages * kT;    // [wg][HD / 2][128]
  static constexpr int kStats = kDk + kConsumers * (HD / 2) * 128 * 4;
  static constexpr int kRed = kStats + kConsumers * 2 * 3 * 64 * 4;
  static constexpr int kBars = kRed + kConsumers * 4 * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kKvStages) + 1024;
};

// The dQ kernel's: Q and dO tiles of the consumers, the K and V ring, score
// scratch, the mbarriers (q[kConsumers], full, empty).
constexpr int kQStages = 3;
template <int HD>
struct QSmem {
  static constexpr int kT = hopper::Tile<HD>::bytes(64);
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kConsumers * kT;
  static constexpr int kK = kDo + kConsumers * kT;
  static constexpr int kV = kK + kQStages * kT;
  static constexpr int kRed = kV + kQStages * kT;
  static constexpr int kBars = kRed + kConsumers * 4 * 4;
  static constexpr int kBytes =
      kBars + 8 * (kConsumers + 2 * kQStages) + 1024;
};

// grid (ceil(s / 128), hkv, b): block x owns keys [128 x, 128 x + 128) of
// group g, consumer wg the 64-key tile kt = 2 x + wg.  partial: f32[b][n_parts]
// or null; consumer wg writes slot g * n_ktiles + kt.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_tc(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ dvec,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            float* __restrict__ partial, int s, int h, int hkv, int window,
            float scale, int n_qtiles, int n_ktiles, int n_parts) {
  using Tl = hopper::Tile<HD>;
  using L = KvSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::align_1024(smem_raw);
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t bar_kv = base + L::kBars;

  const int rep = h / hkv;
  const int bq = kRows / rep;
  const int live_rows = bq * rep;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int kb0 = blockIdx.x * kConsumers * kKeys;
  const int n_live = min(kConsumers, (s - kb0 + kKeys - 1) / kKeys);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  // query tiles that see a key of [k0, k0 + 64): positions >= k0 and, with
  // a window, <= the tile's last key + window - 1
  auto qt_hi = [&](int k0) {
    return window > 0 ? min(n_qtiles - 1, (k0 + kKeys - 1 + window - 1) / bq)
                      : n_qtiles - 1;
  };
  const int qt_begin = kb0 / bq;
  const hopper::Ring<kKvStages, 4 * kConsumers> ring{
      bar_kv + 8, bar_kv + 8 + 8 * kKvStages,
      qt_hi(kb0 + (n_live - 1) * kKeys) - qt_begin + 1};
  // tile i of the ring: the Q and dO rows of query tile qt_begin + i
  auto load = [&](int i, int st, uint32_t bar) {
    hopper::mbar_expect_tx(bar, 2 * Tl::bytes(live_rows));
    const int q0 = (qt_begin + i) * bq;
    hopper::load_tile<HD, kRows>(base + L::kQ + st * L::kT, &tm_q, bar,
                                 g * rep, q0, b);
    hopper::load_tile<HD, kRows>(base + L::kDo + st * L::kT, &tm_do, bar,
                                 g * rep, q0, b);
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_kv, 1);
    ring.init();
    hopper::fence_mbar_init();
  }
  // Q, dO
  hopper::zero_dead_rows<HD>(base_ptr + L::kQ, 2 * kKvStages, live_rows);
  hopper::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(bar_kv, 2 * n_live * L::kT);
    for (int w = 0; w < n_live; ++w) {
      hopper::load_tile<HD, kKeys>(base + L::kK + w * L::kT, &tm_k, bar_kv,
                                   g, kb0 + w * kKeys, b);
      hopper::load_tile<HD, kKeys>(base + L::kV + w * L::kT, &tm_v, bar_kv,
                                   g, kb0 + w * kKeys, b);
    }
    ring.start(load);
  }

  // consumer wg: keys k0 .. k0 + 63, rows kp[a] = k0 + r0 + 8 a of its
  // accumulators in this thread
  const int k0 = kb0 + wg * kKeys;
  const bool kv_live = wg < n_live;
  const int my_lo = k0 / bq - qt_begin;   // ring tiles it works on
  const int my_hi = kv_live ? qt_hi(k0) - qt_begin : -1;
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int kp[2] = {k0 + r0, k0 + r0 + 8};
  const uint32_t k_base = base + L::kK + wg * L::kT;
  const uint32_t v_base = base + L::kV + wg * L::kT;
  float* const stats =
      reinterpret_cast<float*>(base_ptr + L::kStats) + wg * 2 * 3 * 64;
  float* const dk_s = reinterpret_cast<float*>(base_ptr + L::kDk) +
                      wg * (HD / 2) * 128 + t;
  float dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    dv_acc[i] = 0.0f;
    dk_s[i * 128] = 0.0f;
  }
  if (kv_live) hopper::mbar_wait(bar_kv, 0);

  for (int i = 0; i < ring.n; ++i) {
    ring.wait(i);
    if (i >= my_lo && i <= my_hi) {
      const int st = i % kKvStages;
      const int q0 = (qt_begin + i) * bq;
      const uint32_t q_tile = base + L::kQ + st * L::kT;
      const uint32_t do_tile = base + L::kDo + st * L::kT;
      // lse, D and position of the tile's 64 rows (position -1: dead)
      float* const lse_s = stats + (i & 1) * 3 * 64;
      float* const d_s = lse_s + 64;
      int* const pos_s = reinterpret_cast<int*>(d_s + 64);
      {
        const int row = t % 64;
        const int pos = q0 + row / rep;
        const bool lv = row < live_rows && pos < s;
        const size_t idx =
            (static_cast<size_t>(b) * h + g * rep + row % rep) * s + pos;
        if (t < 64) {
          lse_s[row] = lv ? lse[idx] : 0.0f;
          pos_s[row] = lv ? pos : -1;
        } else {
          d_s[row] = lv ? dvec[idx] : 0.0f;
        }
      }
      hopper::named_sync(1 + wg, 128);

      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns query rows
      float st_acc[32], dp_acc[32];
      two_products<HD>(st_acc, hopper::opaque(k_base), q_tile, dp_acc,
                       hopper::opaque(v_base), do_tile);
      p_and_ds(st_acc, dp_acc, scale, [&](int j, float& l_e, float& d_e) {
        const int c = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const int key = kp[(j >> 1) & 1];
        const int pos = pos_s[c];
        l_e = lse_s[c];
        d_e = d_s[c];
        return pos >= 0 && key <= pos && (window <= 0 || pos - key < window);
      });

      // dK += dS^T Q (shared memory; dS in two parts, dp_acc the
      // scratch), then dV += P^T dO (registers; P in three, st_acc the
      // scratch)
      constexpr int kN = kSlice<HD>;
      {
        uint32_t f[4][2][4];
        hopper::split_tile<2>(dp_acc, f);
        tile_product<HD>(f, q_tile, dp_acc,
                         [&](int c, const float (&part)[kN / 2]) {
#pragma unroll
                           for (int j = 0; j < kN / 2; ++j)
                             dk_s[(c * kN / 2 + j) * 128] += part[j];
                         });
      }
      hopper::fence_regs(st_acc);         // split P after the dK product
      uint32_t f[4][3][4];
      hopper::split_tile<3>(st_acc, f);
      tile_product<HD>(f, do_tile, st_acc,
                       [&](int c, const float (&part)[kN / 2]) {
#pragma unroll
                         for (int j = 0; j < kN / 2; ++j)
                           dv_acc[c * kN / 2 + j] += part[j];
                       });
    }
    ring.release(i, load);
  }
  if (!kv_live) return;

  float dk_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dk_s[i * 128] * scale;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (kp[a] >= s) continue;
    const size_t row = ((static_cast<size_t>(b) * s + kp[a]) * hkv + g) * HD;
#pragma unroll
    for (int j = 2 * a; j < HD / 2; j += 4) {
      const int col = 8 * (j >> 2) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
          __floats2bfloat162_rn(dk_acc[j], dk_acc[j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
          __floats2bfloat162_rn(dv_acc[j], dv_acc[j + 1]);
    }
  }
  if (partial == nullptr) return;
  float* const red = reinterpret_cast<float*>(base_ptr + L::kRed) + wg * 4;
  const float sk = wg_sumsq(dk_acc, red, wg);
  const float sv = wg_sumsq(dv_acc, red, wg);
  if (t == 0)
    partial[static_cast<size_t>(b) * n_parts + g * n_ktiles + k0 / kKeys] =
        __fadd_rn(sk, sv);
}

// grid (ceil(n_qtiles / 2), hkv, b): block x owns query tiles 2 x' and
// 2 x' + 1 (x' = gridDim.x - 1 - x, longest first), one a consumer.
// partial: consumer wg writes slot n_kv_parts + g * n_qtiles + qt.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ dvec,
          __nv_bfloat16* __restrict__ dq, float* __restrict__ partial, int s,
          int h, int hkv, int window, float scale, int n_qtiles,
          int n_kv_parts, int n_parts) {
  using Tl = hopper::Tile<HD>;
  using L = QSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::align_1024(smem_raw);
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t bar_q = base + L::kBars;

  const int rep = h / hkv;
  const int bq = kRows / rep;
  const int live_rows = bq * rep;
  const int qt0 = 2 * (static_cast<int>(gridDim.x) - 1 -
                       static_cast<int>(blockIdx.x));
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  auto kt_lo = [&](int qt) {
    return window > 0 ? max(0, qt * bq - window + 1) / kKeys : 0;
  };
  auto kt_hi = [&](int qt) { return (min(qt * bq + bq, s) - 1) / kKeys; };
  const int kt_begin = kt_lo(qt0);
  const int n_live = min(kConsumers, n_qtiles - qt0);
  const hopper::Ring<kQStages, 4 * kConsumers> ring{
      bar_q + 8 * kConsumers, bar_q + 8 * (kConsumers + kQStages),
      kt_hi(qt0 + n_live - 1) - kt_begin + 1};
  // tile i of the ring: the K and V of key tile kt_begin + i
  auto load = [&](int i, int st, uint32_t bar) {
    hopper::mbar_expect_tx(bar, 2 * L::kT);
    const int k0 = (kt_begin + i) * kKeys;
    hopper::load_tile<HD, kKeys>(base + L::kK + st * L::kT, &tm_k, bar, g,
                                 k0, b);
    hopper::load_tile<HD, kKeys>(base + L::kV + st * L::kT, &tm_v, bar, g,
                                 k0, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers; ++i) hopper::mbar_init(bar_q + 8 * i, 1);
    ring.init();
    hopper::fence_mbar_init();
  }
  // Q, dO
  hopper::zero_dead_rows<HD>(base_ptr + L::kQ, 2 * kConsumers, live_rows);
  hopper::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < n_live; ++w) {
      hopper::mbar_expect_tx(bar_q + 8 * w, 2 * Tl::bytes(live_rows));
      hopper::load_tile<HD, kRows>(base + L::kQ + w * L::kT, &tm_q,
                                   bar_q + 8 * w, g * rep, (qt0 + w) * bq, b);
      hopper::load_tile<HD, kRows>(base + L::kDo + w * L::kT, &tm_do,
                                   bar_q + 8 * w, g * rep, (qt0 + w) * bq, b);
    }
    ring.start(load);
  }

  // consumer wg: query tile qt, rows r0 and r0 + 8 in this thread
  const int qt = qt0 + wg;
  const bool tile_live = wg < n_live;
  const int my_lo = kt_lo(qt) - kt_begin;  // ring tiles it works on
  const int my_hi = tile_live ? kt_hi(qt) - kt_begin : -1;
  const int r0 = 16 * (warp % 4) + lane / 4;
  int pos[2], head[2];
  bool live[2];
  float lse_r[2], d_r[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = r0 + 8 * a;
    pos[a] = qt * bq + row / rep;
    head[a] = g * rep + row % rep;
    live[a] = tile_live && row < live_rows && pos[a] < s;
    const size_t idx = (static_cast<size_t>(b) * h + head[a]) * s + pos[a];
    lse_r[a] = live[a] ? lse[idx] : 0.0f;
    d_r[a] = live[a] ? dvec[idx] : 0.0f;
  }
  const uint32_t q_base = base + L::kQ + wg * L::kT;
  const uint32_t do_base = base + L::kDo + wg * L::kT;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  if (tile_live) hopper::mbar_wait(bar_q + 8 * wg, 0);

  for (int i = 0; i < ring.n; ++i) {
    ring.wait(i);
    if (i >= my_lo && i <= my_hi) {
      const int st = i % kQStages;
      const uint32_t k_tile = base + L::kK + st * L::kT;
      const uint32_t v_tile = base + L::kV + st * L::kT;
      // S = Q K^T and dP = dO V^T: rows query rows, columns keys
      float s_acc[32], dp_acc[32];
      two_products<HD>(s_acc, hopper::opaque(q_base), k_tile, dp_acc,
                       hopper::opaque(do_base), v_tile);
      const int k0 = (kt_begin + i) * kKeys;
      p_and_ds(s_acc, dp_acc, scale, [&](int j, float& l_e, float& d_e) {
        const int a = (j >> 1) & 1;
        const int key = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        l_e = lse_r[a];
        d_e = d_r[a];
        return live[a] && key <= pos[a] &&
               (window <= 0 || pos[a] - key < window);
      });

      // dQ += dS K, dS split in two; s_acc is the product's scratch
      constexpr int kN = kSlice<HD>;
      uint32_t f[4][2][4];
      hopper::split_tile<2>(dp_acc, f);
      tile_product<HD>(f, k_tile, s_acc,
                       [&](int c, const float (&part)[kN / 2]) {
#pragma unroll
                         for (int j = 0; j < kN / 2; ++j)
                           acc[c * kN / 2 + j] += part[j];
                       });
    }
    ring.release(i, load);
  }
  if (!tile_live) return;

#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= scale;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!live[a]) continue;
    __nv_bfloat16* const dst =
        dq + ((static_cast<size_t>(b) * s + pos[a]) * h + head[a]) * HD;
#pragma unroll
    for (int j = 2 * a; j < HD / 2; j += 4) {
      const int col = 8 * (j >> 2) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dst + col) =
          __floats2bfloat162_rn(acc[j], acc[j + 1]);
    }
  }
  if (partial == nullptr) return;
  float* const red = reinterpret_cast<float*>(base_ptr + L::kRed) + wg * 4;
  const float sq = wg_sumsq(acc, red, wg);
  if (threadIdx.x % 128 == 0)
    partial[static_cast<size_t>(b) * n_parts + n_kv_parts + g * n_qtiles +
            qt] = sq;
}

template <int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dvec,
                       void* dq, void* dk, void* dv, float* partial,
                       float* scores, int b, int s, int h, int hkv,
                       int window, float scale, cudaStream_t stream) {
  const Plan p = plan(s, h, hkv);
  const int rep = h / hkv;
  const int bq = kRows / rep;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = hopper::tile_map<HD>(&tm_q, q, h, s, b, rep, bq);
  if (err == cudaSuccess)
    err = hopper::tile_map<HD>(&tm_do, dout, h, s, b, rep, bq);
  if (err == cudaSuccess)
    err = hopper::tile_map<HD>(&tm_k, k, hkv, s, b, 1, kKeys);
  if (err == cudaSuccess)
    err = hopper::tile_map<HD>(&tm_v, v, hkv, s, b, 1, kKeys);
  if (err != cudaSuccess) return err;
  constexpr int kv_bytes = KvSmem<HD>::kBytes;
  constexpr int q_bytes = QSmem<HD>::kBytes;
  err = cudaFuncSetAttribute(dkdv_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return err;
  const int n_kblocks = (s + kConsumers * kKeys - 1) / (kConsumers * kKeys);
  dkdv_tc<HD><<<dim3(n_kblocks, hkv, b), kThreads, kv_bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, dvec, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), partial, s, h, hkv, window, scale,
      p.n_qtiles, p.n_ktiles, p.n_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_tc<HD><<<dim3((p.n_qtiles + 1) / 2, hkv, b), kThreads, q_bytes,
              stream>>>(tm_q, tm_k, tm_v, tm_do, lse, dvec,
                        static_cast<__nv_bfloat16*>(dq), partial, s, h, hkv,
                        window, scale, p.n_qtiles, p.n_kv, p.n_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  return reduce(partial, b, p, scores, stream);
}

}  // namespace tc

// -------------------------------------------- bf16 score sweep: flat spans
// The score of example b is the sum of squares of three contiguous spans,
// dq[b] (S H hd elements), dk[b] and dv[b] (S Hkv hd each); the bf16
// instance reads them as flat spans, with no tile geometry (fused == sweep
// is a contract of f32 gradients only).
namespace sweep16 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 8;                 // bf16 a piece: one 16-byte load
constexpr int kPieces = 8;                // pieces a thread a chunk
constexpr int kChunk = kThreads * kPieces * kPiece;   // elements a chunk

struct Spans {
  const __nv_bfloat16* p[3];              // dq, dk, dv
  long long len[3];                       // elements of one example's span
  int chunks[3];                          // chunks of one example's span
  int vec[3];                             // base 16-byte aligned, len % 8 == 0
};

// Chunk idx = b * n_parts + c: its first element, its length, and whether
// it is whole and aligned (16-byte loads) or not (scalar loads).
struct Chunk {
  const __nv_bfloat16* src;
  int m;
  bool vec;
};

__device__ __forceinline__ Chunk locate(const Spans& sp, int idx, int np) {
  const int b = idx / np;
  int c = idx - b * np;
  int which = 0;
  while (c >= sp.chunks[which]) c -= sp.chunks[which++];
  const long long lo = static_cast<long long>(c) * kChunk;
  const long long left = sp.len[which] - lo;
  Chunk ck;
  ck.m = left < kChunk ? static_cast<int>(left) : kChunk;
  ck.src = sp.p[which] + b * sp.len[which] + lo;
  ck.vec = sp.vec[which] && ck.m == kChunk;
  return ck;
}

// Square of the bf16 in the low (hi = false) or high half of a word, in f32.
__device__ __forceinline__ float sq_half(unsigned w, bool hi) {
  const float v = __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
  return __fmul_rn(v, v);
}

// This thread's pieces t, t + 256, ... of a whole aligned chunk.
__device__ __forceinline__ void load_pieces(const Chunk& ck,
                                            uint4 (&w)[kPieces]) {
  const uint4* v = reinterpret_cast<const uint4*>(ck.src) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPieces; ++k) w[k] = __ldcs(v + k * kThreads);
}

// The squares of this thread's pieces, each piece's in element order.
__device__ __forceinline__ float sum_pieces(const uint4 (&w)[kPieces]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const unsigned u[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = __fadd_rn(acc, sq_half(u[i], false));
      acc = __fadd_rn(acc, sq_half(u[i], true));
    }
  }
  return acc;
}

// The same sum in scalar loads, for the ragged last chunk of a span or a
// base off 16 bytes; elements past the span are skipped (+0 in the order).
__device__ __forceinline__ float sum_scalar(const Chunk& ck) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(ck.src);
  float acc = 0.0f;
  for (int k = 0; k < kPieces; ++k) {
    const int e0 = (k * kThreads + threadIdx.x) * kPiece;
    for (int j = 0; j < kPiece && e0 + j < ck.m; ++j)
      acc = __fadd_rn(acc, sq_half(u[e0 + j], false));
  }
  return acc;
}

// Fixed trees: a shuffle-down in each warp, then one over the warps; the
// result is valid in thread 0.  red: kWarps floats, rewritten only after
// the next barrier.
__device__ __forceinline__ float block_sum(float acc, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  float res = 0.0f;
  if (warp == 0) {
    res = lane < kWarps ? red[lane] : 0.0f;
    for (int off = kWarps / 2; off > 0; off >>= 1)
      res = __fadd_rn(res, __shfl_down_sync(kFull, res, off));
  }
  return res;
}

// Block i reduces chunks i, i + gridDim.x, ... of the total = b * n_parts
// chunks into partial[idx] (= partial[b][c]), loading the next chunk's
// pieces before it adds this one's.  The partials do not depend on the
// grid.  red alternates between two buffers: a block_sum's writes reach a
// buffer only after the barrier that follows its last reads.
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(Spans sp, int np, int total, float* __restrict__ partial) {
  __shared__ float red[2][kWarps];
  uint4 cur[kPieces], nxt[kPieces];
  int idx = blockIdx.x;
  Chunk ck = locate(sp, idx, np);
  if (ck.vec) load_pieces(ck, cur);
  for (int it = 0; idx < total; ++it) {
    const int nidx = idx + gridDim.x;
    Chunk nk = ck;
    if (nidx < total) {
      nk = locate(sp, nidx, np);
      if (nk.vec) load_pieces(nk, nxt);
    }
    const float res =
        block_sum(ck.vec ? sum_pieces(cur) : sum_scalar(ck), red[it & 1]);
    if (threadIdx.x == 0) partial[idx] = res;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) cur[k] = nxt[k];
    ck = nk;
    idx = nidx;
  }
}

// One block an example: thread t adds partials t, t + 256, ... in order,
// then block_sum's trees.
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ partial, int np,
                  float* __restrict__ scores) {
  __shared__ float red[kWarps];
  const float* p = partial + static_cast<size_t>(blockIdx.x) * np;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < np; i += kThreads) acc = __fadd_rn(acc, p[i]);
  const float res = block_sum(acc, red);
  if (threadIdx.x == 0) scores[blockIdx.x] = res;
}

Spans spans(const void* dq, const void* dk, const void* dv, int s, int h,
            int hkv, int hd) {
  Spans sp;
  const void* ptr[3] = {dq, dk, dv};
  for (int i = 0; i < 3; ++i) {
    sp.p[i] = static_cast<const __nv_bfloat16*>(ptr[i]);
    sp.len[i] = static_cast<long long>(s) * (i == 0 ? h : hkv) * hd;
    sp.chunks[i] = static_cast<int>((sp.len[i] + kChunk - 1) / kChunk);
    sp.vec[i] = reinterpret_cast<size_t>(ptr[i]) % 16 == 0 &&
                sp.len[i] % kPiece == 0;
  }
  return sp;
}

int count_parts(int s, int h, int hkv, int hd) {
  const Spans sp = spans(nullptr, nullptr, nullptr, s, h, hkv, hd);
  return sp.chunks[0] + sp.chunks[1] + sp.chunks[2];
}

// As many blocks as stay resident on the card (at most one a chunk).
cudaError_t launch(const void* dq, const void* dk, const void* dv,
                   float* partial, float* scores, int b, int s, int h,
                   int hkv, int hd, int device, cudaStream_t stream) {
  const Spans sp = spans(dq, dk, dv, s, h, hkv, hd);
  const int np = sp.chunks[0] + sp.chunks[1] + sp.chunks[2];
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  const int total = np * b;
  const int grid = total < sms * per_sm ? total : sms * per_sm;
  sweep_kernel<<<grid, kThreads, 0, stream>>>(sp, np, total, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_kernel<<<b, kThreads, 0, stream>>>(partial, np, scores);
  return cudaGetLastError();
}

}  // namespace sweep16

bool shape_ok(int b, int s, int h, int hkv) {
  return b >= 1 && s >= 1 && hkv >= 1 && h % hkv == 0 && h / hkv <= kRows &&
         b <= 65535 && hkv <= 65535;
}

}  // namespace

extern "C" {

int fab_max_rep() { return kRows; }

// Slots of a row's partial scratch: hkv * (key tiles + query tiles).
int fab_parts(int s, int h, int hkv) {
  return shape_ok(1, s, h, hkv) ? plan(s, h, hkv).n_parts : -1;
}

// q, dout: (b, s, h, hd); k, v: (b, s, hkv, hd); dq, dk, dv like q, k, v;
// all contiguous, all f32 or all bf16.  lse, dvec: f32[b, h, s].  With
// partial (f32[b, fab_parts]) also scores: f32[b].
int fab_launch(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* dvec, void* dq, void* dk,
               void* dv, float* partial, float* scores, int bf16, int b,
               int s, int h, int hkv, int hd, int window, float scale,
               int device, void* stream) {
  if (!shape_ok(b, s, h, hkv) || (partial == nullptr) != (scores == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FAB_CASE(F)                                                         \
  err = F(q, k, v, dout, lse, dvec, dq, dk, dv, partial, scores, b, s, h,   \
          hkv, window, scale, st)
  switch (hd * 2 + (bf16 ? 1 : 0)) {
    case 64: FAB_CASE(launch_bwd<32>); break;
    case 65: FAB_CASE(tc::launch_bwd<32>); break;
    case 128: FAB_CASE(launch_bwd<64>); break;
    case 129: FAB_CASE(tc::launch_bwd<64>); break;
    case 256: FAB_CASE(launch_bwd<128>); break;
    case 257: FAB_CASE(tc::launch_bwd<128>); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FAB_CASE
  return static_cast<int>(err);
}

// Slots of a row's partial scratch for the score sweep: the f32 instance
// uses the fused epilogue's tiles (fab_parts), the bf16 one its chunks.
int fab_sweep_parts(int bf16, int s, int h, int hkv, int hd) {
  if (!shape_ok(1, s, h, hkv)) return -1;
  return bf16 ? sweep16::count_parts(s, h, hkv, hd) : plan(s, h, hkv).n_parts;
}

// Elements of one chunk of the bf16 sweep (ref.py mirrors it).
int fab_sweep16_chunk() { return sweep16::kChunk; }

// dq: (b, s, h, hd); dk, dv: (b, s, hkv, hd), contiguous, all f32 or all
// bf16 (any base for bf16, 4-byte aligned for f32).  partial:
// f32[b, fab_sweep_parts]; scores: f32[b].
int fab_sweep_launch(const void* dq, const void* dk, const void* dv,
                     float* partial, float* scores, int bf16, int b, int s,
                     int h, int hkv, int hd, int device, void* stream) {
  if (!shape_ok(b, s, h, hkv) || (hd != 32 && hd != 64 && hd != 128) ||
      (bf16 && static_cast<long long>(b) * sweep16::count_parts(s, h, hkv, hd) >
                   0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    err = sweep16::launch(dq, dk, dv, partial, scores, b, s, h, hkv, hd,
                          device, st);
  else if (hd == 32)
    err = launch_sweep<32>(dq, dk, dv, partial, scores, b, s, h, hkv, st);
  else if (hd == 64)
    err = launch_sweep<64>(dq, dk, dv, partial, scores, b, s, h, hkv, st);
  else
    err = launch_sweep<128>(dq, dk, dv, partial, scores, b, s, h, hkv, st);
  return static_cast<int>(err);
}

const char* fab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
