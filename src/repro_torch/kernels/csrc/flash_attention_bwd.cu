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
// and computes their functions: q in f32 times the scale before the dot,
// masked entries give p = 0, the score taken from the f32 gradients before
// they are cast to the operands' type.
//
// What bounds the function on an H100: operations.  At the glm4-9b trainer's
// shape (B = 16, S = 512, H = 32, Hkv = 2, hd = 128, bf16) the backward needs
// five causal-half products, 10 B H hd S(S+1)/2 = 86 GFLOP, 0.087 ms on the
// bf16 tensor cores, against 286 MB of q, k, v, O, dO, lse, dQ, dK, dV
// (0.085 ms).  This first kernel runs its products with f32 FMA on the CUDA
// cores and recomputes S and dP in the dQ kernel (seven products), so it
// stays far above that bound; tensor cores (wgmma) are the next step.
//
// What the design does about it:
//   * the TPU dK/dV kernel ran a grid (B, Hkv, key blocks, q blocks x rep),
//     summing the rep heads' contributions and the score by revisiting the
//     same output block along a sequential axis.  CUDA blocks run in no
//     order, so here one block owns one (b, KV group g, 64-key tile): K and V
//     stay in shared memory, and a loop inside the block walks the query
//     tiles.  A query tile is 64 rows, (position, head) pairs of group g (64 /
//     rep positions times all rep heads), the row mapping of the forward
//     kernel (flash_attention.cu), so every staged K/V tile serves every head
//     of the group.  dK and dV accumulate in f32 registers (a 4-key x hd/16
//     micro-tile per thread) and are written once.
//   * the dQ kernel owns one (b, g, 64-row tile) and walks the key tiles,
//     as the forward does.  Tiles wholly in the past of the window or
//     wholly before the key tile are skipped without being loaded (the
//     Pallas kernels' `live` test).  Blocks are issued longest first.
//   * 256 threads in a 16 x 16 grid: thread (ty, tx) computes S and dP of
//     rows ty*4..ty*4+3 against keys tx, tx+16, tx+32, tx+48.  All staged
//     tiles are row-major with a row stride of hd + 1 floats (conflict-free
//     column reads); P and dS tiles have rows of 68 floats (float4 reads).
//   * with a score, each block reduces the finished f32 accumulator tile
//     with tile_sumsq() (round-to-nearest intrinsics, a fixed shuffle tree:
//     no FMA contraction can differ between kernels) into its own slot of an
//     f32 scratch of per-tile partials, and a last small kernel sums a row's
//     partials in one fixed order: the dK/dV partials by (g, key tile), then
//     the dQ partials by (g, row tile), then the two sums, as the reference
//     adds kv_res[2] + q_res[1].  No float atomics.  The sweep reads the
//     materialized dQ, dK, dV with the same tiles, the same tile_sumsq() and
//     the same reducer, so for f32 gradients fused == sweep bitwise, and two
//     launches are bitwise equal.
//   * the ragged tail of S is masked in the loads (keys and queries past S
//     read as 0 and give exact zeros in gradients and score): no padded
//     copies.
//   * each entry point returns cudaGetLastError(); the wrapper raises if it
//     is not cudaSuccess.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRows = 64;                 // query (position, head) rows a tile
constexpr int kKeys = 64;                 // keys a tile
constexpr int kThreads = 256;             // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kPLd = kKeys + 4;           // row of a P / dS tile (floats)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Sum of squares of a tile's n elements (row-major order, n a multiple of
// kThreads), valid in thread 0: thread t sums elements t, t + kThreads, ...
// in order, then a shuffle-down tree in each warp and one over the warps.
// The fused epilogues and the sweep call it with the same tiles, so their
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
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int b,
                                           int g, int s, int h, int q0,
                                           RowTile rt, float mul, float* dst) {
  for (int e = threadIdx.x; e < kRows * HD; e += kThreads) {
    const int row = e / HD;
    const int d = e % HD;
    const int pos = q0 + row / rt.rep;
    float val = 0.0f;
    if (rt.live(row, pos, s))
      val = to_f32(src[((static_cast<size_t>(b) * s + pos) * h +
                        g * rt.rep + row % rt.rep) * HD + d]) * mul;
    dst[row * (HD + 1) + d] = val;
  }
}

// Stage keys [k0, k0 + 64) of group g into dst[j][d] (row stride hd + 1);
// keys at or past S as 0.
template <typename T, int HD>
__device__ __forceinline__ void stage_keys(const T* __restrict__ src, int b,
                                           int g, int s, int hkv, int k0,
                                           float* dst) {
  for (int e = threadIdx.x; e < kKeys * HD; e += kThreads) {
    const int j = e / HD;
    const int d = e % HD;
    const int kp = k0 + j;
    dst[j * (HD + 1) + d] =
        kp < s ? to_f32(src[((static_cast<size_t>(b) * s + kp) * hkv + g) *
                                HD + d])
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dvec,
                T* __restrict__ dk, T* __restrict__ dv,
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

  stage_keys<T, HD>(k, b, g, s, hkv, k0, k_s);
  stage_keys<T, HD>(v, b, g, s, hkv, k0, v_s);

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
    stage_rows<T, HD>(q, b, g, s, h, q0, rt, scale, q_s);
    stage_rows<T, HD>(dout, b, g, s, h, q0, rt, 1.0f, do_s);
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
        store_as(&dk[base + tx + 16 * c], dk_acc[a][c]);
        store_as(&dv[base + tx + 16 * c], dv_acc[a][c]);
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dvec,
              T* __restrict__ dq, float* __restrict__ partial, int s, int h,
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

  stage_rows<T, HD>(q, b, g, s, h, q0, rt, scale, q_s);
  stage_rows<T, HD>(dout, b, g, s, h, q0, rt, 1.0f, do_s);
  stage_row_stats(lse, dvec, b, g, s, h, q0, rt, lse_s, dvec_s);

  float acc[4][kCols];                    // rows ty*4+a, dims tx+16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.0f;

  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = k_lo / kKeys; kt <= q_last / kKeys; ++kt) {
    const int k0 = kt * kKeys;
    stage_keys<T, HD>(k, b, g, s, hkv, k0, k_s);
    stage_keys<T, HD>(v, b, g, s, hkv, k0, v_s);
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
        store_as(&dq[((static_cast<size_t>(b) * s + pos) * h + g * rep +
                      row % rep) * HD + tx + 16 * c], acc[a][c]);
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
// materialized gradients, with the tiles and order of the fused epilogues.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const T* __restrict__ dq, const T* __restrict__ dk,
                 const T* __restrict__ dv, float* __restrict__ partial,
                 int s, int h, int hkv, int n_ktiles, int n_qtiles) {
  __shared__ float red[kWarps];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int n_kv = hkv * n_ktiles;
  float res;
  if (t < n_kv) {
    const int g = t / n_ktiles;
    const int k0 = (t % n_ktiles) * kKeys;
    auto key_tile = [&](const T* src) {
      return [=](int e) {
        const int kp = k0 + e / HD;
        return kp < s ? to_f32(src[((static_cast<size_t>(b) * s + kp) * hkv +
                                    g) * HD + e % HD])
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
                     ? to_f32(dq[((static_cast<size_t>(b) * s + pos) * h +
                                  g * rep + row % rep) * HD + e % HD])
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

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dvec,
                       void* dq, void* dk, void* dv, float* partial,
                       float* scores, int b, int s, int h, int hkv,
                       int window, float scale, cudaStream_t stream) {
  const Plan p = plan(s, h, hkv);
  constexpr size_t kv_bytes = dkdv_smem_bytes<HD>();
  constexpr size_t q_bytes = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, HD><<<dim3(p.n_ktiles, hkv, b), kThreads, kv_bytes,
                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
      static_cast<T*>(dk), static_cast<T*>(dv), partial, s, h, hkv, window,
      scale, p.n_qtiles, p.n_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, HD><<<dim3(p.n_qtiles, hkv, b), kThreads, q_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
      static_cast<T*>(dq), partial, s, h, hkv, window, scale, p.n_qtiles,
      p.n_kv, p.n_parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  return reduce(partial, b, p, scores, stream);
}

template <typename T, int HD>
cudaError_t launch_sweep(const void* dq, const void* dk, const void* dv,
                         float* partial, float* scores, int b, int s, int h,
                         int hkv, cudaStream_t stream) {
  const Plan p = plan(s, h, hkv);
  sweep_kernel<T, HD><<<dim3(p.n_parts, b), kThreads, 0, stream>>>(
      static_cast<const T*>(dq), static_cast<const T*>(dk),
      static_cast<const T*>(dv), partial, s, h, hkv, p.n_ktiles, p.n_qtiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, b, p, scores, stream);
}

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
#define FAB_CASE(T, HD)                                                     \
  err = launch_bwd<T, HD>(q, k, v, dout, lse, dvec, dq, dk, dv, partial,    \
                          scores, b, s, h, hkv, window, scale, st)
  switch (hd * 2 + (bf16 ? 1 : 0)) {
    case 64: FAB_CASE(float, 32); break;
    case 65: FAB_CASE(__nv_bfloat16, 32); break;
    case 128: FAB_CASE(float, 64); break;
    case 129: FAB_CASE(__nv_bfloat16, 64); break;
    case 256: FAB_CASE(float, 128); break;
    case 257: FAB_CASE(__nv_bfloat16, 128); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FAB_CASE
  return static_cast<int>(err);
}

// dq: (b, s, h, hd); dk, dv: (b, s, hkv, hd), contiguous, all f32 or all
// bf16.  partial: f32[b, fab_parts]; scores: f32[b].
int fab_sweep_launch(const void* dq, const void* dk, const void* dv,
                     float* partial, float* scores, int bf16, int b, int s,
                     int h, int hkv, int hd, int device, void* stream) {
  if (!shape_ok(b, s, h, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FAB_CASE(T, HD) \
  err = launch_sweep<T, HD>(dq, dk, dv, partial, scores, b, s, h, hkv, st)
  switch (hd * 2 + (bf16 ? 1 : 0)) {
    case 64: FAB_CASE(float, 32); break;
    case 65: FAB_CASE(__nv_bfloat16, 32); break;
    case 128: FAB_CASE(float, 64); break;
    case 129: FAB_CASE(__nv_bfloat16, 64); break;
    case 256: FAB_CASE(float, 128); break;
    case 257: FAB_CASE(__nv_bfloat16, 128); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FAB_CASE
  return static_cast<int>(err);
}

const char* fab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
