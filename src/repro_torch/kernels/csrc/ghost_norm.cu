// Per-example squared gradient norm of a linear layer shared across the
// S positions of a sequence (the ghost-norm extension of paper Prop. 1):
//
//   out[n] = ||X_n^T D_n||_F^2 = <X_n X_n^T, D_n D_n^T>_F
//          = sum_{s,t} (x_s . x_t) (d_s . d_t),
//
// with X_n (S, din) the layer input and D_n (S, dout) = dL/dY of row n.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ghost_norm.py::ghost_norm
// (_kernel): gn_tc_launch and gn_launch compute what it computes, for
// symmetric true or false (pairs of 64-position tiles j >= i, j > i counted
// twice).
//
// What bounds the function on an H100: bytes.  The two symmetric S x S
// Grams need S(S+1)(din + dout) flops a row, at most 1.7 TFLOP a step on
// the main paths (0.25 at S = 64, 1.69 for the S = 512 flash trainer, 0.51
// for falcon-mamba at S = 256): 0.25-1.71 ms on the bf16 tensor cores,
// against 3.82, 3.40 and 1.84 ms for the bytes of x (bf16) and d (f32) at
// 3.35 TB/s (chip_smoke.py::ghost_bounds).
//
// Two instances, chosen by the wrapper (kernels/ghost_norm.py):
//
// tensor cores (bf16 x, f32 or bf16 d; every LM call): three launches.
//   1. x_gram_kernel: one block per (row, tile pair), pair fastest, computes
//      the x Gram tile A_ij = X_i X_j^T (64 x 64, f32) over all of din and
//      stores it, in the accumulator's fragment order, to a scratch of
//      rows x pairs x 16 KB.
//   2. d_gram_kernel: one block per (row, feature split, tile pair), pair
//      fastest, so the pair blocks of one (row, split) run together and read
//      the same d slab from L2.  It accumulates B_ij over its split's
//      feature range, reads A_ij once and stores the scalar <A_ij, B_ij>:
//      <A, B> is linear in B, so the splits sum.  The wrapper picks the
//      number of splits (gn_tc_splits) so that every call has at least
//      kWaves waves of blocks; calls with few rows (the 128-row unembed at
//      S = 64) get them from the feature axis.  No Gram tile is written per
//      split.
//   3. row_sum_kernel sums each row's (pair, split) scalars in fixed order,
//      weight 2 for j > i when symmetric.
//   * Products are wgmma m64n64k16 with both operands K-major in shared
//     memory (rows are positions, K is features): 64-position x 64-feature
//     tiles that TMA brings through a hopper::Ring of stages refilled by
//     thread 0, one warpgroup a block.  bf16 tiles land under the 128-byte
//     swizzle that kmajor_desc reads.  An f32 d tile lands densely and is
//     split in shared memory into hi = bf16(d) and lo = bf16(d - hi), each
//     a swizzled bf16 tile; three products hi hi^T + hi lo^T + lo hi^T keep
//     the Gram to about 2^-17 (lo lo^T is below 2^-32 of a term).  bf16 x and
//     bf16 d take one product, exact up to the f32 accumulation.
//   * Each 64-feature k-tile's products go into a fresh accumulator that is
//     added to the running sum with f32 adds: wgmma's own accumulation
//     truncates, and over 151,552 features (2,368 k-tiles) its bias alone
//     would be ~1e-3 of a diagonal entry.
//   * Ragged S and widths read as exact zeros (TMA's out-of-bounds fill),
//     which equals the reference's zero padding.  TMA needs 16-byte row
//     pitches and base addresses; the wrapper sends other calls to SIMT.
//
// SIMT (f32 x, or a pitch TMA cannot take): two launches.
//   * gram_pair_kernel: one block per (row, i-tile, j-tile) pair loops over
//     the feature axis itself: tiles of x and d are staged in shared memory
//     as f32 (bf16 is upcast on load), and both 64 x 64 Grams accumulate in
//     f32 registers (a 4 x 4 micro-tile per thread, f32 FMA, no TF32).  The
//     block multiplies the Grams elementwise, reduces in a fixed order and
//     stores one partial a pair; row_sum_kernel sums them as above.
//
// Both: no float atomics, every reduction in a fixed order, so two launches
// on the same inputs are bitwise equal.  Each launch function returns
// cudaGetLastError(); the wrapper raises if it is not cudaSuccess.
//
// Not done here (later work): the pair blocks of a row read each d tile
// once per pair that holds it (2 ns tiles for ns (ns + 1) / 2 pairs), from
// L2 when they run together: a block that keeps D_i and streams every
// D_j >= i would read it about half as often.  A shared x Gram for taps
// with one input (wq/wk/wv, w_in/w_gate); wgmma overlap within a block (each
// k-tile waits on its products before the next); the SIMT instance's staging
// store, which hits 8 of 32 banks (kLd = 68 is 4 mod 32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;              // S positions per Gram tile
constexpr int kBK = 32;                // features per shared-memory stage
constexpr int kLd = kTile + 4;         // padded row of a staged tile (floats)
constexpr int kThreads = 256;          // 16 x 16 threads, 4 x 4 outputs each
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stage features [k0, k0 + kBK) of `rows` positions starting at `base` into
// tile[k][row] (k-major, so a thread reads its 4 rows as one float4).
// Neighbouring threads read neighbouring features of one position.
template <typename T>
__device__ __forceinline__ void stage(const T* base, int rows, int width,
                                      int k0, float (*tile)[kLd]) {
  for (int e = threadIdx.x; e < kTile * kBK; e += kThreads) {
    const int row = e / kBK;
    const int k = e % kBK;
    float v = 0.0f;
    if (row < rows && k0 + k < width)
      v = to_f32(base[static_cast<size_t>(row) * width + k0 + k]);
    tile[k][row] = v;
  }
}

// acc[a][b] += sum_k A_i[ty*4+a, k] * A_j[tx*4+b, k] over the whole width:
// the (i, j) tile of the Gram A A^T of one row, in registers.
template <typename T>
__device__ __forceinline__ void gram_tile(const T* base_i, const T* base_j, int rows_i,
                          int rows_j, int width, bool same,
                          float (*ti)[kLd], float (*tj)[kLd],
                          float acc[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float (*other)[kLd] = same ? ti : tj;
  for (int k0 = 0; k0 < width; k0 += kBK) {
    stage(base_i, rows_i, width, k0, ti);
    if (!same) stage(base_j, rows_j, width, k0, tj);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&ti[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&other[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// Pair p of the row's (i, j) tile pairs, in row-major order: all (i, j) when
// not symmetric, j >= i when symmetric.
__device__ __forceinline__ void pair_of(int p, int ns, int symmetric, int* i,
                                        int* j) {
  if (!symmetric) {
    *i = p / ns;
    *j = p % ns;
    return;
  }
  int ii = 0;
  while (p >= ns - ii) {
    p -= ns - ii;
    ++ii;
  }
  *i = ii;
  *j = ii + p;
}

// grid (rows, n_pairs): block (n, p) stores <A_ij, B_ij> of row n at
// partial[n * n_pairs + p].
template <typename TX, typename TD>
__global__ void __launch_bounds__(kThreads)
    gram_pair_kernel(const TX* x, const TD* d, int s, int din, int dout,
                     int ns, int n_pairs, int symmetric, float* partial) {
  __shared__ __align__(16) float ti[kBK][kLd];
  __shared__ __align__(16) float tj[kBK][kLd];
  __shared__ float part[kWarps];
  const int n = blockIdx.x;
  const int p = blockIdx.y;
  int i, j;
  pair_of(p, ns, symmetric, &i, &j);
  const int rows_i = min(kTile, s - i * kTile);
  const int rows_j = min(kTile, s - j * kTile);
  const bool same = i == j;

  float ga[4][4] = {};
  float gb[4][4] = {};
  const size_t xrow = static_cast<size_t>(n) * s * din;
  const size_t drow = static_cast<size_t>(n) * s * dout;
  gram_tile(x + xrow + static_cast<size_t>(i) * kTile * din,
            x + xrow + static_cast<size_t>(j) * kTile * din, rows_i, rows_j,
            din, same, ti, tj, ga);
  gram_tile(d + drow + static_cast<size_t>(i) * kTile * dout,
            d + drow + static_cast<size_t>(j) * kTile * dout, rows_i, rows_j,
            dout, same, ti, tj, gb);

  float v = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) v = fmaf(ga[r][c], gb[r][c], v);
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? part[lane] : 0.0f;
    for (int off = kWarps / 2; off > 0; off >>= 1)
      v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) partial[static_cast<size_t>(n) * n_pairs + p] = v;
  }
}

// One thread per row: out[n] = sum_p w_p * sum_c partial[n, c, p], pairs
// in order and splits in order within each, w_p = 2 for j > i when
// symmetric, else 1.
__global__ void row_sum_kernel(const float* partial, int rows, int ns,
                               int n_pairs, int n_splits, int symmetric,
                               float* out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= rows) return;
  const float* row = partial + static_cast<size_t>(n) * n_splits * n_pairs;
  float acc = 0.0f;
  int p = 0;
  for (int i = 0; i < ns; ++i) {
    for (int j = symmetric ? i : 0; j < ns; ++j, ++p) {
      float c = row[p];
      for (int sp = 1; sp < n_splits; ++sp)
        c += row[static_cast<size_t>(sp) * n_pairs + p];
      acc += (symmetric && j > i) ? 2.0f * c : c;
    }
  }
  out[n] = acc;
}

cudaError_t row_sums(const float* partial, int rows, int ns, int n_pairs,
                     int n_splits, int symmetric, float* out,
                     cudaStream_t stream) {
  constexpr int kRowThreads = 128;
  row_sum_kernel<<<(rows + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                   stream>>>(partial, rows, ns, n_pairs, n_splits, symmetric,
                             out);
  return cudaGetLastError();
}

template <typename TX, typename TD>
void launch_pairs(const void* x, const void* d, int rows, int s, int din,
                  int dout, int ns, int n_pairs, int symmetric,
                  float* partial, cudaStream_t stream) {
  const dim3 grid(rows, n_pairs);
  gram_pair_kernel<TX, TD><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TD*>(d), s, din, dout, ns,
      n_pairs, symmetric, partial);
}

// ------------------------------------------ tensor cores: wgmma on TMA tiles
namespace tc {

constexpr int kThreads = 128;          // one warpgroup
constexpr int kKT = 64;                // features a k-tile
constexpr int kElems = kTile * kKT;    // values of a tile, and of a Gram tile
constexpr int kWaves = 4;              // waves of d-Gram blocks a call, at least
constexpr int kMinTiles = 8;           // k-tiles a feature split, at least

// Dynamic shared memory for tiles of T: the ring's stages (tile i, then tile
// j), for f32 the four bf16 parts (hi_i, lo_i, hi_j, lo_j), then the
// mbarriers (full[kStages], empty[kStages]); 1024 bytes of slack align the
// base for the swizzle.  f32: 2 stages, 99 KB, two blocks an SM; bf16: 4
// stages, 67 KB, three.
template <typename T>
struct Smem {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kStages = kF32 ? 2 : 4;
  static constexpr int kTileBytes = kElems * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kPartBytes = kElems * 2;
  static constexpr int kParts = kStages * kStageBytes;
  static constexpr int kBars = kParts + (kF32 ? 4 * kPartBytes : 0);
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
};

// Split the f32 tile at src (64 rows of 64 values, dense, as TMA lands it
// without swizzle) into hi = bf16(v) and lo = bf16(v - hi), each a bf16 tile
// in the 128-byte swizzled layout kmajor_desc<64, 64> reads: value k of row r
// at r * 128 + ((k / 8) ^ (r % 8)) * 16 + (k % 8) * 2.  A thread takes four
// consecutive values a step; a quarter warp reads 128 contiguous bytes and a
// half warp writes one row's 128, so neither conflicts.
__device__ __forceinline__ void split_tile(const uint8_t* src, uint8_t* hi,
                                           uint8_t* lo) {
#pragma unroll
  for (int it = 0; it < kElems / 4 / kThreads; ++it) {
    const int idx = it * kThreads + static_cast<int>(threadIdx.x);
    const int r = idx / 16;
    const int q = idx % 16;
    const float4 v = *reinterpret_cast<const float4*>(src + r * 256 + q * 16);
    const int off = r * 128 + (((q >> 1) ^ (r & 7)) << 4) + (q & 1) * 8;
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f0 = __bfloat1622float2(h0);
    const float2 f1 = __bfloat1622float2(h1);
    const __nv_bfloat162 l0 = __floats2bfloat162_rn(v.x - f0.x, v.y - f0.y);
    const __nv_bfloat162 l1 = __floats2bfloat162_rn(v.z - f1.x, v.w - f1.y);
    *reinterpret_cast<uint2*>(hi + off) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                   *reinterpret_cast<const uint32_t*>(&h1));
    *reinterpret_cast<uint2*>(lo + off) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&l0),
                   *reinterpret_cast<const uint32_t*>(&l1));
  }
}

// acc += the (i, j) tile of row n's Gram T T^T over k-tiles [kt0, kt0 + n_kt)
// of the map's feature axis, in the m64n64 accumulator's fragment order
// (hopper.cuh).  Every thread of the block calls it once.
template <typename T>
__device__ __forceinline__ void gram_tile(const CUtensorMap* map,
                                          uint8_t* base_ptr, uint32_t base,
                                          int n, int i, int j, int kt0,
                                          int n_kt, float (&acc)[32]) {
  using L = Smem<T>;
  const bool same = i == j;
  const hopper::Ring<L::kStages, 4> ring{base + L::kBars,
                                         base + L::kBars + 8 * L::kStages,
                                         n_kt};
  // tile t of the ring: features [(kt0 + t) 64, +64) of positions i 64..
  // and j 64.. of row n
  auto load = [&](int t, int st, uint32_t bar) {
    const uint32_t dst = base + st * L::kStageBytes;
    const int k0 = (kt0 + t) * kKT;
    hopper::mbar_expect_tx(bar, same ? L::kTileBytes : 2 * L::kTileBytes);
    hopper::tma_load_3d(dst, map, bar, k0, i * kTile, n);
    if (!same)
      hopper::tma_load_3d(dst + L::kTileBytes, map, bar, k0, j * kTile, n);
  };
  if (threadIdx.x == 0) {
    ring.init();
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) ring.start(load);

  for (int t = 0; t < n_kt; ++t) {
    ring.wait(t);
    const int st = t % L::kStages;
    uint32_t ti = base + st * L::kStageBytes;
    uint32_t tj = same ? ti : ti + L::kTileBytes;
    uint32_t li = 0, lj = 0;               // the lo parts (f32 only)
    if constexpr (L::kF32) {
      uint8_t* parts = base_ptr + L::kParts;
      split_tile(base_ptr + st * L::kStageBytes, parts, parts + L::kPartBytes);
      if (!same)
        split_tile(base_ptr + st * L::kStageBytes + L::kTileBytes,
                   parts + 2 * L::kPartBytes, parts + 3 * L::kPartBytes);
      hopper::fence_proxy_async();
      __syncthreads();                     // parts written, stage read
      ring.release(t, load);
      ti = base + L::kParts;
      li = ti + L::kPartBytes;
      tj = same ? ti : ti + 2 * L::kPartBytes;
      lj = tj + L::kPartBytes;
    }
    float p[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) p[e] = 0.0f;
    hopper::fence_regs(p);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      const uint64_t di = hopper::kmajor_desc<64, kTile>(ti, kk);
      const uint64_t dj = hopper::kmajor_desc<64, kTile>(tj, kk);
      hopper::wgmma_ss_n64(p, di, dj, kk > 0);
      if constexpr (L::kF32) {
        hopper::wgmma_ss_n64(p, di, hopper::kmajor_desc<64, kTile>(lj, kk), 1);
        hopper::wgmma_ss_n64(p, hopper::kmajor_desc<64, kTile>(li, kk), dj, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(p);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += p[e];
    if constexpr (L::kF32)
      __syncthreads();                     // parts read before the next split
    else
      ring.release(t, load);
  }
}

// Launch 1.  Block b = n * n_pairs + p stores the (i, j) tile of row n's x
// Gram at gx[b * kElems]: value 4 q + c of thread t at (q * kThreads + t) * 4
// + c, so that launch 2's threads read back their own.
__global__ void __launch_bounds__(kThreads)
    x_gram_kernel(const __grid_constant__ CUtensorMap tm_x, int din, int ns,
                  int n_pairs, int symmetric, float* __restrict__ gx) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::align_1024(smem_raw);
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const int p = static_cast<int>(blockIdx.x) % n_pairs;
  const int n = static_cast<int>(blockIdx.x) / n_pairs;
  int i, j;
  pair_of(p, ns, symmetric, &i, &j);
  float acc[32] = {};
  gram_tile<__nv_bfloat16>(&tm_x, base_ptr, base, n, i, j, 0,
                           (din + kKT - 1) / kKT, acc);
  float4* dst = reinterpret_cast<float4*>(
      gx + static_cast<size_t>(blockIdx.x) * kElems);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    dst[q * kThreads + threadIdx.x] =
        make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                    acc[4 * q + 3]);
}

// Launch 2.  Block b = (n * n_splits + c) * n_pairs + p stores <A_ij, B_ij>
// at partial[b], B_ij the (i, j) tile of row n's d Gram over the k-tiles of
// split c: [c n_kt / n_splits, (c + 1) n_kt / n_splits).
template <typename TD>
__global__ void __launch_bounds__(kThreads)
    d_gram_kernel(const __grid_constant__ CUtensorMap tm_d, int dout, int ns,
                  int n_pairs, int n_splits, int symmetric,
                  const float* __restrict__ gx, float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float part[kThreads / 32];
  const uint32_t base = hopper::align_1024(smem_raw);
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const int p = static_cast<int>(blockIdx.x) % n_pairs;
  const int rest = static_cast<int>(blockIdx.x) / n_pairs;
  const int c = rest % n_splits;
  const int n = rest / n_splits;
  int i, j;
  pair_of(p, ns, symmetric, &i, &j);
  const long long n_kt = (dout + kKT - 1) / kKT;
  const int kt0 = static_cast<int>(c * n_kt / n_splits);
  const int kt1 = static_cast<int>((c + 1) * n_kt / n_splits);
  float acc[32] = {};
  gram_tile<TD>(&tm_d, base_ptr, base, n, i, j, kt0, kt1 - kt0, acc);

  const float4* a = reinterpret_cast<const float4*>(
      gx + (static_cast<size_t>(n) * n_pairs + p) * kElems);
  float v = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 av = a[q * kThreads + threadIdx.x];
    v = fmaf(acc[4 * q], av.x, v);
    v = fmaf(acc[4 * q + 1], av.y, v);
    v = fmaf(acc[4 * q + 2], av.z, v);
    v = fmaf(acc[4 * q + 3], av.w, v);
  }
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    partial[blockIdx.x] = ((part[0] + part[1]) + part[2]) + part[3];
}

template <typename TD>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      x_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<__nv_bfloat16>::kBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(d_gram_kernel<TD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Smem<TD>::kBytes);
}

// Feature splits of launch 2: enough for kWaves waves of resident blocks,
// at most one per kMinTiles k-tiles, at least 1.
template <typename TD>
cudaError_t splits(int rows, int n_pairs, int dout, int device, int* out) {
  cudaError_t err = set_smem<TD>();
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, d_gram_kernel<TD>, kThreads, Smem<TD>::kBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(rows) * n_pairs;
  const long long want = kWaves * static_cast<long long>(sms) * per_sm;
  const long long n_kt = (dout + kKT - 1) / kKT;
  long long c = (want + blocks - 1) / blocks;
  c = c < n_kt / kMinTiles ? c : n_kt / kMinTiles;
  *out = static_cast<int>(c > 1 ? c : 1);
  return cudaSuccess;
}

template <typename TD>
cudaError_t launch(const void* x, const void* d, int rows, int s, int din,
                   int dout, int symmetric, int n_splits, float* gx,
                   float* partial, float* out, cudaStream_t stream) {
  constexpr bool kDBf16 = sizeof(TD) == 2;
  const int ns = (s + kTile - 1) / kTile;
  const int n_pairs = symmetric ? ns * (ns + 1) / 2 : ns * ns;
  CUtensorMap tm_x, tm_d;
  cudaError_t err =
      hopper::rows_map(&tm_x, x, true, din, s, rows, kKT, kTile, true);
  if (err == cudaSuccess)
    err = hopper::rows_map(&tm_d, d, kDBf16, dout, s, rows, kKT, kTile,
                           kDBf16);
  if (err == cudaSuccess) err = set_smem<TD>();
  if (err != cudaSuccess) return err;
  x_gram_kernel<<<rows * n_pairs, kThreads, Smem<__nv_bfloat16>::kBytes,
                  stream>>>(tm_x, din, ns, n_pairs, symmetric, gx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  d_gram_kernel<TD><<<rows * n_pairs * n_splits, kThreads, Smem<TD>::kBytes,
                      stream>>>(tm_d, dout, ns, n_pairs, n_splits, symmetric,
                                gx, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return row_sums(partial, rows, ns, n_pairs, n_splits, symmetric, out,
                  stream);
}

}  // namespace tc

}  // namespace

extern "C" {

int gn_tile() { return kTile; }

// Number of (i, j) tile pairs of one row, i.e. the scratch's second extent.
int gn_pairs(int s, int symmetric) {
  const int ns = (s + kTile - 1) / kTile;
  return symmetric ? ns * (ns + 1) / 2 : ns * ns;
}

int gn_max_pairs() { return 65535; }   // gridDim.y

// x: (rows, s, din), d: (rows, s, dout), contiguous, f32 or bf16 each.
// partial: f32[rows, gn_pairs(s, symmetric)] scratch; out: f32[rows].
int gn_launch(const void* x, const void* d, int x_bf16, int d_bf16, int rows,
              int s, int din, int dout, int symmetric, int device,
              float* partial, float* out, void* stream) {
  const int ns = (s + kTile - 1) / kTile;
  const int n_pairs = gn_pairs(s, symmetric);
  if (rows < 1 || s < 1 || din < 0 || dout < 0 || n_pairs > gn_max_pairs())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && d_bf16)
    launch_pairs<__nv_bfloat16, __nv_bfloat16>(x, d, rows, s, din, dout, ns,
                                               n_pairs, symmetric, partial, st);
  else if (x_bf16)
    launch_pairs<__nv_bfloat16, float>(x, d, rows, s, din, dout, ns, n_pairs,
                                       symmetric, partial, st);
  else if (d_bf16)
    launch_pairs<float, __nv_bfloat16>(x, d, rows, s, din, dout, ns, n_pairs,
                                       symmetric, partial, st);
  else
    launch_pairs<float, float>(x, d, rows, s, din, dout, ns, n_pairs,
                               symmetric, partial, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      row_sums(partial, rows, ns, n_pairs, 1, symmetric, out, st));
}

int gn_tc_tile_elems() { return tc::kElems; }

// The tensor-core instance takes bf16 x with f32 or bf16 d: the number of
// feature splits of its d Gram for this call, into *n_splits.
int gn_tc_splits(int rows, int s, int dout, int symmetric, int d_bf16,
                 int device, int* n_splits) {
  if (rows < 1 || s < 1 || dout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_pairs = gn_pairs(s, symmetric);
  err = d_bf16 ? tc::splits<__nv_bfloat16>(rows, n_pairs, dout, device,
                                           n_splits)
               : tc::splits<float>(rows, n_pairs, dout, device, n_splits);
  return static_cast<int>(err);
}

// x: (rows, s, din) bf16, d: (rows, s, dout) f32 or bf16, contiguous, base
// addresses and row pitches multiples of 16 bytes.  gx: f32[rows,
// gn_pairs(s, symmetric), gn_tc_tile_elems()] and partial: f32[rows,
// n_splits, gn_pairs(s, symmetric)] scratch; out: f32[rows].
int gn_tc_launch(const void* x, const void* d, int d_bf16, int rows, int s,
                 int din, int dout, int symmetric, int n_splits, int device,
                 float* gx, float* partial, float* out, void* stream) {
  const long long blocks =
      static_cast<long long>(rows) * gn_pairs(s, symmetric) * n_splits;
  if (rows < 1 || s < 1 || din < 1 || dout < 1 || n_splits < 1 ||
      blocks > 0x7fffffffll)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = d_bf16 ? tc::launch<__nv_bfloat16>(x, d, rows, s, din, dout,
                                           symmetric, n_splits, gx, partial,
                                           out, st)
               : tc::launch<float>(x, d, rows, s, din, dout, symmetric,
                                   n_splits, gx, partial, out, st);
  return static_cast<int>(err);
}

const char* gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
