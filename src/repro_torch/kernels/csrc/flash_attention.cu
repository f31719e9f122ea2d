// Causal (optionally sliding-window) GQA attention forward with an online
// softmax, for prefill:
//
//   out[b, i, g*rep + r] = sum_{j visible from i} softmax_j(q_i . k_j * scale) v_j
//
// q (B, S, H, hd), k and v (B, S, Hkv, hd) with rope applied, rep = H / Hkv;
// key j is visible from query i when j <= i and, for window > 0,
// i - j < window.  With an lse pointer it also writes the (B, H, S) f32
// logsumexp m + log(max(l, 1e-20)), the residual of a backward pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_kernel) and computes its function: masked entries at
// _NEG = -1e30, p = exp(s - m) * mask, output o / max(l, 1e-20) in q's dtype.
//
// What bounds the function on an H100: operations.  At glm4-9b's prefill
// (B = 8, S = 2048, H = 32, Hkv = 2, hd = 128, bf16) it needs
// 4 B H hd S(S+1)/2 = 275 GFLOP, 0.28 ms on the bf16 tensor cores, against
// 151 MB of q, k, v and out (0.05 ms).  Only the tensor cores can come near
// that: f32 FMA on the CUDA cores (67 TFLOP/s) cannot go below 4.1 ms.
//
// Two instances, chosen by dtype:
//
// bf16: flash_fwd_tc, wgmma on tiles that TMA brings into shared memory.
//   * a block is two consumer warpgroups.  Each owns a 64-row query tile:
//     rows are (position, head) pairs of ONE KV group, 64 / rep positions
//     times all rep heads of group g, so each K/V tile serves every head of
//     the group; the block's two tiles are neighbours.  Thread 0 also loads
//     both Q tiles once, then keeps TMA loads of 64-key K and V tiles in
//     flight through a ring of kStages stages with full/empty mbarriers
//     (hopper::Ring, shared with the backward; a dedicated producer warp
//     measured ~1.5% faster, not worth a second pipeline).  q, k, v are
//     mapped as 4-D tensors (hd, heads, S, B): a Q tile is one box (hd
//     chunk, rep, 64 / rep, 1) whose rows land in the row order above, and
//     S is a true bound, so the ragged tail reads as zeros.  Rows past
//     64 / rep * rep (rep 6: 60 live rows) are never written by TMA; they
//     are zeroed once.
//   * per key tile a consumer computes S = Q K^T by SS wgmma (m64 n64 k16
//     over hd), scales and masks S in registers on the accumulator layout,
//     runs the online softmax there (a row's max and sum are two xor
//     shuffles over the 4 lanes that share it), and adds P V to its O
//     accumulator by RS wgmma, V read MN-major.  The accumulator of S turns
//     into the A fragments of P in registers: P never goes to shared memory.
//   * numerics: Q K^T has bf16 inputs and is exact up to the f32
//     accumulation.  P is f32; a single bf16 P would err by 2^-9 a term, so
//     P is split into hi = bf16(P) and lo = bf16(P - hi), and P V is two
//     wgmmas (hi, lo) into one f32 accumulator: the error stays about 2^-17,
//     near the f32 kernel's.  l sums the f32 P.  The scale multiplies S
//     after the product.
//   * kept from the SIMT design: key tiles wholly in the future of a
//     block's last position or wholly before the window of its first are
//     never loaded (and a consumer skips those outside its own tile's
//     range); blocks are issued longest first; each output row has one
//     writer, so two launches are bitwise equal.
//
// f32: flash_fwd_kernel, f32 FMA on the CUDA cores (the f32 parity path;
//   wgmma has no f32 input that keeps f32 accuracy).
//   * one block owns 64 query rows, the rows above, and a loop inside the
//     block walks the 64-key tiles in order, with the same tile skipping.
//   * 256 threads in a 16 x 16 grid; thread (ty, tx) computes scores of rows
//     ty*4..ty*4+3 against keys tx, tx+16, tx+32, tx+48 (conflict-free reads
//     of the K tile, row stride hd + 1) and owns the output of the same rows
//     at dims tx + 16 c.  A row's max and sum are shuffles over the 16 lanes
//     that share it.  q (times the scale before the dot) and p are kept
//     transposed so a thread reads its four rows as one float4.  K and V
//     share one staging buffer.  The ragged tail of S is masked in the loads.
//
// Each launch function returns cudaGetLastError(); the wrapper raises if it
// is not cudaSuccess.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                 // query (position, head) rows a block
constexpr int kKeys = 64;                 // keys per K/V tile
constexpr int kThreads = 256;             // 16 x 16
constexpr int kTLd = kRows + 4;           // transposed q / p row (floats)
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// max / sum over the 16 lanes that share a row (lane bit 4 is ty's parity);
// the xor butterfly leaves the same value in every lane
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(HD) * kTLd + kKeys * (HD + 1) + kKeys * kTLd);
}

// Stage keys [k0, k0 + kKeys) of (b, g) from src into kv[j][d] (row
// stride hd + 1); keys at or past s as 0.
template <int HD>
__device__ __forceinline__ void stage_kv(const float* __restrict__ src, int b,
                                         int g, int s, int hkv, int k0,
                                         float* kv) {
  for (int e = threadIdx.x; e < kKeys * HD; e += kThreads) {
    const int j = e / HD;
    const int d = e % HD;
    const int kp = k0 + j;
    kv[j * (HD + 1) + d] =
        kp < s ? src[((static_cast<size_t>(b) * s + kp) * hkv + g) * HD + d]
               : 0.0f;
  }
}

// grid (n_qtiles, hkv, b); dynamic shared memory smem_bytes<HD>().
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int s, int h, int hkv,
                     int window, float scale, int n_qtiles) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;          // output dims a thread owns
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                      // [HD][kTLd]  q, transposed
  float* kv = q_t + HD * kTLd;            // [kKeys][kLd] K, then V
  float* p_t = kv + kKeys * kLd;          // [kKeys][kTLd] p, transposed

  const int rep = h / hkv;
  const int bq = kRows / rep;             // positions a block
  const int live_rows = bq * rep;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x);
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * bq;
  const int q_last = min(q0 + bq, s) - 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // row i = (position q0 + i / rep, head g*rep + i % rep), f32 times scale
  for (int e = threadIdx.x; e < kRows * HD; e += kThreads) {
    const int row = e / HD;
    const int d = e % HD;
    const int pos = q0 + row / rep;
    float val = 0.0f;
    if (row < live_rows && pos < s)
      val = q[((static_cast<size_t>(b) * s + pos) * h + g * rep + row % rep) *
                  HD + d] * scale;
    q_t[d * kTLd + row] = val;
  }

  int qpos[4];
  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    qpos[a] = q0 + (ty * 4 + a) / rep;
    m[a] = kNeg;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[a][c] = 0.0f;
  }

  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = k_lo / kKeys; kt <= q_last / kKeys; ++kt) {
    const int k0 = kt * kKeys;
    stage_kv<HD>(k, b, g, s, hkv, k0, kv);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&q_t[d * kTLd + ty * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = kv[(tx + 16 * c) * kLd + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(qv[a], kb[c], sc[a][c]);
    }

    // mask, online softmax; p goes to p_t[key][row]
    float pv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        ok[c] = kp <= qpos[a] && kp < s &&
                (window <= 0 || qpos[a] - kp < window);
        sc[a][c] = ok[c] ? sc[a][c] : kNeg;
        mx = fmaxf(mx, sc[a][c]);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      const float alpha = expf(m[a] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pv[a][c] = ok[c] ? expf(sc[a][c] - m_new) : 0.0f;
        ps += pv[a][c];
      }
      l[a] = l[a] * alpha + row_sum(ps);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[a][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&p_t[(tx + 16 * c) * kTLd + ty * 4]) =
          make_float4(pv[0][c], pv[1][c], pv[2][c], pv[3][c]);
    __syncthreads();                      // p written, K no longer read

    stage_kv<HD>(v, b, g, s, hkv, k0, kv);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&p_t[j * kTLd + ty * 4]);
      const float pw[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = kv[j * kLd + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) o[a][c] = fmaf(pw[a], vv, o[a][c]);
      }
    }
    __syncthreads();                      // before the next tile overwrites
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = ty * 4 + a;
    const int pos = qpos[a];
    if (row < live_rows && pos < s) {
      const int head = g * rep + row % rep;
      const float denom = fmaxf(l[a], 1e-20f);
      float* dst = out + ((static_cast<size_t>(b) * s + pos) * h + head) * HD;
#pragma unroll
      for (int c = 0; c < kCols; ++c) dst[tx + 16 * c] = o[a][c] / denom;
      if (lse != nullptr && tx == 0)
        lse[(static_cast<size_t>(b) * h + head) * s + pos] = m[a] + logf(denom);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int s, int h, int hkv, int window,
                   float scale, cudaStream_t stream) {
  const int bq = kRows / (h / hkv);
  const int n_qtiles = (s + bq - 1) / bq;
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_qtiles, hkv, b);
  flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s, h, hkv,
      window, scale, n_qtiles);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16: wgmma on TMA tiles
namespace tc {

// Two consumer warpgroups, one query tile each; thread 0 also issues the
// TMA loads (hopper::Ring).
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers;
constexpr int kStages = 3;                // K/V ring

// Dynamic shared memory: Q tiles, the K and V ring, then the mbarriers
// (q[kConsumers], full[kStages], empty[kStages]); 1024 bytes of slack align
// the base for the swizzle.
template <int HD>
struct Smem {
  static constexpr int kQ = hopper::Tile<HD>::bytes(kRows);
  static constexpr int kKV = hopper::Tile<HD>::bytes(kKeys);
  static constexpr int kK = kConsumers * kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBars = kV + kStages * kKV;
  static constexpr int kBytes = kBars + 8 * (kConsumers + 2 * kStages) + 1024;
};

// Key tiles that query tile qt sees: [lo, hi].
__device__ __forceinline__ int ktile_lo(int qt, int bq, int window) {
  return window > 0 ? max(0, qt * bq - window + 1) / kKeys : 0;
}
__device__ __forceinline__ int ktile_hi(int qt, int bq, int s) {
  return (min(qt * bq + bq, s) - 1) / kKeys;
}

// grid (ceil(n_qtiles / 2), hkv, b); kThreads threads; Smem<HD>::kBytes.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int s, int h, int hkv, int window, float scale,
                 int n_qtiles) {
  using Tl = hopper::Tile<HD>;
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = hopper::align_1024(smem_raw);
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t bar_q = base + L::kBars;

  const int rep = h / hkv;
  const int bq = kRows / rep;             // positions a query tile
  const int live_rows = bq * rep;
  const int qt0 = 2 * (static_cast<int>(gridDim.x) - 1 -
                       static_cast<int>(blockIdx.x));
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128;
  const int n_live = min(kConsumers, n_qtiles - qt0);
  // the key tiles of the block: from its first tile's lo to its last's hi
  const int kt_begin = ktile_lo(qt0, bq, window);
  const hopper::Ring<kStages, 4 * kConsumers> ring{
      bar_q + 8 * kConsumers, bar_q + 8 * (kConsumers + kStages),
      ktile_hi(qt0 + n_live - 1, bq, s) - kt_begin + 1};
  // tile i of the ring: the K and V of key tile kt_begin + i
  auto load = [&](int i, int st, uint32_t bar) {
    hopper::mbar_expect_tx(bar, 2 * L::kKV);
    const int k0 = (kt_begin + i) * kKeys;
    hopper::load_tile<HD, kKeys>(base + L::kK + st * L::kKV, &tm_k, bar, g,
                                 k0, b);
    hopper::load_tile<HD, kKeys>(base + L::kV + st * L::kKV, &tm_v, bar, g,
                                 k0, b);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kConsumers; ++i) hopper::mbar_init(bar_q + 8 * i, 1);
    ring.init();
    hopper::fence_mbar_init();
  }
  hopper::zero_dead_rows<HD>(base_ptr, kConsumers, live_rows);  // Q tiles
  hopper::fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < n_live; ++w) {
      hopper::mbar_expect_tx(bar_q + 8 * w, Tl::bytes(live_rows));
      hopper::load_tile<HD, kRows>(base + w * L::kQ, &tm_q, bar_q + 8 * w,
                                   g * rep, (qt0 + w) * bq, b);
    }
    ring.start(load);
  }

  // consumer wg: query tile qt, rows r0 = 16 (warp % 4) + lane / 4 and
  // r0 + 8 of it in this thread
  const int qt = qt0 + wg;
  const bool tile_live = wg < n_live;
  const int my_lo = ktile_lo(qt, bq, window) - kt_begin;  // its ring tiles
  const int my_hi = tile_live ? ktile_hi(qt, bq, s) - kt_begin : -1;
  const int r0 = 16 * (warp % 4) + lane / 4;
  int pos[2], head[2];
  bool live[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = r0 + 8 * a;
    pos[a] = qt * bq + row / rep;
    head[a] = g * rep + row % rep;
    live[a] = tile_live && row < live_rows && pos[a] < s;
  }
  const uint32_t q_base = base + wg * L::kQ;
  float o[HD / 2], m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  if (tile_live) hopper::mbar_wait(bar_q + 8 * wg, 0);

  for (int i = 0; i < ring.n; ++i) {
    ring.wait(i);
    if (i >= my_lo && i <= my_hi) {
      const int st = i % kStages;
      const uint32_t k_tile = base + L::kK + st * L::kKV;
      const uint32_t v_tile = base + L::kV + st * L::kKV;
      const uint32_t q_tile = hopper::opaque(q_base);
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        hopper::wgmma_ss_n64(sc, hopper::kmajor_desc<HD, kRows>(q_tile, kk),
                             hopper::kmajor_desc<HD, kKeys>(k_tile, kk),
                             kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // scale and mask; entry j is row r0 + 8 ((j / 2) % 2), key
      // k0 + 8 (j / 4) + 2 (lane % 4) + j % 2
      const int k0 = (kt_begin + i) * kKeys;
      uint32_t okm = 0;
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int a = (j >> 1) & 1;
        const int kp = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const bool ok = live[a] && kp <= pos[a] &&
                        (window <= 0 || pos[a] - kp < window);
        sc[j] = ok ? sc[j] * scale : kNeg;
        okm |= ok ? (1u << j) : 0u;
        mx[a] = fmaxf(mx[a], sc[j]);
      }
      float alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        mx[a] = fmaxf(mx[a], __shfl_xor_sync(kFull, mx[a], 1));
        mx[a] = fmaxf(mx[a], __shfl_xor_sync(kFull, mx[a], 2));
        const float m_new = fmaxf(m[a], mx[a]);
        alpha[a] = expf(m[a] - m_new);
        m[a] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int a = (j >> 1) & 1;
        sc[j] = (okm >> j) & 1u ? expf(sc[j] - m[a]) : 0.0f;
        ps[a] += sc[j];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        ps[a] += __shfl_xor_sync(kFull, ps[a], 1);
        ps[a] += __shfl_xor_sync(kFull, ps[a], 2);
        l[a] = l[a] * alpha[a] + ps[a];
      }
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

      // O += P_hi V + P_lo V
      uint32_t f[4][2][4];
      hopper::split_tile<2>(sc, f);
      hopper::fence_regs(o);
      hopper::fence_regs(f);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = hopper::mnmajor_desc<HD, kKeys>(v_tile, kk);
        hopper::wgmma_rs<HD>(o, f[kk][0], dv);
        hopper::wgmma_rs<HD>(o, f[kk][1], dv);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(f);
    }
    ring.release(i, load);
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    if (!live[a]) continue;
    const float denom = fmaxf(l[a], 1e-20f);
    __nv_bfloat16* dst =
        out + ((static_cast<size_t>(b) * s + pos[a]) * h + head[a]) * HD;
#pragma unroll
    for (int j = 2 * a; j < HD / 2; j += 4) {
      const int col = 8 * (j >> 2) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dst + col) =
          __floats2bfloat162_rn(o[j] / denom, o[j + 1] / denom);
    }
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<size_t>(b) * h + head[a]) * s + pos[a]] =
          m[a] + logf(denom);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int s, int h, int hkv, int window,
                   float scale, cudaStream_t stream) {
  const int rep = h / hkv;
  const int bq = kRows / rep;
  const int n_qtiles = (s + bq - 1) / bq;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = hopper::tile_map<HD>(&tm_q, q, h, s, b, rep, bq);
  if (err == cudaSuccess)
    err = hopper::tile_map<HD>(&tm_k, k, hkv, s, b, 1, kKeys);
  if (err == cudaSuccess)
    err = hopper::tile_map<HD>(&tm_v, v, hkv, s, b, 1, kKeys);
  if (err != cudaSuccess) return err;
  constexpr int bytes = Smem<HD>::kBytes;
  err = cudaFuncSetAttribute(flash_fwd_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_qtiles + 1) / 2, hkv, b);
  flash_fwd_tc<HD><<<grid, kThreads, bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), lse, s, h, hkv,
      window, scale, n_qtiles);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

int fa_max_rep() { return kRows; }

// q: (b, s, h, hd); k, v: (b, s, hkv, hd), contiguous, all f32 or all bf16;
// out: like q; lse: f32[b, h, s] or null.
int fa_launch(const void* q, const void* k, const void* v, void* out,
              float* lse, int bf16, int b, int s, int h, int hkv, int hd,
              int window, float scale, int device, void* stream) {
  if (b < 1 || s < 1 || hkv < 1 || h % hkv != 0 || h / hkv > kRows ||
      b > 65535 || hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_CASE(HD)                                                          \
  err = bf16 ? tc::launch<HD>(q, k, v, out, lse, b, s, h, hkv, window,       \
                              scale, st)                                     \
             : launch<HD>(q, k, v, out, lse, b, s, h, hkv, window, scale, st)
  switch (hd) {
    case 32: FA_CASE(32); break;
    case 64: FA_CASE(64); break;
    case 128: FA_CASE(128); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FA_CASE
  return static_cast<int>(err);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
