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
// flash_attention (_kernel) and computes its function: q in f32 times the
// scale before the dot, masked entries at _NEG = -1e30, p = exp(s - m) * mask,
// output o / max(l, 1e-20) in q's dtype.
//
// What bounds the function on an H100: operations.  At glm4-9b's prefill
// (B = 8, S = 2048, H = 32, Hkv = 2, hd = 128, bf16) it needs
// 4 B H hd S(S+1)/2 = 275 GFLOP, 0.28 ms on the bf16 tensor cores, against
// 151 MB of q, k, v and out (0.05 ms).  This first kernel runs the products
// with f32 FMA on the CUDA cores (67 TFLOP/s at best), so it stays well above
// that bound; tensor cores (wgmma) and TMA are the next step.
//
// What the design does about it:
//   * the TPU kernel ran a grid (B, H, q-blocks, k-blocks) with the k axis
//     sequential, carrying (m, l, o) in VMEM.  Here one block owns 64 query
//     rows, (position, head) pairs of ONE KV group: 64 / rep positions times
//     all rep heads of group g (4 positions at glm4-9b's rep = 16), so each
//     K/V tile it stages in shared memory serves every head of the group.  A
//     loop inside the block walks the 64-key tiles in order.
//   * tiles wholly in the future of the block's last position, or wholly
//     before the window of its first, are skipped without being loaded (the
//     Pallas kernel still streams them).  Blocks are issued longest first.
//   * 256 threads in a 16 x 16 grid; thread (ty, tx) computes scores of rows
//     ty*4..ty*4+3 against keys tx, tx+16, tx+32, tx+48 (conflict-free reads
//     of the K tile, row stride hd + 1) and owns the output of the same rows
//     at dims tx + 16 c.  A row's max and sum are shuffles over the 16 lanes
//     that share it.  q and p are kept transposed so a thread reads its four
//     rows as one float4.  K and V share one staging buffer.
//   * the ragged tail of S is masked in the loads (keys and queries past S
//     read as 0): no padded copies.  Each output row is written by one block,
//     so two launches are bitwise equal.
//   * the launch function returns cudaGetLastError(); the wrapper raises if
//     it is not cudaSuccess.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRows = 64;                 // query (position, head) rows a block
constexpr int kKeys = 64;                 // keys per K/V tile
constexpr int kThreads = 256;             // 16 x 16
constexpr int kTLd = kRows + 4;           // transposed q / p row (floats)
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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
template <typename T, int HD>
__device__ __forceinline__ void stage_kv(const T* __restrict__ src, int b,
                                         int g, int s, int hkv, int k0,
                                         float* kv) {
  for (int e = threadIdx.x; e < kKeys * HD; e += kThreads) {
    const int j = e / HD;
    const int d = e % HD;
    const int kp = k0 + j;
    kv[j * (HD + 1) + d] =
        kp < s ? to_f32(src[((static_cast<size_t>(b) * s + kp) * hkv + g) *
                                HD + d])
               : 0.0f;
  }
}

// grid (n_qtiles, hkv, b); dynamic shared memory smem_bytes<HD>().
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
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
      val = to_f32(q[((static_cast<size_t>(b) * s + pos) * h + g * rep +
                      row % rep) * HD + d]) * scale;
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
    stage_kv<T, HD>(k, b, g, s, hkv, k0, kv);
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

    stage_kv<T, HD>(v, b, g, s, hkv, k0, kv);
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
      T* dst = out + ((static_cast<size_t>(b) * s + pos) * h + head) * HD;
#pragma unroll
      for (int c = 0; c < kCols; ++c) store_as(&dst[tx + 16 * c], o[a][c] / denom);
      if (lse != nullptr && tx == 0)
        lse[(static_cast<size_t>(b) * h + head) * s + pos] = m[a] + logf(denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int s, int h, int hkv, int window,
                   float scale, cudaStream_t stream) {
  const int bq = kRows / (h / hkv);
  const int n_qtiles = (s + bq - 1) / bq;
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_qtiles, hkv, b);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, s, h, hkv, window,
      scale, n_qtiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* out, float* lse, int b, int s, int h, int hkv,
                      int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, b, s, h, hkv, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, b, s, h, hkv, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, b, s, h, hkv, window, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

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
  if (bf16)
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, out, lse, b, s, h, hkv,
                                   window, scale, st);
  else
    err = launch_hd<float>(hd, q, k, v, out, lse, b, s, h, hkv, window, scale,
                           st);
  return static_cast<int>(err);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
