// One-token GQA attention against a length-masked KV cache (flash-decode):
//
//   out[b, g*rep + r] = sum_{t < len_b} softmax_t(q_r . k_t * scale) v_t
//
// for every row b, KV group g and the rep = H / Hkv query heads of the group,
// with q (B, H, hd), k and v (B, S, Hkv, hd), lengths (B,) int32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (_kernel) and computes its function: q cast to f32 and
// multiplied by the scale before the dot, masked slots at _NEG = -1e30,
// p = exp(s - m) * mask, output o / max(l, 1e-20) in q's dtype.  A row of
// length 0 gives zeros, not NaN.
//
// What bounds the function on an H100: bytes.  It reads K and V up to each
// row's length once (at glm4-9b's serving shape, B = 8, ~2,100 slots, Hkv = 2,
// hd = 128, bf16: ~17 MB, ~5 us at 3.35 TB/s) and does 4 flops per byte pair
// of q.k and p.v, far below the card's ~295 flops a byte.
//
// What the design does about it:
//   * the TPU kernel walked the S axis as the last, sequential grid axis and
//     carried (m, l, o) in VMEM.  CUDA blocks run concurrently, and a grid of
//     (B, Hkv) alone is 16 blocks for 132 SMs at B = 8, Hkv = 2.  So the S
//     axis is split (split-K, "flash-decoding"): grid (n_split, Hkv, B), each
//     block one contiguous slot range for all rep heads of its group, so one
//     K/V load serves rep heads.  n_split is chosen by the wrapper for about
//     four blocks per SM (the fastest of 1, 2, 4 and 8 at glm4-9b's shapes).  A block writes f32 partials (m, l, o[rep, hd]) to a
//     scratch the wrapper allocates; a second kernel merges the splits in
//     split order, one block per (b, g, head), one thread per output dim.
//     No float atomics: two launches are bitwise equal.
//   * blocks wholly past lengths[b] return at once and load nothing; the merge
//     reads only the live splits.
//   * inside a block, 32-slot tiles of K and V are staged in shared memory as
//     f32 with 16-byte loads.  Lane j of each warp scores slot j of the tile
//     for up to 4 query heads (warp w takes heads w, w+4, w+8, w+12), so the
//     online-softmax max and sum of a head are warp shuffles.  Then thread t
//     owns output dim t % hd of its heads and adds p . v in slot order.  f32
//     FMA on the CUDA cores, no tensor cores.
//   * each call of the op is two launches (splits, then merge); the launch
//     function returns cudaGetLastError() and the wrapper raises if it is not
//     cudaSuccess.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;                     // cache slots per tile
constexpr int kMaxRep = 16;                    // query heads per KV group
constexpr int kRowsPerWarp = kMaxRep / kWarps;
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

template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);     // elements in 16 bytes
};

// 16 bytes of T at src (16-byte aligned) → Vec<T>::n floats at dst.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) dst[i] = to_f32(vals[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// xor butterfly: every lane ends with the same sum
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int clamp_len(int len, int s) {
  return len < 0 ? 0 : (len > s ? s : len);
}

// grid (n_split, hkv, b).  Block (split, g, b) covers slots
// [split * chunk, min((split + 1) * chunk, len_b)) and stores, for each head
// r of group g, part_o[.., r, :] = sum_t p_t v_t (unnormalised) and
// part_ml[.., r] = (m, l).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, int s, int h,
                        int hkv, int chunk, int n_split, float scale,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml) {
  constexpr int kLd = HD + 4;                  // 16-byte aligned rows
  constexpr int kGroups = kThreads / HD;       // head groups of the p.v step
  constexpr int kOut = kMaxRep / kGroups;      // heads a thread owns there
  constexpr int kVec = Vec<T>::n;
  constexpr int kChunks = HD / kVec;
  __shared__ __align__(16) float q_s[kMaxRep][HD];
  __shared__ __align__(16) float k_s[kSlots][kLd];
  __shared__ __align__(16) float v_s[kSlots][kLd];
  __shared__ float p_s[kMaxRep][kSlots];
  __shared__ float alpha_s[kMaxRep];

  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = h / hkv;
  const int len = clamp_len(lengths[b], s);
  const int start = split * chunk;
  if (start >= len) return;
  const int end = min(start + chunk, len);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // the group's query heads in f32, times the scale before the dot
  const T* qb = q + (static_cast<size_t>(b) * h + static_cast<size_t>(g) * rep) * HD;
  for (int e = tid; e < rep * HD; e += kThreads)
    q_s[e / HD][e % HD] = to_f32(qb[e]) * scale;

  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
  }
  const int od = tid % HD;
  const int og = tid / HD;
  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.0f;

  const size_t slot_stride = static_cast<size_t>(hkv) * HD;
  const size_t base = static_cast<size_t>(b) * s * hkv * HD +
                      static_cast<size_t>(g) * HD;
  for (int t0 = start; t0 < end; t0 += kSlots) {
    // stage K and V slots [t0, t0 + 32) as f32; slots at or past `end` as 0
    for (int e = tid; e < kSlots * kChunks; e += kThreads) {
      const int j = e / kChunks;
      const int c = (e % kChunks) * kVec;
      float kv[kVec], vv[kVec];
      if (t0 + j < end) {
        const size_t off = base + static_cast<size_t>(t0 + j) * slot_stride + c;
        load16(k + off, kv);
        load16(v + off, vv);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kv[i] = vv[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(&k_s[j][c + i]) =
            make_float4(kv[i], kv[i + 1], kv[i + 2], kv[i + 3]);
        *reinterpret_cast<float4*>(&v_s[j][c + i]) =
            make_float4(vv[i], vv[i + 1], vv[i + 2], vv[i + 3]);
      }
    }
    __syncthreads();

    // scores: lane = slot, heads warp + kWarps * i
    float sc[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sc[i] = 0.0f;
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&k_s[lane][d]);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        if (r < rep) {
          const float4 qq = *reinterpret_cast<const float4*>(&q_s[r][d]);
          sc[i] = fmaf(qq.x, kk.x, sc[i]);
          sc[i] = fmaf(qq.y, kk.y, sc[i]);
          sc[i] = fmaf(qq.z, kk.z, sc[i]);
          sc[i] = fmaf(qq.w, kk.w, sc[i]);
        }
      }
    }
    const bool valid = t0 + lane < end;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r < rep) {                         // uniform across the warp
        const float sv = valid ? sc[i] : kNeg;
        const float m_new = fmaxf(m[i], warp_max(sv));
        const float alpha = expf(m[i] - m_new);
        const float p = valid ? expf(sv - m_new) : 0.0f;
        l[i] = l[i] * alpha + warp_sum(p);
        m[i] = m_new;
        p_s[r][lane] = p;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // o[r, od] = o * alpha + sum_j p[r, j] v[j, od], slots in order
    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.0f;
    for (int j = 0; j < kSlots; ++j) {
      const float vj = v_s[j][od];
#pragma unroll
      for (int i = 0; i < kOut; ++i)
        acc[i] = fmaf(p_s[og + kGroups * i][j], vj, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int r = og + kGroups * i;
      if (r < rep) o[i] = o[i] * alpha_s[r] + acc[i];
    }
    __syncthreads();
  }

  const size_t part = (static_cast<size_t>(b) * hkv + g) * n_split + split;
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int r = og + kGroups * i;
    if (r < rep) part_o[(part * rep + r) * HD + od] = o[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r < rep) {
        part_ml[(part * rep + r) * 2] = m[i];
        part_ml[(part * rep + r) * 2 + 1] = l[i];
      }
    }
  }
}

// grid (rep, hkv, b), one thread per output dim: merge the live splits of
// head r in split order,
// out = sum_s o_s e^{m_s - M} / max(sum_s l_s e^{m_s - M}, 1e-20).
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_o,
                                    const float* __restrict__ part_ml,
                                    const int* __restrict__ lengths, int s,
                                    int h, int hkv, int hd, int chunk,
                                    int n_split, T* __restrict__ out) {
  const int r = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const int rep = h / hkv;
  const size_t bg = static_cast<size_t>(b) * hkv + g;
  const int len = clamp_len(lengths[b], s);
  const int live = min(n_split, (len + chunk - 1) / chunk);
  float mx = kNeg;
  for (int sp = 0; sp < live; ++sp)
    mx = fmaxf(mx, part_ml[((bg * n_split + sp) * rep + r) * 2]);
  float lsum = 0.0f, osum = 0.0f;
  for (int sp = 0; sp < live; ++sp) {
    const size_t idx = (bg * n_split + sp) * rep + r;
    const float w = expf(part_ml[idx * 2] - mx);
    lsum = fmaf(part_ml[idx * 2 + 1], w, lsum);
    osum = fmaf(part_o[idx * hd + d], w, osum);
  }
  store_as(&out[(static_cast<size_t>(b) * h + g * rep + r) * hd + d],
           osum / fmaxf(lsum, 1e-20f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, int b, int s, int h, int hkv,
                   int chunk, int n_split, float scale, float* part_o,
                   float* part_ml, void* out, cudaStream_t stream) {
  const dim3 grid(n_split, hkv, b);
  decode_split_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, s, h, hkv, chunk, n_split, scale,
      part_o, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(h / hkv, hkv, b), HD, 0, stream>>>(
      part_o, part_ml, lengths, s, h, hkv, HD, chunk, n_split,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const int* lengths, int b, int s, int h, int hkv,
                      int chunk, int n_split, float scale, float* part_o,
                      float* part_ml, void* out, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, b, s, h, hkv, chunk, n_split,
                           scale, part_o, part_ml, out, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, b, s, h, hkv, chunk, n_split,
                           scale, part_o, part_ml, out, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, b, s, h, hkv, chunk, n_split,
                            scale, part_o, part_ml, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int da_slots() { return kSlots; }
int da_max_rep() { return kMaxRep; }

// q: (b, h, hd); k, v: (b, s, hkv, hd), contiguous, all f32 or all bf16,
// 16-byte aligned; lengths: int32[b].  part_o: f32[b, hkv, n_split, rep, hd]
// and part_ml: f32[b, hkv, n_split, rep, 2] scratch; out: (b, h, hd) in q's
// type.  chunk is a multiple of da_slots() and chunk * n_split >= s.
int da_launch(const void* q, const void* k, const void* v,
              const int* lengths, int bf16, int b, int s, int h, int hkv,
              int hd, int chunk, int n_split, float scale, int device,
              float* part_o, float* part_ml, void* out, void* stream) {
  if (b < 1 || s < 1 || hkv < 1 || h % hkv != 0 || h / hkv > kMaxRep ||
      chunk < kSlots || chunk % kSlots != 0 || n_split < 1 ||
      static_cast<long long>(chunk) * n_split < s || b > 65535 ||
      hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, lengths, b, s, h, hkv, chunk,
                                   n_split, scale, part_o, part_ml, out, st);
  else
    err = launch_hd<float>(hd, q, k, v, lengths, b, s, h, hkv, chunk, n_split,
                           scale, part_o, part_ml, out, st);
  return static_cast<int>(err);
}

const char* da_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
