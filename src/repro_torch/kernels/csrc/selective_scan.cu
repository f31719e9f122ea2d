// Mamba-1 selective scan over the whole sequence (the SSM mixer's forward):
//
//   h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) (x) B_t
//   y_t = h_t . C_t + D * u_t
//
// per (b, channel), with h_t the channel's d_state states, h_{-1} = 0.
// u, delta: (B, S, d_inner); A: (d_inner, d_state) f32; B, C: (B, S, d_state)
// with a row stride of their own (they are column slices of the x_proj
// output); D: (d_inner,) f32.  y: (B, S, d_inner) in u's dtype; the state is
// f32 throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py::
// selective_scan (_kernel): ss_launch computes what it computes.
//
// What bounds the function on an H100: operations, the exponentials.  At
// falcon-mamba-7b's scoring shape (B, S, d_inner, d_state) = (8, 2048, 8192,
// 16) in bf16 it reads u and delta and writes y, 268 MB each (0.24 ms at
// 3.35 TB/s; B, C, A and D are small), and takes exp(delta * A) for each of
// 2.15 G (b, t, channel, state) elements: one MUFU op each, 16 a clock on
// each of 132 SMs, ~0.51 ms at 1.98 GHz.  The recurrence is serial in t and
// independent across (b, channel).
//
// What the design does about it:
//   * the TPU grid ran (B, channel blocks, S chunks) in order and carried h
//     across the chunk axis in VMEM scratch.  CUDA blocks run concurrently,
//     so here one block owns (b, 128 channels) and loops over the whole
//     sequence itself: one thread a channel, its d_state states and its row
//     of A in registers (templated on d_state: 4, 8 and 16), h never leaves
//     the thread.
//   * the sequence is walked in chunks of kChunk steps: the block stages the
//     chunk's u and delta (coalesced along d_inner, upcast to f32) and the
//     chunk's B and C rows, which every thread of the block shares, in shared
//     memory, so the loads of a chunk are in flight together; then each
//     thread runs the chunk's steps from shared memory and stores y_t
//     (coalesced along d_inner).
//   * y_t sums the states in one fixed order, k = 0 .. d_state-1, with f32
//     FMA; no atomics, so two launches on the same inputs are bitwise equal.
//     FMA contraction keeps the result from being bitwise equal to the plain
//     PyTorch version (separately rounded products and sums).
//   * ragged S and d_inner are bounds-checked: the loop stops at S, threads
//     past d_inner load and store nothing.  Padded steps would come after
//     every real step and channels are independent, so this equals the
//     reference's padding (delta padded with 1) on every real output.
//   * exp is the accurate expf (not __expf), for parity with the plain
//     version at f32 rtol 1e-5.
//   * ss_launch returns cudaGetLastError(); the wrapper raises if it is not
//     cudaSuccess.
//
// Not done here (later work): more than one (b, channel) per thread or a
// channel split over lanes to fill the card at small B·d_inner (the falcon
// shape gives 512 blocks of 128 threads, ~4 blocks an SM), and a staging
// ring that overlaps the next chunk's loads with this chunk's steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;  // channels of one block, one thread each
constexpr int kChunk = 32;     // steps staged in shared memory at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid (ceil(d_inner / kThreads), B): block (cb, b) scans row b's channels
// [cb * kThreads, (cb + 1) * kThreads).
template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dskip,
                T* __restrict__ y, int s, int di, int ld_b, int ld_c) {
  __shared__ float su[kChunk][kThreads];
  __shared__ float sdl[kChunk][kThreads];
  __shared__ float sb[kChunk][DS];
  __shared__ float sc[kChunk][DS];
  const int tid = threadIdx.x;
  const int ch = blockIdx.x * kThreads + tid;
  const bool live = ch < di;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * s;  // row (b, 0)

  float av[DS];
  float h[DS];
#pragma unroll
  for (int k = 0; k < DS; ++k) {
    av[k] = live ? a[static_cast<size_t>(ch) * DS + k] : 0.0f;
    h[k] = 0.0f;
  }
  const float dv = live ? dskip[ch] : 0.0f;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int n = min(kChunk, s - t0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const size_t off = (row0 + t0 + j) * di + ch;
      su[j][tid] = live ? to_f32(u[off]) : 0.0f;
      sdl[j][tid] = live ? to_f32(delta[off]) : 0.0f;
    }
    for (int e = tid; e < n * DS; e += kThreads) {
      const int j = e / DS;
      const int k = e % DS;
      const size_t row = row0 + t0 + j;
      sb[j][k] = to_f32(bm[row * ld_b + k]);
      sc[j][k] = to_f32(cm[row * ld_c + k]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dl = sdl[j][tid];
      const float ut = su[j][tid];
      const float du = dl * ut;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        const float da = expf(dl * av[k]);
        h[k] = fmaf(h[k], da, du * sb[j][k]);
        acc = fmaf(h[k], sc[j][k], acc);
      }
      if (live) store(&y[(row0 + t0 + j) * di + ch], acc + dv * ut);
    }
    __syncthreads();
  }
}

template <typename T, int DS>
void launch(const void* u, const void* delta, const float* a, const void* bm,
            const void* cm, const float* dskip, void* y, int batch, int s,
            int di, int ld_b, int ld_c, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  scan_kernel<T, DS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), dskip,
      static_cast<T*>(y), s, di, ld_b, ld_c);
}

template <typename T>
bool dispatch(int ds, const void* u, const void* delta, const float* a,
              const void* bm, const void* cm, const float* dskip, void* y,
              int batch, int s, int di, int ld_b, int ld_c,
              cudaStream_t stream) {
  switch (ds) {
#define SS_CASE(N)                                                           \
  case N:                                                                    \
    launch<T, N>(u, delta, a, bm, cm, dskip, y, batch, s, di, ld_b, ld_c,    \
                 stream);                                                    \
    return true;
    SS_CASE(4)
    SS_CASE(8)
    SS_CASE(16)
#undef SS_CASE
    default:
      return false;
  }
}

}  // namespace

extern "C" {

// 1 if the build has an instance for this d_state, else 0.
int ss_supports(int ds) { return ds == 4 || ds == 8 || ds == 16; }

// u, delta, y: (batch, s, di) contiguous, bf16 when is_bf16 else f32; a:
// (di, ds) f32 contiguous; bm, cm: (batch, s, ds) of u's type, row (b, t) at
// element (b * s + t) * ld_b (ld_c), states contiguous; dskip: (di,) f32.
int ss_launch(const void* u, const void* delta, const float* a, const void* bm,
              const void* cm, const float* dskip, void* y, int is_bf16,
              int batch, int s, int di, int ds, int ld_b, int ld_c,
              int device, void* stream) {
  if (batch < 1 || batch > 65535 || s < 1 || di < 1 || ld_b < ds ||
      ld_c < ds || !ss_supports(ds))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    dispatch<__nv_bfloat16>(ds, u, delta, a, bm, cm, dskip, y, batch, s, di,
                            ld_b, ld_c, st);
  else
    dispatch<float>(ds, u, delta, a, bm, cm, dskip, y, batch, s, di, ld_b,
                    ld_c, st);
  return static_cast<int>(cudaGetLastError());
}

const char* ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
