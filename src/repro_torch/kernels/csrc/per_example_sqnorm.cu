// Per-example squared gradient norms of rank-1 (fully connected) layers,
// paper Proposition 1:  out[n] = ||x[n]||^2 * ||d[n]||^2 (+ ||d[n]||^2),
// with x the layer input (B, din) and d = dL/dY (B, dout).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/per_example_sqnorm.py:
//   per_example_sqnorm        (_kernel)        -> pes_launch
//   per_example_sqnorm_multi  (_multi_kernel)  -> pes_multi_launch
//
// What bounds it on an H100: bytes.  Every input element is read once and
// costs two flops, far below the card's 20 flop/byte f32 ridge.  At the
// mlp_svhn scoring shapes (B=256, five taps, x widths 3072+4*2048, d widths
// 4*2048+10, f32) one multi-tap launch reads 19,466 floats a row, ~19.9 MB,
// ~6 us at 3.35 TB/s.
//
// What the design does about it:
//   * the TPU kernel carried row partial sums in VMEM across a sequential
//     feature grid; CUDA blocks run concurrently, so here one block owns one
//     (row, tap) pair and reduces both sums of squares itself: a strided loop
//     over the features (neighbouring threads on neighbouring addresses), a
//     fixed-order shuffle tree in each warp, and a fixed-order tree over the
//     warps.  No atomics, no cross-block reduction: bitwise deterministic.
//   * ragged widths need no padded copies: the strided loop simply stops at
//     the row's width (identical to summing zero padding), and the multi-tap
//     launch takes a table of (x, d, din, dout) entries by value instead of
//     the reference wrapper's padded, stacked operands (~26 MB of extra
//     traffic at the shapes above).
//   * every float operation is an explicit round-to-nearest intrinsic, so no
//     FMA contraction can differ between the two kernels: both compute a
//     tap's row with tap_row(), and the multi-tap kernel STORES per-tap rows
//     (T, B) that the wrapper chains in tap order.  Multi-tap therefore equals
//     chained single-tap launches bitwise, and the plain-PyTorch emulator
//     kernels/ref.py::per_example_sqnorm_blocked reproduces either exactly.
//
// bf16 or f32 inputs, upcast to f32 on load.  Each entry point returns
// cudaGetLastError(); the Python wrapper raises if it is not cudaSuccess.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

// One tap of a launch; mirrored by ctypes in the wrapper.  Declared outside
// the anonymous namespace: the extern "C" entry points take it, and a type
// with internal linkage would give them internal linkage too.
struct PesTap {
  const void* x;
  const void* d;
  int din;
  int dout;
  int x_bf16;
  int d_bf16;
};

namespace {

constexpr int kThreads = 256;             // one block per (row, tap)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 32;              // kernel-parameter table size
constexpr unsigned kFull = 0xffffffffu;

using Tap = PesTap;

struct TapTable {
  Tap taps[kMaxTaps];
};

__device__ __forceinline__ float load_f32(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Thread t sums the squares of elements t, t+kThreads, ... of one row.
__device__ __forceinline__ float thread_sumsq(const void* p, size_t row, int n,
                                              int bf16) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = load_f32(p, row * static_cast<size_t>(n) + i, bf16);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  return acc;
}

// Lane 0 ends with ((v0+v16)+(v8+v24))+... : a fixed tree.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  return v;
}

// ||x[n]||^2 * ||d[n]||^2 (+ ||d[n]||^2) of one tap; valid in thread 0.
__device__ float tap_row(const Tap& tap, int n, int with_bias) {
  __shared__ float part[2][kWarps];
  float xs = warp_sum(thread_sumsq(tap.x, n, tap.din, tap.x_bf16));
  float ds = warp_sum(thread_sumsq(tap.d, n, tap.dout, tap.d_bf16));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = xs;
    part[1][warp] = ds;
  }
  __syncthreads();
  float res = 0.0f;
  if (warp == 0) {
    xs = lane < kWarps ? part[0][lane] : 0.0f;
    ds = lane < kWarps ? part[1][lane] : 0.0f;
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      xs = __fadd_rn(xs, __shfl_down_sync(kFull, xs, off));
      ds = __fadd_rn(ds, __shfl_down_sync(kFull, ds, off));
    }
    res = __fmul_rn(xs, ds);
    if (with_bias) res = __fadd_rn(res, ds);
  }
  return res;
}

__global__ void __launch_bounds__(kThreads)
    sqnorm_kernel(Tap tap, int with_bias, float* out) {
  const float r = tap_row(tap, blockIdx.x, with_bias);
  if (threadIdx.x == 0) out[blockIdx.x] = r;
}

// grid (B, T): block (n, t) stores tap t's row n at out[t, n].
__global__ void __launch_bounds__(kThreads)
    sqnorm_multi_kernel(TapTable table, int b, int with_bias, float* out) {
  const int t = blockIdx.y;
  const float r = tap_row(table.taps[t], blockIdx.x, with_bias);
  if (threadIdx.x == 0) out[static_cast<size_t>(t) * b + blockIdx.x] = r;
}

}  // namespace

extern "C" {

int pes_threads() { return kThreads; }

int pes_max_taps() { return kMaxTaps; }

// out: f32[b].  x: (b, din), d: (b, dout), contiguous, f32 or bf16.
int pes_launch(const void* x, const void* d, int x_bf16, int d_bf16, int b,
               int din, int dout, int with_bias, int device, float* out,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tap tap{x, d, din, dout, x_bf16, d_bf16};
  sqnorm_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tap, with_bias, out);
  return static_cast<int>(cudaGetLastError());
}

// out: f32[n_taps, b].  taps: host array of n_taps <= kMaxTaps entries.
int pes_multi_launch(const PesTap* taps, int n_taps, int b, int with_bias,
                     int device, float* out, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  TapTable table;
  for (int t = 0; t < n_taps; ++t) table.taps[t] = taps[t];
  const dim3 grid(b, n_taps);
  sqnorm_multi_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, b, with_bias, out);
  return static_cast<int>(cudaGetLastError());
}

const char* pes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
