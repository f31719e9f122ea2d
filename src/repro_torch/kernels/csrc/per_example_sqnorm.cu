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
//     feature grid and its wrapper added the taps' rows outside it.  Here
//     one launch ends in the (B,) score: one block a row n, of kGroups
//     groups of kThreads threads.  The launch deals the row's 2T sums of
//     squares (x and d of each tap) to the groups, widest first to the
//     least loaded (6,144, 5,120, 4,106 and 4,096 elements at the shapes
//     above), so a row's bytes are read by 1024 threads at once and 256
//     rows fill the 132 SMs two blocks each.  Each sum is reduced as the single-tap
//     kernel reduces it: a strided loop over the features (neighbouring
//     threads on neighbouring addresses), a fixed-order shuffle tree in
//     each warp and a fixed tree over the warps.  Then lane t of warp 0
//     forms tap t's row and lane 0 chains the rows in tap order.  No float
//     atomics, no cross-block reduction: bitwise deterministic.
//   * the strided loop keeps kUnroll loads in flight a thread: each round
//     issues its kUnroll loads before its adds, which still run in the
//     loop's element order (thread t adds elements t, t + 256, ... in turn).
//     The last, partial round is one masked round of the same kUnroll
//     loads (the masked ones add nothing), so a 3072-wide sum costs a
//     thread two trips to memory, not a round and then four dependent
//     ones.  Rounds of 16 loads (one trip at 3072) measured no faster at
//     that width, slower at 2048 and slower in the multi-tap kernel
//     (PERF.md); issuing the next round (or the next sum) before a round's
//     adds, and a (row, tap) grid whose last block of a row chains the row
//     (an integer ticket), both measured slower on an H100 (PERF.md).
//   * the single-tap kernel (one block a row) reduces the row's x and d
//     sums at the same time, on two groups of kThreads threads, as the
//     multi-tap kernel's groups do; each sum keeps the order above, so
//     the redesign moved no bit (PERF.md, the kernel table).
//   * ragged widths need no padded copies: the strided loop simply stops at
//     the row's width (identical to summing zero padding), and the multi-tap
//     launch takes a table of (x, d, din, dout) entries by value instead of
//     the reference wrapper's padded, stacked operands (~26 MB of extra
//     traffic at the shapes above).
//   * every float operation is an explicit round-to-nearest intrinsic, so no
//     FMA contraction can differ between the two kernels: both reduce a
//     feature row with row_sumsq() and the same trees, and the chain adds
//     the rows as chained single-tap launches would be added.  Multi-tap
//     therefore equals chained single-tap launches bitwise, and the
//     plain-PyTorch emulator kernels/ref.py::per_example_sqnorm_multi_blocked
//     reproduces either exactly.  More than kMaxTaps taps take one launch a
//     table, each later launch adding its rows onto the running (B,) sum.
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

constexpr int kThreads = 256;             // threads a row reduction
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 32;              // kernel-parameter table size
constexpr int kUnroll = 8;                // loads in flight a thread
constexpr int kGroups = 4;                // row reductions a multi-tap block
constexpr unsigned kFull = 0xffffffffu;

using Tap = PesTap;

struct TapTable {
  Tap taps[kMaxTaps];
  // sum s (x of tap s / 2 if s is even, else its d) runs on thread group
  // group[s] of a multi-tap block
  unsigned char group[2 * kMaxTaps];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);   // bf16 bits
}

// Thread tid of kThreads sums the squares of elements tid, tid + kThreads,
// ... of one row, in that order; each round issues its kUnroll loads before
// its adds, and the last, partial round is the same round with the loads
// past n masked off (and their adds skipped).
template <typename T>
__device__ __forceinline__ float row_sumsq(const T* __restrict__ r, int n,
                                           int tid) {
  float acc = 0.0f;
  int i = tid;
  for (; i + (kUnroll - 1) * kThreads < n; i += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = to_f32(__ldg(r + i + k * kThreads));
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], v[k]));
  }
  if (i < n) {
    float v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = i + k * kThreads < n ? to_f32(__ldg(r + i + k * kThreads)) : 0.0f;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (i + k * kThreads < n) acc = __fadd_rn(acc, __fmul_rn(v[k], v[k]));
  }
  return acc;
}

__device__ __forceinline__ float thread_sumsq(const void* p, size_t row, int n,
                                              int bf16, int tid) {
  const size_t off = row * static_cast<size_t>(n);
  return bf16 ? row_sumsq(static_cast<const unsigned short*>(p) + off, n, tid)
              : row_sumsq(static_cast<const float*>(p) + off, n, tid);
}

// Lane 0 ends with ((v0+v16)+(v8+v24))+... : a fixed tree.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(kFull, v, off));
  return v;
}

// The tree over the kWarps warp sums p[0..7] that a shuffle-down over
// lanes 0..7 (off 4, 2, 1) gives: ((p0+p4)+(p2+p6)) + ((p1+p5)+(p3+p7)).
__device__ __forceinline__ float warps_tree(const float* p) {
  const float a = __fadd_rn(__fadd_rn(p[0], p[4]), __fadd_rn(p[2], p[6]));
  const float b = __fadd_rn(__fadd_rn(p[1], p[5]), __fadd_rn(p[3], p[7]));
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float row_score(float xs, float ds, int with_bias) {
  const float r = __fmul_rn(xs, ds);
  return with_bias ? __fadd_rn(r, ds) : r;
}

// ||x[n]||^2 * ||d[n]||^2 (+ ||d[n]||^2) of one tap, one block a row n:
// group 0 (threads 0..kThreads-1) reduces x while group 1 reduces d, each
// into part[group][warp]; thread 0 forms the row.
__global__ void __launch_bounds__(2 * kThreads)
    sqnorm_kernel(Tap tap, int with_bias, float* out) {
  __shared__ float part[2][kWarps];
  const int n = blockIdx.x;
  const int grp = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  const float acc = warp_sum(
      grp ? thread_sumsq(tap.d, n, tap.dout, tap.d_bf16, tid)
          : thread_sumsq(tap.x, n, tap.din, tap.x_bf16, tid));
  if ((tid & 31) == 0) part[grp][tid >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0)
    out[n] = row_score(warps_tree(part[0]), warps_tree(part[1]), with_bias);
}

// One block a row n, kGroups groups of kThreads threads: each group
// reduces the sums (x or d of a tap) the table deals it, each as the
// single-tap kernel's groups do, into part[sum][warp]; then lane t of warp
// 0 forms tap t's row and lane 0 chains the rows in tap order onto out[n]
// (accumulate) or from row 0.  The deal moves time, never bits.
__global__ void __launch_bounds__(kThreads * kGroups)
    sqnorm_multi_kernel(TapTable table, int n_taps, int with_bias,
                        int accumulate, float* out) {
  __shared__ float part[2 * kMaxTaps][kWarps];
  __shared__ float rows[kMaxTaps];
  const int n = blockIdx.x;
  const int grp = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;
  for (int s = 0; s < 2 * n_taps; ++s) {
    if (table.group[s] != grp) continue;
    const Tap& tap = table.taps[s >> 1];
    const float acc = warp_sum(
        (s & 1) ? thread_sumsq(tap.d, n, tap.dout, tap.d_bf16, tid)
                : thread_sumsq(tap.x, n, tap.din, tap.x_bf16, tid));
    if ((tid & 31) == 0) part[s][tid >> 5] = acc;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  if (lane < n_taps)
    rows[lane] = row_score(warps_tree(part[2 * lane]),
                           warps_tree(part[2 * lane + 1]), with_bias);
  __syncwarp();
  if (lane == 0) {
    float res = accumulate ? out[n] : rows[0];
    for (int t = accumulate ? 0 : 1; t < n_taps; ++t)
      res = __fadd_rn(res, rows[t]);
    out[n] = res;
  }
}

int sum_width(const TapTable& table, int s) {
  return (s & 1) ? table.taps[s >> 1].dout : table.taps[s >> 1].din;
}

// Deal the 2 * n_taps sums to the kGroups groups: the widest left to the
// least loaded group (ties to the lower sum, then the lower group).
void deal_sums(TapTable& table, int n_taps) {
  long long load[kGroups] = {};
  bool dealt[2 * kMaxTaps] = {};
  for (int k = 0; k < 2 * n_taps; ++k) {
    int best = -1;
    for (int s = 0; s < 2 * n_taps; ++s)
      if (!dealt[s] && (best < 0 || sum_width(table, s) > sum_width(table, best)))
        best = s;
    int grp = 0;
    for (int g = 1; g < kGroups; ++g)
      if (load[g] < load[grp]) grp = g;
    load[grp] += sum_width(table, best);
    table.group[best] = static_cast<unsigned char>(grp);
    dealt[best] = true;
  }
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
  sqnorm_kernel<<<b, 2 * kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tap, with_bias, out);
  return static_cast<int>(cudaGetLastError());
}

// out: f32[b], the taps' rows chained in order: onto out's values when
// accumulate (a later table of a call with more than kMaxTaps taps), else
// from tap 0's row.  taps: host array of n_taps <= kMaxTaps entries.
int pes_multi_launch(const PesTap* taps, int n_taps, int b, int with_bias,
                     int accumulate, int device, float* out, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  TapTable table;
  for (int t = 0; t < n_taps; ++t) table.taps[t] = taps[t];
  deal_sums(table, n_taps);
  sqnorm_multi_kernel<<<b, kThreads * kGroups, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, n_taps, with_bias, accumulate, out);
  return static_cast<int>(cudaGetLastError());
}

const char* pes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
