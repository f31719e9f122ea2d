// Per-example squared gradient norm of a linear layer shared across the
// S positions of a sequence (the ghost-norm extension of paper Prop. 1):
//
//   out[n] = ||X_n^T D_n||_F^2 = <X_n X_n^T, D_n D_n^T>_F
//          = sum_{s,t} (x_s . x_t) (d_s . d_t),
//
// with X_n (S, din) the layer input and D_n (S, dout) = dL/dY of row n.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ghost_norm.py::ghost_norm
// (_kernel): gn_launch computes what it computes, for symmetric true or false.
//
// What bounds the function on an H100: bytes.  At the LM scorer's main
// shapes (glm4-9b, score batch 128, S = 64, 4 layers; x bf16, d f32) one
// step makes 8 calls that read 12.8 GB (3.8 ms at 3.35 TB/s).  The two
// symmetric S x S Grams need S(S+1)(din + dout) flops a row: 2.6 ms a step
// with the bf16 x Gram on the tensor cores (989 TFLOP/s, exact for bf16)
// and the f32 d Gram at 67 TFLOP/s.  This kernel does more than that: it
// computes each 64 x 64 Gram tile in full (S = 64 is one tile) with f32 FMA
// on the CUDA cores, 492 GFLOP a step, 7.3 ms at 67 TFLOP/s, so its own
// arithmetic bounds it above the function's bound.  Every staged input
// element is used 64 times from shared memory.
//
// What the design does about it:
//   * the TPU kernel ran a sequential grid (row, S_i, S_j, feature), kept both
//     Gram tiles in VMEM across the feature axis and added each (i, j) tile's
//     share into the row's output.  CUDA blocks run concurrently, so here one
//     block owns one (row, i-tile, j-tile) pair (j >= i when symmetric) and
//     loops over the feature axis itself: tiles of x and d are staged in
//     shared memory as f32 (bf16 is upcast on load), separately for din and
//     dout, and both 64 x 64 Grams accumulate in f32 registers (a 4 x 4
//     micro-tile per thread, plain f32 FMA on the CUDA cores, no TF32).
//     When i == j the two operands are the same tile and are staged once.
//   * the block multiplies the two Grams elementwise, reduces in a fixed order
//     (per thread, then a shuffle tree in each warp, then over the warps) and
//     stores one partial into a (rows, n_pairs) scratch that the wrapper
//     allocates.  A second small kernel sums each row's partials in fixed
//     pair order, with weight 2 for j > i when symmetric.  No float atomics:
//     two launches on the same inputs are bitwise equal.
//   * ragged S and feature widths are masked in the loads (rows past S and
//     features past the width read as 0, contributing exact zeros), which
//     equals the reference's zero padding without its padded copies.
//   * each call of the op makes two launches (Gram partials, then the row
//     sums) and returns cudaGetLastError(); the wrapper raises if it is not
//     cudaSuccess.
//
// Not done here (later work): tensor cores (the bf16 x Gram is exact on
// bf16 mma), sharing the x Gram across taps with the same input, a split
// of the feature axis for calls with few rows (the product of the Grams is
// taken after the feature sum, so the split must keep partial Gram tiles,
// not scalars), and a conflict-free staging store (tile[k][row] with k
// fastest across a warp hits 8 of 32 banks, since kLd = 68 is 4 mod 32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

// One thread per row: out[n] = sum_p w_p * partial[n, p] in pair order,
// w_p = 2 for j > i when symmetric, else 1.
__global__ void row_sum_kernel(const float* partial, int rows, int ns,
                               int n_pairs, int symmetric, float* out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= rows) return;
  const float* row = partial + static_cast<size_t>(n) * n_pairs;
  float acc = 0.0f;
  int p = 0;
  for (int i = 0; i < ns; ++i) {
    for (int j = symmetric ? i : 0; j < ns; ++j, ++p) {
      const float c = row[p];
      acc += (symmetric && j > i) ? 2.0f * c : c;
    }
  }
  out[n] = acc;
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
  constexpr int kRowThreads = 128;
  row_sum_kernel<<<(rows + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                   st>>>(partial, rows, ns, n_pairs, symmetric, out);
  return static_cast<int>(cudaGetLastError());
}

const char* gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
