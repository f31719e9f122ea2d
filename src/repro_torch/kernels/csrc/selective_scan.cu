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
// What bounds the function on an H100: the exponentials, on the SFU.  At
// falcon-mamba-7b's scoring shape (B, S, d_inner, d_state) = (8, 2048, 8192,
// 16) in bf16 it reads u and delta and writes y, 268 MB each (0.24 ms at
// 3.35 TB/s; B, C, A and D are small), and takes one exponential for each of
// 2.15 G (b, t, channel, state) elements: one MUFU.EX2 each, 16 a clock on
// each of 132 SMs, ~0.51 ms at 1.98 GHz.  A warp's MUFU op holds its
// scheduler's SFU lanes for 8 clocks, in which the scheduler can dispatch the
// element's other instructions; every instruction an element adds beyond
// that budget, and every stall, shows in the time.  The recurrence is
// serial in t and independent across (b, channel).
//
// What the design does about it:
//   * Few instructions an element.  Each decay is ex2.approx.ftz.f32 of
//     delta_t times A·log2(e) (taken once at block start): one multiply and
//     one MUFU op, no libm range reduction.  With a multiply for
//     delta_t·u_t·B_t and two FMAs (h and y's partial) that is 5, and the
//     step's loads, conversions and y store are shared by the thread's
//     states.  ftz flushes decays below 2^-126 to 0 (|delta·A| > 87), where
//     the plain version keeps a subnormal; the state it multiplies is then
//     ~1e-38 of its size.
//   * One thread owns a (b, channel): its d_state states and its row of A
//     sit in registers.  Splitting the states over 2 or 4 lanes of a warp,
//     joined by a shuffle tree, doubled and quadrupled the threads but
//     measured slower at d_state 16 (PERF.md): the per-step loads and the
//     tree cost more than the extra warps win.  A block of 128 threads owns
//     (b, 128 channels) and walks the whole sequence itself (CUDA blocks
//     run concurrently, so no state is carried across blocks as the TPU
//     grid carried it across its chunk axis).
//   * y_t runs in two chains (even and odd states) added at the end: a
//     fixed order and no atomics, so two launches on the same inputs are
//     bitwise equal.  ref.selective_scan_exp2_emulation repeats this order
//     on the CPU.  FMA contraction and ex2.approx (2 ulp) keep the result
//     from being bitwise equal to the plain PyTorch version.
//   * The step loop is unrolled by kUnroll, so the next steps'
//     exponentials (which depend on delta alone) are dispatched while a
//     step's h and y chains drain.
//   * Loads overlap the steps: a ring of kStages chunk stages in shared
//     memory, each kChunk steps of u and delta (the block's channels) and of
//     the B and C rows, filled by cp.async; chunk c + kStages - 1 is requested
//     as chunk c starts, and chunk c + 1 is awaited as it ends.  Where every
//     base and row pitch is 16-byte aligned (the model's operands) the
//     kWide instance copies 16-byte pieces with the piece arithmetic known
//     at compile time; otherwise pieces of 8 or 4 bytes, else 2-byte loads
//     (odd d_inner, B and C slices at odd columns): every input the wrapper
//     takes is taken.  A chunk's B and C rows are converted to f32 once for
//     the block, and its y is staged in shared memory and written back in
//     the same pieces.
//   * Ragged S and d_inner are bounds-checked: the walk stops at S, and
//     channels past d_inner load and store nothing.  Padded steps would come
//     after every real step and channels are independent, so this equals the
//     reference's padding (delta padded with 1) on every real output.
//   * ss_launch returns cudaGetLastError(); the wrapper raises if it is not
//     cudaSuccess.
//
// Not done here: a split over time for small B·d_inner (the main shapes fill
// the card), a software exp2 on the FMA pipe for part of the states (it would
// move the bound itself), and a backward (the TPU kernel has none).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block, one a channel
constexpr int kChunk = 32;     // steps a ring stage holds
constexpr int kStages = 2;     // ring stages
constexpr int kUnroll = 4;     // steps unrolled
constexpr int kMinBlocks = 4;  // resident blocks an SM: at most 128 registers
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// copy g bytes (16, 8 or 4 asynchronously; else 2 at once) to shared memory
__device__ __forceinline__ void copy_in(void* dst, const void* src, int g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (g) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
      break;
    default:
      *static_cast<unsigned short*>(dst) =
          __ldg(static_cast<const unsigned short*>(src));
  }
}

__device__ __forceinline__ void copy_out(void* dst, const void* src, int g) {
  switch (g) {
    case 16:
      *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
      break;
    case 8:
      *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
      break;
    case 4:
      *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
      break;
    default:
      *static_cast<unsigned short*>(dst) =
          *static_cast<const unsigned short*>(src);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one block's shared memory: the ring, the chunk's B and C in f32, its y
template <typename T, int DS>
struct Smem {
  alignas(16) T u[kStages][kChunk][kThreads];
  alignas(16) T dl[kStages][kChunk][kThreads];
  alignas(16) T b[kStages][kChunk][DS];
  alignas(16) T c[kStages][kChunk][DS];
  alignas(16) float bf[kChunk][DS];
  alignas(16) float cf[kChunk][DS];
  alignas(16) T y[kChunk][kThreads];
};

// where a block reads and writes: row (b, 0) of its batch row, its first
// channel, the live channels, and the piece sizes in bytes
struct Span {
  size_t row0;
  int c0, live, di, ld_b, ld_c, g_io, g_bc;
};

// start the copies of steps [t0, t0 + n) into ring stage st
template <typename T, int DS>
__device__ __forceinline__ void fetch(Smem<T, DS>& sm, int st, int t0,
                                      int n, const Span& sp,
                                      const T* __restrict__ u,
                                      const T* __restrict__ delta,
                                      const T* __restrict__ bm,
                                      const T* __restrict__ cm) {
  const int ep = sp.g_io / static_cast<int>(sizeof(T));  // elements a piece
  const int rp = kThreads / ep;                          // pieces a row
  const int np = n * rp;
  for (int p = threadIdx.x; p < 2 * np; p += kThreads) {
    const bool is_dl = p >= np;
    const int q = is_dl ? p - np : p;
    const int j = q / rp;
    const int e = (q - j * rp) * ep;
    // pieces never straddle d_inner: g_io divides its row pitch
    if (e < sp.live) {
      const size_t off = (sp.row0 + t0 + j) * sp.di + sp.c0 + e;
      copy_in(is_dl ? &sm.dl[st][j][e] : &sm.u[st][j][e],
              (is_dl ? delta : u) + off, sp.g_io);
    }
  }
  const int eb = sp.g_bc / static_cast<int>(sizeof(T));
  const int rb = DS / eb;
  const int nb = n * rb;
  for (int p = threadIdx.x; p < 2 * nb; p += kThreads) {
    const bool is_c = p >= nb;
    const int q = is_c ? p - nb : p;
    const int j = q / rb;
    const int e = (q - j * rb) * eb;
    const size_t row = sp.row0 + t0 + j;
    copy_in(is_c ? &sm.c[st][j][e] : &sm.b[st][j][e],
            is_c ? cm + row * sp.ld_c + e : bm + row * sp.ld_b + e, sp.g_bc);
  }
}

// stage st's B and C rows into f32, once for the whole block
template <typename T, int DS>
__device__ __forceinline__ void convert(Smem<T, DS>& sm, int st) {
  for (int e = threadIdx.x; e < kChunk * DS; e += kThreads) {
    (&sm.bf[0][0])[e] = to_f32((&sm.b[st][0][0])[e]);
    (&sm.cf[0][0])[e] = to_f32((&sm.c[st][0][0])[e]);
  }
}

// one step j of stage st for local channel lc
template <typename T, int DS>
__device__ __forceinline__ void step(Smem<T, DS>& sm, int st, int j, int lc,
                                     const float (&ap)[DS], float (&h)[DS],
                                     float dv) {
  const float dl = to_f32(sm.dl[st][j][lc]);
  const float ut = to_f32(sm.u[st][j][lc]);
  const float du = dl * ut;
  float bv[DS], cv[DS];
#pragma unroll
  for (int q = 0; q < DS / 4; ++q) {
    const float4 b4 = reinterpret_cast<const float4*>(sm.bf[j])[q];
    const float4 c4 = reinterpret_cast<const float4*>(sm.cf[j])[q];
    bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y, bv[4 * q + 2] = b4.z;
    bv[4 * q + 3] = b4.w;
    cv[4 * q] = c4.x, cv[4 * q + 1] = c4.y, cv[4 * q + 2] = c4.z;
    cv[4 * q + 3] = c4.w;
  }
  // y_t in two chains, the even and the odd states, so that neither is
  // DS FMAs long
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < DS; ++k) {
    h[k] = fmaf(h[k], ex2(dl * ap[k]), du * bv[k]);
    acc[k % 2] = fmaf(h[k], cv[k], acc[k % 2]);
  }
  store(&sm.y[j][lc], fmaf(dv, ut, acc[0] + acc[1]));
}

// grid (ceil(d_inner / kThreads), B): block (cb, b) scans row b's channels
// [cb·kThreads, (cb + 1)·kThreads), one a thread.
template <typename T, int DS, bool kWide>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dskip,
                T* __restrict__ y, int s, int di, int ld_b, int ld_c,
                int g_io_arg, int g_bc_arg) {
  // kWide: every piece is 16 bytes, known here, so the piece arithmetic
  // folds to shifts
  const int g_io = kWide ? 16 : g_io_arg;
  const int g_bc = kWide ? 16 : g_bc_arg;
  static_assert(DS % 4 == 0, "B and C rows are read as float4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& sm = *reinterpret_cast<Smem<T, DS>*>(smem_raw);
  const int lc = threadIdx.x;
  Span sp;
  sp.row0 = static_cast<size_t>(blockIdx.y) * s;
  sp.c0 = blockIdx.x * kThreads;
  sp.live = min(kThreads, di - sp.c0);
  sp.di = di, sp.ld_b = ld_b, sp.ld_c = ld_c, sp.g_io = g_io, sp.g_bc = g_bc;
  const int ch = sp.c0 + lc;
  const bool live = lc < sp.live;

  float ap[DS], h[DS];
#pragma unroll
  for (int k = 0; k < DS; ++k) {
    ap[k] = live ? a[static_cast<size_t>(ch) * DS + k] * kLog2e : 0.0f;
    h[k] = 0.0f;
  }
  const float dv = live ? dskip[ch] : 0.0f;

  const int nchunks = (s + kChunk - 1) / kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks)
      fetch(sm, c, c * kChunk, min(kChunk, s - c * kChunk), sp, u, delta, bm,
            cm);
    cp_commit();
  }
  cp_wait<kStages - 2>();
  __syncthreads();
  convert(sm, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % kStages;
    const int t0 = c * kChunk;
    const int n = min(kChunk, s - t0);
    // chunk c's rows and f32 B, C are in; every thread is done with chunk
    // c - 1, whose stage the next copies fill, and with the staged y
    __syncthreads();
    const int nc = c + kStages - 1;
    if (nc < nchunks)
      fetch(sm, nc % kStages, nc * kChunk, min(kChunk, s - nc * kChunk), sp, u,
            delta, bm, cm);
    cp_commit();
    if (n == kChunk) {
#pragma unroll kUnroll
      for (int j = 0; j < kChunk; ++j)
        step<T, DS>(sm, st, j, lc, ap, h, dv);
    } else {
#pragma unroll 1
      for (int j = 0; j < n; ++j)
        step<T, DS>(sm, st, j, lc, ap, h, dv);
    }
    cp_wait<kStages - 2>();  // this thread's copies of chunk c + 1
    __syncthreads();         // everyone's; and chunk c's y is staged
    const int ep = g_io / static_cast<int>(sizeof(T));
    const int rp = kThreads / ep;
    for (int p = threadIdx.x; p < n * rp; p += kThreads) {
      const int j = p / rp;
      const int e = (p - j * rp) * ep;
      if (e < sp.live)
        copy_out(y + (sp.row0 + t0 + j) * di + sp.c0 + e, &sm.y[j][e], g_io);
    }
    if (c + 1 < nchunks) convert(sm, (c + 1) % kStages);
  }
}

template <typename T, int DS>
cudaError_t launch(const void* u, const void* delta, const float* a,
                   const void* bm, const void* cm, const float* dskip, void* y,
                   int batch, int s, int di, int ld_b, int ld_c, int g_io,
                   int g_bc, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<T, DS>));
  auto kernel = g_io == 16 && g_bc == 16 ? scan_kernel<T, DS, true>
                                         : scan_kernel<T, DS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), dskip,
      static_cast<T*>(y), s, di, ld_b, ld_c, g_io, g_bc);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch(int ds, const void* u, const void* delta, const float* a,
                     const void* bm, const void* cm, const float* dskip,
                     void* y, int batch, int s, int di, int ld_b, int ld_c,
                     int g_io, int g_bc, cudaStream_t stream) {
  switch (ds) {
#define SS_CASE(N)                                                         \
  case N:                                                                  \
    return launch<T, N>(u, delta, a, bm, cm, dskip, y, batch, s, di, ld_b, \
                        ld_c, g_io, g_bc, stream);
    SS_CASE(4)
    SS_CASE(8)
    SS_CASE(16)
#undef SS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// the widest piece (16, 8, 4 bytes, down to one element) that every address
// and pitch OR-ed into `bits` is aligned to
int widest(uintptr_t bits, int elem) {
  int g = 16;
  while (g > elem && (bits & static_cast<uintptr_t>(g - 1))) g >>= 1;
  return g;
}

}  // namespace

extern "C" {

// 1 if the build has an instance for this d_state, else 0.
int ss_supports(int ds) { return ds == 4 || ds == 8 || ds == 16; }

// threads that share one (b, channel) in the d_state instance: 1, one
// thread owns a channel's states (0 if there is no instance).
int ss_lanes(int ds) { return ss_supports(ds); }

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
  const size_t elem = is_bf16 ? 2 : 4;
  const int g_io = widest(reinterpret_cast<uintptr_t>(u) |
                              reinterpret_cast<uintptr_t>(delta) |
                              reinterpret_cast<uintptr_t>(y) | (di * elem),
                          static_cast<int>(elem));
  const int g_bc = widest(
      reinterpret_cast<uintptr_t>(bm) | reinterpret_cast<uintptr_t>(cm) |
          (ld_b * elem) | (ld_c * elem) | (ds * elem),
      static_cast<int>(elem));
  err = is_bf16 ? dispatch<__nv_bfloat16>(ds, u, delta, a, bm, cm, dskip, y,
                                          batch, s, di, ld_b, ld_c, g_io,
                                          g_bc, st)
                : dispatch<float>(ds, u, delta, a, bm, cm, dskip, y, batch, s,
                                  di, ld_b, ld_c, g_io, g_bc, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
