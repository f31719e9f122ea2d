// Thin wrappers of the Hopper (sm_90a) instructions that the tensor-core
// kernels (flash_attention.cu, flash_attention_bwd.cu, ghost_norm.cu) are
// built from: mbarriers and the ring of tile stages built on them (Ring), TMA
// tile loads, wgmma with its shared-memory matrix descriptors, the split of
// f32 accumulators into bf16 A fragments, and the host-side encoding of TMA
// tensor maps.
//
// Tiles.  A bf16 tile of R rows and HD values a row lives in shared memory as
// HD / AW column chunks of R rows x AW values (AW = 64, or 32 for HD = 32),
// each chunk the image of one TMA box under the 128-byte (64-byte for HD 32)
// swizzle, chunk c at c * R * AW * 2 bytes from the tile's base.  Every tile
// base is aligned to 1024 bytes, so the swizzle, a function of the address,
// is the one the wgmma descriptors assume.  The same tile is read two ways:
//   * K-major (kmajor_desc): rows are the M or N of a product and HD its K,
//     as Q and K in S = Q K^T;
//   * MN-major (mnmajor_desc): rows are the K of a product and HD its N,
//     as V in O += P V.
//
// Fragments.  A warpgroup's m64 x nN f32 accumulator holds, in thread
// 32 w + l (warp w, lane l), entry i at row 16 w + l / 4 + 8 ((i / 2) % 2) and
// column 8 (i / 4) + 2 (l % 4) + i % 2.  Entries 8 kk .. 8 kk + 7 are, pair by
// pair, the four registers of the bf16 A fragment of k-step kk of a product
// whose K is that accumulator's N (split_frag): P never leaves registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------- shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned shared address at or after p.
__device__ __forceinline__ uint32_t align_1024(const void* p) {
  return (smem_u32(p) + 1023u) & ~1023u;
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// v, hidden from the optimizer: descriptors built from it inside a loop are
// rebuilt there (a few integer operations) instead of being hoisted out and
// held in registers for the whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Barrier over the `count` threads that name barrier `id` (1..15).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier is
// in phase 0, so waiting on parity 1 returns at once).  A wait still open
// after 2^34 clocks (~9 s) traps: a lost transfer or arrival fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// ------------------------------------------------------------------------ TMA
// One box of the 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory at dst; completes `bar`'s transactions.
// Coordinates past the tensor's extent read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// One box of the 3-D tensor map at coordinates (c0, c1, c2), innermost
// first, into shared memory at dst; completes `bar`'s transactions.
// Coordinates past the tensor's extent read as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A ring of kStages stages of streamed tiles, n tiles in all, filled by the
// block's thread 0: every stage at the start, then stage i % kStages again
// with tile i + kStages once all kWarps consumer warps have released tile
// i.  full[s] completes when a stage's bytes have landed, empty[s] when
// every consumer warp has released it.  Thread 0 waits there for the other
// consumers, so no warp of the block is set aside to load.
template <int kStages, int kWarps>
struct Ring {
  uint32_t full, empty;                   // mbarrier arrays (8 bytes each)
  int n;
  __device__ void init() const {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kWarps);
    }
  }
  // Thread 0: fill the stages at the start.  load(i, stage, bar) issues
  // tile i's loads.
  template <typename Load>
  __device__ void start(Load load) const {
    for (int i = 0; i < min(kStages, n); ++i) load(i, i, full + 8 * i);
  }
  __device__ void wait(int i) const {
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
  }
  // Every consumer thread after tile i; thread 0 then refills the stage.
  template <typename Load>
  __device__ void release(int i, Load load) const {
    const int st = i % kStages;
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * st);
    if (threadIdx.x == 0 && i + kStages < n) {
      mbar_wait(empty + 8 * st, (i / kStages) & 1);
      load(i + kStages, st, full + 8 * st);
    }
    __syncwarp();                         // warp 0 whole again for wgmma
  }
};

// ---------------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their other uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(r[i]);
}

// Geometry of a bf16 tile with HD values a row (see the top of this file).
template <int HD>
struct Tile {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head dim 32, 64 or 128");
  static constexpr int kAW = HD >= 64 ? 64 : 32;    // values a swizzle row
  static constexpr int kRowBytes = 2 * kAW;         // 128 or 64
  static constexpr int kChunks = HD / kAW;          // TMA boxes a tile row
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8 rows: a swizzle atom
  static constexpr uint64_t kLayout = HD >= 64 ? 1 : 2;  // 128B or 64B swizzle
  static constexpr bool kSwizzle128 = HD >= 64;
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * HD * 2;
  }
};

// Load one tile of R rows into dst: Tile<HD>::kChunks boxes of the 4-D
// map, chunk c from coordinates (c * AW, c1, c2, c3) to dst + c * R * AW * 2.
template <int HD, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const CUtensorMap* map,
                                          uint32_t bar, int c1, int c2,
                                          int c3) {
  using T = Tile<HD>;
  for (int c = 0; c < T::kChunks; ++c)
    tma_load_4d(dst + c * R * T::kRowBytes, map, bar, c * T::kAW, c1, c2, c3);
}

// Zero rows [live_rows, 64) of n_tiles consecutive 64-row tiles at tiles
// (all threads of the block): a query tile's box fills only its first
// 64 / rep * rep rows, and 0 * garbage must not reach a product.
template <int HD>
__device__ __forceinline__ void zero_dead_rows(uint8_t* tiles, int n_tiles,
                                               int live_rows) {
  using T = Tile<HD>;
  if (live_rows == 64) return;
  const int dead = (64 - live_rows) * (T::kRowBytes / 16);  // 16 B a store
  for (int e = threadIdx.x; e < n_tiles * T::kChunks * dead; e += blockDim.x)
    *reinterpret_cast<uint4*>(tiles + (e / dead) * 64 * T::kRowBytes +
                              live_rows * T::kRowBytes + (e % dead) * 16) =
        make_uint4(0, 0, 0, 0);
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle layout (bits 0-13, 16-29, 32-45, 62-63; in 16-byte units).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// k-step kk (16 values of HD) of a tile of R rows read K-major: within a
// chunk the step moves the start address by 32 bytes; the leading offset is
// unused for swizzled K-major layouts.
template <int HD, int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  using T = Tile<HD>;
  constexpr int kPer = T::kAW / 16;                  // k-steps a chunk
  return make_desc(base + (kk / kPer) * R * T::kRowBytes + (kk % kPer) * 32,
                   16, T::kGroupBytes, T::kLayout);
}

// k-step kk (rows 16 kk .. 16 kk + 15) of a tile of R rows read MN-major:
// the leading offset steps from one AW-wide chunk to the next along N, the
// stride offset from one 8-row group to the next along K.
template <int HD, int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk) {
  using T = Tile<HD>;
  return make_desc(base + kk * 16 * T::kRowBytes, R * T::kRowBytes,
                   T::kGroupBytes, T::kLayout);
}

// Accumulator entries c[0..7] (the k-step's columns of rows r and r + 8) as
// the A fragment of one k-step, split into NP bf16 parts: part p is the
// bf16 rounding of what parts 0..p-1 leave (the differences are exact in
// f32), so two parts keep x to about 2^-17 of its value, three to 2^-26.
template <int NP>
__device__ __forceinline__ void split_frag(const float* c,
                                           uint32_t (&f)[NP][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float x0 = c[2 * t], x1 = c[2 * t + 1];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
      const float2 vf = __bfloat1622float2(v);
      x0 -= vf.x;
      x1 -= vf.y;
      f[p][t] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

// The m64 x n64 accumulator c (P or dS) as the split A fragments of the 4
// k-steps of a 64-row K: f[kk][part].
template <int NP>
__device__ __forceinline__ void split_tile(const float (&c)[32],
                                           uint32_t (&f)[4][NP][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) split_frag<NP>(&c[8 * kk], f[kk]);
}

// D (m64 x n64, f32) (+)= A . B, A (m64 x k16) and B (k16 x n64) bf16 in
// shared memory, both K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (m64 x n32, f32) += A . B, A (m64 x k16) bf16 from registers (the
// fragment of frag_index), B (k16 x n32) bf16 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (m64 x n64, f32) += A . B, A (m64 x k16) bf16 from registers (the
// fragment of frag_index), B (k16 x n64) bf16 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (m64 x n128, f32) += A . B, A (m64 x k16) bf16 from registers (the
// fragment of frag_index), B (k16 x n128) bf16 MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// D += A . B with A from registers and B MN-major, N = HD.
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HD == 32)
    wgmma_rs_n32(d, a, desc_b);
  else if constexpr (HD == 64)
    wgmma_rs_n64(d, a, desc_b);
  else
    wgmma_rs_n128(d, a, desc_b);
}

// ----------------------------------------------------------- host: tensor maps
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// so that no library links against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a contiguous bf16 tensor (b, s, heads, HD) as the 4-D tensor
// (HD, heads, s, b), with boxes of (AW, box_heads, box_rows, 1): a box of
// box_rows positions of box_heads consecutive heads lands in shared memory
// row (position i, head r) -> row i * box_heads + r.  S is a true bound of the
// map, so rows past it read as zeros.
template <int HD>
cudaError_t tile_map(CUtensorMap* map, const void* ptr, int heads, int s,
                     int b, int box_heads, int box_rows) {
  using T = Tile<HD>;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kAW),
                             static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kSwizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Map of a contiguous (b, rows, width) tensor of bf16 or f32 as the 3-D
// tensor (width, rows, b), with boxes of (box_w, box_rows, 1): a box lands as
// box_rows rows of box_w values, under the 128-byte swizzle when `swizzle`
// (box_w values must then fill 128 bytes), else densely.  Width and rows
// are true bounds, so what lies past them reads as zeros.  TMA needs the
// base address and the row pitch (width values) to be multiples of 16 bytes.
inline cudaError_t rows_map(CUtensorMap* map, const void* ptr, bool bf16,
                            int width, int rows, int b, int box_w,
                            int box_rows, bool swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {dims[0] * elem, dims[0] * dims[1] * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
