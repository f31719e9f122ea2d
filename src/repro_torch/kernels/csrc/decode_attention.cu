// One-token GQA attention against a length-masked KV cache (flash-decode):
//
//   out[b, g*rep + r] = sum_{t < len_b} softmax_t(q_r . k_t * scale) v_t
//
// for every row b, KV group g and the rep = H / Hkv query heads of the group,
// with q (B, H, hd), k and v (B, S, Hkv, hd), lengths (B,) int32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (_kernel) and computes its function: masked slots at
// _NEG = -1e30, p = exp(s - m) * mask, output o / max(l, 1e-20) in q's
// dtype.  A row of length 0 gives zeros, not NaN.
//
// What bounds the function on an H100: bytes.  It reads K and V up to each
// row's length once (at glm4-9b's serving shape, B = 8, 2,112 slots,
// Hkv = 2, hd = 128, bf16: 17.3 MB, 5.2 us at 3.35 TB/s; 268 MB and 80 us
// at a 32k cache) and does 4 flops per byte pair of q.k and p.v.  In f32
// on the CUDA cores that work alone (with its conversions and shared-memory
// operand reads) reaches the byte bound; on the tensor cores it is a small
// fraction of it, so only they leave the memory as the limit.
//
// Both instances split the S axis (split-K, "flash-decoding"): grid
// (n_split, Hkv, B), block (split, g, b) one contiguous slot range of `chunk`
// slots for all rep heads of group g, so one K/V load serves rep heads.  The
// TPU kernel walked S as the last, sequential grid axis and carried (m, l, o)
// in VMEM; a grid of (B, Hkv) alone would be 16 blocks for 132 SMs at B = 8,
// Hkv = 2.  The wrapper aims at one block an SM (the fastest of 1 to 4 at
// glm4-9b's serving shape, with the merge below).  A block stores f32
// partials (m, l, o[rep, hd]) to a scratch the wrapper allocates; a second
// kernel merges the splits in split order, one block per (b, g, head), one
// thread per output dim, several splits' loads in flight at once.  (A merge
// fused into the last block of each (b, g), found by an integer ticket,
// measured 1.8x slower at that shape: one block then merges 16 heads of
// every split alone.)  Blocks wholly past lengths[b] return at once and load
// nothing; the merge reads only the live splits.  No float atomics: two
// launches are bitwise equal.
//
// bf16: decode_tc, mma.sync on the tensor cores.
//   * the rep query heads of a group are the M of m16n8k16 (16 rows; rows at
//     or past rep are zeros: rep 16 at glm4-9b, 6 at internlm2-20b, 1 at
//     deepseek-7b).  wgmma's 64-row M would waste three quarters of the unit.
//   * each warp takes the 16-slot tiles w, w + 4, w + 8, ... of its block's
//     range through a private ring of kStages stages (K and V tiles, bf16)
//     that cp.async fills in 16-byte pieces, kStages - 1 tiles in flight
//     while it computes; slots at or past the row's length load as zeros.
//     No block barrier in the loop: a warp waits on its own copies only.
//     Tiles are stored with their 16-byte pieces XOR-swizzled by row, so
//     ldmatrix reads 8 rows without bank conflicts.
//   * S = Q K^T: Q is the bf16 A fragment, loaded once a block into
//     registers; K the B operand, read by ldmatrix.  The scale (times
//     log2 e) multiplies S after the product; the online softmax runs in f32
//     on the accumulator fragment, base 2, slots past the length at _NEG.
//   * O += P V: the S accumulator turns into A fragments in registers, P
//     split in two bf16 parts (hi = bf16(P), lo = bf16(P - hi); one bf16 P
//     would err by 2^-9 a term), two mma a tile into one f32 accumulator;
//     V is read by ldmatrix.trans.  l sums the f32 P.  P never goes to
//     shared memory.
//   * the four warps' partials are merged in warp order through shared
//     memory (the ring, reused), then stored as the block's partial in the
//     SIMT instance's layout (m in natural-log units).
//
// f32: decode_split_kernel, f32 FMA on the CUDA cores (the f32 parity path).
//   * 32-slot tiles of K and V are staged in shared memory as f32 with
//     16-byte loads.  Lane j of each warp scores slot j of the tile for up to
//     4 query heads (warp w takes heads w, w+4, w+8, w+12), so the online
//     softmax's max and sum of a head are warp shuffles.  Then thread t owns
//     output dim t % hd of its heads and adds p . v in slot order.
//
// The launch function returns cudaGetLastError() after each launch; the
// wrapper raises if it is not cudaSuccess.  It makes no call that a CUDA
// graph capture refuses: the device is set only if it is not current, and
// the tensor-core kernel's shared-memory limit once a device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxRep = 16;                    // query heads per KV group
constexpr int kSlots = 32;                     // unit of a block's range
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int clamp_len(int len, int s) {
  return len < 0 ? 0 : (len > s ? s : len);
}

// ----------------------------------------------------------- f32: SIMT
namespace simt {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kMaxRep / kWarps;

// 16 bytes of f32 at src (16-byte aligned) → 4 floats at dst.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 raw = *reinterpret_cast<const float4*>(src);
  dst[0] = raw.x;
  dst[1] = raw.y;
  dst[2] = raw.z;
  dst[3] = raw.w;
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

// grid (n_split, hkv, b).  Block (split, g, b) covers slots
// [split * chunk, min((split + 1) * chunk, len_b)) and stores, for each head
// r of group g, part_o[.., r, :] = sum_t p_t v_t (unnormalised) and
// part_ml[.., r] = (m, l).
template <int HD>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths, int s, int h,
                        int hkv, int chunk, int n_split, float scale,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml) {
  constexpr int kLd = HD + 4;                  // 16-byte aligned rows
  constexpr int kGroups = kThreads / HD;       // head groups of the p.v step
  constexpr int kOut = kMaxRep / kGroups;      // heads a thread owns there
  constexpr int kVec = 4;
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

  // the group's query heads, times the scale before the dot
  const float* qb =
      q + (static_cast<size_t>(b) * h + static_cast<size_t>(g) * rep) * HD;
  for (int e = tid; e < rep * HD; e += kThreads)
    q_s[e / HD][e % HD] = qb[e] * scale;

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
    // stage K and V slots [t0, t0 + 32); slots at or past `end` as 0
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
      *reinterpret_cast<float4*>(&k_s[j][c]) =
          make_float4(kv[0], kv[1], kv[2], kv[3]);
      *reinterpret_cast<float4*>(&v_s[j][c]) =
          make_float4(vv[0], vv[1], vv[2], vv[3]);
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

}  // namespace simt

constexpr int kMergeUnroll = 4;                // splits whose loads overlap

// grid (rep, hkv, b), one thread per output dim: merge the live splits of
// head r in split order,
// out = sum_s o_s e^{m_s - M} / max(sum_s l_s e^{m_s - M}, 1e-20).
// The split loops are unrolled so that several splits' loads are in
// flight at once: each is an L2 round trip.
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
#pragma unroll kMergeUnroll
  for (int sp = 0; sp < live; ++sp)
    mx = fmaxf(mx, part_ml[((bg * n_split + sp) * rep + r) * 2]);
  float lsum = 0.0f, osum = 0.0f;
#pragma unroll kMergeUnroll
  for (int sp = 0; sp < live; ++sp) {
    const size_t idx = (bg * n_split + sp) * rep + r;
    const float w = expf(part_ml[idx * 2] - mx);
    lsum = fmaf(part_ml[idx * 2 + 1], w, lsum);
    osum = fmaf(part_o[idx * hd + d], w, osum);
  }
  store_as(&out[(static_cast<size_t>(b) * h + g * rep + r) * hd + d],
           osum / fmaxf(lsum, 1e-20f));
}

// ------------------------------------------------ bf16: mma.sync, cp.async
namespace tc {

constexpr int kWarps = 4;                      // the fastest of 2, 4 and 8
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;                      // slots a warp takes a step
constexpr int kStages = 3;                     // ring stages a warp: 2-4 alike
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Layout {
  static constexpr int kPieces = HD / 8;              // 16-byte pieces a row
  static constexpr int kTileBytes = kTile * HD * 2;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kOLd = HD + 4;                 // f32 o row, merge
  static constexpr int kBytes = kWarps * kWarpBytes;
  static_assert(kTile * kOLd * 4 <= kWarpBytes, "o exchange fits the ring");

  // byte offset of piece c of row r in a tile: pieces XOR-swizzled by row
  // so that the 8 rows one ldmatrix reads at one piece index fall on 8
  // different 16-byte bank groups
  static __device__ __forceinline__ uint32_t at(int r, int c) {
    const int key = kPieces >= 8 ? (r & 7) : ((r >> 1) & (kPieces - 1));
    return static_cast<uint32_t>(r * HD * 2 + ((c ^ key) << 4));
  }
};

// 16 bytes from global src to shared dst; zeros when !valid (src unread)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (m16 x n8, f32) += a (m16 x k16, bf16) . b (k16 x n8, bf16)
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p,
                                              bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// Block (split, g, b): slots [split * chunk, min(split * chunk + chunk,
// len_b)) in 16-slot tiles, tile j to warp j % 4.  Stores the block's
// partial (m in natural-log units, l, o[rep, hd]) as the SIMT kernel does.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    decode_tc(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ lengths, int s, int h, int hkv,
              int chunk, int n_split, float scale_log2,
              float* __restrict__ part_o, float* __restrict__ part_ml) {
  using L = Layout<HD>;
  constexpr int kK = HD / 16;                  // k-steps of q.k
  constexpr int kN = HD / 8;                   // n-tiles of o
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ float ml_s[kWarps][kTile][2];
  __shared__ float wt_s[kWarps][kTile];

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
  const int gr = lane / 4;                     // fragment row (and row + 8)
  const int tg = lane % 4;                     // fragment column pair

  // Q as the A fragments of the kK k-steps; rows at or past rep are zeros
  uint32_t qa[kK][4];
  {
    const __nv_bfloat16* q0 =
        q + (static_cast<size_t>(b) * h + static_cast<size_t>(g) * rep) * HD;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const int c = 16 * kk + 2 * tg;
      qa[kk][0] = load_pair(q0 + gr * HD + c, gr < rep);
      qa[kk][1] = load_pair(q0 + (gr + 8) * HD + c, gr + 8 < rep);
      qa[kk][2] = load_pair(q0 + gr * HD + c + 8, gr < rep);
      qa[kk][3] = load_pair(q0 + (gr + 8) * HD + c + 8, gr + 8 < rep);
    }
  }

  const size_t slot_stride = static_cast<size_t>(hkv) * HD;
  const __nv_bfloat16* kb =
      k + static_cast<size_t>(b) * s * slot_stride + static_cast<size_t>(g) * HD;
  const __nv_bfloat16* vb =
      v + static_cast<size_t>(b) * s * slot_stride + static_cast<size_t>(g) * HD;
  const uint32_t ring = hopper::smem_u32(smem + warp * L::kWarpBytes);
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const int mine = n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;

  // this warp's i-th tile into stage i % kStages: lane takes pieces
  // lane, lane + 32, ... of the K tile and the same of the V tile
  auto issue = [&](int i) {
    const int t0 = start + (warp + kWarps * i) * kTile;
    const uint32_t st = ring + (i % kStages) * L::kStageBytes;
#pragma unroll
    for (int j = 0; j < kTile * L::kPieces / 32; ++j) {
      const int r = (lane + 32 * j) / L::kPieces;
      const int c = (lane + 32 * j) % L::kPieces;
      const bool ok = t0 + r < end;
      const size_t off = static_cast<size_t>(ok ? t0 + r : start) * slot_stride +
                         c * 8;
      cp16(st + L::at(r, c), kb + off, ok);
      cp16(st + L::kTileBytes + L::at(r, c), vb + off, ok);
    }
  };

  float m[2] = {kNeg, kNeg};                   // rows gr, gr + 8 (base 2)
  float l[2] = {0.0f, 0.0f};                   // this thread's columns
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) issue(i);
    cp_commit();
  }
  // ldmatrix row addresses: lane's matrix mi = lane / 8, its row lane % 8
  const int mi = lane / 8;
  const int kr = (mi >> 1) * 8 + lane % 8;     // K: slot, piece 2 kk + (mi & 1)
  const int vr = (mi & 1) * 8 + lane % 8;      // V: slot, piece 2 np + (mi >> 1)
  for (int i = 0; i < mine; ++i) {
    cp_wait<kStages - 2>();
    __syncwarp();
    if (i + kStages - 1 < mine) issue(i + kStages - 1);
    cp_commit();
    const uint32_t st = ring + (i % kStages) * L::kStageBytes;
    const int t0 = start + (warp + kWarps * i) * kTile;

    // S = Q K^T: s[0..3] slots t0 + 2 tg + {0, 1} (rows gr, gr + 8),
    // s[4..7] the same + 8
    float sc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kf, st + L::at(kr, 2 * kk + (mi & 1)));
      mma(&sc[0], qa[kk], kf[0], kf[1]);
      mma(&sc[4], qa[kk], kf[2], kf[3]);
    }
    // online softmax, base 2, on the fragment
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int slot = t0 + 8 * (j / 4) + 2 * tg + (j % 2);
      sc[j] = slot < end ? sc[j] * scale_log2 : kNeg;
      mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], sc[j]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
    const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int slot = t0 + 8 * (j / 4) + 2 * tg + (j % 2);
      const int r = (j / 2) % 2;
      sc[j] = slot < end ? exp2f(sc[j] - mx[r]) : 0.0f;
      ps[r] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + ps[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P_hi V + P_lo V
    uint32_t pf[2][4];
    hopper::split_frag<2>(sc, pf);
#pragma unroll
    for (int np = 0; np < kN / 2; ++np) {
      uint32_t vf[4];
      ldsm_x4_t(vf, st + L::kTileBytes + L::at(vr, 2 * np + (mi >> 1)));
      mma(o[2 * np], pf[0], vf[0], vf[1]);
      mma(o[2 * np], pf[1], vf[0], vf[1]);
      mma(o[2 * np + 1], pf[0], vf[2], vf[3]);
      mma(o[2 * np + 1], pf[1], vf[2], vf[3]);
    }
    __syncwarp();
  }
  cp_wait<0>();

  // a row's l over its four lanes; the warp's (m, l) and o to shared memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  __syncwarp();
  if (tg == 0) {
    ml_s[warp][gr][0] = m[0];
    ml_s[warp][gr][1] = l[0];
    ml_s[warp][gr + 8][0] = m[1];
    ml_s[warp][gr + 8][1] = l[1];
  }
  float* o_s = reinterpret_cast<float*>(smem + warp * L::kWarpBytes);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = 8 * n + 2 * tg;
    *reinterpret_cast<float2*>(&o_s[gr * L::kOLd + c]) =
        make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(&o_s[(gr + 8) * L::kOLd + c]) =
        make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();

  // merge the warps in order: M = max_w m_w, c_w = 2^(m_w - M),
  // L = sum_w c_w l_w, O = sum_w c_w o_w
  const size_t part = (static_cast<size_t>(b) * hkv + g) * n_split + split;
  if (tid < rep) {
    float mm = ml_s[0][tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, ml_s[w][tid][0]);
    float ll = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(ml_s[w][tid][0] - mm);
      wt_s[w][tid] = c;
      ll = fmaf(ml_s[w][tid][1], c, ll);
    }
    part_ml[(part * rep + tid) * 2] = mm * kLn2;
    part_ml[(part * rep + tid) * 2 + 1] = ll;
  }
  __syncthreads();
  for (int e = tid; e < rep * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e % HD;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ow = reinterpret_cast<const float*>(smem + w * L::kWarpBytes);
      acc = fmaf(ow[r * L::kOLd + d], wt_s[w][r], acc);
    }
    part_o[(part * rep + r) * HD + d] = acc;
  }
}

}  // namespace tc

// the tensor-core kernel's dynamic shared memory, set once a device
template <int HD>
cudaError_t allow_smem(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      tc::decode_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::Layout<HD>::kBytes);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

template <int HD>
cudaError_t launch(bool bf16, const void* q, const void* k, const void* v,
                   const int* lengths, int b, int s, int h, int hkv,
                   int chunk, int n_split, float scale, int device,
                   float* part_o, float* part_ml, void* out,
                   cudaStream_t stream) {
  const dim3 grid(n_split, hkv, b);
  cudaError_t err;
  if (bf16) {
    err = allow_smem<HD>(device);
    if (err != cudaSuccess) return err;
    tc::decode_tc<HD><<<grid, tc::kThreads, tc::Layout<HD>::kBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), lengths, s, h, hkv, chunk,
        n_split, scale * tc::kLog2e, part_o, part_ml);
  } else {
    simt::decode_split_kernel<HD><<<grid, simt::kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lengths, s, h, hkv, chunk, n_split,
        scale, part_o, part_ml);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 mgrid(h / hkv, hkv, b);
  if (bf16)
    decode_merge_kernel<__nv_bfloat16><<<mgrid, HD, 0, stream>>>(
        part_o, part_ml, lengths, s, h, hkv, HD, chunk, n_split,
        static_cast<__nv_bfloat16*>(out));
  else
    decode_merge_kernel<float><<<mgrid, HD, 0, stream>>>(
        part_o, part_ml, lengths, s, h, hkv, HD, chunk, n_split,
        static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int da_slots() { return kSlots; }
int da_max_rep() { return kMaxRep; }

// q: (b, h, hd); k, v: (b, s, hkv, hd), contiguous, all f32 or all bf16,
// 16-byte aligned; lengths: int32[b].  part_o: f32[b, hkv, n_split, rep, hd]
// and part_ml: f32[b, hkv, n_split, rep, 2] scratch; out: (b, h, hd) in q's
// type.  chunk is a multiple of da_slots() and chunk * n_split >= s.  bf16
// runs the tensor-core kernel, f32 the SIMT one.
int da_launch(const void* q, const void* k, const void* v,
              const int* lengths, int bf16, int b, int s, int h, int hkv,
              int hd, int chunk, int n_split, float scale, int device,
              float* part_o, float* part_ml, void* out, void* stream) {
  if (b < 1 || s < 1 || hkv < 1 || h % hkv != 0 || h / hkv > kMaxRep ||
      chunk < kSlots || chunk % kSlots != 0 || n_split < 1 ||
      static_cast<long long>(chunk) * n_split < s || b > 65535 ||
      hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      err = launch<32>(bf16, q, k, v, lengths, b, s, h, hkv, chunk, n_split,
                       scale, device, part_o, part_ml, out, st);
      break;
    case 64:
      err = launch<64>(bf16, q, k, v, lengths, b, s, h, hkv, chunk, n_split,
                       scale, device, part_o, part_ml, out, st);
      break;
    case 128:
      err = launch<128>(bf16, q, k, v, lengths, b, s, h, hkv, chunk, n_split,
                        scale, device, part_o, part_ml, out, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* da_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
