// Shared code of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the parameter block, the producer's register budget and the tile layout
// of the bf16 wgmma kernels, which tiles a block visits and which need a
// mask, and the fp32 kernels' tile loads, tile products and mask of one
// score.
//
// Where the mask rules live: masked_logit below (the fp32 kernels);
// flash_fwd.cu softmax (its key-range form) and edge_x, and flash_bwd.cu
// edge_p (the bf16 kernels' edge tiles, in the log2 domain), each written
// out in its kernel because every form that called a shared rule made
// ptxas branch on each score (PERF.md). They must agree: change
// them together.
//
// The CUDA-core kernels (fp32 inputs, and bf16 at head_dim 256, 384 and 512,
// which no wgmma form of these kernels fits in registers) run their products
// in full fp32 on tiles staged into shared memory as fp32 (DW columns, the
// head_dim's width class; zero past the head_dim), in warp tiles of 16 rows:
//
//   mma_nt: C[16 x 8*NT] += A[16 x KD] . B[8*NT x KD]^T   A, B rows in shared memory
//   mma_pv: C[16 x 8*NT] += P[16 x KN] . V[KN x 8*NT]     P through shared scratch
//
// Accumulator layout (per lane, gid = lane / 4, tig = lane % 4): c[n][0..1]
// are row gid, columns 8n + 2tig and 8n + 2tig + 1; c[n][2..3] the same
// columns of row gid + 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

using bf16 = __nv_bfloat16;

// pallas_flash.py MASK_VALUE and HALF_MASK: finite, so a row with no
// visible key ends with l == 0 (O = 0, LSE = MASK) and never NaN
constexpr float kMask = -0.7f * 3.4028234663852886e38f;
constexpr float kHalfMask = 0.5f * kMask;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Everything a launch reads; strides are in elements. Passed by value.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;        // backward: the forward's output (contiguous)
  const void* dout;     // backward: dL/dO (contiguous)
  const float* lse;     // [B, H, Sq]
  const float* dlse;    // backward: the cotangent on the LSE, [B, H, Sq], or null
  float* di;            // backward: rowsum(dO * O) - dLSE, [B, H, Sq]; the dQ
                        // launch writes it, the dK/dV launch reads it
  const int* qseg;      // [B, Sq] or null
  const int* kseg;      // [B, Sk] or null
  const float* slopes;  // [H] ALiBi slopes or null
  void* out0;           // forward: O [B, Sq, H, D]; dQ: dQ; dK/dV: dK [B, Sk, kvH, D]
  void* out1;           // forward: LSE [B, H, Sq]; dK/dV: dV
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, Sq, Sk, H, kvH, D;
  int causal, window, q_offset;
  float scale;
};

// ---- bf16: the wgmma kernels ------------------------------------------------

// registers a thread of the producer warpgroup keeps after setmaxnreg; the
// consumer warpgroups take the rest
constexpr int kProducerRegs = 24;

// A bf16 tile of rows x DK columns in shared memory (hopper.cuh): regions
// of E columns, swizzled by SW bytes. DK is the columns the S and dP
// products span (the head_dim; for packed heads, below, the head_dim plus
// kMaxShift) rounded up to 16, one wgmma k-step per 16 columns; the tile
// holds the next whole width DP (32, 64 or 128 columns). The head_dim D
// itself is a run-time value: the TMA maps' inner extent is D, so the
// columns past D arrive as zeros, the products over them add nothing, and
// the stores stop at D.
template <int DK>
struct Tile {
  static constexpr int DP = DK <= 32 ? 32 : DK <= 64 ? 64 : 128;  // columns a tile holds
  static constexpr int SW = DP >= 64 ? 128 : 64;  // swizzle = bytes of a region row
  static constexpr int E = SW / 2;                // columns of a region
  static constexpr int NR = DP / E;               // regions
};

// Heads at a head_dim that is no multiple of 8 (open-llama-3b's 100; bf16,
// an even D up to 122, one kv head a query head, heads packed: head stride
// D, which flash.py makes sure of): no head's row is whole 16 bytes, so no
// TMA map steps over heads, and a TMA box must start on 16 bytes. The maps
// then span a token's H x D columns (map_heads, hopper.cuh map_cols), and
// head h's box starts at the 16-byte column at or before h * D: its
// columns sit at [o, o + D) of the tile, o = (h * D) % 8 (head_shift), the
// rest holds the neighbours' columns (zeros past the last). Q, K, V, O and
// dO of one head share o (one kv head a query head), so the consumers zero
// the columns outside [o, o + D) of one operand of every product over D
// (zero_outside: Q and dO, or K and V), the products run over o + D
// columns, and the stores take columns [o, o + D).
__host__ __device__ inline bool packed_heads(int D) { return D % 8 != 0; }
constexpr int kMaxShift = 6;  // the largest o at an even D

// Where head h's columns start in its tiles.
__device__ __forceinline__ int head_shift(int D, int h) {
  return packed_heads(D) ? (h * D) % 8 : 0;
}

struct HeadBox {
  int col, head;
};
// The box coordinates (column, head) of head h's tile columns from c.
__device__ __forceinline__ HeadBox head_box(int D, int h, int c) {
  return packed_heads(D) ? HeadBox{h * D - (h * D) % 8 + c, 0} : HeadBox{c, h};
}

// The TMA map of [B, S, H, D] bf16 rows (strides in elements) whose box is
// box_rows rows x SW / 2 columns of one head.
template <int SW>
inline bool map_heads(CUtensorMap* map, const void* base, int B, int S, int H, int D, long long sb,
                      long long ss, long long sh, int box_rows) {
  if (!packed_heads(D)) return hopper::map_rows<SW>(map, base, B, S, H, D, sb, ss, sh, box_rows);
  if (sh != D) return false;
  return hopper::map_cols<SW>(map, base, B, S, (long long)H * D, sb, ss, box_rows);
}

// Zero the columns outside [lo, hi) of the 64 rows from row0 of a Tile<DK>
// tile of `rows` rows, by the 128 threads of a warpgroup.
template <int DK>
__device__ __forceinline__ void zero_outside(char* tile, int rows, int row0, int lo, int hi) {
  constexpr int SW = Tile<DK>::SW, E = Tile<DK>::E, C = Tile<DK>::DP / 8;
  for (int i = threadIdx.x % 128; i < 64 * C; i += 128) {
    const int r = row0 + i / C, c = i % C;
    if (8 * c >= lo && 8 * c + 8 <= hi) continue;
    bf16* e = reinterpret_cast<bf16*>(tile + (c / (E / 8)) * rows * SW +
                                      hopper::swizzled<SW>(r, c % (E / 8)));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (8 * c + k < lo || 8 * c + k >= hi) e[k] = __float2bfloat16(0.f);
  }
}
// Make warpgroup wg's stores to shared memory visible to its wgmma (the
// async proxy): a fence and the warpgroup's named barrier 1 + wg.
__device__ __forceinline__ void publish(int wg) {
  hopper::fence_async_smem();
  hopper::named_sync(1 + wg, 128);
}

// Whether the query rows [q0, q0 + nq) see any key of [k0, k0 + nk)
// (pallas_flash._should_run).
__device__ __forceinline__ bool tile_runs(const FlashParams& p, int q0, int nq, int k0, int nk) {
  if (!p.causal) return true;
  bool run = p.q_offset + q0 + nq - 1 >= k0;
  if (p.window > 0) run = run && (p.q_offset + q0) - (k0 + nk - 1) < p.window;
  return run;
}

// Whether a (rows x cols) score tile needs no mask: no segment ids or
// ALiBi in the call, no ragged edge, every key visible to every row.
__device__ __forceinline__ bool interior(const FlashParams& p, int q0, int nq, int k0, int nk) {
  if (p.qseg != nullptr || p.slopes != nullptr || q0 + nq > p.Sq || k0 + nk > p.Sk) return false;
  if (!p.causal) return true;
  const int first = p.q_offset + q0, last = first + nq - 1;
  return first >= k0 + nk - 1 && (p.window <= 0 || last - k0 < p.window);
}

// ---- the CUDA-core kernels -------------------------------------------------------

constexpr int kBK = 64;        // keys per tile (forward, dQ) and per dK/dV block, DW <= 256
constexpr int kPad = 4;        // floats per shared row past DW: 16 bytes
constexpr int kMaxWarps = 4;   // forward / dQ block

// Heads of one kv group a forward / dQ block covers, and its query rows
// per head: HB * BQ / 16 warps of 16 rows, at most max_warps.
__host__ inline void pick_rows(int G, int max_warps, int* HB, int* BQ) {
  int hb = 1;
  for (int d = 1; d <= G && d <= max_warps; ++d)
    if (G % d == 0) hb = d;
  *HB = hb;
  *BQ = 16 * (max_warps / hb > 0 ? max_warps / hb : 1);
}

// 16-byte global -> shared copy; src_ok false writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool src_ok) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = src_ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Stage `rows` rows of the first d values (d a multiple of 4 in fp32, of 8
// in bf16) into fp32 shared memory of DW columns (row stride ld); row r is
// read from base + r * stride when r < valid, and the columns from d to DW
// and the rows from valid on are zero-filled. fp32 rows go by cp.async
// (wait for the group); bf16 rows are read 16 bytes at a time and widened
// to fp32 on the way (plain stores: the __syncthreads before their use
// orders them).
template <int DW>
__device__ __forceinline__ void stage_rows(float* smem, int ld, const float* base,
                                           long long stride, int rows, int valid, int d, int tid,
                                           int nthreads) {
  constexpr int C = DW / 4;
  for (int i = tid; i < rows * C; i += nthreads) {
    const int r = i / C, c = (i - r * C) * 4;
    const bool ok = r < valid && c < d;
    cp_async16(smem + r * ld + c, ok ? base + r * stride + c : base, ok);
  }
}
template <int DW>
__device__ __forceinline__ void stage_rows(float* smem, int ld, const bf16* base,
                                           long long stride, int rows, int valid, int d, int tid,
                                           int nthreads) {
  constexpr int C = DW / 8;
  for (int i = tid; i < rows * C; i += nthreads) {
    const int r = i / C, c = (i - r * C) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < d) raw = *reinterpret_cast<const uint4*>(base + r * stride + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]),
                 x = __bfloat1622float2(h[2]), y = __bfloat1622float2(h[3]);
    float4* dst = reinterpret_cast<float4*>(smem + r * ld + c);
    dst[0] = make_float4(a.x, a.y, b.x, b.y);
    dst[1] = make_float4(x.x, x.y, y.x, y.y);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x rounded to the input type T and back: the Pallas kernels cast p and ds
// to the input dtype before their products.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return sizeof(T) == 4 ? x : __bfloat162float(__float2bfloat16(x));
}

// Store two neighbouring columns.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <int NT, int KD>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const float* a, int lda, const float* b,
                                       int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * lda;
  const float* a1 = a + (g + 8) * lda;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float* b0 = b + (n * 8 + 2 * t) * ldb;
    const float* b1 = b0 + ldb;
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int k = 0; k < KD; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
      const float4 y0 = *reinterpret_cast<const float4*>(b0 + k);
      const float4 y1 = *reinterpret_cast<const float4*>(b1 + k);
      s00 += x0.x * y0.x + x0.y * y0.y + x0.z * y0.z + x0.w * y0.w;
      s01 += x0.x * y1.x + x0.y * y1.y + x0.z * y1.z + x0.w * y1.w;
      s10 += x1.x * y0.x + x1.y * y0.y + x1.z * y0.z + x1.w * y0.w;
      s11 += x1.x * y1.x + x1.y * y1.y + x1.z * y1.z + x1.w * y1.w;
    }
    c[n][0] += s00;
    c[n][1] += s01;
    c[n][2] += s10;
    c[n][3] += s11;
  }
}

// P times V rows in shared memory; P goes through the warp's scratch rows
// [16][KN + 4] in shared memory.
template <int KN, int NT>
__device__ __forceinline__ void mma_pv(float (&c)[NT][4], const float (&p)[KN / 8][4],
                                       const float* v, int ldv, float* scratch) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int ld = KN + 4;
#pragma unroll
  for (int j = 0; j < KN / 8; ++j) {
    store2(scratch + g * ld + j * 8 + 2 * t, p[j][0], p[j][1]);
    store2(scratch + (g + 8) * ld + j * 8 + 2 * t, p[j][2], p[j][3]);
  }
  __syncwarp();
  const float* p0 = scratch + g * ld;
  const float* p1 = scratch + (g + 8) * ld;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int k = 0; k < KN; ++k) {
      const float2 vv = *reinterpret_cast<const float2*>(v + k * ldv + col);
      s00 += p0[k] * vv.x;
      s01 += p0[k] * vv.y;
      s10 += p1[k] * vv.x;
      s11 += p1[k] * vv.y;
    }
    c[n][0] += s00;
    c[n][1] += s01;
    c[n][2] += s10;
    c[n][3] += s11;
  }
  __syncwarp();
}

// Scaled logit of query position qi against key kj, with ALiBi, or kMask
// where the key is out of range or masked (causal on q_offset + qi, window,
// segment ids): pallas_flash._tile_logits for one score.
__device__ __forceinline__ float masked_logit(const FlashParams& p, float dot, int qi, int kj,
                                              float slope, int qseg, int kseg) {
  float s = dot * p.scale;
  const int qpos = qi + p.q_offset;
  if (p.slopes != nullptr) s += slope * static_cast<float>(kj - qpos);
  bool ok = kj < p.Sk;
  if (p.qseg != nullptr) ok = ok && qseg == kseg;
  if (p.causal) {
    ok = ok && qpos >= kj;
    if (p.window > 0) ok = ok && (qpos - kj) < p.window;
  }
  return ok ? s : kMask;
}

template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash
