// Shared device code of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the parameter block, the tile products on the tensor
// cores, the tile loads and the mask of one score.
//
// The products are warp-level tiles of 16 rows, in the register layout of
// mma.sync.m16n8k16 (bf16 inputs, fp32 accumulators). For fp32 inputs the
// same two products are computed on the CUDA cores in full fp32, into the
// same register layout, so the softmax, mask and store code is one code
// for both types:
//
//   mma_nt: C[16 x 8*NT] += A[16 x KD] . B[8*NT x KD]^T   A, B rows in shared memory
//   mma_pv: C[16 x 8*NT] += P[16 x KN] . V[KN x 8*NT]     P in accumulator registers
//
// Accumulator layout (per lane, gid = lane / 4, tig = lane % 4): c[n][0..1]
// are row gid, columns 8n + 2tig and 8n + 2tig + 1; c[n][2..3] the same
// columns of row gid + 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

// pallas_flash.py MASK_VALUE and HALF_MASK: finite, so a row with no
// visible key ends with l == 0 (O = 0, LSE = MASK) and never NaN
constexpr float kMask = -0.7f * 3.4028234663852886e38f;
constexpr float kHalfMask = 0.5f * kMask;
constexpr int kBK = 64;  // keys per tile (forward, dQ) and per dK/dV block

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

template <typename T> struct Traits;
template <> struct Traits<bf16> {
  static constexpr int kPad = 8;       // elements per shared row: 16 bytes
  static constexpr int kStages = 2;    // K/V (Q/dO) tiles in flight
  static constexpr int kMaxWarps = 8;  // forward / dQ block
};
template <> struct Traits<float> {
  static constexpr int kPad = 4;
  static constexpr int kStages = 1;
  static constexpr int kMaxWarps = 4;
};

// Heads of one kv group a forward / dQ block covers, and its query rows
// per head: HB * BQ / 16 warps of 16 rows, at most max_warps.
__host__ inline void pick_rows(int G, int max_warps, int* HB, int* BQ) {
  int hb = 1;
  for (int d = 1; d <= G && d <= max_warps; ++d)
    if (G % d == 0) hb = d;
  *HB = hb;
  *BQ = 16 * (max_warps / hb > 0 ? max_warps / hb : 1);
}

// ---- loads ----------------------------------------------------------------

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

// Stage `rows` rows of D elements into shared memory (row stride ld); row r
// is read from base + r * stride when r < valid, else zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* smem, int ld, const T* base, long long stride,
                                           int rows, int valid, int tid, int nthreads) {
  constexpr int V = 16 / sizeof(T);
  constexpr int C = D / V;
  for (int i = tid; i < rows * C; i += nthreads) {
    const int r = i / C, c = (i - r * C) * V;
    const bool ok = r < valid;
    cp_async16(smem + r * ld + c, ok ? base + r * stride + c : base, ok);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// Store two neighbouring columns.
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// ---- tile products --------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int NT, int KD>
__device__ __forceinline__ void mma_nt(float (&c)[NT][4], const bf16* a, int lda, const bf16* b,
                                       int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    const uint32_t a0 = ld32(a + g * lda + kk + 2 * t);
    const uint32_t a1 = ld32(a + (g + 8) * lda + kk + 2 * t);
    const uint32_t a2 = ld32(a + g * lda + kk + 2 * t + 8);
    const uint32_t a3 = ld32(a + (g + 8) * lda + kk + 2 * t + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* br = b + (n * 8 + g) * ldb + kk + 2 * t;
      mma16816(c[n], a0, a1, a2, a3, ld32(br), ld32(br + 8));
    }
  }
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

// P (accumulator registers, cast to bf16 as the Pallas kernel casts p to
// v's dtype) times V rows in shared memory.
template <int KN, int NT>
__device__ __forceinline__ void mma_pv(float (&c)[NT][4], const float (&p)[KN / 8][4],
                                       const bf16* v, int ldv, float* /*scratch*/) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KN / 16; ++kk) {
    const uint32_t a0 = pack_f32(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t a1 = pack_f32(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t a2 = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t a3 = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* v0 = v + (kk * 16 + 2 * t) * ldv;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + g;
      const uint32_t b0 = pack_bf16(v0[col], v0[ldv + col]);
      const uint32_t b1 = pack_bf16(v0[8 * ldv + col], v0[9 * ldv + col]);
      mma16816(c[n], a0, a1, a2, a3, b0, b1);
    }
  }
}

// fp32: P goes through the warp's scratch rows [16][KN + 4] in shared memory.
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

// ---- the mask of one score (pallas_flash._tile_logits) -------------------

// Scaled logit of query position qi against key kj, with ALiBi, or kMask
// where the key is out of range or masked (causal on q_offset + qi, window,
// segment ids). flash_bwd.cu edge_p applies the same rules in the log2
// domain: change both together.
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

template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash
