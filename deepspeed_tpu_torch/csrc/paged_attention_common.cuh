// Shared device code of the two paged-attention kernels
// (ragged_paged_attention.cu, paged_decode.cu): vector loads, the masks of
// the TPU kernels, the query scaling both kernels fold in, and the
// CUDA-core form of the ragged wave (attend_rows) that serves what the
// tensor-core wave kernel does not take (fp32, page sizes its tiles do not
// hold, head_dim other than 64 / 128, GQA groups above 64 rows).
//
// attend_rows: one thread block computes one group of query rows (the rows
// of one atom that read one kv head) against the keys of its block table.
// The TPU kernels ran a sequential grid axis over pages with the
// online-softmax state in VMEM scratch carried from one grid step to the
// next; blocks on the GPU run in no order, so the key axis is a loop inside
// the block and the state lives in the block's shared memory. The loop
// walks TILES of up to kTileKeys keys (several pages), staged in shared
// memory with cp.async and double-buffered, so the next tile's loads are
// in flight while this one is computed:
//
//   for each tile of keys (pages j0 .. j0 + pages_per_tile - 1):
//     start the next tile's K/V copies; wait for this tile's
//     s[r][c] = q[r] . k[c]     one thread per (key, RC rows): each K
//                               element read feeds RC rows; q is scaled
//                               and rounded to T as it is staged
//     mask    : key < kv_len and key <= pos (pos = kv_len - q_len + t),
//               and pos - key < window where a window is set
//     ALiBi   : s += slope[head] * (key - pos), fp32, before the mask
//     one warp per row: m_new = max(m, max_c s); p = exp(s - m_new);
//                       rescale l and acc
//     acc[r][d] += sum_c p[r][c] * v[c][d]   one thread per (2 columns,
//                               RC rows), the sums in registers
//   out[r] = acc[r] / l[r]   (l == 0 -> 0)
//
// The staged K/V rows are padded by kPad elements, so the 32 keys a warp
// reads at one offset fall into distinct shared-memory banks. RC (rows a
// thread carries) is 4 where the group has 4 or more rows, else 2 or 1,
// chosen per block.
//
// A window skips the key tiles wholly below the first row's window: the
// loop starts at the tile holding key kv_len - q_len - window + 1.
//
// Any head_dim: a head_dim that is no multiple of 8 takes the NARROW form,
// whose shared memory holds rows of DV = D rounded up to 8 columns (zero
// past D), so every product reads whole 8-element chunks, and whose rows
// are copied from the pool at the widest width their byte length allows
// (16, 8, 4 or 2 bytes, row_width), so rows that are no multiple of 16
// bytes (D 100 in bf16, odd D) read aligned. The other form keeps 16-byte
// copies only: the width chosen at run time cost the waves at D 64-256
// 10-30% (kernel_ab.py, PR 16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;
constexpr int kMaxRowChunk = 4;  // query rows one thread carries
constexpr int kPad = 8;          // padding elements per staged K/V row
constexpr int kTileBytes = 160 * 1024;  // the K / V tiles' shared memory at most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive elements of src as floats (16 or 32 bytes, aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* src, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// 2 consecutive elements as floats (4 or 8 bytes, aligned).
__device__ __forceinline__ float2 load2(const __nv_bfloat16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}
__device__ __forceinline__ float2 load2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}

// 16-byte global -> shared copy that bypasses registers (cp.async), and the
// wait for all but the newest `n` committed groups of them.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
// A w-byte global -> shared copy, w = 16, 8, 4 (cp.async) or 2 (a plain
// load and store, ordered by the __syncthreads before its use).
__device__ __forceinline__ void copy_async(void* smem, const void* gmem, int w) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (w == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  } else if (w == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
  } else if (w == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
  } else {
    *static_cast<unsigned short*>(smem) = *static_cast<const unsigned short*>(gmem);
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Mask value and softmax floor of the ragged wave: pallas_flash MASK_VALUE
// and HALF_MASK (ragged_paged_attention.py:106-137).
constexpr float kMask = -0.7f * 3.4028234663852886e38f;
constexpr float kFloor = 0.5f * kMask;

// q as the TPU kernels take it: scaled, then rounded to its own type
// (bf16(float(q) * scale), the bits of torch's (q * scale).to(q.dtype)).
template <typename T>
__device__ __forceinline__ float scale_round(float x, float scale) {
  return to_float(from_float<T>(x * scale));
}

// The widest load (16, 8, 4 or 2 bytes) that keeps every row of `bytes`
// bytes aligned, the rows being consecutive from a 16-byte aligned base.
__host__ __device__ inline int row_width(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
}

// Columns a staged row holds: D rounded up to 8.
__host__ __device__ inline int width8(int D) { return (D + 7) / 8 * 8; }

// Keys a K/V tile: kTileKeys in whole pages, or a whole page when pages are
// longer; fewer (halved, down to a page or 16) where the four tiles (K and
// V, two buffers) of rows this wide would pass kTileBytes (fp32 past D 150).
__host__ __device__ inline int tile_keys(int ps, int D, int esize) {
  int keys = kTileKeys;
  while (keys > ps && keys > 16 && 4 * keys * (width8(D) + kPad) * esize > kTileBytes) keys /= 2;
  return ps >= keys ? ps : (keys / ps) * ps;
}

__host__ __device__ inline int padded_rows(int rows) {
  return (rows + kMaxRowChunk - 1) / kMaxRowChunk * kMaxRowChunk;
}

// fp32 part of the shared memory, rounded up to 16 bytes
__host__ __device__ inline size_t smem_float_words(int rows, int ps, int D, int esize) {
  const size_t rp = padded_rows(rows);
  const size_t words = 2 * rp * width8(D)                 // q, accumulator
                       + rp * tile_keys(ps, D, esize)     // scores / probabilities
                       + 3 * rp;                 // max, denominator, rescale
  return (words + 3) / 4 * 4;
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(int rows, int ps, int D) {
  return smem_float_words(rows, ps, D, sizeof(T)) * sizeof(float)
         + 4 * (size_t)tile_keys(ps, D, sizeof(T)) * (width8(D) + kPad) * sizeof(T);  // K, V tiles, 2 buffers
}

// Causal attention of `rows = q_len * g` query rows (row r = t*g + gi is
// query token t at position kv_len - q_len + t, head kvh*g + gi) against
// the keys of `table`, each thread carrying RC rows. q (unscaled) and out
// point at the first token of the group; token t, head h is at
// (t*H + h)*D. Any D (NARROW: D no multiple of 8); q, out and the pool
// 16-byte aligned. `slopes` ([H] fp32, ALiBi) may be null; `window` <= 0 is
// global.
template <typename T, int RC, bool NARROW>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            const T* __restrict__ k_pages, const T* __restrict__ v_pages,
                            const int* __restrict__ table, int n_table, int H, int kvh,
                            int g, int P, int ps, int D, int q_len, int kv_len,
                            float scale, const float* __restrict__ slopes, int window,
                            unsigned char* smem_raw) {
  const int rows = q_len * g;
  const int rp = (rows + RC - 1) / RC * RC;  // rows padded to whole chunks
  const int n_rc = rp / RC;
  const int TK = tile_keys(ps, D, sizeof(T));
  const int DV = NARROW ? width8(D) : D;  // columns of a staged row, zero past D
  const int Dp = DV + kPad;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* acc = qs + rp * DV;
  float* s = acc + rp * DV;
  float* m = s + rp * TK;
  float* l = m + rp;
  float* alpha = l + rp;
  T* kv_tiles =
      reinterpret_cast<T*>(smem_raw + smem_float_words(rows, ps, D, sizeof(T)) * sizeof(float));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = DV / 8;
  const int rb = D * (int)sizeof(T);  // bytes of a row

  for (int i = tid; i < rp * chunks; i += kThreads) {
    const int r = i / chunks, c8 = (i - r * chunks) * 8;
    float* dst = qs + r * DV + c8;
    if constexpr (!NARROW) {
      if (r < rows) {
        load8(q + (long)(r / g) * H * D + (long)(kvh * g + r % g) * D + c8, dst);
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = scale_round<T>(dst[e], scale);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = 0.f;
      }
    } else {  // one element at a time, zero past D
      const T* src = q + (long)(r / g) * H * D + (long)(kvh * g + r % g) * D;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = r < rows && c8 + e < D ? scale_round<T>(to_float(src[c8 + e]), scale) : 0.f;
    }
  }
  for (int i = tid; i < rp * DV; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < rp; r += kThreads) {
    m[r] = kMask;
    l[r] = 0.f;
  }

  const int n_keys = min(kv_len, n_table * ps);
  const long page_elems = (long)ps * D;
  const int W = NARROW ? row_width(rb) : 16;  // bytes a copy
  const int V = W / (int)sizeof(T);           // elements a copy
  const int vecs = D / V;
  if constexpr (NARROW) {  // the columns past D of both buffers stay zero
    for (int i = tid; i < 4 * TK; i += kThreads)
      for (int e = D; e < DV; ++e) kv_tiles[(long)i * Dp + e] = from_float<T>(0.f);
  }
  // stage the K and V rows of the tile starting at key k0 into buffer b
  // (K at kv_tiles + b*2*TK*Dp, V right after it); all copies in flight at once
  auto stage = [&](int k0, int b) {
    T* kb = kv_tiles + (long)b * 2 * TK * Dp;
    T* vb = kb + TK * Dp;
    const int valid = min(TK, n_keys - k0);
    for (int i = tid; i < valid * vecs; i += kThreads) {
      const int c = i / vecs, e = (i - c * vecs) * V;
      const int key = k0 + c;
      int page = table[key / ps];
      page = page < 0 ? 0 : (page >= P ? P - 1 : page);
      const long src = ((long)kvh * P + page) * page_elems + (long)(key % ps) * D + e;
      if constexpr (NARROW) {
        copy_async(kb + c * Dp + e, k_pages + src, W);
        copy_async(vb + c * Dp + e, v_pages + src, W);
      } else {
        cp_async16(kb + c * Dp + e, k_pages + src);
        cp_async16(vb + c * Dp + e, v_pages + src);
      }
    }
    cp_async_commit();
  };
  // the first tile any row's window reaches
  const int k_first = window > 0 ? max(0, kv_len - q_len - window + 1) / TK * TK : 0;
  if (k_first < n_keys) stage(k_first, 0);
  for (int k0 = k_first, b = 0; k0 < n_keys; k0 += TK, b ^= 1) {
    const int valid = min(TK, n_keys - k0);
    // prefetch the next tile into the other buffer (its readers finished
    // at the end of the previous step), then wait for this tile only
    if (k0 + TK < n_keys) {
      stage(k0 + TK, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv_tiles + (long)b * 2 * TK * Dp;
    const T* vs = ks + TK * Dp;

    // scores: thread (key c, rows r0 .. r0+RC-1); neighbouring threads
    // read neighbouring keys (distinct banks), q is a broadcast
    for (int u = tid; u < TK * n_rc; u += kThreads) {
      const int c = u % TK, r0 = (u / TK) * RC;
      float dot[RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) dot[i] = 0.f;
      if (c < valid) {
        const T* kr = ks + c * Dp;
        const float* q0 = qs + r0 * DV;
        for (int e = 0; e < DV; e += 8) {
          float k8[8];
          load8(kr + e, k8);
#pragma unroll
          for (int i = 0; i < RC; ++i) {
            float q8[8];
            load8(q0 + i * DV + e, q8);
#pragma unroll
            for (int j = 0; j < 8; ++j) dot[i] = fmaf(q8[j], k8[j], dot[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        const int r = r0 + i, key = k0 + c, pos = kv_len - q_len + r / g;
        const bool visible = c < valid && key <= pos && (window <= 0 || pos - key < window);
        const float bias = slopes != nullptr && r < rows
                               ? slopes[kvh * g + r % g] * (float)(key - pos) : 0.f;
        s[r * TK + c] = visible ? dot[i] + bias : kMask;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < rp; r += kWarps) {
      float* sr = s + r * TK;
      float mx = kMask;
      for (int c = lane; c < valid; c += 32) mx = fmaxf(mx, sr[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m[r];
      const float m_next = fmaxf(m_prev, mx);
      // the floor keeps fully masked rows at p == 0 (never inf - inf)
      const float m_safe = fmaxf(m_next, kFloor);
      float sum = 0.f;
      for (int c = lane; c < valid; c += 32) {
        const float p = expf(sr[c] - m_safe);
        sr[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float a = expf(fmaxf(m_prev, kFloor) - m_safe);
        l[r] = l[r] * a + sum;
        m[r] = m_next;
        alpha[r] = a;
      }
    }
    __syncthreads();

    // P.V: thread (columns d, d+1; rows r0 .. r0+RC-1), the 2*RC sums in
    // registers, so each V element read feeds RC rows
    const int half_d = DV / 2;
    for (int u = tid; u < half_d * n_rc; u += kThreads) {
      const int d = (u % half_d) * 2, r0 = (u / half_d) * RC;
      float o[RC][2];
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        const float a = alpha[r0 + i];
        const float2 prev = *reinterpret_cast<const float2*>(acc + (r0 + i) * DV + d);
        o[i][0] = prev.x * a;
        o[i][1] = prev.y * a;
      }
      for (int c = 0; c < valid; ++c) {
        const float2 v = load2(vs + c * Dp + d);
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          const float p = s[(r0 + i) * TK + c];
          o[i][0] = fmaf(p, v.x, o[i][0]);
          o[i][1] = fmaf(p, v.y, o[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        *reinterpret_cast<float2*>(acc + (r0 + i) * DV + d) = make_float2(o[i][0], o[i][1]);
      }
    }
    __syncthreads();  // this buffer and s are free for the next step
  }
  __syncthreads();  // (no keys) the initial m / l / acc are visible to all

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const float den = l[r] > 0.f ? l[r] : 1.f;
    out[(long)(r / g) * H * D + (long)(kvh * g + r % g) * D + d] =
        from_float<T>(acc[r * DV + d] / den);
  }
}

// attend_rows with the widest row chunk the group fills.
template <typename T, bool NARROW>
__device__ void attend_pages(const T* __restrict__ q, T* __restrict__ out,
                             const T* __restrict__ k_pages, const T* __restrict__ v_pages,
                             const int* __restrict__ table, int n_table, int H, int kvh,
                             int g, int P, int ps, int D, int q_len, int kv_len,
                             float scale, const float* __restrict__ slopes, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = q_len * g;
  if (rows >= 4) {
    attend_rows<T, 4, NARROW>(q, out, k_pages, v_pages, table, n_table, H, kvh, g, P, ps, D,
                              q_len, kv_len, scale, slopes, window, smem_raw);
  } else if (rows >= 2) {
    attend_rows<T, 2, NARROW>(q, out, k_pages, v_pages, table, n_table, H, kvh, g, P, ps, D,
                              q_len, kv_len, scale, slopes, window, smem_raw);
  } else {
    attend_rows<T, 1, NARROW>(q, out, k_pages, v_pages, table, n_table, H, kvh, g, P, ps, D,
                              q_len, kv_len, scale, slopes, window, smem_raw);
  }
}

// Opt in to the dynamic shared memory a launch needs beyond the 48 KB
// default; returns the CUDA error of the attribute call.
template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace dstt
