// Grouped expert FFN of the mixture of experts, with two epilogues:
//
//   mid[e, c]  = silu(x[e, c] @ w1[e]^T) * (x[e, c] @ w3[e]^T)      (gelu(x @ w1^T) ungated)
//   y[e, c]    = mid[e, c] @ w2[e]^T                                  fp32
//   split:  store y (rows of empty slots as zeros)
//   fused:  out[src - 1] += slot_w * y  for every filled slot          out [T, H] fp32
//
// x [E, C, H] is the dispatched payload (C slots an expert), w1 / w3 [E, F, H]
// and w2 [E, H, F] the expert weights in the [out, in] layout (the reduction
// axis contiguous), src [E * C] the slot -> token + 1 map (0 = empty slot),
// slot_w [E * C] the slots' combine weights.
//
// Replaces two TPU kernels of deepspeed_tpu/ops/transformer/pallas_moe.py:
// _ffn_combine_kernel (via moe_ffn_combine, the fused epilogue) and
// _ffn_kernel (via moe_ffn, the split form, whose combine is
// csrc/moe_dispatch.cu). Same function: the products in fp32, the combine
// scatter in fp32. What differs is where the intermediate lives: the Pallas
// kernel keeps a [cap_block, H] fp32 accumulator in VMEM across its
// sequential F axis; a Hopper block cannot hold H = 4096 rows of fp32 sums
// next to its tiles, so the FFN runs as two passes over a mid [E, C, F]
// buffer in the compute dtype. In bf16 mid is rounded to bf16 before the
// down product, which is the numerics of the XLA reference path
// (moe_reference_forward); in fp32 it stays fp32.
//
// Bound on an H100 SXM: at decode (8 tokens, 16 picks over 8 experts) the
// bytes of the experts' weights, 3 * H * F * 2 bytes an expert; at a prefill
// wave of 512 tokens the operations, 6 * H * F a filled slot. Design:
// - bf16 on the tensor cores (mma.sync m16n8k16, fp32 sums), a 4-stage
//   cp.async ring of 64-wide K tiles, ldmatrix from rows padded to 144 bytes
//   (no bank conflicts). A block owns BM rows of one expert and 128 staged
//   weight rows: 128 output columns, or 64 columns of w1 and the same 64 of
//   w3 when gated, so silu(g) * u is formed in registers. BM is 16 for
//   decode-sized capacities, 64 above.
// - Dropless serving fills k * T of the E * T slots, and an expert's slots
//   fill from position 0: a tile whose first slot is empty is empty, and its
//   block returns at once (the split form writes its rows of y as zeros,
//   since the combine reads slot 0 with weight 0 for a dropped choice). So
//   the work is that of the filled slots, not E / k times more.
// - The fused epilogue adds slot_w * y into out with atomicAdd. With top_k
//   <= 2 each output element receives at most two products on a zeroed
//   row, 0 + a + b == 0 + b + a in fp32: the result has the same bits on
//   every run and equals the split form's 0 + w0 * y0 + w1 * y1. The
//   product is rounded on its own (__fmul_rn), never contracted into an FMA.
// - fp32 runs on the CUDA cores (32 x 64 tiles, 8 sums a thread).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Everything a launch reads, passed by value.
struct MoeFfnParams {
  const void* x;         // [E, C, H] payload
  const void* w1;        // [E, F, H] wi_gate (gated) or wi
  const void* w3;        // [E, F, H] wi_up, or null (ungated)
  const void* w2;        // [E, H, F] wo
  void* mid;             // [E, C, F] scratch in x's dtype
  const int* src;        // [E * C] token + 1 of each slot, 0 = empty
  const float* slot_w;   // [E * C] combine weight of each slot (fused)
  float* y;              // [E, C, H] (split), or null
  float* out;            // [T, H] zeroed by the caller (fused), or null
  int E, C, H, F, T;
  int gated;             // 1: silu(x w1) * (x w3); 0: gelu(x w1) (tanh form)
  int bf16;              // x, the weights and mid are bf16 (else fp32)
  int fused;             // 1: scatter slot_w * y into out; 0: store y
};

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float silu_f(float g) { return g / (1.f + expf(-g)); }

__device__ __forceinline__ float gelu_f(float x) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

// Pass 1's value of one element: silu(g) * u gated, gelu(g) ungated.
__device__ __forceinline__ float mid_value(bool gated, float g, float u) {
  return gated ? silu_f(g) * u : gelu_f(g);
}

// Pass 2's epilogue for columns col, col + 1 of slot row `row` of expert e.
__device__ __forceinline__ void out_pair(const MoeFfnParams& p, int e, int row, int col,
                                         float v0, float v1) {
  const long long slot = (long long)e * p.C + row;
  const int s = p.src[slot];
  if (p.fused) {
    if (s > 0) {
      const float w = p.slot_w[slot];
      float* o = p.out + (long long)(s - 1) * p.H + col;
      atomicAdd(o, __fmul_rn(w, v0));
      if (col + 1 < p.H) atomicAdd(o + 1, __fmul_rn(w, v1));
    }
  } else {
    float* o = p.y + slot * p.H + col;
    o[0] = s > 0 ? v0 : 0.f;
    if (col + 1 < p.H) o[1] = s > 0 ? v1 : 0.f;
  }
}

// The split form's rows of a skipped tile: zeros.
__device__ void zero_y_tile(const MoeFfnParams& p, int e, int m0, int rows, int n0, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = m0 + i / cols, c = n0 + i % cols;
    if (r < p.C && c < p.H) p.y[((long long)e * p.C + r) * p.H + c] = 0.f;
  }
}

// ---- bf16: tensor cores ----------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBRows = 128;          // weight rows staged a block
constexpr int kBK = 64;              // K a stage
constexpr int kLd = kBK + 8;         // bf16 between staged rows: 144 bytes
constexpr int kStages = 4;

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int WARPS_M>
struct TcShape {
  static constexpr int kWarpsN = 8 / WARPS_M;
  static constexpr int kWM = BM / WARPS_M;               // rows a warp
  static constexpr int kMT = kWM / 16;                   // 16-row mma tiles a warp
  static constexpr int kNT = kBRows / kWarpsN / 8;       // 8-column mma tiles a warp
  static constexpr int kStageElems = (BM + kBRows) * kLd;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
};

// PASS 1: A = x [C, H] of the expert, B = w1 (and w3) rows -> mid.
// PASS 2: A = mid [C, F], B = w2 rows -> y or out.
// Staged B row r is output column n0 + r; GATED (pass 1 only), rows 0..63
// are w1's and rows 64..127 w3's for the same 64 columns. A warp's n-tile j
// covers staged rows brow(j); GATED, tile j < kNT / 2 is w1 and tile
// j + kNT / 2 is w3 of the same columns. Every index into the fragment
// arrays is known at compile time, so they stay in registers.
template <int BM, int WARPS_M, int PASS, bool GATED>
__global__ void __launch_bounds__(kThreads, 2) moe_gemm_tc(const MoeFfnParams p) {
  using Sh = TcShape<BM, WARPS_M>;
  constexpr int MT = Sh::kMT, NT = Sh::kNT;
  constexpr bool gated = GATED;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / Sh::kWarpsN, wn = warp % Sh::kWarpsN;
  constexpr int out_cols = gated ? kBRows / 2 : kBRows;
  const int n0 = blockIdx.x * out_cols;
  const int K = PASS == 1 ? p.H : p.F;
  const int N = PASS == 1 ? p.F : p.H;

  if (p.src[(long long)e * p.C + m0] == 0) {   // slots fill from 0: the tile is empty
    if (PASS == 2 && !p.fused) zero_y_tile(p, e, m0, BM, n0, out_cols);
    return;
  }
  const bf16* A = static_cast<const bf16*>(PASS == 1 ? p.x : p.mid) + (long long)e * p.C * K;
  const bf16* W1 = static_cast<const bf16*>(PASS == 1 ? p.w1 : p.w2) + (long long)e * N * K;
  const bf16* W3 = gated ? static_cast<const bf16*>(p.w3) + (long long)e * N * K : W1;
  const int ktiles = (K + kBK - 1) / kBK;

  auto issue = [&](int kt) {
    if (kt < ktiles) {
      bf16* As = smem + (kt % kStages) * Sh::kStageElems;
      bf16* Bs = As + BM * kLd;
      const int k0 = kt * kBK;
      for (int i = tid; i < BM * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const bool ok = m0 + r < p.C && k0 + c < K;   // K % 8 == 0: a chunk is in or out
        cp_async16(As + r * kLd + c, ok ? A + (long long)(m0 + r) * K + k0 + c : A, ok);
      }
      for (int i = tid; i < kBRows * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const bf16* W = (gated && r >= kBRows / 2) ? W3 : W1;
        const int n = n0 + (gated ? (r & (kBRows / 2 - 1)) : r);
        const bool ok = n < N && k0 + c < K;
        cp_async16(Bs + r * kLd + c, ok ? W + (long long)n * K + k0 + c : W1, ok);
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count uniform
  };
  auto brow = [&](int j) {
    if constexpr (gated) {
      return j < NT / 2 ? wn * (NT / 2) * 8 + j * 8
                        : kBRows / 2 + wn * (NT / 2) * 8 + (j - NT / 2) * 8;
    } else {
      return wn * NT * 8 + j * 8;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt has landed
    __syncthreads();                // for every thread; and tile kt - 1 is consumed
    issue(kt + kStages - 1);        // into the buffer of tile kt - 1
    const bf16* As = smem + (kt % kStages) * Sh::kStageElems;
    const bf16* Bs = As + BM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], As + (wm * Sh::kWM + i * 16 + (lane & 15)) * kLd + kk + (lane >> 4) * 8);
      uint32_t b[NT][2];
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        const int t0 = gated ? q : 2 * q, t1 = gated ? q + NT / 2 : 2 * q + 1;
        uint32_t r[4];
        ldmatrix_x4(r, Bs + (brow((lane >> 4) ? t1 : t0) + (lane & 7)) * kLd + kk +
                           ((lane >> 3) & 1) * 8);
        b[t0][0] = r[0], b[t0][1] = r[1], b[t1][0] = r[2], b[t1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // c0, c1: row g, columns 2t, 2t + 1 of the n-tile; c2, c3: row g + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * Sh::kWM + i * 16 + g + 8 * h;
      if (row >= p.C) continue;
      if constexpr (PASS == 1) {
        bf16* mrow = static_cast<bf16*>(p.mid) + ((long long)e * p.C + row) * p.F;
        constexpr int tiles = gated ? NT / 2 : NT;
#pragma unroll
        for (int j = 0; j < tiles; ++j) {
          const int col = n0 + brow(j) + 2 * t4;   // gated: w1 row == output column
          if (col >= N) continue;
          constexpr int du = gated ? NT / 2 : 0;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              mid_value(gated, acc[i][j][2 * h], acc[i][j + du][2 * h]),
              mid_value(gated, acc[i][j][2 * h + 1], acc[i][j + du][2 * h + 1]));
          *reinterpret_cast<__nv_bfloat162*>(mrow + col) = v;   // N even: col + 1 < N
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + brow(j) + 2 * t4;
          if (col < N) out_pair(p, e, row, col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
}

template <int BM, int WARPS_M, int PASS, bool GATED>
cudaError_t launch_tc(const MoeFfnParams& p, cudaStream_t stream) {
  constexpr int bytes = TcShape<BM, WARPS_M>::kSmemBytes;
  static bool raised = false;   // more than 48 KB of shared memory is opt-in, once a kernel
  if (!raised) {
    const cudaError_t rc = cudaFuncSetAttribute(moe_gemm_tc<BM, WARPS_M, PASS, GATED>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                bytes);
    if (rc != cudaSuccess) return rc;
    raised = true;
  }
  constexpr int out_cols = GATED ? kBRows / 2 : kBRows;
  const int N = PASS == 1 ? p.F : p.H;
  const dim3 grid((N + out_cols - 1) / out_cols, (p.C + BM - 1) / BM, p.E);
  moe_gemm_tc<BM, WARPS_M, PASS, GATED><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int BM, int WARPS_M, int PASS>
cudaError_t launch_tc_act(const MoeFfnParams& p, cudaStream_t stream) {
  if constexpr (PASS == 1) {
    if (p.gated) return launch_tc<BM, WARPS_M, PASS, true>(p, stream);
  }
  return launch_tc<BM, WARPS_M, PASS, false>(p, stream);
}

// ---- fp32: CUDA cores -------------------------------------------------------------

constexpr int kFBM = 32;   // rows a block
constexpr int kFBN = 64;   // output columns a block
constexpr int kFBK = 16;

template <int PASS>
__global__ void __launch_bounds__(kThreads) moe_gemm_f32(const MoeFfnParams p) {
  __shared__ float As[kFBK][kFBM];
  __shared__ float Bs[kFBK][2 * kFBN];   // gated: w1 columns, then w3's
  const int e = blockIdx.z, m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kFBN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const bool gated = PASS == 1 && p.gated;
  const int K = PASS == 1 ? p.H : p.F;
  const int N = PASS == 1 ? p.F : p.H;
  if (p.src[(long long)e * p.C + m0] == 0) {   // slots fill from 0: the tile is empty
    if (PASS == 2 && !p.fused) zero_y_tile(p, e, m0, kFBM, n0, kFBN);
    return;
  }
  const float* A = static_cast<const float*>(PASS == 1 ? p.x : p.mid) + (long long)e * p.C * K;
  const float* W1 = static_cast<const float*>(PASS == 1 ? p.w1 : p.w2) + (long long)e * N * K;
  const float* W3 = gated ? static_cast<const float*>(p.w3) + (long long)e * N * K : W1;
  const int brows = gated ? 2 * kFBN : kFBN;

  float acc[2][4], accu[2][4];   // rows 2 ty + i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = accu[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    for (int i = tid; i < kFBM * kFBK; i += kThreads) {
      const int r = i / kFBK, c = i % kFBK;
      As[c][r] = (m0 + r < p.C && k0 + c < K) ? A[(long long)(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < brows * kFBK; i += kThreads) {
      const int r = i / kFBK, c = i % kFBK;
      const float* W = r >= kFBN ? W3 : W1;
      const int n = n0 + r % kFBN;
      Bs[c][r] = (n < N && k0 + c < K) ? W[(long long)n * K + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      const float a0 = As[k][2 * ty], a1 = As[k][2 * ty + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = Bs[k][tx + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
        if (gated) {
          const float bu = Bs[k][kFBN + tx + 16 * j];
          accu[0][j] = fmaf(a0, bu, accu[0][j]);
          accu[1][j] = fmaf(a1, bu, accu[1][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + 2 * ty + i;
    if (row >= p.C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      if (PASS == 1) {
        static_cast<float*>(p.mid)[((long long)e * p.C + row) * p.F + col] =
            mid_value(gated, acc[i][j], accu[i][j]);
      } else {
        const long long slot = (long long)e * p.C + row;
        const int s = p.src[slot];
        if (p.fused) {
          if (s > 0) atomicAdd(p.out + (long long)(s - 1) * p.H + col,
                               __fmul_rn(p.slot_w[slot], acc[i][j]));
        } else {
          p.y[slot * p.H + col] = s > 0 ? acc[i][j] : 0.f;
        }
      }
    }
  }
}

template <int PASS>
cudaError_t launch_f32(const MoeFfnParams& p, cudaStream_t stream) {
  const int N = PASS == 1 ? p.F : p.H;
  const dim3 grid((N + kFBN - 1) / kFBN, (p.C + kFBM - 1) / kFBM, p.E);
  moe_gemm_f32<PASS><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int PASS>
cudaError_t launch_pass(const MoeFfnParams& p, cudaStream_t stream) {
  if (!p.bf16) return launch_f32<PASS>(p, stream);
  return p.C <= 16 ? launch_tc_act<16, 1, PASS>(p, stream)
                   : launch_tc_act<64, 2, PASS>(p, stream);
}

}  // namespace

// The grouped FFN with its epilogue; returns the cudaError_t. The caller has
// checked the shapes (bf16: H % 8 == 0 and F % 8 == 0), allocated mid and y
// (split) and zeroed out (fused).
extern "C" int dstt_moe_ffn(MoeFfnParams p, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (p.E == 0 || p.C == 0 || p.H == 0) return cudaSuccess;
  cudaError_t rc = launch_pass<1>(p, stream);
  if (rc != cudaSuccess) return rc;
  return launch_pass<2>(p, stream);
}
