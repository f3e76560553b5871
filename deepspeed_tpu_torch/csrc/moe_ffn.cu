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
// Bound on an H100 SXM: the bytes of the experts' weights, 3 * H * F * 2
// bytes an expert that received a token, at a decode step (8 tokens, 16
// picks over 8 experts) and at a prefill wave of 512 tokens (~128 filled
// slots an expert: 2 * 128 operations a weight's 2 bytes, under the 295 at
// which the tensor cores bound); the operations, 6 * H * F a filled slot,
// from about 1024 tokens up. Two forms:
// - Decode (C <= 16, moe_gemm_tc): bf16 on the tensor cores
//   (mma.sync m16n8k16, fp32 sums), a 4-stage cp.async ring of 64-wide K
//   tiles, ldmatrix from rows padded to 144 bytes (no bank conflicts). A
//   block owns 16 slot rows of one expert and 128 staged weight rows: 128
//   output columns, or 64 columns of w1 and the same 64 of w3 when gated,
//   so silu(g) * u is formed in registers. Dropless serving fills k * T of
//   the E * T slots, and an expert's slots fill from position 0: a tile
//   whose first slot is empty is empty, and its block returns at once (the
//   split form writes its rows of y as zeros, since the combine reads slot
//   0 with weight 0 for a dropped choice).
// - Wave (C > 16, moe_wave): wgmma fed by TMA (hopper.cuh). A block owns
//   one expert and the same 128 weight rows, and walks every row tile that
//   holds the expert's filled slots (counted from src at the block's start)
//   under one stream of those weight rows: each weight byte leaves HBM once a pass
//   for up to 256 filled slots an expert, and no block is launched for an
//   empty row tile. One producer thread issues the TMA copies of 64-wide K
//   steps of the weight rows (K-major B, as the [out, in] weights lie) and
//   of the row tiles (K-major A) into a 4-stage ring of 128-byte-swizzled
//   tiles; two consumer warpgroups each multiply 64 of the weight rows
//   (gated: w1 and w3 of 32 columns, so silu(g) * u stays in registers)
//   against up to four 64-row tiles (wgmma m64n64k16, fp32 sums). The
//   producer's other warps write the split form's zero rows meanwhile.
// - The fused epilogue adds slot_w * y into out with atomicAdd. With top_k
//   <= 2 each output element receives at most two products on a zeroed
//   row, 0 + a + b == 0 + b + a in fp32: the result has the same bits on
//   every run and equals the split form's 0 + w0 * y0 + w1 * y1. The
//   product is rounded on its own (__fmul_rn), never contracted into an FMA.
// - fp32 runs on the CUDA cores (32 x 64 tiles, 8 sums a thread).
#include "hopper.cuh"

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

// The decode form's tile: 16 slot rows, each of the 8 warps 16 of the 128
// staged weight rows.
constexpr int kBM = 16;                              // slot rows a block
constexpr int kNT = kBRows / 8 / 8;                  // 8-column mma tiles a warp
constexpr int kStageElems = (kBM + kBRows) * kLd;
constexpr int kTcSmem = kStages * kStageElems * 2;

// PASS 1: A = x [C, H] of the expert, B = w1 (and w3) rows -> mid.
// PASS 2: A = mid [C, F], B = w2 rows -> y or out.
// Staged B row r is output column n0 + r; GATED (pass 1 only), rows 0..63
// are w1's and rows 64..127 w3's for the same 64 columns. A warp's n-tile j
// covers staged rows brow(j); GATED, tile j < kNT / 2 is w1 and tile
// j + kNT / 2 is w3 of the same columns. Every index into the fragment
// arrays is known at compile time, so they stay in registers.
template <int PASS, bool GATED>
__global__ void __launch_bounds__(kThreads, 2) moe_gemm_tc(const MoeFfnParams p) {
  constexpr int NT = kNT;
  constexpr bool gated = GATED;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, m0 = blockIdx.y * kBM;
  const int tid = threadIdx.x, wn = tid >> 5, lane = tid & 31;
  constexpr int out_cols = gated ? kBRows / 2 : kBRows;
  const int n0 = blockIdx.x * out_cols;
  const int K = PASS == 1 ? p.H : p.F;
  const int N = PASS == 1 ? p.F : p.H;

  if (p.src[(long long)e * p.C + m0] == 0) {   // slots fill from 0: the tile is empty
    if (PASS == 2 && !p.fused) zero_y_tile(p, e, m0, kBM, n0, out_cols);
    return;
  }
  const bf16* A = static_cast<const bf16*>(PASS == 1 ? p.x : p.mid) + (long long)e * p.C * K;
  const bf16* W1 = static_cast<const bf16*>(PASS == 1 ? p.w1 : p.w2) + (long long)e * N * K;
  const bf16* W3 = gated ? static_cast<const bf16*>(p.w3) + (long long)e * N * K : W1;
  const int ktiles = (K + kBK - 1) / kBK;

  auto issue = [&](int kt) {
    if (kt < ktiles) {
      bf16* As = smem + (kt % kStages) * kStageElems;
      bf16* Bs = As + kBM * kLd;
      const int k0 = kt * kBK;
      for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
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

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt has landed
    __syncthreads();                // for every thread; and tile kt - 1 is consumed
    issue(kt + kStages - 1);        // into the buffer of tile kt - 1
    const bf16* As = smem + (kt % kStages) * kStageElems;
    const bf16* Bs = As + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, As + (lane & 15) * kLd + kk + (lane >> 4) * 8);
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
      for (int j = 0; j < NT; ++j) mma16816(acc[j], a, b[j][0], b[j][1]);
    }
  }

  // c0, c1: row g, columns 2t, 2t + 1 of the n-tile; c2, c3: row g + 8
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + g + 8 * h;
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
            mid_value(gated, acc[j][2 * h], acc[j + du][2 * h]),
            mid_value(gated, acc[j][2 * h + 1], acc[j + du][2 * h + 1]));
        *reinterpret_cast<__nv_bfloat162*>(mrow + col) = v;   // N even: col + 1 < N
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + brow(j) + 2 * t4;
        if (col < N) out_pair(p, e, row, col, acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

template <int PASS, bool GATED>
cudaError_t launch_tc(const MoeFfnParams& p, cudaStream_t stream) {
  static bool raised = false;   // more than 48 KB of shared memory is opt-in, once a kernel
  if (!raised) {
    const cudaError_t rc = cudaFuncSetAttribute(
        moe_gemm_tc<PASS, GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (rc != cudaSuccess) return rc;
    raised = true;
  }
  constexpr int out_cols = GATED ? kBRows / 2 : kBRows;
  const int N = PASS == 1 ? p.F : p.H;
  const dim3 grid((N + out_cols - 1) / out_cols, (p.C + kBM - 1) / kBM, p.E);
  moe_gemm_tc<PASS, GATED><<<grid, kThreads, kTcSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int PASS>
cudaError_t launch_tc_act(const MoeFfnParams& p, cudaStream_t stream) {
  if constexpr (PASS == 1) {
    if (p.gated) return launch_tc<PASS, true>(p, stream);
  }
  return launch_tc<PASS, false>(p, stream);
}

// ---- bf16 wave form: wgmma fed by TMA ---------------------------------------------

// A block owns one expert and kWaveBRows weight rows: 128 output columns,
// or 64 columns of w1 and the same 64 of w3 when gated. For each chunk of
// up to kWaveChunk filled slot rows it streams its weight rows' whole K
// once, so at a prefill wave (dropless, ~k T / E filled slots an expert)
// each weight byte leaves HBM once a pass.
constexpr int kWaveK = 64;                              // K a stage: one 128-byte swizzled region
constexpr int kWaveRowTiles = 4;                        // 64-row tiles of slots a chunk
constexpr int kWaveChunk = 64 * kWaveRowTiles;          // slot rows under one weight stream
constexpr int kWaveBRows = 128;                         // weight rows a block, 64 a consumer
constexpr int kWaveStages = 4;
constexpr int kWaveConsumers = 2;
constexpr int kWaveThreads = 128 * (kWaveConsumers + 1);   // and a producer warpgroup
constexpr int kWaveATile = 64 * kWaveK * 2;             // one 64-row tile of A, 8 KB
constexpr int kWaveABytes = kWaveRowTiles * kWaveATile;
constexpr int kWaveBBytes = kWaveBRows * kWaveK * 2;
constexpr int kWaveStage = kWaveABytes + kWaveBBytes;   // 48 KB
constexpr int kWaveSmem = 1024 + kWaveStages * kWaveStage + 2 * kWaveStages * 8;
constexpr int kWaveProducerRegs = 40, kWaveConsumerRegs = 232;
static_assert(128 * (kWaveConsumers * kWaveConsumerRegs + kWaveProducerRegs) <= 65536,
              "register file");

// One chunk of NRT row tiles of the slots, on consumer warpgroup `wg`: its
// 64 of the block's weight rows against every row tile, over all of K,
// then the epilogue. Returns the ring position after the chunk. Row tile r
// of the chunk is slot rows row0 + 64 r ..; accumulator element 4i + 2h + c
// of acc[r] is slot row row0 + 64 r + 16 warp + g + 8h, B row 8i + 2q + c
// of the warpgroup's 64.
template <int NRT, int PASS, bool GATED>
__device__ __forceinline__ int wave_chunk(const MoeFfnParams& p, const char* sbase,
                                          uint64_t* full, uint64_t* empty, int it, int ktiles,
                                          int e, int n0, int row0, int wg) {
  using namespace hopper;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  float acc[NRT][32];
#pragma unroll
  for (int r = 0; r < NRT; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[r][i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt, ++it) {
    const int s = it % kWaveStages;
    bar_wait(&full[s], (it / kWaveStages) & 1);
    const char* st = sbase + s * kWaveStage;
    wg_fence();
#pragma unroll
    for (int j = 0; j < kWaveK / 16; ++j) {
      const uint64_t db = desc_k<128>(st + kWaveABytes, kWaveBRows, 64 * wg, j);
#pragma unroll
      for (int r = 0; r < NRT; ++r) mma_ss<64>(acc[r], desc_k<128>(st, kWaveChunk, 64 * r, j), db);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int r = 0; r < NRT; ++r) hold(acc[r]);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }

  const int N = PASS == 1 ? p.F : p.H;
#pragma unroll
  for (int r = 0; r < NRT; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 64 * r + 16 * warp + g + 8 * h;
      if (row >= p.C) continue;   // the rows past the expert's slots belong to the next one
      if constexpr (PASS == 1 && GATED) {
        // B rows 0..31 are w1's, 32..63 w3's, of the same 32 output columns
        bf16* mrow = static_cast<bf16*>(p.mid) + ((long long)e * p.C + row) * p.F;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + 32 * wg + 8 * i + 2 * q;
          if (col >= N) continue;   // N even: col + 1 < N
          *reinterpret_cast<__nv_bfloat162*>(mrow + col) = __floats2bfloat162_rn(
              mid_value(true, acc[r][4 * i + 2 * h], acc[r][4 * (i + 4) + 2 * h]),
              mid_value(true, acc[r][4 * i + 2 * h + 1], acc[r][4 * (i + 4) + 2 * h + 1]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = n0 + 64 * wg + 8 * i + 2 * q;
          if (col >= N) continue;
          if constexpr (PASS == 1) {
            bf16* mrow = static_cast<bf16*>(p.mid) + ((long long)e * p.C + row) * p.F;
            *reinterpret_cast<__nv_bfloat162*>(mrow + col) =
                __floats2bfloat162_rn(mid_value(false, acc[r][4 * i + 2 * h], 0.f),
                                      mid_value(false, acc[r][4 * i + 2 * h + 1], 0.f));
          } else {
            out_pair(p, e, row, col, acc[r][4 * i + 2 * h], acc[r][4 * i + 2 * h + 1]);
          }
        }
      }
    }
  return it;
}

// PASS 1: A = x [E * C, H] rows of slots, B = w1 (and w3) [E * F, H] rows ->
// mid. PASS 2: A = mid [E * C, F], B = w2 [E * H, F] -> y or out. The block
// is (column tile, expert). It first finds one past the expert's last
// filled slot in src (slots fill from 0, so every slot below it is filled)
// and walks the row tiles below it: every filled tile, and no empty one.
// Staged B rows: gated, w1 rows n0 .. n0 + 31, w3's same rows, w1 n0 + 32 .. + 63,
// w3's same, so consumer warpgroup c's 64 rows (64 c ..) are w1 and w3 of
// the 32 columns n0 + 32 c ..; otherwise rows n0 .. n0 + 127 in order.
template <int PASS, bool GATED>
__global__ void __launch_bounds__(kWaveThreads, 1)
moe_wave(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb1,
         const __grid_constant__ CUtensorMap mb3, const MoeFfnParams p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  char* sbase = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sbase + kWaveStages * kWaveStage);
  uint64_t* empty = full + kWaveStages;
  constexpr int out_cols = GATED ? kWaveBRows / 2 : kWaveBRows;
  const int e = blockIdx.y, n0 = blockIdx.x * out_cols;
  const int K = PASS == 1 ? p.H : p.F, N = PASS == 1 ? p.F : p.H;
  const int ktiles = (K + kWaveK - 1) / kWaveK;

  __shared__ int warp_rows[kWaveThreads / 32];
  int rows = 0;   // one past the last filled slot of the expert that the thread reads
  for (int r = threadIdx.x; r < p.C; r += kWaveThreads)
    if (p.src[(long long)e * p.C + r] > 0) rows = r + 1;
  rows = __reduce_max_sync(0xffffffffu, rows);
  if (threadIdx.x % 32 == 0) warp_rows[threadIdx.x / 32] = rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWaveStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * kWaveConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();
  for (int w = 0; w < kWaveThreads / 32; ++w) rows = max(rows, warp_rows[w]);
  const int tiles = (rows + 63) / 64;   // row tiles holding the expert's filled slots
  const int chunks = (tiles + kWaveRowTiles - 1) / kWaveRowTiles;

  const int wg = threadIdx.x / 128;
  if (wg == kWaveConsumers) {
    regs_dec<kWaveProducerRegs>();
    const int pt = threadIdx.x - 128 * kWaveConsumers;
    if (pt == 0) {   // one thread issues every copy
      int it = 0;
      for (int ch = 0; ch < chunks; ++ch) {
        const int nrt = min(kWaveRowTiles, tiles - kWaveRowTiles * ch);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kWaveStages, n = it / kWaveStages;
          if (n > 0) bar_wait(&empty[s], (n - 1) & 1);
          char* st = sbase + s * kWaveStage;
          bar_expect(&full[s], nrt * kWaveATile + kWaveBBytes);
          const int k0 = kt * kWaveK;
          for (int r = 0; r < nrt; ++r)
            tma_load2(st + r * kWaveATile, &ma, &full[s], k0, e * p.C + kWaveChunk * ch + 64 * r);
          for (int j = 0; j < kWaveBRows / 32; ++j) {
            const CUtensorMap* mb = GATED && (j & 1) ? &mb3 : &mb1;
            const int row = n0 + (GATED ? 32 * (j >> 1) : 32 * j);
            tma_load2(st + kWaveABytes + j * 32 * 128, mb, &full[s], k0, e * N + row);
          }
        }
      }
    } else if (PASS == 2 && !p.fused && pt >= 32) {
      // the split form's rows past the walked tiles are empty slots: zeros,
      // written by the producer's other warps beside the products
      const int r0 = min(p.C, 64 * tiles), quads = min(out_cols, N - n0) / 4;
      for (int i = pt - 32; i < (p.C - r0) * quads; i += 128 - 32) {
        const int row = r0 + i / quads, col = n0 + 4 * (i % quads);
        *reinterpret_cast<float4*>(p.y + ((long long)e * p.C + row) * p.H + col) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  regs_inc<kWaveConsumerRegs>();
  int it = 0;
  for (int ch = 0; ch < chunks; ++ch) {
    const int nrt = min(kWaveRowTiles, tiles - kWaveRowTiles * ch);
    const int row0 = kWaveChunk * ch;
    // each count of row tiles its own straight-line products (no product
    // issued in one branch and waited for in another)
    switch (nrt) {
      case 4: it = wave_chunk<4, PASS, GATED>(p, sbase, full, empty, it, ktiles, e, n0, row0, wg); break;
      case 3: it = wave_chunk<3, PASS, GATED>(p, sbase, full, empty, it, ktiles, e, n0, row0, wg); break;
      case 2: it = wave_chunk<2, PASS, GATED>(p, sbase, full, empty, it, ktiles, e, n0, row0, wg); break;
      default: it = wave_chunk<1, PASS, GATED>(p, sbase, full, empty, it, ktiles, e, n0, row0, wg);
    }
  }
}

template <int PASS, bool GATED>
cudaError_t launch_wave(const MoeFfnParams& p, cudaStream_t stream) {
  const int K = PASS == 1 ? p.H : p.F, N = PASS == 1 ? p.F : p.H;
  const void* A = PASS == 1 ? p.x : p.mid;
  const void* B1 = PASS == 1 ? p.w1 : p.w2;
  const void* B3 = GATED ? p.w3 : B1;
  CUtensorMap ma, mb1, mb3;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hopper::map_2d(&ma, A, bf, 2, (long long)p.E * p.C, K, K, kWaveK, 64, sw) ||
      !hopper::map_2d(&mb1, B1, bf, 2, (long long)p.E * N, K, K, kWaveK, 32, sw) ||
      !hopper::map_2d(&mb3, B3, bf, 2, (long long)p.E * N, K, K, kWaveK, 32, sw))
    return cudaErrorInvalidValue;
  static bool raised = false;   // more than 48 KB of shared memory is opt-in, once a kernel
  if (!raised) {
    const cudaError_t rc = cudaFuncSetAttribute(
        moe_wave<PASS, GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWaveSmem);
    if (rc != cudaSuccess) return rc;
    raised = true;
  }
  constexpr int out_cols = GATED ? kWaveBRows / 2 : kWaveBRows;
  const dim3 grid((N + out_cols - 1) / out_cols, p.E);
  moe_wave<PASS, GATED><<<grid, kWaveThreads, kWaveSmem, stream>>>(ma, mb1, mb3, p);
  return cudaGetLastError();
}

template <int PASS>
cudaError_t launch_wave_act(const MoeFfnParams& p, cudaStream_t stream) {
  if constexpr (PASS == 1) {
    if (p.gated) return launch_wave<PASS, true>(p, stream);
  }
  return launch_wave<PASS, false>(p, stream);
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
  return p.C <= kBM ? launch_tc_act<PASS>(p, stream) : launch_wave_act<PASS>(p, stream);
}

}  // namespace

// The grouped FFN with its epilogue; returns the cudaError_t. The caller has
// checked the shapes (bf16: H % 8 == 0 and F % 8 == 0, x and the weights
// 16-byte aligned), allocated mid and y (split) and zeroed out (fused).
extern "C" int dstt_moe_ffn(MoeFfnParams p, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (p.E == 0 || p.C == 0 || p.H == 0) return cudaSuccess;
  cudaError_t rc = launch_pass<1>(p, stream);
  if (rc != cudaSuccess) return rc;
  return launch_pass<2>(p, stream);
}
