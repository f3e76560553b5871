// Weight-only-quantized matmul for decode-shaped activations:
//
//   out[M, N] = sum_g (x[:, g*gs:(g+1)*gs] @ q[g]) * scale[g]
//
// x [M, K] bf16 or fp32, q [G, gs, N] int8 (N contiguous), scale [G, N] fp32,
// K = G * gs, out in x's dtype.
//
// Replaces the TPU kernel _woq_kernel in
// deepspeed_tpu/ops/quantizer/pallas_woq_matmul.py (reached through
// woq_matmul -> pl.pallas_call). Same function: the int8 weights are read at
// one byte each and converted in registers, each group's partial product is
// accumulated in fp32 and multiplied by the group's scale (the partial
// product is scaled, never the weights), the group sums are added in fp32
// and cast once at the end. No dense copy of the weights exists anywhere.
//
// Bound on an H100 SXM: bytes. With at most 64 rows of x the K * N weight
// bytes dominate (2 * M operations a byte), so both kernels here are built
// around reading q once, in order, in full 128-byte lines, and around what
// the Pallas kernel could lean on and a GPU cannot: a sequential group axis
// with its accumulator in VMEM. Blocks run in no order, and N / 128 column
// tiles alone do not fill 132 SMs, so K is split across blocks: each writes
// an fp32 partial [split, M, N], and a second small kernel adds the splits
// in index order and casts. No atomics: two runs give the same bits. With
// one split the block casts and writes the output itself.
//
// woq_mma_kernel (bf16 x, up to 64 rows, gs and N multiples of 16): the
// tensor cores. On the CUDA cores every weight costs M fused multiply-adds,
// which at 8 rows already take as long as the memory stream; mma.sync
// m16n8k16 takes the rows for free.
// - A block owns 256 columns and a range of groups. Tiles of 64 rows of q
//   (16 KB, 256 contiguous bytes a row: wider rows measured faster than 128)
//   and the matching 64 columns of x go to shared memory with cp.async, 4
//   stages deep, so ~48 KB of weights are in flight a block whatever the
//   threads are doing.
// - A warp owns a slab of 32 of the columns over all of the block's rows, so
//   no sum crosses warps. x is the A operand (rows padded with zeros to 16),
//   q the B operand: thread (g, t) of a warp reads four 32-bit words of q
//   (rows 2t, 2t+1, 2t+8, 2t+9 of a 16-row step, columns 4g..4g+3 of the
//   slab) and byte j of each feeds n-tile j, so n-tile j holds the slab's
//   columns 4n + j and one word load serves four mma. Rows are padded by 16
//   bytes in shared memory, which spreads both operands' loads over all
//   banks.
// - int8 -> bf16 without the conversion unit: the byte, biased by 128, is
//   placed in the mantissa of 2^23 (prmt) and 2^23 + 128 subtracted, two
//   such floats packed into a bf16 pair; exact.
// - A warp scales its partial accumulator at the end of every group.
//
// woq_matmul_kernel (fp32 x, and the shapes the other does not take): the
// CUDA cores, fp32 FMA on exact int8 -> fp32 conversions. A block owns 128
// columns, a range of groups and a tile of MT <= 8 rows of x; its 8 warps
// split the rows of each group between them, a lane owns 4 neighbouring
// columns (one 32-bit load a row, 8 rows in flight), x sits in shared memory
// as fp32 transposed to [row][m] for broadcast 128-bit loads, and row tiles
// are the fastest grid axis so blocks sharing a tile of q find it in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Everything a launch reads, passed by value.
struct WoqParams {
  const void* x;        // [M, K]
  const int8_t* q;      // [G, gs, N]
  const float* scale;   // [G, N]
  void* out;            // [M, N], x's dtype
  float* partial;       // [splits, M, N], or null when splits == 1
  int M, K, N, G, gs;
  int groups_per_split, splits;
  int bf16;             // x and out are bf16 (else fp32)
  int mma;              // the tensor-core kernel (the wrapper checked its conditions)
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;      // output columns a block: 4 a lane
constexpr int kRowChunk = 128;  // rows of x staged at a time
constexpr int kUnroll = 8;      // rows of q in flight a thread

__device__ __forceinline__ void store_out(const WoqParams& a, long long i, float v) {
  if (a.bf16) {
    static_cast<__nv_bfloat16*>(a.out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(a.out)[i] = v;
  }
}

// One staged row of x, MT values: every lane of a warp reads the same
// address, so a 128-bit load is one broadcast.
template <int MT>
__device__ __forceinline__ void load_row(const float* row, float (&xv)[MT]) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MT / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(row)[i];
      xv[4 * i] = t.x, xv[4 * i + 1] = t.y, xv[4 * i + 2] = t.z, xv[4 * i + 3] = t.w;
    }
  } else if constexpr (MT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row);
    xv[0] = t.x, xv[1] = t.y;
  } else {
    xv[0] = row[0];
  }
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 2) woq_matmul_kernel(const WoqParams a) {
  __shared__ __align__(16) float xs[kRowChunk * MT];          // [row][m]
  __shared__ __align__(16) float red[kWarps][MT][kCols];
  const int m0 = blockIdx.x * MT;
  const int col0 = blockIdx.y * kCols;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = col0 + lane * 4;
  const bool col_ok = n < a.N;   // N % 4 == 0: the lane's 4 columns are in or out together
  const int g0 = split * a.groups_per_split;
  const int g1 = min(a.G, g0 + a.groups_per_split);

  float total[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) total[m][c] = 0.f;

  for (int g = g0; g < g1; ++g) {
    float part[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[m][c] = 0.f;

    for (int r0 = 0; r0 < a.gs; r0 += kRowChunk) {
      const int rows = min(kRowChunk, a.gs - r0);
      __syncthreads();   // the previous chunk of x has been consumed
      for (int i = tid; i < rows * MT; i += kThreads) {
        const int m = i % MT, r = i / MT, mm = m0 + m;
        float v = 0.f;
        if (mm < a.M) {
          const long long at = (long long)mm * a.K + (long long)g * a.gs + r0 + r;
          v = a.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[at])
                     : static_cast<const float*>(a.x)[at];
        }
        xs[i] = v;
      }
      __syncthreads();
      if (col_ok) {
        const int8_t* qrow = a.q + ((long long)g * a.gs + r0) * a.N + n;
        for (int r = warp; r < rows; r += kWarps * kUnroll) {
          int w[kUnroll];
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const int rr = r + j * kWarps;
            w[j] = rr < rows ? *reinterpret_cast<const int*>(qrow + (long long)rr * a.N) : 0;
          }
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            const int rr = r + j * kWarps;
            if (rr < rows) {
              float wf[4];
#pragma unroll
              for (int c = 0; c < 4; ++c)
                wf[c] = static_cast<float>(static_cast<signed char>(w[j] >> (8 * c)));
              float xv[MT];
              load_row<MT>(xs + rr * MT, xv);
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int c = 0; c < 4; ++c) part[m][c] = fmaf(xv[m], wf[c], part[m][c]);
            }
          }
        }
      }
    }
    if (col_ok) {
      const float4 s = *reinterpret_cast<const float4*>(a.scale + (long long)g * a.N + n);
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) total[m][c] = fmaf(part[m][c], sv[c], total[m][c]);
    }
  }

  // the 8 warps' sums, added in warp order
#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][lane * 4]) =
        make_float4(total[m][0], total[m][1], total[m][2], total[m][3]);
  __syncthreads();
  for (int i = tid; i < MT * kCols; i += kThreads) {
    const int m = i / kCols, c = i % kCols;
    const int mm = m0 + m, nn = col0 + c;
    if (mm >= a.M || nn >= a.N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][m][c];
    if (a.splits == 1) {
      store_out(a, (long long)mm * a.N + nn, sum);
    } else {
      a.partial[((long long)split * a.M + mm) * a.N + nn] = sum;
    }
  }
}

// ---- the tensor-core kernel ---------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kTileRows = 64;           // rows of q a stage
constexpr int kStages = 4;
constexpr int kMmaCols = 32 * kWarps;   // output columns a block: a 32-column slab a warp
constexpr int kChunks = kMmaCols / 16;  // 16-byte copies a staged row of q
constexpr int kQLd = kMmaCols + 16;     // bytes between staged rows of q
constexpr int kXLd = kTileRows + 8;     // bf16 between staged rows of x
constexpr int kQBytes = kTileRows * kQLd;

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

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte j of w (an int8 biased by 128) as a float, exactly.
template <int j>
__device__ __forceinline__ float biased_byte(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}
// Byte j of lo and of hi as a bf16 pair, lo in the low half.
template <int j>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(biased_byte<j>(lo), biased_byte<j>(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int MT>   // 16-row tiles of x
__global__ void __launch_bounds__(kThreads, MT <= 2 ? 2 : 1) woq_mma_kernel(const WoqParams a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kXBytes = 16 * MT * kXLd * 2;
  constexpr int kStage = kQBytes + kXBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.y * kMmaCols;
  const int split = blockIdx.z;
  const int g0 = split * a.groups_per_split;
  const int g1 = min(a.G, g0 + a.groups_per_split);
  const int tiles_per_group = (a.gs + kTileRows - 1) / kTileRows;
  const int tiles = (g1 - g0) * tiles_per_group;
  const bf16* x = static_cast<const bf16*>(a.x);

  // tile u of this block: its group, first row in the group, rows (16 | rows)
  auto tile_at = [&](int u, int& grp, int& r0, int& rows) {
    grp = g0 + u / tiles_per_group;
    r0 = (u % tiles_per_group) * kTileRows;
    rows = min(kTileRows, a.gs - r0);
  };
  auto issue = [&](int u) {
    if (u < tiles) {
      int grp, r0, rows;
      tile_at(u, grp, r0, rows);
      unsigned char* qs = smem + (u % kStages) * kStage;
      bf16* xs = reinterpret_cast<bf16*>(qs + kQBytes);
      const long long k0 = (long long)grp * a.gs + r0;
      for (int i = tid; i < rows * kChunks; i += kThreads) {
        const int r = i / kChunks, c = (i % kChunks) * 16;
        const bool ok = col0 + c < a.N;   // 16 | N: a chunk is in or out as a whole
        cp_async16(qs + r * kQLd + c, ok ? a.q + (k0 + r) * a.N + col0 + c : a.q, ok);
      }
      for (int i = tid; i < 16 * MT * (rows >> 3); i += kThreads) {
        const int m = i / (rows >> 3), c = (i % (rows >> 3)) * 8;
        const bool ok = m < a.M;          // rows of x past M read as zeros
        cp_async16(xs + m * kXLd + c, ok ? x + (long long)m * a.K + k0 + c : x, ok);
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count uniform
  };

  float total[MT][4][4], part[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[i][j][e] = part[i][j][e] = 0.f;

  for (int u = 0; u < kStages - 1; ++u) issue(u);
  for (int u = 0; u < tiles; ++u) {
    cp_async_wait<kStages - 2>();   // tile u has landed
    __syncthreads();                // for every thread; and tile u - 1 is consumed
    issue(u + kStages - 1);         // into the buffer of tile u - 1
    int grp, r0, rows;
    tile_at(u, grp, r0, rows);
    const unsigned char* qs = smem + (u % kStages) * kStage;
    const bf16* xs = reinterpret_cast<const bf16*>(qs + kQBytes);
    for (int kk = 0; kk < rows; kk += 16) {
      const unsigned char* qp = qs + (kk + 2 * t) * kQLd + warp * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qp) ^ 0x80808080u;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qp + kQLd) ^ 0x80808080u;
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(qp + 8 * kQLd) ^ 0x80808080u;
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(qp + 9 * kQLd) ^ 0x80808080u;
      const uint32_t b0[4] = {bf16_pair<0>(w0, w1), bf16_pair<1>(w0, w1), bf16_pair<2>(w0, w1),
                              bf16_pair<3>(w0, w1)};
      const uint32_t b1[4] = {bf16_pair<0>(w2, w3), bf16_pair<1>(w2, w3), bf16_pair<2>(w2, w3),
                              bf16_pair<3>(w2, w3)};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16* xa = xs + (i * 16 + g) * kXLd + kk + 2 * t;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xa);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(xa + 8 * kXLd);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xa + 8);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(xa + 8 * kXLd + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma16816(part[i][j], a0, a1, a2, a3, b0[j], b1[j]);
      }
    }
    if (r0 + rows == a.gs) {   // the group is complete: scale its partial product
      // n-tile j holds columns 4n + j of the slab: c0/c2 are column 8t + j, c1/c3 8t + 4 + j
      const int cb = col0 + warp * 32 + 8 * t;
      float lo[4] = {0.f, 0.f, 0.f, 0.f}, hi[4] = {0.f, 0.f, 0.f, 0.f};
      if (cb < a.N) {
        const float4* sp = reinterpret_cast<const float4*>(a.scale + (long long)grp * a.N + cb);
        const float4 s0 = sp[0], s1 = sp[1];
        lo[0] = s0.x, lo[1] = s0.y, lo[2] = s0.z, lo[3] = s0.w;
        hi[0] = s1.x, hi[1] = s1.y, hi[2] = s1.z, hi[3] = s1.w;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          total[i][j][0] = fmaf(part[i][j][0], lo[j], total[i][j][0]);
          total[i][j][1] = fmaf(part[i][j][1], hi[j], total[i][j][1]);
          total[i][j][2] = fmaf(part[i][j][2], lo[j], total[i][j][2]);
          total[i][j][3] = fmaf(part[i][j][3], hi[j], total[i][j][3]);
          part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
        }
    }
  }

  const int cb = col0 + warp * 32 + 8 * t;
  if (cb >= a.N) return;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // rows g and g + 8 of the tile
      const int m = i * 16 + g + 8 * h;
      if (m >= a.M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = total[i][j][2 * h], v[4 + j] = total[i][j][2 * h + 1];
      if (a.splits == 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) store_out(a, (long long)m * a.N + cb + e, v[e]);
      } else {
        float4* dst =
            reinterpret_cast<float4*>(a.partial + ((long long)split * a.M + m) * a.N + cb);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
}

template <int MT>
cudaError_t launch_mma(const WoqParams& a, cudaStream_t stream) {
  constexpr int bytes = kStages * (kQBytes + 16 * MT * kXLd * 2);
  static bool raised = false;   // more than 48 KB of shared memory is opt-in, once a kernel
  if (!raised) {
    const cudaError_t rc = cudaFuncSetAttribute(
        woq_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return rc;
    raised = true;
  }
  const dim3 grid(1, (a.N + kMmaCols - 1) / kMmaCols, a.splits);
  woq_mma_kernel<MT><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// out = sum over the splits of partial, in split order, cast once.
__global__ void __launch_bounds__(256) woq_reduce_kernel(const WoqParams a) {
  const long long mn = (long long)a.M * a.N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn; i += stride) {
    float sum = 0.f;
    for (int s = 0; s < a.splits; ++s) sum += a.partial[(long long)s * mn + i];
    store_out(a, i, sum);
  }
}

template <int MT>
cudaError_t launch(const WoqParams& a, cudaStream_t stream) {
  const dim3 grid((a.M + MT - 1) / MT, (a.N + kCols - 1) / kCols, a.splits);
  woq_matmul_kernel<MT><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out = woq(x, q, scale); returns the cudaError_t. The caller has checked
// the shapes (K == G * gs, N % 4 == 0, splits * groups_per_split >= G; with
// mma: bf16, M <= 64, gs % 16 == 0, N % 16 == 0) and allocated partial when
// splits > 1.
extern "C" int dstt_woq_matmul(WoqParams a, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (a.M == 0 || a.N == 0) return cudaSuccess;
  cudaError_t rc;
  if (a.mma) {
    rc = a.M <= 16 ? launch_mma<1>(a, stream)
                   : (a.M <= 32 ? launch_mma<2>(a, stream) : launch_mma<4>(a, stream));
  } else if (a.M > 4) {
    rc = launch<8>(a, stream);
  } else if (a.M > 2) {
    rc = launch<4>(a, stream);
  } else if (a.M == 2) {
    rc = launch<2>(a, stream);
  } else {
    rc = launch<1>(a, stream);
  }
  if (rc != cudaSuccess || a.splits == 1) return rc;
  const long long mn = (long long)a.M * a.N;
  long long blocks = (mn + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  woq_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}
