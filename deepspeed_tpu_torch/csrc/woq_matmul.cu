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
// with its accumulator in VMEM. Blocks run in no order, and the column
// tiles alone do not fill 132 SMs, so K is split across blocks, each
// writing an fp32 partial [split, M, N]. No float atomics: two runs give
// the same bits. With one split the block casts and writes the output
// itself.
//
// woq_tc_kernel (bf16 x, up to 64 rows, gs and N multiples of 16): the
// tensor cores, fed by TMA. On the CUDA cores every weight costs M fused
// multiply-adds, which at 8 rows already take as long as the memory
// stream.
// - A block owns 256 weight columns, two slabs of 128, and is one SM's
//   worth (1 block an SM, by shared memory): a consumer warpgroup a slab
//   and a producer warp. One thread of the producer
//   issues TMA copies of 128 rows of q (two 16 KB boxes of the [K, N] int8
//   view) and the matching 128 columns of x (the rows of x padded to NP =
//   8, 16, 32 or 64 by TMA's zero fill) into a ring of 128-byte-swizzled
//   stages (kTcMaxStages), with full and empty mbarriers: the weight
//   stream waits on no thread's address arithmetic and on no block-wide
//   barrier.
// - Swap-AB: the weight columns are the products' M and the rows of x their
//   N, so 8 rows of x cost an 8-wide product, not a 16-row tile padded
//   with zeros. A thread reads 32-bit words of q from the swizzled tile
//   without bank conflicts; byte 2j + h of a word is row g + 8h of the
//   warp's 16 rows of 64-row tile j, so one word load feeds both of the
//   warpgroup's tiles (the column permutation is undone in the epilogue).
// - int8 -> bf16 without the conversion unit: the byte, biased by 128, is
//   placed in the mantissa of 2^23 (prmt) and 2^23 + 128 subtracted, two
//   such floats packed into a bf16 pair; exact.
// - The products are wgmma m64nNPk16 with A from registers and x^T from
//   the swizzled tile. The block's scales come first, in one TMA
//   copy into shared memory (a load from HBM under the weight stream takes
//   longer than a group's products), and a group's partial product is
//   scaled when the group ends.
// - Split-K is reduced in the same launch: each block writes its partial,
//   and the last block of a column tile to finish (a counter a column
//   tile, which it resets) adds the splits in split order and casts. No
//   second launch, and the same bits whichever block is last.
//
// woq_matmul_kernel (fp32 x, and the shapes the other does not take): the
// CUDA cores, fp32 FMA on exact int8 -> fp32 conversions. A block owns 128
// columns, a range of groups and a tile of MT <= 8 rows of x; its 8 warps
// split the rows of each group between them, a lane owns 4 neighbouring
// columns (one 32-bit load a row, 8 rows in flight), x sits in shared memory
// as fp32 transposed to [row][m] for broadcast 128-bit loads, and row tiles
// are the fastest grid axis so blocks sharing a tile of q find it in L2.
// Its splits are added by a second small kernel (woq_reduce_kernel).
#include "hopper.cuh"

// Everything a launch reads, passed by value.
struct WoqParams {
  const void* x;        // [M, K]
  const int8_t* q;      // [G, gs, N]
  const float* scale;   // [G, N]
  void* out;            // [M, N], x's dtype
  float* partial;       // [splits, M, N], or null when splits == 1
  int* counters;        // tensor cores, splits > 1: a zeroed counter a column tile
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

constexpr int kTcCols = 256;                        // output columns a block: two slabs of 128
constexpr int kTcRows = 128;                        // rows of q (of K) a stage
constexpr int kQRegion = kTcRows * 128;             // a 128-column slab of a q stage
constexpr int kSmemMax = 232448;                    // shared memory a block may use
constexpr int kTcMaxStages = 3;                     // a sweep point (kernel_ab.py)
constexpr int kTcMaxGroups = 64;                    // groups a split (woq_matmul.py)

constexpr int kTcThreads = 128 * 2 + 32;            // a consumer warpgroup a slab, a producer warp

// NP: rows of x padded to the products' N (8, 16, 32 or 64). Shared memory:
// the block's scales [groups a split, kTcCols] fp32, then the ring of
// stages, then the barriers.
template <int NP>
struct TcShape {
  static constexpr int kXBytes = NP * 256;          // two 64-column regions of NP rows
  static constexpr int kStage = 2 * kQRegion + kXBytes;
  __host__ __device__ static constexpr int scale_bytes(int per) {
    return (per * kTcCols * 4 + 1023) & ~1023;
  }
  __host__ __device__ static constexpr int stages(int per) {
    return (kSmemMax - 1024 - 256 - scale_bytes(per)) / kStage > kTcMaxStages
               ? kTcMaxStages
               : (kSmemMax - 1024 - 256 - scale_bytes(per)) / kStage;
  }
  __host__ __device__ static constexpr int smem(int per) {
    return 1024 + scale_bytes(per) + stages(per) * kStage + (2 * stages(per) + 1) * 8 + 16;
  }
};
static_assert(TcShape<64>::stages(kTcMaxGroups) >= 2, "a ring of two stages at the most groups");

// Byte j of w (an int8 biased by 128) as a float, exactly.
template <int j>
__device__ __forceinline__ float biased_byte(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}
// Byte j of lo and of hi as a bf16 pair, lo in the low half: the floats are
// integers of at most 8 significant bits, so their top halves are exact
// bf16 values and a byte permute packs them.
template <int j>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
  return __byte_perm(__float_as_uint(biased_byte<j>(lo)), __float_as_uint(biased_byte<j>(hi)),
                     0x7632);
}

// The 32-bit word at byte `c` (a multiple of 4) of row r of a 128-byte
// swizzled region.
__device__ __forceinline__ uint32_t ld_swz(const char* region, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(region + hopper::swizzled<128>(r, c >> 4) + (c & 15));
}

// part += the 16-row step kk of a stage: A from the converted weights (a[j]
// for the two 64-row tiles of the warpgroup), B = x^T from the stage's x
// tile (rows of x as N, K-major). Issued here, completed by tc_finish.
template <int NP>
__device__ __forceinline__ void tc_issue(float (&part)[2][NP / 2], uint32_t (&a)[2][4],
                                         const char* xs, int kk) {
  using namespace hopper;
  const uint64_t db = desc_k<128>(xs, NP, 0, kk);
  wg_fence();
  mma_rs<NP>(part[0], a[0], db);
  mma_rs<NP>(part[1], a[1], db);
  wg_commit();
}
template <int NP>
__device__ __forceinline__ void tc_finish(float (&part)[2][NP / 2], uint32_t (&a)[2][4]) {
  using namespace hopper;
  wg_wait<0>();
  hold(part[0]);
  hold(part[1]);
  hold(a);
}

// The weight columns are wgmma's M and the rows of x its N (swap-AB):
// out^T = q^T x^T. A block owns kTcCols columns and the groups [g0, g1) of
// one split. Warp w of a consumer warpgroup of slab c owns the 32 columns
// 128 c + 32 w .. + 31; its thread (g, t) reads 32-bit words of q (four
// neighbouring columns 4g .. 4g + 3) at rows 2t, 2t + 1, 2t + 8, 2t + 9 of a
// 16-row step, and byte 2j + h of each word is row g + 8h of the warp's 16
// rows of 64-row tile j. So one word load feeds both tiles, and the
// thread's accumulator rows are its own four columns.
template <int NP>
__global__ void __launch_bounds__(kTcThreads, 1)
woq_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mx,
              const __grid_constant__ CUtensorMap ms, const WoqParams a) {
  using namespace hopper;
  using Sh = TcShape<NP>;
  const int ST = Sh::stages(a.groups_per_split);
  extern __shared__ unsigned char smem_raw[];
  const float* scales = reinterpret_cast<const float*>(align1024(smem_raw));
  char* sbase = align1024(smem_raw) + Sh::scale_bytes(a.groups_per_split);
  uint64_t* full = reinterpret_cast<uint64_t*>(sbase + ST * Sh::kStage);
  uint64_t* empty = full + ST;
  uint64_t* bar_scales = empty + ST;
  int* last = reinterpret_cast<int*>(bar_scales + 1);

  const int col0 = blockIdx.x * kTcCols;
  const int split = blockIdx.y;
  const int g0 = split * a.groups_per_split;
  const int g1 = min(a.G, g0 + a.groups_per_split);
  const int k_begin = g0 * a.gs, k_end = g1 * a.gs;
  const int tiles = (k_end - k_begin + kTcRows - 1) / kTcRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);   // the consumers' warps
    }
    bar_init(bar_scales, 1);
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;   // consumers: wg is the slab
  const int warp = (threadIdx.x / 32) % 4, g = lane / 4, t = lane % 4;
  const int cb = col0 + 128 * wg + 32 * warp + 4 * g;   // the thread's four columns
  float total[2][NP / 2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) total[j][i] = 0.f;

  if (wg == 2) {   // producer warp: one thread issues every copy
    if (lane == 0) {
      // the block's scales first: they are needed at the end of its first group
      bar_expect(bar_scales, a.groups_per_split * kTcCols * 4);
      tma_load2(const_cast<float*>(scales), &ms, bar_scales, col0, g0);
      for (int u = 0; u < tiles; ++u) {
        const int s = u % ST, n = u / ST;
        if (n > 0) bar_wait(&empty[s], (n - 1) & 1);
        char* st = sbase + s * Sh::kStage;
        bar_expect(&full[s], Sh::kStage);
        const int k0 = k_begin + u * kTcRows;
        for (int c = 0; c < 2; ++c) tma_load2(st + c * kQRegion, &mq, &full[s], col0 + 128 * c, k0);
        for (int h = 0; h < 2; ++h)
          tma_load2(st + 2 * kQRegion + h * NP * 128, &mx, &full[s], k0 + 64 * h, 0);
      }
    }
    __syncwarp();
  } else {
    float part[2][NP / 2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) part[j][i] = 0.f;
    const int group_steps = a.gs / 16;
    int step = 0;     // 16-row steps done of the group under way (blocks start on a group)
    int grp = 0;      // the group under way, from the block's first
    bar_wait(bar_scales, 0);
    for (int u = 0; u < tiles; ++u) {
      const int s = u % ST;
      bar_wait(&full[s], (u / ST) & 1);
      const char* st = sbase + s * Sh::kStage;
      const char* qs = st + wg * kQRegion;
      const char* xs = st + 2 * kQRegion;
      const int k0 = k_begin + u * kTcRows;
      const int steps = min(kTcRows, k_end - k0) / 16;
      // the four words of q of a step: rows 2t, 2t + 1, 2t + 8, 2t + 9 of
      // its 16, the thread's four columns, unbiased by 128
      uint32_t w[4];
      auto words = [&](int kk) {
        const int r = 16 * kk + 2 * t, c = 32 * warp + 4 * g;
        w[0] = ld_swz(qs, r, c) ^ 0x80808080u;
        w[1] = ld_swz(qs, r + 1, c) ^ 0x80808080u;
        w[2] = ld_swz(qs, r + 8, c) ^ 0x80808080u;
        w[3] = ld_swz(qs, r + 9, c) ^ 0x80808080u;
      };
      words(0);
#pragma unroll   // every stage but a split's last has all its steps: known offsets
      for (int kk = 0; kk < kTcRows / 16; ++kk) {
        if (kk == steps) break;
        uint32_t af[2][4] = {{bf16_pair<0>(w[0], w[1]), bf16_pair<1>(w[0], w[1]),
                              bf16_pair<0>(w[2], w[3]), bf16_pair<1>(w[2], w[3])},
                             {bf16_pair<2>(w[0], w[1]), bf16_pair<3>(w[0], w[1]),
                              bf16_pair<2>(w[2], w[3]), bf16_pair<3>(w[2], w[3])}};
        tc_issue<NP>(part, af, xs, kk);
        if (kk + 1 < steps) words(kk + 1);   // the next step's loads under the products
        tc_finish<NP>(part, af);
        if (++step == group_steps) {   // the group is complete: scale its partial product
          const float4 sc =
              *reinterpret_cast<const float4*>(scales + grp * kTcCols + (cb - col0));
          const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
          step = 0;
          ++grp;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < NP / 2; ++i) {
              // rows g (elements 0, 1 of four) are column 2j, rows g + 8 column 2j + 1
              total[j][i] = fmaf(part[j][i], sv[2 * j + ((i >> 1) & 1)], total[j][i]);
              part[j][i] = 0.f;
            }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    // element 4i + 2r + h of tile j: column cb + 2j + r, row of x 8i + 2t + h
    if (cb < a.N) {
#pragma unroll
      for (int i = 0; i < NP / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 8 * i + 2 * t + h;
          if (m >= a.M) continue;
          const float v0 = total[0][4 * i + h], v1 = total[0][4 * i + 2 + h];
          const float v2 = total[1][4 * i + h], v3 = total[1][4 * i + 2 + h];
          if (a.splits == 1) {
            const __nv_bfloat162 lo = __floats2bfloat162_rn(v0, v1);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(v2, v3);
            uint2 pk;
            pk.x = *reinterpret_cast<const uint32_t*>(&lo);
            pk.y = *reinterpret_cast<const uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + (long long)m * a.N + cb) = pk;
          } else {
            *reinterpret_cast<float4*>(a.partial + ((long long)split * a.M + m) * a.N + cb) =
                make_float4(v0, v1, v2, v3);
          }
        }
    }
  }
  if (a.splits == 1) return;

  // The last block of the column tile to finish adds the splits' partials
  // in split order and casts once: the same bits whichever block is last.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(&a.counters[blockIdx.x], 1) == a.splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const int quads = min(kTcCols, a.N - col0) / 4;   // 16 | N: whole quads
  const long long mn = (long long)a.M * a.N;
  constexpr int kBatch = 8;   // partials loaded at once, then added in split order
  for (int i = threadIdx.x; i < a.M * quads; i += kTcThreads) {
    const int m = i / quads, c = col0 + 4 * (i % quads);
    const float* src = a.partial + (long long)m * a.N + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < a.splits; s0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (s0 + j < a.splits) v[j] = __ldcg(reinterpret_cast<const float4*>(src + (s0 + j) * mn));
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (s0 + j < a.splits) sum.x += v[j].x, sum.y += v[j].y, sum.z += v[j].z, sum.w += v[j].w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x, sum.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z, sum.w);
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + (long long)m * a.N + c) = pk;
  }
  if (threadIdx.x == 0) a.counters[blockIdx.x] = 0;   // ready for the next launch
}

template <int NP>
cudaError_t launch_tc(const WoqParams& a, cudaStream_t stream) {
  using Sh = TcShape<NP>;
  if (a.groups_per_split > kTcMaxGroups) return cudaErrorInvalidValue;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap mq, mx, ms;
  if (!hopper::map_2d(&mq, a.q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.K, a.N, a.N, 128, kTcRows,
                      sw) ||
      !hopper::map_2d(&mx, a.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.M, a.K, a.K, 64, NP, sw) ||
      !hopper::map_2d(&ms, a.scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.G, a.N, a.N, kTcCols,
                      a.groups_per_split, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static bool raised = false;   // more than 48 KB of shared memory is opt-in, once a kernel
  if (!raised) {
    const cudaError_t rc = cudaFuncSetAttribute(
        woq_tc_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (rc != cudaSuccess) return rc;
    raised = true;
  }
  const dim3 grid((a.N + kTcCols - 1) / kTcCols, a.splits);
  woq_tc_kernel<NP><<<grid, kTcThreads, Sh::smem(a.groups_per_split), stream>>>(mq, mx, ms, a);
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
// mma: bf16, M <= 64, gs % 16 == 0, N % 16 == 0, x and q 16-byte aligned),
// allocated partial when splits > 1, and with mma given counters, zeroed.
extern "C" int dstt_woq_matmul(WoqParams a, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (a.M == 0 || a.N == 0) return cudaSuccess;
  if (a.mma) {
    return a.M <= 8    ? launch_tc<8>(a, stream)
           : a.M <= 16 ? launch_tc<16>(a, stream)
           : a.M <= 32 ? launch_tc<32>(a, stream)
                       : launch_tc<64>(a, stream);
  }
  cudaError_t rc;
  if (a.M > 4) {
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
