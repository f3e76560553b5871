// Flash attention forward with the row log-sum-exp, for training.
//
// Replaces the TPU kernel _fwd_kernel in
// deepspeed_tpu/ops/transformer/pallas_flash.py (reached through
// flash_attention_with_lse -> _fwd_call -> pl.pallas_call). Same function:
// O = softmax(mask(scale * Q K^T + alibi)) V per query head, with fp32
// online softmax, GQA-native (K/V stay at kv heads), causal on a runtime
// q_offset (bottom-right alignment, may be negative), sliding window,
// segment ids and ALiBi; p is cast to v's dtype before P V; the LSE is in
// natural-log units, and a row with no visible key gives O = 0 and
// LSE = MASK_VALUE.
//
// Bound on an H100 SXM: operations. Causal attention at the training shape
// (S 2048, D 64) does 4 * D flops per visible (query, key) pair on bytes
// each block reads once, so the tensor cores (989 TFLOP/s bf16) set the
// bound; at D 64 the softmax's work per score (an exp2 on the
// special-function unit, a max, a sum, a conversion) costs about as much
// time as the products, so the design keeps it short and runs it beside
// other warpgroups' products. What it does (bf16, the training dtype):
//
// - wgmma fed by TMA. A block is three consumer warpgroups, 64 query rows
//   of one head each, and one producer warpgroup, of which one thread
//   issues TMA copies (hopper.cuh): each consumer's Q tile once, then the
//   K and V tiles of 128 keys the rows can see, into a ring of two
//   128-byte-swizzled stages with full and empty mbarriers. setmaxnreg
//   leaves the producer 24 registers and gives the consumers 160. Blocks
//   start with the last query tiles, which see the most keys; a
//   warpgroup skips the tiles its rows cannot see.
// - S = Q K^T reads both operands K-major from shared memory; O += P V
//   takes P from registers (the fp32 scores cast to bf16, as the Pallas
//   kernel casts p to v's dtype) and V MN-major through wgmma's transpose
//   bit, so V is never transposed by hand.
// - Softmax in registers in the log2 domain: one FMA gives
//   s * scale * log2 e - m, then ex2.approx; the row max and sum reduce over
//   the row's four lanes. The MASK_VALUE / HALF_MASK sentinels stand in the
//   log2 domain unscaled (a masked score is set to MASK_VALUE after the
//   scale, never scaled by log2 e, which would overflow), so a row with no
//   visible key keeps l = 0. LSE = (m + log2 l) * ln 2 at the end.
// - A mask only where one applies. Each (64-row, 128-key) tile is
//   classified first (flash_common.cuh interior): an interior tile takes
//   no mask; an edge tile of a call without segment ids or ALiBi (the
//   training step's) masks each row to its visible key range, two compares
//   and a select a score; other calls take the rules of edge_x.
// - Each warpgroup waits for each of its products before it touches their
//   registers; the overlap of softmax and products comes from the three
//   warpgroups. Issuing the next tile's S with this tile's P V (the
//   softmax under a product), ping-pong of the warpgroups on named
//   barriers, two consumers, 64-key tiles, three stages, two heads a
//   block sharing K/V, a producer warp and a persistent grid all measured
//   slower (PERF.md): the first two made ptxas serialize the wgmmas when
//   a product is issued in one branch and waited for in another (C7518),
//   or spill when the registers ran short (C7512).
// - No atomics and a fixed order: every run gives the same bits.
//
// TMA reads rows whose strides are multiples of 16 bytes from a 16-byte
// aligned base: the wrapper (flash.py _rows) passes a contiguous copy of
// any q, k or v that is not.
//
// Head dims: any even head_dim up to 128, at run time. One kernel a DK, the
// head_dim rounded up to 16 (16, 32, ..., 128): S runs DK / 16 k-steps, the
// tiles hold the next whole width DP of 32, 64 or 128 columns, and the TMA
// maps' inner extent is D, so the columns past D arrive as zeros
// (flash_common.cuh Tile); O is stored only at the D real columns. A
// head_dim that is no multiple of 8 (open-llama-3b's 100) has no head row of
// whole 16 bytes: its maps span a token's packed heads, each box starts on
// 16 bytes with the head's columns shifted in the tile, and Q's other
// columns are zeroed in shared memory (flash_common.cuh packed_heads). The
// wrapper (flash.py) pads the head dims this does not take (odd ones, GQA)
// to the next multiple of 8.
//
// fp32 inputs, and bf16 at head_dim 256, 384 and 512, take the CUDA-core
// kernel (the tile products of flash_common.cuh, on tiles staged as fp32):
// a 64-row O tile of 256 fp32 columns is 128 registers a thread alone,
// which leaves the wgmma form no room for S and P. Past 256 a block keeps
// 128 of O's columns (a grid axis over the column chunks, each recomputing
// S), one warp of query rows and 32-key tiles, so that registers and shared
// memory hold. It casts p to the input type before P V, as the Pallas
// kernel does. It is right first; a wgmma form at 256 is later work.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// ---- bf16: wgmma fed by TMA ----------------------------------------------------

// The block and tile shapes, chosen by sweeps at the training and
// llama2-7b shapes (kernel_ab.py: a copy of this directory with one of
// them edited against this one; PERF.md).
constexpr int kFwdConsumers = 3;  // consumer warpgroups a block: 64 query rows each
constexpr int kFwdKeys = 128;     // keys a step
constexpr int kFwdStages = 2;     // K/V tiles in flight
constexpr int kFwdThreads = 128 * (kFwdConsumers + 1);  // and a producer warpgroup
// registers a consumer thread gets from setmaxnreg: all of the SM's 65536
// but the producer's, in multiples of 8. At head_dim 128 ptxas spills
// ~120 bytes a thread within them; two consumers (240 registers, no spill)
// measured slower there all the same (PERF.md).
constexpr int kFwdConsumerRegs = 160;
static_assert(128 * (kFwdConsumers * kFwdConsumerRegs + kProducerRegs) <= 65536,
              "register file");

// Scaled log2-domain logit (ALiBi included) of query position qi against
// key kj of an edge tile of a call with segment ids or ALiBi, or kMask
// where the key is out of range or masked. The rules are masked_logit's
// (flash_common.cuh) and flash_bwd.cu edge_p's, written out here as
// edge_p writes them: every form of edge_p that called a shared rule made
// ptxas branch on each score and cost the backward 5-7% (PERF.md).
// Calls with neither take softmax's key-range form of the same rules.
__device__ __forceinline__ float edge_x(const FlashParams& p, float dot, float scale2,
                                        float slope2, int qi, int kj, int b) {
  bool ok = qi < p.Sq && kj < p.Sk;
  const int qpos = qi + p.q_offset;
  if (ok && p.qseg != nullptr)
    ok = p.qseg[(long long)b * p.Sq + qi] == p.kseg[(long long)b * p.Sk + kj];
  if (p.causal) {
    ok = ok && qpos >= kj;
    if (p.window > 0) ok = ok && qpos - kj < p.window;
  }
  float x = dot * scale2;
  if (p.slopes != nullptr) x += slope2 * static_cast<float>(kj - qpos);
  return ok ? x : kMask;
}

// S = Q K^T of one 64-row x BK-key tile, both operands K-major in shared
// memory, over the DK columns (zero past D); one commit group.
template <int DK, int BK>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], const char* q_t, const char* k_t) {
  using namespace hopper;
  constexpr int SW = Tile<DK>::SW;
  wg_fence();
#pragma unroll
  for (int j = 0; j < DK / 16; ++j) {
    const uint64_t dq = desc_k<SW>(q_t, 64, 0, j), dk = desc_k<SW>(k_t, BK, 0, j);
    if (j == 0) mma_ss0<BK>(sc, dq, dk);
    else mma_ss<BK>(sc, dq, dk);
  }
  wg_commit();
}

// O += P V over the tile's DP columns, P in registers, V MN-major in shared
// memory; one commit group.
template <int DK, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[Tile<DK>::DP / 2],
                                         const uint32_t (&a)[BK / 16][4], const char* v_t) {
  using namespace hopper;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_rs_mn<Tile<DK>::DP>(o, a[kk], desc_mn<Tile<DK>::SW>(v_t, BK, kk));
  wg_commit();
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// The online softmax of one tile, in the log2 domain: the raw dots in sc
// become p = 2^(x - m) in place (x the scaled, masked logit); the rows'
// max m, sum l (this lane's columns) and the factor alpha for O follow.
// Rows 16 warp + g (+ 8) of the warpgroup's 64 from r0, keys from k0.
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], const FlashParams& p, int r0, int k0,
                                        int b, float scale2, float slope2) {
  using hopper::ex2;
  const int lane = threadIdx.x % 32, row = 16 * ((threadIdx.x / 32) % 4) + lane / 4,
            t = lane % 4;
  float mx[2];
  const bool inner = interior(p, r0, 64, k0, BK);
  if (inner) {  // every score visible: the extreme raw dot, scaled
    constexpr float kBig = 3.4028234663852886e38f;
    float ext[2];
    if (scale2 >= 0.f) {
      ext[0] = ext[1] = -kBig;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) ext[(e >> 1) & 1] = fmaxf(ext[(e >> 1) & 1], sc[e]);
    } else {
      ext[0] = ext[1] = kBig;
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) ext[(e >> 1) & 1] = fminf(ext[(e >> 1) & 1], sc[e]);
    }
    mx[0] = ext[0] * scale2;
    mx[1] = ext[1] * scale2;
  } else if (p.qseg == nullptr && p.slopes == nullptr) {
    // causal, window and the ragged edges only: each row sees the keys
    // [lo, hi), so a score costs two compares and a select
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + row + 8 * r, qpos = qi + p.q_offset;
      hi[r] = qi >= p.Sq ? 0 : p.causal ? min(p.Sk, qpos + 1) : p.Sk;
      lo[r] = p.causal && p.window > 0 ? qpos - p.window + 1 : 0;
      // against the thread's column offset
      hi[r] -= k0 + 2 * t;
      lo[r] -= k0 + 2 * t;
    }
    mx[0] = mx[1] = kMask;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1, c = 8 * (e >> 2) + (e & 1);
      sc[e] = c >= lo[r] && c < hi[r] ? sc[e] * scale2 : kMask;
      mx[r] = fmaxf(mx[r], sc[e]);
    }
  } else {
    mx[0] = mx[1] = kMask;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      const int qi = r0 + row + 8 * r, kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      sc[e] = edge_x(p, sc[e], scale2, slope2, qi, kj, b);
      mx[r] = fmaxf(mx[r], sc[e]);
    }
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_next = fmaxf(m[r], mx[r]);
    m_safe[r] = fmaxf(m_next, kHalfMask);
    alpha[r] = ex2(fmaxf(m[r], kHalfMask) - m_safe[r]);
    m[r] = m_next;
  }
  float rs[2] = {0.f, 0.f};
  if (inner) {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      sc[e] = ex2(fmaf(sc[e], scale2, -m_safe[r]));
      rs[r] += sc[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int r = (e >> 1) & 1;
      sc[e] = ex2(sc[e] - m_safe[r]);
      rs[r] += sc[e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
}

// One block: BQ = 64 * NC query rows of one head; consumer warpgroup w
// owns rows 64 w .. 64 w + 63 (its Q tile loaded once), the producer
// streams the K/V tiles the rows can see.
template <int DK>
__global__ void __launch_bounds__(kFwdThreads, 1)
fwd_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv, const FlashParams p) {
  using namespace hopper;
  constexpr int SW = Tile<DK>::SW, E = Tile<DK>::E, NR = Tile<DK>::NR, DP = Tile<DK>::DP;
  constexpr int NC = kFwdConsumers, BK = kFwdKeys, ST = kFwdStages;
  constexpr int QT = 64 * DP * 2, KT = BK * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  char* sQ = align1024(smem_raw);
  char* sK = sQ + NC * QT;
  char* sV = sK + ST * KT;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + ST * KT);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;

  constexpr int BQ = 64 * NC;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H, kvh = h / (p.H / p.kvH);
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;  // longest rows first

  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) {
    k_hi = min(p.Sk, p.q_offset + q0 + BQ);
    if (p.window > 0) k_lo = max(0, p.q_offset + q0 - p.window + 1);
  }
  const int jt_lo = k_lo / BK;
  const int n_tiles = k_hi > 0 ? max(0, (k_hi + BK - 1) / BK - jt_lo) : 0;

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * NC);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {  // producer: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (threadIdx.x == NC * 128) {
      bar_expect(bar_q, NC * QT);
      for (int w = 0; w < NC; ++w)
        for (int rg = 0; rg < NR; ++rg) {
          const HeadBox x = head_box(p.D, h, rg * E);
          tma_load4(sQ + w * QT + rg * 64 * SW, &mq, bar_q, x.col, x.head, q0 + 64 * w, b);
        }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST, n = it / ST;
        if (n > 0) bar_wait(&empty[s], (n - 1) & 1);
        bar_expect(&full[s], 2 * KT);
        const int k0 = (jt_lo + it) * BK;
        for (int rg = 0; rg < NR; ++rg) {
          const HeadBox x = head_box(p.D, kvh, rg * E);
          tma_load4(sK + s * KT + rg * BK * SW, &mk, &full[s], x.col, x.head, k0, b);
          tma_load4(sV + s * KT + rg * BK * SW, &mv, &full[s], x.col, x.head, k0, b);
        }
      }
    }
    return;
  }

  // consumers
  regs_inc<kFwdConsumerRegs>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * wg;
  const char* q_t = sQ + wg * QT;
  const float scale2 = p.scale * kLog2e;
  const float slope2 = p.slopes != nullptr ? p.slopes[h] * kLog2e : 0.f;
  // this warpgroup's tiles [t_lo, t_hi) of the block's n_tiles: the ones
  // its rows see, a contiguous range
  int t_lo = 0, t_hi = n_tiles;
  while (t_lo < t_hi && !tile_runs(p, r0, 64, (jt_lo + t_lo) * BK, BK)) ++t_lo;
  while (t_hi > t_lo && !tile_runs(p, r0, 64, (jt_lo + t_hi - 1) * BK, BK)) --t_hi;

  // softmax state of the thread's rows 16 warp + g (+ 8), in log2 units
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  bar_wait(bar_q, 0);
  const int o_sh = head_shift(p.D, h);  // this head's first column in its tiles
  if (packed_heads(p.D)) {  // Q's columns outside [o_sh, o_sh + D): the neighbours'
    zero_outside<DK>(sQ + wg * QT, 64, 0, o_sh, o_sh + p.D);
    publish(wg);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % ST;
    bar_wait(&full[s], (it / ST) & 1);
    if (it >= t_lo && it < t_hi) {
      float sc[BK / 2];
      issue_s<DK, BK>(sc, q_t, sK + s * KT);
      wg_wait<0>();
      hold(sc);
      softmax<BK>(sc, m, l, alpha, p, r0, (jt_lo + it) * BK, b, scale2, slope2);
      uint32_t a[BK / 16][4];
      to_a<BK>(a, sc);
      rescale<DP>(o, alpha);
      issue_pv<DK, BK>(o, a, sV + s * KT);
      wg_wait<0>();
      hold(o);
      hold(a);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }

  bf16* out = static_cast<bf16*>(p.out0);
  float* lse = static_cast<float*>(p.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = r0 + 16 * warp + g + 8 * r;
    if (i >= p.Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    // tile column c is O's column c - o_sh: the D real columns of DP
    bf16* row = out + (((long long)b * p.Sq + i) * p.H + h) * p.D - o_sh;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int c = 8 * n + 2 * t;
      if (c >= o_sh && c < o_sh + p.D)
        store2(row + c, o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
    if (t == 0)
      lse[((long long)b * p.H + h) * p.Sq + i] =
          l[r] == 0.f ? kMask : (fmaxf(m[r], kHalfMask) + log2f(l[r])) * kLn2;
  }
}

template <int DK>
cudaError_t launch_bf16(const FlashParams& p, cudaStream_t stream) {
  constexpr int SW = Tile<DK>::SW, DP = Tile<DK>::DP, NC = kFwdConsumers, BK = kFwdKeys,
                ST = kFwdStages;
  const int D = p.D;
  CUtensorMap mq, mk = {}, mv = {};
  if (!map_heads<SW>(&mq, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh, 64) ||
      (p.Sk > 0 &&
       (!map_heads<SW>(&mk, p.k, p.B, p.Sk, p.kvH, D, p.k_sb, p.k_ss, p.k_sh, BK) ||
        !map_heads<SW>(&mv, p.v, p.B, p.Sk, p.kvH, D, p.v_sb, p.v_ss, p.v_sh, BK))))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)(NC * 64 + 2 * ST * BK) * DP * 2 + (1 + 2 * ST) * 8;
  cudaError_t err = reserve_smem(fwd_wgmma<DK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + 64 * NC - 1) / (64 * NC));
  fwd_wgmma<DK><<<grid, kFwdThreads, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// ---- the CUDA-core kernel: fp32, and bf16 past head_dim 128 ----------------------

// One block: HB heads x BQ query rows, the DC columns of O from c0 = DC *
// blockIdx.z, over key tiles of BK keys; S over the D real columns.
template <typename T, int DW, int DC, int BK>
__global__ void __launch_bounds__(128)
fwd_cuda_cores(const FlashParams p, int HB, int BQ) {
  constexpr int LD = DW + kPad;
  constexpr int NT = BK / 8;   // score tiles of 8 keys
  constexpr int DT = DC / 8;   // output tiles of 8 columns
  const int D = p.D, c0 = DC * blockIdx.z;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int G = p.H / p.kvH;
  const int chunks = G / HB;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;  // long (late) query tiles first
  const int q0 = qt * BQ;
  int y = blockIdx.y;
  const int hc = y % chunks;
  y /= chunks;
  const int kvh = y % p.kvH;
  const int b = y / p.kvH;
  const int h0 = kvh * G + hc * HB;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wph = BQ / 16;  // warps per head
  const int hl = warp / wph, rb = warp - hl * wph;
  const int h = h0 + hl;
  const int rows = HB * BQ;

  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + rows * LD;  // [BK][LD]
  float* sV = sK + BK * LD;    // [BK][LD]
  int* sKseg = reinterpret_cast<int*>(sV + BK * LD);  // [BK]
  float* scratch = reinterpret_cast<float*>(sKseg + BK) + warp * 16 * (BK + 4);

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int valid_q = min(BQ, p.Sq - q0);
  for (int hh = 0; hh < HB; ++hh)
    stage_rows<DW>(sQ + hh * BQ * LD, LD, q + b * p.q_sb + (long long)q0 * p.q_ss + (h0 + hh) * p.q_sh,
                   p.q_ss, BQ, valid_q, D, tid, nthreads);
  cp_async_commit();

  // key tiles the block can see
  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) {
    k_hi = min(p.Sk, p.q_offset + q0 + BQ);
    if (p.window > 0) k_lo = max(0, p.q_offset + q0 - p.window + 1);
  }
  const int jt_lo = k_lo / BK;
  const int jt_hi = k_hi > 0 ? (k_hi + BK - 1) / BK : 0;
  const int n_tiles = max(0, jt_hi - jt_lo);

  auto stage = [&](int jt) {
    const int k0 = jt * BK;
    const int valid = min(BK, p.Sk - k0);
    stage_rows<DW>(sK, LD, k + b * p.k_sb + (long long)k0 * p.k_ss + kvh * p.k_sh, p.k_ss, BK,
                   valid, D, tid, nthreads);
    stage_rows<DW>(sV, LD, v + b * p.v_sb + (long long)k0 * p.v_ss + kvh * p.v_sh, p.v_ss, BK,
                   valid, D, tid, nthreads);
    if (p.kseg != nullptr)
      for (int c = tid; c < BK; c += nthreads)
        sKseg[c] = k0 + c < p.Sk ? p.kseg[(long long)b * p.Sk + k0 + c] : 0;
    cp_async_commit();
  };

  // this thread's two rows: query positions i0 and i0 + 8 of head h
  const int i0 = q0 + rb * 16 + g;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  int qseg[2] = {0, 0};
  if (p.qseg != nullptr)
    for (int r = 0; r < 2; ++r)
      qseg[r] = i0 + 8 * r < p.Sq ? p.qseg[(long long)b * p.Sq + i0 + 8 * r] : 0;

  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const float* qw = sQ + (hl * BQ + rb * 16) * LD;
  if (n_tiles > 0) stage(jt_lo);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const int k0 = (jt_lo + it) * BK;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_nt<NT, DW>(s, qw, LD, sK, LD);

    float mx[2] = {kMask, kMask};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const int ks = p.kseg != nullptr ? sKseg[c] : 0;
        s[n][e] = masked_logit(p, s[n][e], i0 + 8 * r, k0 + c, slope, qseg[r], ks);
        mx[r] = fmaxf(mx[r], s[n][e]);
      }
    float alpha[2], m_safe[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m[r], mx[r]);
      m_safe[r] = fmaxf(m_next, kHalfMask);
      alpha[r] = expf(fmaxf(m[r], kHalfMask) - m_safe[r]);
      m[r] = m_next;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[n][e] = expf(s[n][e] - m_safe[r]);
        rs[r] += s[n][e];
        s[n][e] = round_to<T>(s[n][e]);  // p in v's type for P V
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];  // this lane's columns
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_pv<BK, DT>(acc, s, sV + c0, LD, scratch);
    __syncthreads();  // the tile is free for the next stage
    if (it + 1 < n_tiles) stage(jt_lo + it + 1);
  }
  cp_async_wait<0>();

  T* o = static_cast<T*>(p.out0);
  float* lse = static_cast<float*>(p.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = i0 + 8 * r;
    if (i >= p.Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    T* orow = o + (((long long)b * p.Sq + i) * p.H + h) * D + c0;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      if (c0 + n * 8 + 2 * t < D)
        store2(orow + n * 8 + 2 * t, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0 && blockIdx.z == 0)
      lse[((long long)b * p.H + h) * p.Sq + i] =
          l[r] == 0.f ? kMask : fmaxf(m[r], kHalfMask) + logf(l[r]);
  }
}

// Past head_dim 256: 128 columns of O a block, one warp, 32-key tiles.
template <typename T, int DW>
cudaError_t launch_cuda_cores(const FlashParams& p, cudaStream_t stream) {
  constexpr int DC = DW > 256 ? 128 : DW, BK = DW > 256 ? 32 : kBK, LD = DW + kPad;
  int HB, BQ;
  pick_rows(p.H / p.kvH, DW > 256 ? 1 : kMaxWarps, &HB, &BQ);
  const int warps = HB * BQ / 16;
  const size_t smem = sizeof(float) * ((size_t)HB * BQ * LD + 2 * BK * LD) +
                      sizeof(int) * BK + sizeof(float) * warps * 16 * (BK + 4);
  cudaError_t err = reserve_smem(fwd_cuda_cores<T, DW, DC, BK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.kvH * (p.H / p.kvH / HB), DW / DC);
  fwd_cuda_cores<T, DW, DC, BK><<<grid, warps * 32, smem, stream>>>(p, HB, BQ);
  return cudaGetLastError();
}

// The CUDA-core kernel of the head_dim's width class (32, 64 or 128
// columns staged: every multiple of 4 up to 128 in fp32, rows of whole 16
// bytes), and 256, 384, 512 (pallas_flash.supports' dims past 128) in both
// types.
template <typename T>
cudaError_t cuda_cores(const FlashParams& p, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (p.D <= 32) return launch_cuda_cores<T, 32>(p, s);
    if (p.D <= 64) return launch_cuda_cores<T, 64>(p, s);
    if (p.D <= 128) return launch_cuda_cores<T, 128>(p, s);
  }
  switch (p.D) {
    case 256: return launch_cuda_cores<T, 256>(p, s);
    case 384: return launch_cuda_cores<T, 384>(p, s);
    case 512: return launch_cuda_cores<T, 512>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 up to 128: the wgmma kernel of DK, the columns the products span
// rounded up to 16 (D, or D + kMaxShift for packed heads: an even D that is
// no multiple of 8, at most 122, one kv head a query head).
cudaError_t dispatch(const FlashParams& p, bool bf16_in, cudaStream_t s) {
  if (p.D <= 0 || p.D % (bf16_in ? 2 : 4)) return cudaErrorInvalidValue;
  if (!bf16_in) return cuda_cores<float>(p, s);
  const bool packed = packed_heads(p.D);
  if (packed && (p.D + kMaxShift > 128 || p.H != p.kvH)) return cudaErrorInvalidValue;
  switch ((p.D + (packed ? kMaxShift : 0) + 15) / 16) {
    case 1: return launch_bf16<16>(p, s);
    case 2: return launch_bf16<32>(p, s);
    case 3: return launch_bf16<48>(p, s);
    case 4: return launch_bf16<64>(p, s);
    case 5: return launch_bf16<80>(p, s);
    case 6: return launch_bf16<96>(p, s);
    case 7: return launch_bf16<112>(p, s);
    case 8: return launch_bf16<128>(p, s);
    default: return cuda_cores<bf16>(p, s);
  }
}

}  // namespace

// q [B, Sq, H, D], k / v [B, Sk, kvH, D] (strided rows, unit last stride; D
// a multiple of 8, at most 128, or 256, 384 or 512);
// writes O (out0, contiguous [B, Sq, H, D]) and LSE (out1, [B, H, Sq] fp32).
// Returns the cudaError_t of the launch.
extern "C" int dstt_flash_fwd(flash::FlashParams p, int is_bf16, void* stream) {
  if (p.B == 0 || p.Sq == 0) return cudaSuccess;
  return dispatch(p, is_bf16 != 0, static_cast<cudaStream_t>(stream));
}
