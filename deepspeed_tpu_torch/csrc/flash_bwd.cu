// Flash attention backward: dQ (with di), and dK / dV summed over each GQA
// group.
//
// Replaces the TPU kernels _dq_kernel and _dkv_kernel in
// deepspeed_tpu/ops/transformer/pallas_flash.py (reached through the
// custom-VJP backward _flash_bwd -> _bwd_call -> pl.pallas_call). Both
// recompute each score tile from Q, K and the forward's saved row LSE
// (P = exp(s - lse), 0 on rows with no visible key, _masked_p):
//
//   di = rowsum(dO * O) - dLSE        (the dQ launch; the dK/dV launch reads it)
//   dS = P * (dO V^T - di) * scale
//   dQ = dS K            dK = sum over the group's heads of dS^T Q
//                        dV = sum over the group's heads of P^T dO
//
// Bound on an H100 SXM: operations. Per visible (query, key) pair dQ does
// three products of head_dim multiply-adds (S, dP, dQ) and dK/dV four (S,
// dP, dV, dK) on bytes each block reads once, so the tensor cores set the
// pace. What the design does about it (bf16, the training dtype):
//
// - wgmma fed by TMA. A block is two consumer warpgroups of 64 rows each
//   and one producer warpgroup, of which one thread issues TMA copies into
//   a ring of 128-byte-swizzled tiles (hopper.cuh) and signals mbarriers;
//   setmaxnreg moves the producer's registers (24 left) to the consumers
//   (240). S = Q K^T and dP = dO V^T (or their transposes) read both
//   operands from shared memory, K-major; dQ, dV and dK take dS / P from
//   registers (the accumulator cast to bf16 where the Pallas kernels cast
//   p and ds) and K, dO or Q from the same tiles through wgmma's transpose
//   bit. A warpgroup waits for each group of products before it touches
//   their registers: ptxas serializes every wgmma of a kernel in which an
//   accumulator is written while a product is pending, or in which the
//   registers run short, so the overlap comes from the two warpgroups and
//   the producer running ahead, not from within a warpgroup.
// - A mask only where one applies. Each (query tile, key tile) is
//   classified before its scores are used (flash_common.cuh interior): an
//   interior tile (no ragged edge, every key visible to every row, no
//   segment ids or ALiBi in the call) takes P = exp2(s * scale * log2 e -
//   lse * log2 e) alone; edge tiles take the forward's mask rules (edge_p).
//   Tiles no row can see are skipped.
// - di in the dQ kernel: its block holds dO and O of its rows anyway, and
//   writes di to an fp32 [B, H, Sq] buffer for the dK/dV launch that
//   follows on the same stream.
// - The Pallas split, deterministic. dQ (dstt_flash_dq): a block owns the
//   64-row tiles of two query heads of one kv group (one head's 128 rows
//   at odd groups) and walks the 128-key tiles (64 at head_dim 128) they
//   can see, two in flight.
//   dK/dV (dstt_flash_dkv): a block owns one kv head's 128 keys (K and V
//   loaded once) and walks the group's query heads x the 64-row query
//   tiles (32 at head_dim 128) that see the keys, three in flight, in a
//   fixed order, the producer warp copying each tile's LSE and di beside
//   it. The Pallas kernels' sequential grid axes become these loops; the
//   sums stay in registers, with no atomics, so every run gives the same
//   bits. The tile shapes were chosen by measurement at the training and
//   llama2-7b shapes (PERF.md).
//
// TMA reads rows whose strides are multiples of 16 bytes from a 16-byte
// aligned base: the wrapper (flash.py _rows) passes a contiguous copy of
// any q, k or v that is not.
//
// Head dims: any even head_dim up to 128, at run time, as in the forward:
// one kernel a DK (the head_dim rounded up to 16), the tiles DP columns wide
// with the columns past D zero (flash_common.cuh Tile); S and dP run DK / 16
// k-steps, and dQ, dK and dV are stored only at the D real columns. At a
// head_dim that is no multiple of 8 the maps span a token's packed heads
// (flash_common.cuh packed_heads: each box on 16 bytes, the head's columns
// shifted in the tile), and the consumers zero the other columns of Q and
// dO (dQ) or of K and V (dK/dV), the loaded-once side of every product
// over D.
//
// fp32 inputs, and bf16 at head_dim 256, 384 and 512, take the CUDA-core
// kernels (the same two launches, the tile products of flash_common.cuh on
// tiles staged as fp32; p and ds cast to the input type before their
// products, as the Pallas kernels cast them). From 256 a dK/dV block keeps
// 128 of the columns of dK and dV (a grid axis over the column chunks, each
// recomputing S and dP), so that its accumulators fit the registers; past
// 256 a dQ block keeps 128 of dQ's columns the same way, on one warp of
// query rows and 32-key tiles, and a dK/dV block takes 32 keys and 16 query
// rows a step: shared memory holds the rows at their full width.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// ---- bf16: wgmma fed by TMA ----------------------------------------------------

constexpr int kConsumers = 2;                    // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
// registers a consumer thread gets from setmaxnreg (kProducerRegs left to
// the producer warpgroup)
constexpr int kConsumerRegs = 240;

// Tile shapes, chosen by sweeps at the training and llama2-7b shapes
// (kernel_ab.py: a copy of this directory with one of them edited against
// this one; PERF.md).
constexpr int kDqKeys64 = 128;   // keys a dQ step at head_dim <= 64 (64 at 128)
constexpr int kDqHeads = 2;      // heads a dQ block at even GQA groups (else 1)
constexpr int kDkvRows128 = 32;  // query rows a dK/dV step at head_dim 128 (64 below)
constexpr int kDkvStages = 3;    // Q/dO tiles in flight (K/V tiles in flight for dQ: 2)

// sum of the products of eight bf16 pairs, in order
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// P (scaled by log2 e: exp2) of one score of an edge tile: 0 where the key
// is masked or out of range, or the row sees no key at all. The rules are
// masked_logit's (flash_common.cuh) and flash_fwd.cu edge_x's, written out
// here: every form that calls a shared rule made ptxas branch on each score
// and cost the training-shape backward 5-7% (PERF.md).
__device__ __forceinline__ float edge_p(const FlashParams& p, float dot, float scale2, float lse2,
                                        bool live, int qi, int kj, int h, int b) {
  bool ok = live && qi < p.Sq && kj < p.Sk;
  const int qpos = qi + p.q_offset;
  if (ok && p.qseg != nullptr)
    ok = p.qseg[(long long)b * p.Sq + qi] == p.kseg[(long long)b * p.Sk + kj];
  if (p.causal) {
    ok = ok && qpos >= kj;
    if (p.window > 0) ok = ok && qpos - kj < p.window;
  }
  float x = dot * scale2 - lse2;
  if (p.slopes != nullptr) x += p.slopes[h] * kLog2e * static_cast<float>(kj - qpos);
  return ok ? hopper::ex2(x) : 0.f;
}

// dQ and di. One block: HB heads of one kv group x BQ = 64 * 2 / HB query
// rows; consumer warpgroup w owns 64 rows of one head (Q, dO and O tiles
// loaded once), the producer streams the K/V tiles the rows can see.
template <int DK, int BK, int ST>
__global__ void __launch_bounds__(kThreads, 1)
dq_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
         const __grid_constant__ CUtensorMap mo, const __grid_constant__ CUtensorMap mk,
         const __grid_constant__ CUtensorMap mv, const FlashParams p, int HB) {
  using namespace hopper;
  constexpr int SW = Tile<DK>::SW, E = Tile<DK>::E, NR = Tile<DK>::NR, DP = Tile<DK>::DP;
  constexpr int QT = 64 * DP * 2, KT = BK * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  char* sQ = align1024(smem_raw);
  char* sdO = sQ + kConsumers * QT;
  char* sO = sdO + kConsumers * QT;
  char* sK = sO + kConsumers * QT;
  char* sV = sK + ST * KT;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + ST * KT);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;

  const int G = p.H / p.kvH, chunks = G / HB, wph = kConsumers / HB, BQ = 64 * wph;
  int x = blockIdx.x;
  const int hc = x % chunks;
  x /= chunks;
  const int kvh = x % p.kvH, b = x / p.kvH;
  const int h0 = kvh * G + hc * HB;
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
      bar_init(&empty[s], 4 * kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // producer: one thread issues every copy
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      bar_expect(bar_q, 3 * kConsumers * QT);
      for (int w = 0; w < kConsumers; ++w) {
        const int h = h0 + w / wph, r0 = q0 + (w % wph) * 64;
        for (int rg = 0; rg < NR; ++rg) {
          const int off = w * QT + rg * 64 * SW;
          const HeadBox x = head_box(p.D, h, rg * E);
          tma_load4(sQ + off, &mq, bar_q, x.col, x.head, r0, b);
          tma_load4(sdO + off, &mdo, bar_q, x.col, x.head, r0, b);
          tma_load4(sO + off, &mo, bar_q, x.col, x.head, r0, b);
        }
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
  } else {  // consumers
    hopper::regs_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int h = h0 + wg / wph, r0 = q0 + (wg % wph) * 64;
    const char* q_t = sQ + wg * QT;
    const char* do_t = sdO + wg * QT;
    const char* o_t = sO + wg * QT;
    bar_wait(bar_q, 0);
    const int o_sh = head_shift(p.D, h);  // this head's first column in its tiles
    if (packed_heads(p.D)) {  // Q's and dO's columns outside [o_sh, o_sh + D)
      zero_outside<DK>(sQ + wg * QT, 64, 0, o_sh, o_sh + p.D);
      zero_outside<DK>(sdO + wg * QT, 64, 0, o_sh, o_sh + p.D);
      publish(wg);
    }

    // di = rowsum(dO * O) - dLSE of the thread's rows 16 warp + g (+ 8):
    // each of the row's four lanes sums every fourth 16-byte chunk, then the
    // lanes add in a fixed order
    float di[2], lse2[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 16 * warp + g + 8 * r, i = r0 + lr;
      float acc = 0.f;
#pragma unroll
      for (int c = t; c < DK / 8; c += 4) {
        if (8 * c >= o_sh + p.D) break;
        const int at = (c / (E / 8)) * 64 * SW + swizzled<SW>(lr, c % (E / 8));
        acc += dot8(*reinterpret_cast<const uint4*>(do_t + at),
                    *reinterpret_cast<const uint4*>(o_t + at));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const bool in = i < p.Sq;
      const long long row = ((long long)b * p.H + h) * p.Sq + i;
      if (in && p.dlse != nullptr) acc -= p.dlse[row];
      if (in && t == 0) p.di[row] = acc;
      di[r] = acc;
      const float l = in ? p.lse[row] : kMask;
      live[r] = l > kHalfMask;
      lse2[r] = live[r] ? l * kLog2e : 0.f;
    }

    const float scale2 = p.scale * kLog2e;
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST;
      bar_wait(&full[s], (it / ST) & 1);
      const int k0 = (jt_lo + it) * BK;
      if (tile_runs(p, r0, 64, k0, BK)) {
        const char* k_t = sK + s * KT;
        const char* v_t = sV + s * KT;
        float sc[BK / 2], dp[BK / 2];
        wg_fence();
#pragma unroll
        for (int j = 0; j < DK / 16; ++j) {
          const uint64_t dq_ = desc_k<SW>(q_t, 64, 0, j), dk_ = desc_k<SW>(k_t, BK, 0, j);
          if (j == 0) mma_ss0<BK>(sc, dq_, dk_);
          else mma_ss<BK>(sc, dq_, dk_);
        }
#pragma unroll
        for (int j = 0; j < DK / 16; ++j) {
          const uint64_t do_ = desc_k<SW>(do_t, 64, 0, j), dv_ = desc_k<SW>(v_t, BK, 0, j);
          if (j == 0) mma_ss0<BK>(dp, do_, dv_);
          else mma_ss<BK>(dp, do_, dv_);
        }
        wg_commit();
        wg_wait<0>();
        hold(sc);
        hold(dp);
        if (interior(p, r0, 64, k0, BK)) {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const int r = (e >> 1) & 1;
            sc[e] = ex2(fmaf(sc[e], scale2, -lse2[r])) * (dp[e] - di[r]) * p.scale;
          }
        } else {
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) {
            const int r = (e >> 1) & 1;
            const int qi = r0 + 16 * warp + g + 8 * r, kj = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
            sc[e] = edge_p(p, sc[e], scale2, lse2[r], live[r], qi, kj, h, b) * (dp[e] - di[r]) *
                    p.scale;
          }
        }
        uint32_t a[BK / 16][4];
        to_a<BK>(a, sc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) mma_rs_mn<DP>(dq, a[kk], desc_mn<SW>(k_t, BK, kk));
        wg_commit();
        wg_wait<0>();
        hold(dq);
        hold(a);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    bf16* out = static_cast<bf16*>(p.out0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + 16 * warp + g + 8 * r;
      if (i >= p.Sq) continue;
      // tile column c is dQ's column c - o_sh: the D real columns of DP
      bf16* row = out + (((long long)b * p.Sq + i) * p.H + h) * p.D - o_sh;
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        const int c = 8 * n + 2 * t;
        if (c >= o_sh && c < o_sh + p.D) store2(row + c, dq[4 * n + 2 * r], dq[4 * n + 2 * r + 1]);
      }
    }
  }
}

// dK / dV. One block: one kv head, 128 keys (64 a consumer warpgroup, K and
// V loaded once); the producer streams, for each query head of the group
// in turn, the BQ-row Q / dO tiles that see the keys, with their LSE and di.
template <int DK, int BQ, int ST>
__global__ void __launch_bounds__(kThreads, 1)
dkv_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
          const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
          const FlashParams p) {
  using namespace hopper;
  constexpr int SW = Tile<DK>::SW, E = Tile<DK>::E, NR = Tile<DK>::NR, DP = Tile<DK>::DP;
  constexpr int BKV = 64 * kConsumers;
  constexpr int KT = BKV * DP * 2, QT = BQ * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  char* sK = align1024(smem_raw);
  char* sV = sK + KT;
  char* sQ = sV + KT;           // [ST]
  char* sdO = sQ + ST * QT;     // [ST]
  float* sLse = reinterpret_cast<float*>(sdO + ST * QT);  // [ST][BQ]
  float* sDi = sLse + ST * BQ;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sDi + ST * BQ);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + ST;

  const int G = p.H / p.kvH;
  const int kvh = blockIdx.x % p.kvH, b = blockIdx.x / p.kvH;
  const int k0 = blockIdx.y * BKV;  // the keys seen by the most queries first

  // query tiles that see this key tile: a contiguous range
  const int nq = (p.Sq + BQ - 1) / BQ;
  int it_lo = 0, it_hi = nq;
  while (it_lo < nq && !tile_runs(p, it_lo * BQ, BQ, k0, BKV)) ++it_lo;
  while (it_hi > it_lo && !tile_runs(p, (it_hi - 1) * BQ, BQ, k0, BKV)) --it_hi;
  const int per_head = it_hi - it_lo;
  const int n_iter = G * per_head;

  if (threadIdx.x == 0) {
    bar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(&full[s], 1 + 32);  // the TMA thread and the producer warp's copies
      bar_init(&empty[s], 4 * kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // producer warp
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x / 32 == 4 * kConsumers) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        bar_expect(bar_kv, 2 * KT);
        for (int rg = 0; rg < NR; ++rg) {
          const HeadBox x = head_box(p.D, kvh, rg * E);
          tma_load4(sK + rg * BKV * SW, &mk, bar_kv, x.col, x.head, k0, b);
          tma_load4(sV + rg * BKV * SW, &mv, bar_kv, x.col, x.head, k0, b);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % ST, n = it / ST;
        if (n > 0) bar_wait(&empty[s], (n - 1) & 1);
        const int gi = it / per_head;
        const int q0 = (it_lo + it - gi * per_head) * BQ, h = kvh * G + gi;
        const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;
        for (int c = lane; c < BQ; c += 32) {
          const bool in = q0 + c < p.Sq;
          cp_async4(sLse + s * BQ + c, p.lse + (in ? row0 + c : 0), in);
          cp_async4(sDi + s * BQ + c, p.di + (in ? row0 + c : 0), in);
        }
        cp_async_arrive(&full[s]);
        if (lane == 0) {
          bar_expect(&full[s], 2 * QT);
          for (int rg = 0; rg < NR; ++rg) {
            const HeadBox x = head_box(p.D, h, rg * E);
            tma_load4(sQ + s * QT + rg * BQ * SW, &mq, &full[s], x.col, x.head, q0, b);
            tma_load4(sdO + s * QT + rg * BQ * SW, &mdo, &full[s], x.col, x.head, q0, b);
          }
        }
      }
    }
  } else {  // consumers
    hopper::regs_inc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int kw = k0 + 64 * wg;  // this warpgroup's keys
    const float scale2 = p.scale * kLog2e;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
    bar_wait(bar_kv, 0);
    const int o_sh = head_shift(p.D, kvh);  // the head's first column in its tiles
    if (packed_heads(p.D)) {  // this warpgroup's K and V columns outside [o_sh, o_sh + D)
      zero_outside<DK>(sK, BKV, 64 * wg, o_sh, o_sh + p.D);
      zero_outside<DK>(sV, BKV, 64 * wg, o_sh, o_sh + p.D);
      publish(wg);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % ST;
      bar_wait(&full[s], (it / ST) & 1);
      const int gi = it / per_head;
      const int q0 = (it_lo + it - gi * per_head) * BQ, h = kvh * G + gi;
      if (tile_runs(p, q0, BQ, kw, 64)) {
        const char* q_t = sQ + s * QT;
        const char* do_t = sdO + s * QT;
        const float* lse = sLse + s * BQ;
        const float* dis = sDi + s * BQ;
        float sc[BQ / 2], dp[BQ / 2];  // S^T and dP^T: [64 keys x BQ queries]
        wg_fence();
#pragma unroll
        for (int j = 0; j < DK / 16; ++j) {
          const uint64_t dk_ = desc_k<SW>(sK, BKV, 64 * wg, j), dq_ = desc_k<SW>(q_t, BQ, 0, j);
          if (j == 0) mma_ss0<BQ>(sc, dk_, dq_);
          else mma_ss<BQ>(sc, dk_, dq_);
        }
#pragma unroll
        for (int j = 0; j < DK / 16; ++j) {
          const uint64_t dv_ = desc_k<SW>(sV, BKV, 64 * wg, j), do_ = desc_k<SW>(do_t, BQ, 0, j);
          if (j == 0) mma_ss0<BQ>(dp, dv_, do_);
          else mma_ss<BQ>(dp, dv_, do_);
        }
        wg_commit();
        wg_wait<0>();
        hold(sc);
        hold(dp);
        if (interior(p, q0, BQ, kw, 64)) {
#pragma unroll
          for (int e = 0; e < BQ / 2; ++e) {
            const int c = 8 * (e >> 2) + 2 * t + (e & 1);
            const float pr = ex2(fmaf(sc[e], scale2, -lse[c] * kLog2e));
            sc[e] = pr;
            dp[e] = pr * (dp[e] - dis[c]) * p.scale;
          }
        } else {
#pragma unroll
          for (int e = 0; e < BQ / 2; ++e) {
            const int c = 8 * (e >> 2) + 2 * t + (e & 1);
            const int kj = kw + 16 * warp + g + 8 * ((e >> 1) & 1);
            const float l = lse[c];
            const bool live = l > kHalfMask;
            const float pr =
                edge_p(p, sc[e], scale2, live ? l * kLog2e : 0.f, live, q0 + c, kj, h, b);
            sc[e] = pr;
            dp[e] = pr * (dp[e] - dis[c]) * p.scale;
          }
        }
        uint32_t ap[BQ / 16][4], ads[BQ / 16][4];
        to_a<BQ>(ap, sc);
        to_a<BQ>(ads, dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) mma_rs_mn<DP>(dv, ap[kk], desc_mn<SW>(do_t, BQ, kk));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) mma_rs_mn<DP>(dk, ads[kk], desc_mn<SW>(q_t, BQ, kk));
        wg_commit();
        wg_wait<0>();
        hold(dk);
        hold(dv);
        hold(ap);
        hold(ads);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

    bf16* dk_out = static_cast<bf16*>(p.out0);
    bf16* dv_out = static_cast<bf16*>(p.out1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = kw + 16 * warp + g + 8 * r;
      if (j >= p.Sk) continue;
      // tile column c is column c - o_sh of dK and dV: the D real columns of DP
      const long long row = (((long long)b * p.Sk + j) * p.kvH + kvh) * p.D - o_sh;
#pragma unroll
      for (int n = 0; n < DK / 8; ++n) {
        const int c = 8 * n + 2 * t;
        if (c < o_sh || c >= o_sh + p.D) continue;
        store2(dk_out + row + c, dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
        store2(dv_out + row + c, dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
}

// ---- the CUDA-core kernels: fp32, and bf16 past head_dim 128 ---------------------

// dQ (and di): the DC columns of dQ from c0 = DC * blockIdx.z, over key
// tiles of BK keys

template <typename T, int DW, int DC, int BK>
__global__ void __launch_bounds__(256)
dq_cuda_cores(const FlashParams p, int HB, int BQ) {
  constexpr int LD = DW + kPad;
  constexpr int NT = BK / 8;
  constexpr int DT = DC / 8;
  const int D = p.D, c0 = DC * blockIdx.z;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int G = p.H / p.kvH;
  const int chunks = G / HB;
  const int nq = (p.Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;
  const int q0 = qt * BQ;
  int y = blockIdx.y;
  const int hc = y % chunks;
  y /= chunks;
  const int kvh = y % p.kvH;
  const int b = y / p.kvH;
  const int h0 = kvh * G + hc * HB;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wph = BQ / 16;
  const int hl = warp / wph, rb = warp - hl * wph;
  const int h = h0 + hl;
  const int rows = HB * BQ;

  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + rows * LD;
  float* sK = sdO + rows * LD;
  float* sV = sK + BK * LD;
  int* sKseg = reinterpret_cast<int*>(sV + BK * LD);
  float* scratch = reinterpret_cast<float*>(sKseg + BK) + warp * 16 * (BK + 4);

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int valid_q = min(BQ, p.Sq - q0);
  for (int hh = 0; hh < HB; ++hh) {
    stage_rows<DW>(sQ + hh * BQ * LD, LD, q + b * p.q_sb + (long long)q0 * p.q_ss + (h0 + hh) * p.q_sh,
                   p.q_ss, BQ, valid_q, D, tid, nthreads);
    stage_rows<DW>(sdO + hh * BQ * LD, LD, dout + (((long long)b * p.Sq + q0) * p.H + h0 + hh) * D,
                   (long long)p.H * D, BQ, valid_q, D, tid, nthreads);
  }
  cp_async_commit();

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

  const int i0 = q0 + rb * 16 + g;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  int qseg[2] = {0, 0};
  float lse[2], di[2];
  const T* o = static_cast<const T*>(p.o);
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    const bool in = i < p.Sq;
    const long long row = ((long long)b * p.H + h) * p.Sq + i;
    if (p.qseg != nullptr) qseg[r] = in ? p.qseg[(long long)b * p.Sq + i] : 0;
    lse[r] = in ? p.lse[row] : kMask;
    // di = rowsum(dO * O) - dLSE: each of the row's four lanes sums every
    // fourth column, then the lanes add in a fixed order
    float acc = 0.f;
    if (in) {
      const long long at = (((long long)b * p.Sq + i) * p.H + h) * D;
      for (int c = t; c < D; c += 4) acc += to_f(dout[at + c]) * to_f(o[at + c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (in && p.dlse != nullptr) acc -= p.dlse[row];
    di[r] = in ? acc : 0.f;
    if (in && t == 0 && blockIdx.z == 0) p.di[row] = acc;
  }

  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const float* qw = sQ + (hl * BQ + rb * 16) * LD;
  const float* dow = sdO + (hl * BQ + rb * 16) * LD;
  if (n_tiles > 0) stage(jt_lo);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const int k0 = (jt_lo + it) * BK;
    const float* kt = sK;
    const float* vt = sV;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_nt<NT, DW>(s, qw, LD, kt, LD);
    mma_nt<NT, DW>(dp, dow, LD, vt, LD);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const int ks = p.kseg != nullptr ? sKseg[c] : 0;
        const float sv = masked_logit(p, s[n][e], i0 + 8 * r, k0 + c, slope, qseg[r], ks);
        const float pr = lse[r] > kHalfMask ? expf(sv - lse[r]) : 0.f;
        s[n][e] = round_to<T>(pr * (dp[n][e] - di[r]) * p.scale);  // dS, in k's type
      }
    mma_pv<BK, DT>(dq, s, kt + c0, LD, scratch);
    __syncthreads();
    if (it + 1 < n_tiles) stage(jt_lo + it + 1);
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(p.out0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= p.Sq) continue;
    T* row = out + (((long long)b * p.Sq + i) * p.H + h) * D + c0;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      if (c0 + n * 8 + 2 * t < D) store2(row + n * 8 + 2 * t, dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// dK / dV: the block's DC columns of them, from column c0 = DC * blockIdx.z,
// for KB = 16 x (its warps) keys

template <typename T, int DW, int DC, int BQ2, int KB>
__global__ void __launch_bounds__(128)
dkv_cuda_cores(const FlashParams p) {
  constexpr int LD = DW + kPad;
  constexpr int NT = BQ2 / 8;  // score tiles of 8 query rows
  constexpr int DT = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int G = p.H / p.kvH, D = p.D;
  const int c0 = DC * blockIdx.z;
  const int k0 = blockIdx.x * KB;
  const int kvh = blockIdx.y % p.kvH;
  const int b = blockIdx.y / p.kvH;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + KB * LD;
  float* sQ = sV + KB * LD;         // [BQ2][LD]
  float* sdO = sQ + BQ2 * LD;       // [BQ2][LD]
  float* sLse = reinterpret_cast<float*>(sdO + BQ2 * LD);  // [BQ2]
  float* sDi = sLse + BQ2;
  int* sQseg = reinterpret_cast<int*>(sDi + BQ2);
  float* scratch = reinterpret_cast<float*>(sQseg + BQ2) + warp * 16 * (BQ2 + 4);

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int valid_k = min(KB, p.Sk - k0);
  stage_rows<DW>(sK, LD, k + b * p.k_sb + (long long)k0 * p.k_ss + kvh * p.k_sh, p.k_ss, KB,
                 valid_k, D, tid, nthreads);
  stage_rows<DW>(sV, LD, v + b * p.v_sb + (long long)k0 * p.v_ss + kvh * p.v_sh, p.v_ss, KB,
                 valid_k, D, tid, nthreads);
  cp_async_commit();

  // query tiles that see this key tile: a contiguous range
  const int nq = (p.Sq + BQ2 - 1) / BQ2;
  int it_lo = 0, it_hi = nq;
  while (it_lo < nq && !tile_runs(p, it_lo * BQ2, BQ2, k0, KB)) ++it_lo;
  while (it_hi > it_lo && !tile_runs(p, (it_hi - 1) * BQ2, BQ2, k0, KB)) --it_hi;
  const int per_head = it_hi - it_lo;
  const int n_iter = G * per_head;

  auto stage = [&](int idx) {
    const int gi = idx / per_head;
    const int q0 = (it_lo + idx - gi * per_head) * BQ2;
    const int h = kvh * G + gi;
    const int valid = min(BQ2, p.Sq - q0);
    stage_rows<DW>(sQ, LD, q + b * p.q_sb + (long long)q0 * p.q_ss + h * p.q_sh, p.q_ss, BQ2,
                   valid, D, tid, nthreads);
    stage_rows<DW>(sdO, LD, dout + (((long long)b * p.Sq + q0) * p.H + h) * D,
                   (long long)p.H * D, BQ2, valid, D, tid, nthreads);
    for (int c = tid; c < BQ2; c += nthreads) {
      const int i = q0 + c;
      const bool in = i < p.Sq;
      const long long row = ((long long)b * p.H + h) * p.Sq + i;
      sLse[c] = in ? p.lse[row] : kMask;
      sDi[c] = in ? p.di[row] : 0.f;
      if (p.qseg != nullptr) sQseg[c] = in ? p.qseg[(long long)b * p.Sq + i] : 0;
    }
    cp_async_commit();
  };

  // this thread's two rows of S^T: keys j0 and j0 + 8
  const int j0 = k0 + warp * 16 + g;
  int kseg[2] = {0, 0};
  if (p.kseg != nullptr)
    for (int r = 0; r < 2; ++r)
      kseg[r] = j0 + 8 * r < p.Sk ? p.kseg[(long long)b * p.Sk + j0 + 8 * r] : 0;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const float* kw = sK + warp * 16 * LD;
  const float* vw = sV + warp * 16 * LD;
  if (n_iter > 0) stage(0);
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const int gi = it / per_head;
    const int q0 = (it_lo + it - gi * per_head) * BQ2;
    const int h = kvh * G + gi;
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const float* qt = sQ;
    const float* dot = sdO;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_nt<NT, DW>(s, kw, LD, qt, LD);    // S^T  [16 keys x BQ2 queries]
    mma_nt<NT, DW>(dp, vw, LD, dot, LD);  // dP^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const int qs = p.qseg != nullptr ? sQseg[c] : 0;
        const float sv = masked_logit(p, s[n][e], q0 + c, j0 + 8 * r, slope, qs, kseg[r]);
        const float lse = sLse[c];
        const float pr = lse > kHalfMask ? expf(sv - lse) : 0.f;
        dp[n][e] = round_to<T>(pr * (dp[n][e] - sDi[c]) * p.scale);  // dS^T, in q's type
        s[n][e] = round_to<T>(pr);                                    // P^T, in dO's type
      }
    mma_pv<BQ2, DT>(dv, s, dot + c0, LD, scratch);
    mma_pv<BQ2, DT>(dk, dp, qt + c0, LD, scratch);
    __syncthreads();
    if (it + 1 < n_iter) stage(it + 1);
  }
  cp_async_wait<0>();

  T* dk_out = static_cast<T*>(p.out0);
  T* dv_out = static_cast<T*>(p.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 8 * r;
    if (j >= p.Sk) continue;
    const long long row = (((long long)b * p.Sk + j) * p.kvH + kvh) * D + c0;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      if (c0 + n * 8 + 2 * t >= D) continue;
      store2(dk_out + row + n * 8 + 2 * t, dk[n][2 * r], dk[n][2 * r + 1]);
      store2(dv_out + row + n * 8 + 2 * t, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---- launches -------------------------------------------------------------------

template <int DK>
cudaError_t launch_dq_bf16(const FlashParams& p, cudaStream_t stream) {
  constexpr int SW = Tile<DK>::SW, DP = Tile<DK>::DP, BK = DP > 64 ? 64 : kDqKeys64, ST = 2;
  const int D = p.D;
  CUtensorMap mq, mdo, mo, mk = {}, mv = {};
  const long long oh = D, os = (long long)p.H * D, ob = (long long)p.Sq * os;
  if (!map_heads<SW>(&mq, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh, 64) ||
      !map_heads<SW>(&mdo, p.dout, p.B, p.Sq, p.H, D, ob, os, oh, 64) ||
      !map_heads<SW>(&mo, p.o, p.B, p.Sq, p.H, D, ob, os, oh, 64) ||
      (p.Sk > 0 &&
       (!map_heads<SW>(&mk, p.k, p.B, p.Sk, p.kvH, D, p.k_sb, p.k_ss, p.k_sh, BK) ||
        !map_heads<SW>(&mv, p.v, p.B, p.Sk, p.kvH, D, p.v_sb, p.v_ss, p.v_sh, BK))))
    return cudaErrorInvalidValue;
  const int G = p.H / p.kvH;
  const int HB = G % kDqHeads == 0 ? kDqHeads : 1;
  const int BQ = 64 * (kConsumers / HB);
  const size_t smem = 1024 + (size_t)(3 * kConsumers * 64 + 2 * ST * BK) * DP * 2 + (1 + 2 * ST) * 8;
  cudaError_t err = reserve_smem(dq_wgmma<DK, BK, ST>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.kvH * (G / HB), (p.Sq + BQ - 1) / BQ);
  dq_wgmma<DK, BK, ST><<<grid, kThreads, smem, stream>>>(mq, mdo, mo, mk, mv, p, HB);
  return cudaGetLastError();
}

template <int DK>
cudaError_t launch_dkv_bf16(const FlashParams& p, cudaStream_t stream) {
  constexpr int SW = Tile<DK>::SW, DP = Tile<DK>::DP, BQ = DP > 64 ? kDkvRows128 : 64;
  constexpr int ST = kDkvStages, BKV = 64 * kConsumers;
  const int D = p.D;
  CUtensorMap mq, mdo, mk, mv;
  const long long oh = D, os = (long long)p.H * D, ob = (long long)p.Sq * os;
  if (!map_heads<SW>(&mq, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh, BQ) ||
      !map_heads<SW>(&mdo, p.dout, p.B, p.Sq, p.H, D, ob, os, oh, BQ) ||
      !map_heads<SW>(&mk, p.k, p.B, p.Sk, p.kvH, D, p.k_sb, p.k_ss, p.k_sh, BKV) ||
      !map_heads<SW>(&mv, p.v, p.B, p.Sk, p.kvH, D, p.v_sb, p.v_ss, p.v_sh, BKV))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)(2 * BKV + 2 * ST * BQ) * DP * 2 +
                      (size_t)2 * ST * BQ * sizeof(float) + (1 + 2 * ST) * 8;
  cudaError_t err = reserve_smem(dkv_wgmma<DK, BQ, ST>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.kvH, (p.Sk + BKV - 1) / BKV);
  dkv_wgmma<DK, BQ, ST><<<grid, kThreads, smem, stream>>>(mq, mdo, mk, mv, p);
  return cudaGetLastError();
}

template <typename T, int DW>
cudaError_t launch_dq_cuda_cores(const FlashParams& p, cudaStream_t stream) {
  // at 256 the Q and dO rows of four warps and the K / V tiles pass the
  // shared memory a block may hold: two warps; past 256 one warp, 32-key
  // tiles and 128 columns of dQ a block
  constexpr int DC = DW > 256 ? 128 : DW, BK = DW > 256 ? 32 : kBK, LD = DW + kPad;
  int HB, BQ;
  pick_rows(p.H / p.kvH, DW > 256 ? 1 : DW > 128 ? 2 : kMaxWarps, &HB, &BQ);
  const int warps = HB * BQ / 16;
  const size_t smem = sizeof(float) * (2 * (size_t)HB * BQ * LD + 2 * BK * LD) +
                      sizeof(int) * BK + sizeof(float) * warps * 16 * (BK + 4);
  cudaError_t err = reserve_smem(dq_cuda_cores<T, DW, DC, BK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.kvH * (p.H / p.kvH / HB), DW / DC);
  dq_cuda_cores<T, DW, DC, BK><<<grid, warps * 32, smem, stream>>>(p, HB, BQ);
  return cudaGetLastError();
}

template <typename T, int DW>
cudaError_t launch_dkv_cuda_cores(const FlashParams& p, cudaStream_t stream) {
  // query rows a step and keys a block (16 a warp): bound the registers and,
  // past 256, the shared memory
  constexpr int BQ2 = DW > 256 ? 16 : DW > 64 ? 32 : 64;
  constexpr int WARPS = DW > 256 ? 2 : 4, KB = 16 * WARPS;
  constexpr int DC = DW > 128 ? 128 : DW;  // dK / dV columns a block
  constexpr int LD = DW + kPad;
  const size_t smem = sizeof(float) * (2 * (size_t)KB * LD + 2 * BQ2 * LD) +
                      sizeof(float) * 3 * BQ2 + sizeof(float) * WARPS * 16 * (BQ2 + 4);
  cudaError_t err = reserve_smem(dkv_cuda_cores<T, DW, DC, BQ2, KB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + KB - 1) / KB, p.B * p.kvH, DW / DC);
  dkv_cuda_cores<T, DW, DC, BQ2, KB><<<grid, WARPS * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// The CUDA-core launch of the head_dim's width class (flash_fwd.cu
// cuda_cores): every multiple of 4 up to 128 in fp32 (32, 64 or 128
// columns staged), 256, 384 and 512 in both types.
template <typename T, bool DQ>
cudaError_t cuda_cores(const FlashParams& p, cudaStream_t s) {
#define FLASH_CC(DW) (DQ ? launch_dq_cuda_cores<T, DW>(p, s) : launch_dkv_cuda_cores<T, DW>(p, s))
  if constexpr (sizeof(T) == 4) {
    if (p.D <= 32) return FLASH_CC(32);
    if (p.D <= 64) return FLASH_CC(64);
    if (p.D <= 128) return FLASH_CC(128);
  }
  switch (p.D) {
    case 256: return FLASH_CC(256);
    case 384: return FLASH_CC(384);
    case 512: return FLASH_CC(512);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CC
}

// bf16 up to 128: the wgmma kernels of DK, the columns the products span
// rounded up to 16 (flash_fwd.cu dispatch).
template <bool DQ>
cudaError_t dispatch(const FlashParams& p, bool bf16_in, cudaStream_t s) {
#define FLASH_WG(DK) (DQ ? launch_dq_bf16<DK>(p, s) : launch_dkv_bf16<DK>(p, s))
  if (p.D <= 0 || p.D % (bf16_in ? 2 : 4)) return cudaErrorInvalidValue;
  if (!bf16_in) return cuda_cores<float, DQ>(p, s);
  const bool packed = packed_heads(p.D);
  if (packed && (p.D + kMaxShift > 128 || p.H != p.kvH)) return cudaErrorInvalidValue;
  switch ((p.D + (packed ? kMaxShift : 0) + 15) / 16) {
    case 1: return FLASH_WG(16);
    case 2: return FLASH_WG(32);
    case 3: return FLASH_WG(48);
    case 4: return FLASH_WG(64);
    case 5: return FLASH_WG(80);
    case 6: return FLASH_WG(96);
    case 7: return FLASH_WG(112);
    case 8: return FLASH_WG(128);
    default: return cuda_cores<bf16, DQ>(p, s);
  }
#undef FLASH_WG
}

}  // namespace

// dQ (out0, contiguous [B, Sq, H, D]) and di (the fp32 [B, H, Sq] buffer
// p.di) from q, k, v (strided), o and dO (contiguous), lse and dlse
// ([B, H, Sq] fp32; dlse may be null). Returns the cudaError_t.
extern "C" int dstt_flash_dq(flash::FlashParams p, int is_bf16, void* stream) {
  if (p.B == 0 || p.Sq == 0) return cudaSuccess;
  return dispatch<true>(p, is_bf16 != 0, static_cast<cudaStream_t>(stream));
}

// dK, dV (out0, out1, contiguous [B, Sk, kvH, D]), summed over each kv
// head's query heads, from the inputs of dstt_flash_dq and the di it wrote.
// Returns the cudaError_t.
extern "C" int dstt_flash_dkv(flash::FlashParams p, int is_bf16, void* stream) {
  if (p.B == 0 || p.Sk == 0) return cudaSuccess;
  return dispatch<false>(p, is_bf16 != 0, static_cast<cudaStream_t>(stream));
}
