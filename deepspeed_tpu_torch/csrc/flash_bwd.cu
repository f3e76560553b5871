// Flash attention backward: dQ, and dK / dV summed over each GQA group.
//
// Replaces the TPU kernels _dq_kernel and _dkv_kernel in
// deepspeed_tpu/ops/transformer/pallas_flash.py (reached through the
// custom-VJP backward _flash_bwd -> _bwd_call -> pl.pallas_call). Both
// recompute each score tile from Q, K and the forward's saved row LSE
// (P = exp(s - lse), 0 on rows with no visible key, _masked_p) and use
// di = rowsum(dO * O) - dLSE, computed by the wrapper:
//
//   dS = P * (dO V^T - di) * scale
//   dQ = dS K            dK = sum over the group's heads of dS^T Q
//                        dV = sum over the group's heads of P^T dO
//
// Masks, ragged edges and the tile skip are the forward's
// (flash_common.cuh).
//
// dQ (dstt_flash_dq): the forward's walk. One block per (batch, kv head,
// heads of the group, query tile) loops over the key tiles it can see;
// dQ accumulates in registers.
//
// dK/dV (dstt_flash_dkv): one block per (batch, kv head, tile of 64 keys),
// 4 warps of 16 keys. The Pallas kernel accumulated over a sequential
// (g, q tile) grid axis in VMEM scratch; here that is a loop inside the
// block over every query head of the group and every query tile that can
// see the keys, with dK and dV in registers. No atomics: every run gives
// the same bits. The block computes S^T = K Q^T directly, so P^T, dP^T and
// dS^T come out in the accumulator layout that feeds the next product.
//
// Products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate; P and dS are cast to the input type before their products,
// as the Pallas kernels cast them), on the CUDA cores in fp32 for fp32
// inputs.
//
// Bound on an H100 SXM: operations. The backward does 2.5x the forward's
// tensor-core work (dP, dQ, dK, dV and the recomputed S) on the same
// bytes. What the simple design leaves: both kernels recompute S and P
// (FlashAttention-2 computes dQ inside the dK/dV walk with atomics; this
// port keeps the Pallas split, deterministic), mma.sync and no TMA.
#include "flash_common.cuh"

namespace {

using namespace flash;

// ---- dQ ---------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_dq_kernel(const FlashParams p, int HB, int BQ) {
  constexpr int LD = D + Traits<T>::kPad;
  constexpr int STAGES = Traits<T>::kStages;
  constexpr int NT = kBK / 8;
  constexpr int DT = D / 8;
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

  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + rows * LD;
  T* sK = sdO + rows * LD;
  T* sV = sK + STAGES * kBK * LD;
  int* sKseg = reinterpret_cast<int*>(sV + STAGES * kBK * LD);
  float* scratch = reinterpret_cast<float*>(sKseg + STAGES * kBK) + warp * 16 * (kBK + 4);

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int valid_q = min(BQ, p.Sq - q0);
  for (int hh = 0; hh < HB; ++hh) {
    stage_rows<T, D>(sQ + hh * BQ * LD, LD, q + b * p.q_sb + (long long)q0 * p.q_ss + (h0 + hh) * p.q_sh,
                     p.q_ss, BQ, valid_q, tid, nthreads);
    stage_rows<T, D>(sdO + hh * BQ * LD, LD, dout + (((long long)b * p.Sq + q0) * p.H + h0 + hh) * D,
                     (long long)p.H * D, BQ, valid_q, tid, nthreads);
  }
  cp_async_commit();

  int k_lo = 0, k_hi = p.Sk;
  if (p.causal) {
    k_hi = min(p.Sk, p.q_offset + q0 + BQ);
    if (p.window > 0) k_lo = max(0, p.q_offset + q0 - p.window + 1);
  }
  const int jt_lo = k_lo / kBK;
  const int jt_hi = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;
  const int n_tiles = max(0, jt_hi - jt_lo);

  auto stage = [&](int jt, int buf) {
    const int k0 = jt * kBK;
    const int valid = min(kBK, p.Sk - k0);
    stage_rows<T, D>(sK + buf * kBK * LD, LD, k + b * p.k_sb + (long long)k0 * p.k_ss + kvh * p.k_sh,
                     p.k_ss, kBK, valid, tid, nthreads);
    stage_rows<T, D>(sV + buf * kBK * LD, LD, v + b * p.v_sb + (long long)k0 * p.v_ss + kvh * p.v_sh,
                     p.v_ss, kBK, valid, tid, nthreads);
    if (p.kseg != nullptr)
      for (int c = tid; c < kBK; c += nthreads)
        sKseg[buf * kBK + c] = k0 + c < p.Sk ? p.kseg[(long long)b * p.Sk + k0 + c] : 0;
    cp_async_commit();
  };

  const int i0 = q0 + rb * 16 + g;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  int qseg[2] = {0, 0};
  float lse[2], di[2];
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    const bool in = i < p.Sq;
    if (p.qseg != nullptr) qseg[r] = in ? p.qseg[(long long)b * p.Sq + i] : 0;
    lse[r] = in ? p.lse[((long long)b * p.H + h) * p.Sq + i] : kMask;
    di[r] = in ? p.di[((long long)b * p.H + h) * p.Sq + i] : 0.f;
  }

  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const T* qw = sQ + (hl * BQ + rb * 16) * LD;
  const T* dow = sdO + (hl * BQ + rb * 16) * LD;
  if (n_tiles > 0) stage(jt_lo, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = STAGES == 2 ? (it & 1) : 0;
    if (STAGES == 2 && it + 1 < n_tiles) {
      stage(jt_lo + it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (jt_lo + it) * kBK;
    const T* kt = sK + buf * kBK * LD;
    const T* vt = sV + buf * kBK * LD;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_nt<NT, D>(s, qw, LD, kt, LD);
    mma_nt<NT, D>(dp, dow, LD, vt, LD);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const int ks = p.kseg != nullptr ? sKseg[buf * kBK + c] : 0;
        const float sv = masked_logit(p, s[n][e], i0 + 8 * r, k0 + c, slope, qseg[r], ks);
        const float pr = lse[r] > kHalfMask ? expf(sv - lse[r]) : 0.f;
        s[n][e] = pr * (dp[n][e] - di[r]) * p.scale;  // dS
      }
    mma_pv<kBK, DT>(dq, s, kt, LD, scratch);
    __syncthreads();
    if (STAGES == 1 && it + 1 < n_tiles) stage(jt_lo + it + 1, 0);
  }
  cp_async_wait<0>();

  T* out = static_cast<T*>(p.out0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= p.Sq) continue;
    T* row = out + (((long long)b * p.Sq + i) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) store2(row + n * 8 + 2 * t, dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// ---- dK / dV ------------------------------------------------------------------

template <typename T, int D, int BQ2>
__global__ void __launch_bounds__(128)
flash_dkv_kernel(const FlashParams p) {
  constexpr int LD = D + Traits<T>::kPad;
  constexpr int STAGES = Traits<T>::kStages;
  constexpr int NT = BQ2 / 8;  // score tiles of 8 query rows
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int G = p.H / p.kvH;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y % p.kvH;
  const int b = blockIdx.y / p.kvH;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kBK * LD;
  T* sQ = sV + kBK * LD;               // [STAGES][BQ2][LD]
  T* sdO = sQ + STAGES * BQ2 * LD;     // [STAGES][BQ2][LD]
  float* sLse = reinterpret_cast<float*>(sdO + STAGES * BQ2 * LD);  // [STAGES][BQ2]
  float* sDi = sLse + STAGES * BQ2;
  int* sQseg = reinterpret_cast<int*>(sDi + STAGES * BQ2);
  float* scratch = reinterpret_cast<float*>(sQseg + STAGES * BQ2) + warp * 16 * (BQ2 + 4);

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int valid_k = min(kBK, p.Sk - k0);
  stage_rows<T, D>(sK, LD, k + b * p.k_sb + (long long)k0 * p.k_ss + kvh * p.k_sh, p.k_ss, kBK,
                   valid_k, tid, nthreads);
  stage_rows<T, D>(sV, LD, v + b * p.v_sb + (long long)k0 * p.v_ss + kvh * p.v_sh, p.v_ss, kBK,
                   valid_k, tid, nthreads);
  cp_async_commit();

  // query tiles that see this key tile: a contiguous range
  const int nq = (p.Sq + BQ2 - 1) / BQ2;
  int it_lo = 0, it_hi = nq;
  while (it_lo < nq && !tile_runs(p, it_lo * BQ2, BQ2, k0, kBK)) ++it_lo;
  while (it_hi > it_lo && !tile_runs(p, (it_hi - 1) * BQ2, BQ2, k0, kBK)) --it_hi;
  const int per_head = it_hi - it_lo;
  const int n_iter = G * per_head;

  auto stage = [&](int idx, int buf) {
    const int gi = idx / per_head;
    const int q0 = (it_lo + idx - gi * per_head) * BQ2;
    const int h = kvh * G + gi;
    const int valid = min(BQ2, p.Sq - q0);
    stage_rows<T, D>(sQ + buf * BQ2 * LD, LD, q + b * p.q_sb + (long long)q0 * p.q_ss + h * p.q_sh,
                     p.q_ss, BQ2, valid, tid, nthreads);
    stage_rows<T, D>(sdO + buf * BQ2 * LD, LD, dout + (((long long)b * p.Sq + q0) * p.H + h) * D,
                     (long long)p.H * D, BQ2, valid, tid, nthreads);
    for (int c = tid; c < BQ2; c += nthreads) {
      const int i = q0 + c;
      const bool in = i < p.Sq;
      const long long row = ((long long)b * p.H + h) * p.Sq + i;
      sLse[buf * BQ2 + c] = in ? p.lse[row] : kMask;
      sDi[buf * BQ2 + c] = in ? p.di[row] : 0.f;
      if (p.qseg != nullptr) sQseg[buf * BQ2 + c] = in ? p.qseg[(long long)b * p.Sq + i] : 0;
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

  const T* kw = sK + warp * 16 * LD;
  const T* vw = sV + warp * 16 * LD;
  if (n_iter > 0) stage(0, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int buf = STAGES == 2 ? (it & 1) : 0;
    if (STAGES == 2 && it + 1 < n_iter) {
      stage(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int gi = it / per_head;
    const int q0 = (it_lo + it - gi * per_head) * BQ2;
    const int h = kvh * G + gi;
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const T* qt = sQ + buf * BQ2 * LD;
    const T* dot = sdO + buf * BQ2 * LD;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_nt<NT, D>(s, kw, LD, qt, LD);    // S^T  [16 keys x BQ2 queries]
    mma_nt<NT, D>(dp, vw, LD, dot, LD);  // dP^T
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const int qs = p.qseg != nullptr ? sQseg[buf * BQ2 + c] : 0;
        const float sv = masked_logit(p, s[n][e], q0 + c, j0 + 8 * r, slope, qs, kseg[r]);
        const float lse = sLse[buf * BQ2 + c];
        const float pr = lse > kHalfMask ? expf(sv - lse) : 0.f;
        s[n][e] = pr;                                               // P^T
        dp[n][e] = pr * (dp[n][e] - sDi[buf * BQ2 + c]) * p.scale;  // dS^T
      }
    mma_pv<BQ2, DT>(dv, s, dot, LD, scratch);
    mma_pv<BQ2, DT>(dk, dp, qt, LD, scratch);
    __syncthreads();
    if (STAGES == 1 && it + 1 < n_iter) stage(it + 1, 0);
  }
  cp_async_wait<0>();

  T* dk_out = static_cast<T*>(p.out0);
  T* dv_out = static_cast<T*>(p.out1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 8 * r;
    if (j >= p.Sk) continue;
    const long long row = (((long long)b * p.Sk + j) * p.kvH + kvh) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      store2(dk_out + row + n * 8 + 2 * t, dk[n][2 * r], dk[n][2 * r + 1]);
      store2(dv_out + row + n * 8 + 2 * t, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---- launches -------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq(const FlashParams& p, cudaStream_t stream) {
  constexpr int LD = D + Traits<T>::kPad;
  constexpr int STAGES = Traits<T>::kStages;
  int HB, BQ;
  pick_rows(p.H / p.kvH, Traits<T>::kMaxWarps, &HB, &BQ);
  const int warps = HB * BQ / 16;
  const size_t smem = sizeof(T) * (2 * (size_t)HB * BQ * LD + 2 * STAGES * kBK * LD) +
                      sizeof(int) * STAGES * kBK +
                      (sizeof(T) == 4 ? sizeof(float) * warps * 16 * (kBK + 4) : 0);
  cudaError_t err = reserve_smem(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.kvH * (p.H / p.kvH / HB));
  flash_dq_kernel<T, D><<<grid, warps * 32, smem, stream>>>(p, HB, BQ);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const FlashParams& p, cudaStream_t stream) {
  constexpr int BQ2 = D > 64 ? 32 : 64;  // query rows a step: bounds the registers
  constexpr int LD = D + Traits<T>::kPad;
  constexpr int STAGES = Traits<T>::kStages;
  const size_t smem = sizeof(T) * (2 * (size_t)kBK * LD + 2 * STAGES * BQ2 * LD) +
                      sizeof(float) * 3 * STAGES * BQ2 +
                      (sizeof(T) == 4 ? sizeof(float) * 4 * 16 * (BQ2 + 4) : 0);
  cudaError_t err = reserve_smem(flash_dkv_kernel<T, D, BQ2>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kBK - 1) / kBK, p.B * p.kvH);
  flash_dkv_kernel<T, D, BQ2><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const FlashParams& p, cudaStream_t s) {
  switch (p.D) {
    case 32: return launch_dq<T, 32>(p, s);
    case 64: return launch_dq<T, 64>(p, s);
    case 128: return launch_dq<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const FlashParams& p, cudaStream_t s) {
  switch (p.D) {
    case 32: return launch_dkv<T, 32>(p, s);
    case 64: return launch_dkv<T, 64>(p, s);
    case 128: return launch_dkv<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dQ (out0, contiguous [B, Sq, H, D]) from q, k, v (strided), dO
// (contiguous), lse and di ([B, H, Sq] fp32). Returns the cudaError_t.
extern "C" int dstt_flash_dq(flash::FlashParams p, int is_bf16, void* stream) {
  if (p.B == 0 || p.Sq == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_dq<flash::bf16>(p, s) : dispatch_dq<float>(p, s);
}

// dK, dV (out0, out1, contiguous [B, Sk, kvH, D]), summed over each kv
// head's query heads. Returns the cudaError_t.
extern "C" int dstt_flash_dkv(flash::FlashParams p, int is_bf16, void* stream) {
  if (p.B == 0 || p.Sk == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_dkv<flash::bf16>(p, s) : dispatch_dkv<float>(p, s);
}
