// Flash attention forward with the row log-sum-exp, for training.
//
// Replaces the TPU kernel _fwd_kernel in
// deepspeed_tpu/ops/transformer/pallas_flash.py (reached through
// flash_attention_with_lse -> _fwd_call -> pl.pallas_call). Same function:
// O = softmax(mask(scale * Q K^T + alibi)) V per query head, with fp32
// online softmax, GQA-native (K/V stay at kv heads), causal on a runtime
// q_offset (bottom-right alignment, may be negative), sliding window,
// segment ids and ALiBi; a row with no visible key gives O = 0 and
// LSE = MASK_VALUE.
//
// Design. The Pallas grid (b*kvH, g, q tile, k tile) ran its key axis in
// order with (m, l, acc) in VMEM scratch. Here one block takes (batch, kv
// head, HB heads of its group, BQ query positions) and loops over the key
// tiles itself; (m, l, acc) stay in registers and nothing crosses blocks.
// The block's HB * BQ rows (HB * BQ / 16 warps of 16 rows) share each K/V
// tile, so a tile is read once per group as in the Pallas [B*kvH, G, Sq, D]
// fold. Q, K and V are read in place through their [B, S, H, D] strides;
// tiles of 64 keys are staged with cp.async (two in flight for bf16), the
// ragged edge zero-filled and masked, so any Sq and Sk work. Q K^T and P V
// run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; p
// is cast to bf16 before P V as the Pallas kernel casts it to v's dtype);
// fp32 inputs take the same code with the products on the CUDA cores.
// Key tiles that no row of the block can see are never visited
// (_should_run). Blocks start with the last query tiles, which see the most
// keys under a causal mask.
//
// Bound on an H100 SXM: operations. Causal attention at the training shape
// (S 2048, D 64) does 4 * D flops per visible (query, key) pair on 2 bytes
// per element of traffic; the tensor-core rate (989 TFLOP/s bf16) is the
// limit. What this simple design leaves: mma.sync rather than wgmma, no TMA,
// fragments reloaded from shared memory every tile, and with BQ = 16 rows
// per head at GQA g = 8 each block redoes the causal diagonal tile's masked
// work. Measured against the bound in PERF.md.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_fwd_kernel(const FlashParams p, int HB, int BQ) {
  constexpr int LD = D + Traits<T>::kPad;
  constexpr int STAGES = Traits<T>::kStages;
  constexpr int NT = kBK / 8;  // score tiles of 8 keys
  constexpr int DT = D / 8;    // output tiles of 8 columns
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

  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + rows * LD;                       // [STAGES][kBK][LD]
  T* sV = sK + STAGES * kBK * LD;               // [STAGES][kBK][LD]
  int* sKseg = reinterpret_cast<int*>(sV + STAGES * kBK * LD);  // [STAGES][kBK]
  float* scratch = reinterpret_cast<float*>(sKseg + STAGES * kBK) + warp * 16 * (kBK + 4);

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int valid_q = min(BQ, p.Sq - q0);
  for (int hh = 0; hh < HB; ++hh)
    stage_rows<T, D>(sQ + hh * BQ * LD, LD, q + b * p.q_sb + (long long)q0 * p.q_ss + (h0 + hh) * p.q_sh,
                     p.q_ss, BQ, valid_q, tid, nthreads);
  cp_async_commit();

  // key tiles the block can see
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

  const T* qw = sQ + (hl * BQ + rb * 16) * LD;
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

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_nt<NT, D>(s, qw, LD, sK + buf * kBK * LD, LD);

    float mx[2] = {kMask, kMask};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = n * 8 + 2 * t + (e & 1);
        const int ks = p.kseg != nullptr ? sKseg[buf * kBK + c] : 0;
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
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];  // this lane's columns
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    mma_pv<kBK, DT>(acc, s, sV + buf * kBK * LD, LD, scratch);
    __syncthreads();  // this buffer is free for the next stage
    if (STAGES == 1 && it + 1 < n_tiles) stage(jt_lo + it + 1, 0);
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
    T* orow = o + (((long long)b * p.Sq + i) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      store2(orow + n * 8 + 2 * t, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0)
      lse[((long long)b * p.H + h) * p.Sq + i] =
          l[r] == 0.f ? kMask : fmaxf(m[r], kHalfMask) + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int LD = D + Traits<T>::kPad;
  constexpr int STAGES = Traits<T>::kStages;
  int HB, BQ;
  pick_rows(p.H / p.kvH, Traits<T>::kMaxWarps, &HB, &BQ);
  const int warps = HB * BQ / 16;
  const size_t smem = sizeof(T) * ((size_t)HB * BQ * LD + 2 * STAGES * kBK * LD) +
                      sizeof(int) * STAGES * kBK +
                      (sizeof(T) == 4 ? sizeof(float) * warps * 16 * (kBK + 4) : 0);
  cudaError_t err = reserve_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.kvH * (p.H / p.kvH / HB));
  flash_fwd_kernel<T, D><<<grid, warps * 32, smem, stream>>>(p, HB, BQ);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FlashParams& p, cudaStream_t s) {
  switch (p.D) {
    case 32: return launch<T, 32>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 128: return launch<T, 128>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H, D], k / v [B, Sk, kvH, D] (strided rows, unit last stride);
// writes O (out0, contiguous [B, Sq, H, D]) and LSE (out1, [B, H, Sq] fp32).
// Returns the cudaError_t of the launch.
extern "C" int dstt_flash_fwd(flash::FlashParams p, int is_bf16, void* stream) {
  if (p.B == 0 || p.Sq == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<flash::bf16>(p, s) : dispatch<float>(p, s);
}
