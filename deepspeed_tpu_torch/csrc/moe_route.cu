// Top-k routing of the mixture of experts with the capacity-slot scatter, in
// one launch over the router logits [T, E], fp32 or bf16 (cast to fp32 as
// they are loaded; the cast is exact):
//
//   gates = softmax(logits); picks = top-k of the gates (lowest index on ties)
//   pos   = rank among the tokens with the same pick + the expert's kept total
//           of the earlier choices;  keep = pos < cap
//   w     = kept gates / max(sum of the token's kept gates, 1e-9)
//   src[e * cap + pos] = t + 1, slot_w[...] = w        (0 where no token lands)
//   slot_tk[t, k] = e * cap + pos or 0, w_tk[t, k] = w or 0
//   me[e] = mean gate, ce[e] = share of first picks
//
// Replaces the TPU kernel _route_kernel in
// deepspeed_tpu/ops/transformer/pallas_moe.py (via moe_route). Same function,
// the fp32 operations of top_k_gating_indices in its order: max, exp of the
// difference, the sum over the experts in index order, one divide; the picks
// as a masked re-argmax; positions choice by choice; the gate times the keep
// flag; the sum of the kept gates from 0; one divide. The plain version
// (deepspeed_tpu_torch/moe/sharded_moe.py) computes the same sequence, so
// picks, positions, keep flags, src and slot_tk agree bit for bit, and so do
// the weights wherever the two exp functions agree (both are expf here).
// me is summed in another order than torch's mean: it agrees to an ulp.
//
// Bound on an H100 SXM: neither bytes nor operations (T * E * 4 bytes in, a
// few times that out) but the launch and a chain of dependent steps: load
// the row, softmax, picks, a rank among the tokens, a scan over the ranks'
// counts, the scatter. The design shortens the chain:
// - each thread holds one token; its gates stay in registers from the
//   softmax to the weights (E is a template bound, every loop over it
//   unrolled, the picked gate taken in the pick loop: no local memory);
// - T <= 32: one warp and no block barrier. __match_any_sync ranks a token
//   among the lanes with the same pick, one ballot an expert counts the
//   first picks (choice 1 starts from their kept totals), butterflies sum
//   the gates for me; the warp zero-fills src / slot_w, __syncwarp, and
//   each lane scatters its own slots;
// - above: one block walks the tokens in chunks of its size with two
//   __syncthreads a chunk. Choice 1's positions are its own ranks plus
//   choice 0's kept totals, a per-expert constant known after the last
//   chunk, so both choices' ranks are counted in one pass: each warp writes
//   its count of each (choice, expert), then one warp a column scans the
//   warps' counts with __shfl_up_sync from a running base that carries the
//   ranks across chunks (buffers alternate between chunks). The last
//   chunk's tokens finish from registers; an earlier chunk's park their
//   pick, unclamped position and gate in slot_tk / w_tk and finish after
//   the loop. Each kept (t, k) owns a distinct slot, so the scatter has no
//   races, and every sum has a fixed order: two runs give the same bits;
// - programmatic dependent launch: the route's launch overlaps the router
//   product's tail (it waits for it before reading anything), and it lets
//   the dispatch gather launch at its start.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Everything a launch reads, passed by value.
struct MoeRouteParams {
  const void* logits;    // [T, E], fp32 or bf16 (bf16 != 0)
  int* src;              // [E * cap]
  float* slot_w;         // [E * cap]
  int* slot_tk;          // [T, K]
  float* w_tk;           // [T, K]
  float* me;             // [E]
  float* ce;             // [E]
  int T, E, K, cap, bf16;
};

namespace {

constexpr int kMaxE = 64;
constexpr int kMaxT = 1 << 24;   // an earlier chunk parks (position << 6 | expert)
// Programmatic dependent launch: the route launched to overlap the kernel
// before it (the router product), waiting for it before touching memory.
// Its kernels always let the next launch (the dispatch gather) start early.
constexpr bool kRoutePdl = true;

__device__ __forceinline__ void pdl_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One token's route before its position: gates g (0 past E), picks e0 / e1
// and their gates (e1 -1 when K == 1).
template <int kE>
struct Token {
  float g[kE];
  int e0, e1;
  float g0, g1;
};

// Softmax of row t and the masked re-argmax picks; a dead lane (t >= T)
// gets zero gates and picks -1.
template <int kE, typename In>
__device__ __forceinline__ void route_token(const In* logits, int t, int T, int E, int K,
                                            Token<kE>& r) {
  const bool live = t < T;
  float x[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e)
    x[e] = (live && e < E) ? to_f32(logits[(long long)t * E + e]) : 0.f;
  float m = x[0];
#pragma unroll
  for (int e = 1; e < kE; ++e)
    if (e < E) m = fmaxf(m, x[e]);
#pragma unroll
  for (int e = 0; e < kE; ++e) r.g[e] = e < E ? expf(x[e] - m) : 0.f;
  float s = r.g[0];
#pragma unroll
  for (int e = 1; e < kE; ++e)
    if (e < E) s = __fadd_rn(s, r.g[e]);
#pragma unroll
  for (int e = 0; e < kE; ++e) r.g[e] = live ? __fdiv_rn(r.g[e], s) : 0.f;
  r.e0 = 0, r.g0 = r.g[0];
#pragma unroll
  for (int e = 1; e < kE; ++e)
    if (e < E && r.g[e] > r.g0) r.e0 = e, r.g0 = r.g[e];
  r.e1 = -1, r.g1 = 0.f;
  if (K == 2) {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (e < E && e != r.e0 && (r.e1 < 0 || r.g[e] > r.g1)) r.e1 = e, r.g1 = r.g[e];
  }
  if (!live) r.e0 = r.e1 = -1;
}

// Token t's weights, slot_tk / w_tk and its slots in src / slot_w, from its
// picks, positions and gates.
__device__ __forceinline__ void finish(const MoeRouteParams& p, int t, int e0, int pos0,
                                       float g0, int e1, int pos1, float g1) {
  const int K = p.K, cap = p.cap;
  const bool keep0 = pos0 < cap, keep1 = K == 2 && pos1 < cap;
  const float gk0 = __fmul_rn(g0, keep0 ? 1.f : 0.f);
  const float gk1 = __fmul_rn(g1, keep1 ? 1.f : 0.f);
  float sum = __fadd_rn(0.f, gk0);
  if (K == 2) sum = __fadd_rn(sum, gk1);
  const float denom = fmaxf(sum, 1e-9f);
  const float w0 = __fdiv_rn(gk0, denom);
  const int slot0 = e0 * cap + pos0;
  p.slot_tk[(long long)t * K] = keep0 ? slot0 : 0;
  p.w_tk[(long long)t * K] = __fmul_rn(w0, keep0 ? 1.f : 0.f);
  if (keep0) p.src[slot0] = t + 1, p.slot_w[slot0] = w0;
  if (K == 2) {
    const float w1 = __fdiv_rn(gk1, denom);
    const int slot1 = e1 * cap + pos1;
    p.slot_tk[(long long)t * K + 1] = keep1 ? slot1 : 0;
    p.w_tk[(long long)t * K + 1] = __fmul_rn(w1, keep1 ? 1.f : 0.f);
    if (keep1) p.src[slot1] = t + 1, p.slot_w[slot1] = w1;
  }
}

// src and slot_w zeroed by `n` threads, 16 bytes a store where aligned.
__device__ __forceinline__ void zero_slots(const MoeRouteParams& p, int i0, int n) {
  const int S = p.E * p.cap;
  if (((S & 3) | ((uintptr_t)p.src & 15) | ((uintptr_t)p.slot_w & 15)) == 0) {
    for (int i = i0; i < S / 4; i += n) {
      reinterpret_cast<int4*>(p.src)[i] = make_int4(0, 0, 0, 0);
      reinterpret_cast<float4*>(p.slot_w)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = i0; i < S; i += n) p.src[i] = 0, p.slot_w[i] = 0.f;
  }
}

// T <= 32: lane t holds token t; no block barrier.
template <int kE, typename In>
__global__ void __launch_bounds__(32) moe_route_warp(const MoeRouteParams p) {
  pdl_start();
  const int lane = threadIdx.x;
  const int T = p.T, E = kE == 8 ? 8 : p.E, K = p.K, cap = p.cap;
  Token<kE> r;
  route_token<kE>(static_cast<const In*>(p.logits), lane, T, E, K, r);
  zero_slots(p, lane, 32);
  const unsigned below = (1u << lane) - 1u;
  const int rank0 = __popc(__match_any_sync(0xffffffffu, r.e0) & below);
  const int rank1 = __popc(__match_any_sync(0xffffffffu, r.e1) & below);
  int base1 = 0;            // choice 0's kept total of this lane's second pick
  int cnt[(kE + 31) / 32];  // lane e % 32 keeps expert e's first picks and gate sum
  float sum[(kE + 31) / 32];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    if (e >= E) break;
    const int c = __popc(__ballot_sync(0xffffffffu, r.e0 == e));
    if (r.e1 == e) base1 = min(c, cap);
    float v = r.g[e];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    if ((e & 31) == lane) cnt[e >> 5] = c, sum[e >> 5] = v;
  }
#pragma unroll
  for (int j = 0; j < (kE + 31) / 32; ++j) {
    const int e = j * 32 + lane;
    if (e < E) p.me[e] = sum[j] / (float)T, p.ce[e] = (float)cnt[j] / (float)T;
  }
  __syncwarp();   // the zero fill before any lane's scatter
  if (lane < T) finish(p, lane, r.e0, rank0, r.g0, r.e1, rank1 + base1, r.g1);
}

// T > 32: one block of kThreads (or fewer) threads, chunks of blockDim tokens.
template <int kE, int kThreads, typename In>
__global__ void __launch_bounds__(kThreads) moe_route_block(const MoeRouteParams p) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_cnt[2][kWarps][2 * kE];   // a warp's count of each (choice, expert),
                                             // then its first position; two chunks' buffers
  __shared__ float s_me[kWarps][kE];         // a warp's gate sums (last chunk)
  __shared__ int s_base[2 * kE];             // running position of each (choice, expert)
  pdl_start();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const int T = p.T, E = kE == 8 ? 8 : p.E, K = p.K, cap = p.cap;
  const int cols = K * kE;
  const In* logits = static_cast<const In*>(p.logits);
  for (int i = tid; i < 2 * kE; i += nthr) s_base[i] = 0;
  zero_slots(p, tid, nthr);
  float me[kE];   // this thread's gate sums over its tokens
#pragma unroll
  for (int e = 0; e < kE; ++e) me[e] = 0.f;
  const unsigned below = (1u << lane) - 1u;
  const int last = (T - 1) / nthr * nthr;   // the last chunk's first token
  for (int c0 = 0, buf = 0; c0 < T; c0 += nthr, buf ^= 1) {
    const int t = c0 + tid;
    Token<kE> r;
    route_token<kE>(logits, t, T, E, K, r);
#pragma unroll
    for (int e = 0; e < kE; ++e) me[e] += r.g[e];
    int* cnt = s_cnt[buf][warp];
    for (int i = lane; i < cols; i += 32) cnt[i] = 0;
    const unsigned peers0 = __match_any_sync(0xffffffffu, r.e0);
    const unsigned peers1 = __match_any_sync(0xffffffffu, r.e1);
    const int rank0 = __popc(peers0 & below), rank1 = __popc(peers1 & below);
    __syncwarp();
    if (r.e0 >= 0 && rank0 == 0) cnt[r.e0] = __popc(peers0);
    if (r.e1 >= 0 && rank1 == 0) cnt[kE + r.e1] = __popc(peers1);
    if (c0 == last) {   // the gate sums, summed over the warp's lanes
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        float v = me[e];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
        if (lane == 0) s_me[warp][e] = v;
      }
    }
    __syncthreads();
    // one warp a column: the warps' counts scanned in warp order from the
    // running base; in the last chunk also the totals' me and ce
    for (int col = warp; col < cols; col += nwarps) {
      const int n = lane < nwarps ? s_cnt[buf][lane][col] : 0;
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      const int base = s_base[col];
      if (lane < nwarps) s_cnt[buf][lane][col] = base + incl - n;
      const int total = base + __shfl_sync(0xffffffffu, incl, 31);
      if (c0 == last && col < E) {
        float v = lane < nwarps ? s_me[lane][col] : 0.f;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
        if (lane == 0) p.me[col] = v / (float)T, p.ce[col] = (float)total / (float)T;
      }
      __syncwarp();
      if (lane == 0) s_base[col] = total;
    }
    __syncthreads();
    const int pos0 = r.e0 >= 0 ? s_cnt[buf][warp][r.e0] + rank0 : 0;
    const int pos1 = r.e1 >= 0 ? s_cnt[buf][warp][kE + r.e1] + rank1 : 0;   // before the base
    if (t >= T) continue;
    if (c0 == last) {
      finish(p, t, r.e0, pos0, r.g0, r.e1, K == 2 ? pos1 + min(s_base[r.e1], cap) : 0, r.g1);
    } else {   // parked until choice 0's kept totals are known
      p.slot_tk[(long long)t * K] = pos0 << 6 | r.e0;
      p.w_tk[(long long)t * K] = r.g0;
      if (K == 2) {
        p.slot_tk[(long long)t * K + 1] = pos1 << 6 | r.e1;
        p.w_tk[(long long)t * K + 1] = r.g1;
      }
    }
  }
  // the earlier chunks' tokens: each thread reads back only what it parked
  for (int t = tid; t < last; t += nthr) {
    const int a = p.slot_tk[(long long)t * K];
    const int b = K == 2 ? p.slot_tk[(long long)t * K + 1] : 0;
    const float g0 = p.w_tk[(long long)t * K], g1 = K == 2 ? p.w_tk[(long long)t * K + 1] : 0.f;
    const int e1 = b & 63;
    finish(p, t, a & 63, a >> 6, g0, e1, K == 2 ? (b >> 6) + min(s_base[e1], cap) : 0, g1);
  }
}

template <int kE, int kThreads, typename In>
int launch(const MoeRouteParams& p, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {dim3(1), dim3(32), 0, stream, &attr, kRoutePdl ? 1u : 0u};
  if (p.T <= 32) return cudaLaunchKernelEx(&cfg, moe_route_warp<kE, In>, p);
  cfg.blockDim = dim3(min(kThreads, (p.T + 31) / 32 * 32));
  return cudaLaunchKernelEx(&cfg, moe_route_block<kE, kThreads, In>, p);
}

template <typename In>
int dispatch(const MoeRouteParams& p, cudaStream_t stream) {
  // Mixtral's E = 8 with E fixed at compile time; any other E <= 64 through
  // the generic form, in blocks of 256 (its gates and sums take ~150
  // registers a thread)
  return p.E == 8 ? launch<8, 1024, In>(p, stream) : launch<kMaxE, 256, In>(p, stream);
}

}  // namespace

// The route of T tokens over E <= 64 experts, top_k K in {1, 2}, capacity
// cap, from fp32 (bf16 == 0) or bf16 logits; returns the cudaError_t.
extern "C" int dstt_moe_route(MoeRouteParams p, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (p.E < 1 || p.E > kMaxE || p.K < 1 || p.K > 2 || p.K > p.E || p.T < 1 || p.T > kMaxT ||
      p.cap < 1)
    return cudaErrorInvalidValue;
  return p.bf16 ? dispatch<__nv_bfloat16>(p, stream) : dispatch<float>(p, stream);
}
