// Top-k routing of the mixture of experts with the capacity-slot scatter, in
// one launch over the router logits [T, E] fp32:
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
// few times that out); a chain of dependent steps, each a block-wide scan.
// The Pallas kernel runs its grid of one step in order; here one block of
// 1024 threads walks the tokens in chunks of 1024, choice by choice (choice
// k's positions start from choice k - 1's kept totals): within a warp the
// rank is the count of lower lanes with the same pick (__match_any_sync), the
// warps' counts are scanned in warp order by one thread an expert, and a
// running base carries the ranks from chunk to chunk. The positions wait in
// slot_tk until every choice is placed; a last pass computes the weights and
// scatters src / slot_w. Each kept (t, k) owns a distinct slot, so the
// scatter has no races.
#include <cuda_runtime.h>
#include <math.h>

// Everything a launch reads, passed by value.
struct MoeRouteParams {
  const float* logits;   // [T, E]
  int* src;              // [E * cap]
  float* slot_w;         // [E * cap]
  int* slot_tk;          // [T, K]
  float* w_tk;           // [T, K]
  float* me;             // [E]
  float* ce;             // [E]
  int T, E, K, cap;
};

namespace {

constexpr int kMaxE = 64;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void softmax_row(const float* row, int E, float (&g)[kMaxE]) {
  float m = row[0];
  for (int e = 1; e < E; ++e) m = fmaxf(m, row[e]);
  for (int e = 0; e < E; ++e) g[e] = expf(row[e] - m);
  float s = g[0];
  for (int e = 1; e < E; ++e) s = __fadd_rn(s, g[e]);
  for (int e = 0; e < E; ++e) g[e] = __fdiv_rn(g[e], s);
}

// argmax over the gates other than `skip`: the first maximum
__device__ __forceinline__ int pick(const float (&g)[kMaxE], int E, int skip) {
  int best = -1;
  float bv = 0.f;
  for (int e = 0; e < E; ++e) {
    if (e == skip) continue;
    if (best < 0 || g[e] > bv) best = e, bv = g[e];
  }
  return best;
}

__device__ __forceinline__ int pick_k(const float (&g)[kMaxE], int E, int k) {
  const int first = pick(g, E, -1);
  return k == 0 ? first : pick(g, E, first);
}

__global__ void __launch_bounds__(kThreads) moe_route_kernel(const MoeRouteParams p) {
  __shared__ int s_off[kWarps][kMaxE];     // a warp's count of each pick, then its first position
  __shared__ float s_me[kWarps][kMaxE];    // a warp's sum of each gate (first choice's pass)
  __shared__ int s_base[kMaxE];            // next position of each expert in this choice
  __shared__ int s_kept[kMaxE];            // kept slots of each expert over the earlier choices
  __shared__ int s_first[kMaxE];           // tokens whose first pick is the expert
  __shared__ float s_me_acc[kMaxE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int E = p.E, K = p.K, T = p.T, cap = p.cap;
  for (int i = tid; i < E * cap; i += kThreads) p.src[i] = 0, p.slot_w[i] = 0.f;
  if (tid < E) s_kept[tid] = 0, s_first[tid] = 0, s_me_acc[tid] = 0.f;
  float g[kMaxE];

  for (int k = 0; k < K; ++k) {
    __syncthreads();
    if (tid < E) s_base[tid] = s_kept[tid];
    for (int c0 = 0; c0 < T; c0 += kThreads) {
      for (int i = tid; i < kWarps * kMaxE; i += kThreads) (&s_off[0][0])[i] = 0;
      __syncthreads();
      const int t = c0 + tid;
      const bool live = t < T;
      int e = -1;
      if (live) {
        softmax_row(p.logits + (long long)t * E, E, g);
        e = pick_k(g, E, k);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (live && rank == 0) s_off[warp][e] = __popc(peers);
      if (k == 0) {
        for (int j = 0; j < E; ++j) {
          float v = live ? g[j] : 0.f;
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
          if (lane == 0) s_me[warp][j] = v;
        }
      }
      __syncthreads();
      if (tid < E) {   // positions: a scan over the warps in order, from the running base
        int run = s_base[tid];
        for (int w = 0; w < kWarps; ++w) {
          const int n = s_off[w][tid];
          s_off[w][tid] = run;
          run += n;
        }
        if (k == 0) {
          s_first[tid] += run - s_base[tid];
          float m = s_me_acc[tid];
          for (int w = 0; w < kWarps; ++w) m += s_me[w][tid];
          s_me_acc[tid] = m;
        }
        s_base[tid] = run;
      }
      __syncthreads();
      if (live) p.slot_tk[(long long)t * K + k] = s_off[warp][e] + rank;   // unclamped, for now
      __syncthreads();
    }
    if (tid < E) {   // kept this choice: the positions below cap
      const int before = s_kept[tid], total = s_base[tid] - before;
      s_kept[tid] = before + min(total, max(cap - before, 0));
    }
  }
  __syncthreads();
  if (tid < E) {
    p.me[tid] = s_me_acc[tid] / (float)T;
    p.ce[tid] = (float)s_first[tid] / (float)T;
  }

  // weights and the slot scatter; a thread reads back only what it wrote
  for (int t = tid; t < T; t += kThreads) {
    softmax_row(p.logits + (long long)t * E, E, g);
    int ex[2], pos[2];
    float gk[2];
    float sum = 0.f;
    for (int k = 0; k < K; ++k) {
      ex[k] = pick_k(g, E, k);
      pos[k] = p.slot_tk[(long long)t * K + k];
      gk[k] = __fmul_rn(g[ex[k]], pos[k] < cap ? 1.f : 0.f);
      sum = __fadd_rn(sum, gk[k]);
    }
    const float denom = fmaxf(sum, 1e-9f);
    for (int k = 0; k < K; ++k) {
      const bool keep = pos[k] < cap;
      const float w = __fdiv_rn(gk[k], denom);
      const int slot = ex[k] * cap + pos[k];
      p.slot_tk[(long long)t * K + k] = keep ? slot : 0;
      p.w_tk[(long long)t * K + k] = __fmul_rn(w, keep ? 1.f : 0.f);
      if (keep) {
        p.src[slot] = t + 1;
        p.slot_w[slot] = w;
      }
    }
  }
}

}  // namespace

// The route of T tokens over E <= 64 experts, top_k K in {1, 2}, capacity
// cap; returns the cudaError_t.
extern "C" int dstt_moe_route(MoeRouteParams p, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (p.E > kMaxE || p.K < 1 || p.K > 2) return cudaErrorInvalidValue;
  moe_route_kernel<<<1, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
