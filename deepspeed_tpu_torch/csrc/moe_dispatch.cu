// The row gathers of the mixture of experts, all driven by a slot table:
//
//   dispatch gather:       payload[s] = tokens[max(src[s] - 1, 0)]    cast to the wire dtype
//   int8 dispatch gather:  q[s], scale[s] = int8 row quantize of that row (zero where
//                          src[s] == 0 when mask_pad)
//   split combine:         out[t] = 0 + w_tk[t, 0] * y[slot_tk[t, 0]] + w_tk[t, 1] * y[slot_tk[t, 1]]
//
// Replaces three TPU kernels of deepspeed_tpu/ops/transformer/pallas_moe.py:
// _gather_kernel (via moe_dispatch_gather; one scalar-prefetched grid step a
// slot), _gather_int8_kernel (via moe_dispatch_gather_int8; the same grid)
// and _combine_kernel (via moe_combine; grid (T, K) revisiting token t's
// output block K times). Same functions. The int8 gather quantizes each
// gathered row as one group with quant_common.cuh's row forms, those of the
// wire quantizer (quant_rows.cu): its output is byte-identical to
// quantize_rows_int8 of the gathered rows. An empty slot (src 0) reads
// token 0's row unmasked, as the Pallas kernel does with mask_pad=False: the
// combine never reads it with a non-zero weight. The gather's bf16 cast is
// __float2bfloat16_rn, the rounding of torch's .to(bfloat16), so the payload
// is byte-identical to tokens.index_select(0, (src - 1).clamp_min(0)). The
// combine adds its k terms in order from 0, each product rounded on its own
// (__fmul_rn, __fadd_rn: no FMA), the plain version's sequence, bit for bit.
//
// Bound on an H100 SXM: bytes (no arithmetic to speak of), and at decode
// sizes the launch and two dependent loads (a slot's src entry, then its
// row). The dispatch gather's grid is sized to the card, not to the slots:
// a warp copies up to 32 slots strided by the number of warps, loads their
// src entries at once and keeps two whole rows' 16-byte loads in flight (16
// a lane and row at H 4096 in bf16) before storing them; it waits for the
// route by programmatic dependent launch, so its launch overlaps the
// route's.
//
// The int8 gather reads a routed row and writes a quarter (fp32) or half
// (bf16) of its bytes plus a 4-byte scale; with mask_pad an empty slot reads
// nothing and writes its int8 zeros and a scale of 1. At a 512-token Mixtral
// wave (top-2, dropless: 4096 slots of H 4096, 1024 of them filled) that is
// 4.2 MB of tokens read and 16.8 MB of int8 written, 12.6 MB of it zero rows:
// 0.0063 ms at 3.35 TB/s. So the rows are read once, into registers, and
// quantized by one multiply a value; zero rows cost their 16-byte stores and
// nothing else; and the grid is sized to the card (the launch plan,
// ops/transformer/moe.py plan_gather_int8, is the wire quantizer's; the
// launcher cuts it to the blocks the card holds at once): at H 4096 a block
// holds a slot's row (2 or 4 units a thread), walks the slots in rotated
// rounds of the grid, so that an expert's run of filled slots spreads over
// the blocks, and loads its next slot's row, and the src entry of the one
// after, before it reduces the row it holds. Plain loads (no evict-first):
// a token's row is read by its top_k slots, the later reads from L2. No
// programmatic dependent launch: no kernel precedes this one on any path.
//
// The combine moves T * K rows of y in and T rows out: at a 512-token
// Mixtral wave (K 2, H 4096) 25.2 MB, 0.0075 ms at 3.35 TB/s. Its launch
// plan (ops/transformer/moe.py plan_combine) gives a token's row to a group
// of L threads (all 256 of a block at H 4096), CH 16-byte units a thread and
// pick, and sizes the grid to the card, groups walking the tokens. K is a
// template parameter: a thread loads its token's K slot indices and weights,
// then all K * CH row loads (8 in flight at H 4096, K 2), and only then adds
// them in order; the next token's indices are loaded while this one's rows
// are in flight. The combine waits for the FFN before it by programmatic
// dependent launch (kCombinePdl), so its blocks are resident when the FFN's
// last blocks finish.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quant_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int clamp_token(int t, int T) {
  return t < 0 ? 0 : (t < T ? t : T - 1);
}

__device__ __forceinline__ int source_row(const int* src, int s, int T) {
  return clamp_token(src[s] - 1, T);
}

template <typename In, typename Out>
__device__ __forceinline__ Out convert(In v);
template <> __device__ __forceinline__ uint4 convert(uint4 v) { return v; }
template <> __device__ __forceinline__ float convert(float v) { return v; }
template <> __device__ __forceinline__ bf16 convert(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float convert(bf16 v) { return __bfloat162float(v); }
template <> __device__ __forceinline__ bf16 convert(bf16 v) { return v; }

constexpr int kGatherThreads = 64;      // 2 warps a block: the few rows of a decode step
                                        // spread over many SMs
constexpr int kGatherUnroll = 16;       // loads in flight a lane and row: a 4096-wide bf16
                                        // row a warp
constexpr int kGatherRows = 2;          // rows a warp loads before it stores them
constexpr int kGatherWarpsPerSm = 64;   // the grid: at most this many warps an SM
// Programmatic dependent launch: the gather's blocks start while the kernel
// before it (the route) finishes, and wait for it before reading src.
constexpr bool kGatherPdl = true;

// Warp w of W copies slots w, w + W, ... (at most 32: their src entries in
// one load), so the warps' stores at any moment fill one stretch of the
// payload. kGatherRows rows at a time it issues all their loads
// (kGatherUnroll a lane and row) before their stores. Plain stores: the FFN
// reads the payload next, from L2. `n` elements a row: 16-byte units for
// the copy, values for a cast.
template <typename In, typename Out>
__global__ void __launch_bounds__(kGatherThreads)
    moe_gather_kernel(const In* __restrict__ tokens, const int* __restrict__ src,
                      Out* __restrict__ out, int S, int T, int n) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kGatherThreads + threadIdx.x) / 32;
  const int W = gridDim.x * (kGatherThreads / 32);
  if (warp >= S) return;
  const int m = (S - 1 - warp) / W + 1;
  const int mine = lane < m ? source_row(src, warp + lane * W, T) : 0;
  for (int j = 0; j < m; j += kGatherRows) {
    for (int i0 = lane; i0 < n; i0 += 32 * kGatherUnroll) {
      In v[kGatherRows][kGatherUnroll];
#pragma unroll
      for (int r = 0; r < kGatherRows; ++r) {
        if (j + r >= m) break;
        const In* in = tokens + (long long)__shfl_sync(0xffffffffu, mine, j + r) * n;
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u)
          if (i0 + 32 * u < n) v[r][u] = in[i0 + 32 * u];
      }
#pragma unroll
      for (int r = 0; r < kGatherRows; ++r) {
        if (j + r >= m) break;
        Out* o = out + (long long)(warp + (j + r) * W) * n;
#pragma unroll
        for (int u = 0; u < kGatherUnroll; ++u)
          if (i0 + 32 * u < n) o[i0 + 32 * u] = convert<In, Out>(v[r][u]);
      }
    }
  }
}

template <typename In, typename Out>
int launch_gather(const In* tokens, const int* src, Out* out, int S, int T, int n,
                  cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  // a warp a slot up to the cap, then up to 32 slots a warp
  const int warps_max = sms * kGatherWarpsPerSm;
  const int run = min(32, (S + warps_max - 1) / warps_max);
  const int per_block = kGatherThreads / 32;
  const int blocks = ((S + run - 1) / run + per_block - 1) / per_block;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  const cudaLaunchConfig_t cfg = {dim3(blocks), dim3(kGatherThreads), 0, stream, &attr,
                                  kGatherPdl ? 1u : 0u};
  return cudaLaunchKernelEx(&cfg, moe_gather_kernel<In, Out>, tokens, src, out, S, T, n);
}

// Slot s of the int8 gather, for quant_common.cuh's row forms: its key is
// src[s]; its row is tokens[max(src[s] - 1, 0)], or a row of zeros where
// src[s] == 0 when mask_pad.
template <typename T>
struct SlotRows {
  typedef T Elem;
  typedef int Key;
  static constexpr bool kZeroRows = true;
  static constexpr bool kEvictFirst = false;
  const T* tokens;
  const int* src;
  int n_tokens, H, mask_pad;
  __device__ __forceinline__ Key key(long long s) const { return __ldg(src + s); }
  __device__ __forceinline__ const T* row(Key v, long long) const {
    if (mask_pad && v <= 0) return nullptr;
    return tokens + (long long)clamp_token(v - 1, n_tokens) * H;
  }
};

template <typename T>
int launch_gather_int8(const T* tokens, const int* src, int8_t* q, float* scale, int S, int T_,
                       int H, int mask_pad, int form, int vec, int lg2p, int units, int blocks,
                       cudaStream_t stream) {
  if (vec && ((reinterpret_cast<uintptr_t>(tokens) & 15) || (H * sizeof(T)) % 16 ||
              (reinterpret_cast<uintptr_t>(q) & 15)))
    return cudaErrorInvalidValue;
  return quant::launch_rows(SlotRows<T>{tokens, src, T_, H, mask_pad}, q, scale, S, H, form, vec,
                            lg2p, units, blocks, stream);
}

constexpr int kCombineThreads = 256;
constexpr int kCombineUnits = 4;        // 16-byte units a thread and pick at most
constexpr int kCombineBlocksPerSm = 4;  // the launch bound: <= 64 registers a thread
constexpr bool kCombinePdl = true;

// Token t's K picks: slot indices clamped into [0, S), and weights.
template <int K>
__device__ __forceinline__ void combine_picks(const int* slot_tk, const float* w_tk, long long t,
                                              int S, int (&s)[K], float (&w)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = slot_tk[t * K + k];
    s[k] = v < 0 ? 0 : (v < S ? v : S - 1);
    w[k] = w_tk[t * K + k];
  }
}

// 0 + w[0] * v[0] + w[1] * v[1] ..., each product and sum rounded on its own
template <int K>
__device__ __forceinline__ float combine_sum(const float (&w)[K], const float (&v)[K]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(w[k], v[k]));
  return acc;
}
template <int K>
__device__ __forceinline__ float4 combine_sum(const float (&w)[K], const float4 (&v)[K]) {
  float x[K], y[K], z[K], u[K];
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = v[k].x, y[k] = v[k].y, z[k] = v[k].z, u[k] = v[k].w;
  return make_float4(combine_sum<K>(w, x), combine_sum<K>(w, y), combine_sum<K>(w, z),
                     combine_sum<K>(w, u));
}

// Work item i is token i / tiles and its column tile i % tiles (a tile is L *
// CH units: the whole row at H 4096). A group of L = 1 << lg2l threads takes
// an item at a time, thread j the units j, j + L, ... of the tile; the
// groups walk the items.
template <int K, bool VEC, int CH>
__global__ void __launch_bounds__(kCombineThreads, kCombineBlocksPerSm) combine_kernel(
    const float* __restrict__ y, const int* __restrict__ slot_tk,
    const float* __restrict__ w_tk, float* __restrict__ out, int T, int H, int S, int lg2l) {
  typedef typename std::conditional<VEC, float4, float>::type Unit;
  constexpr int V = VEC ? 4 : 1;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // y is the FFN's output
  const int L = 1 << lg2l;
  const int n = H / V;
  const int span = L * CH;
  const int tiles = (n + span - 1) / span;
  const long long items = (long long)T * tiles;
  const int per_block = kCombineThreads >> lg2l;
  const long long step = (long long)gridDim.x * per_block;
  const int j = threadIdx.x & (L - 1);
  long long i = (long long)blockIdx.x * per_block + (threadIdx.x >> lg2l);
  int s[K];
  float w[K];
  if (i < items) combine_picks<K>(slot_tk, w_tk, i / tiles, S, s, w);
  for (; i < items; i += step) {
    const long long t = i / tiles;
    const int u0 = (int)(i - t * tiles) * span + j;
    Unit v[CH][K];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = u0 + c * L;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (u < n) v[c][k] = reinterpret_cast<const Unit*>(y + (long long)s[k] * H)[u];
    }
    float wk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k] = w[k];
    if (i + step < items) combine_picks<K>(slot_tk, w_tk, (i + step) / tiles, S, s, w);
    Unit* o = reinterpret_cast<Unit*>(out + t * H);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = u0 + c * L;
      if (u < n) o[u] = combine_sum<K>(wk, v[c]);
    }
  }
}

template <int K, bool VEC>
int launch_combine(const float* y, const int* slot_tk, const float* w_tk, float* out, int T,
                   int H, int S, int lg2l, int units, int blocks, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  const cudaLaunchConfig_t cfg = {dim3(blocks), dim3(kCombineThreads), 0, stream, &attr,
                                  kCombinePdl ? 1u : 0u};
  switch (units) {
    case 1:
      return cudaLaunchKernelEx(&cfg, combine_kernel<K, VEC, 1>, y, slot_tk, w_tk, out, T, H, S,
                                lg2l);
    case 2:
      return cudaLaunchKernelEx(&cfg, combine_kernel<K, VEC, 2>, y, slot_tk, w_tk, out, T, H, S,
                                lg2l);
    case 4:
      return cudaLaunchKernelEx(&cfg, combine_kernel<K, VEC, 4>, y, slot_tk, w_tk, out, T, H, S,
                                lg2l);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// payload [S, H] (out_bf16 ? bf16 : fp32) = tokens [T, H] (in_bf16 ? bf16 :
// fp32) at rows max(src - 1, 0); returns the cudaError_t.
extern "C" int dstt_moe_gather(const void* tokens, const int* src, void* out, int S, int T,
                               int H, int in_bf16, int out_bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (S == 0 || H == 0) return cudaSuccess;
  const int esize = in_bf16 ? 2 : 4;
  if (in_bf16 == out_bf16 && ((long long)H * esize) % 16 == 0)
    return launch_gather(static_cast<const uint4*>(tokens), src, static_cast<uint4*>(out), S, T,
                         H * esize / 16, stream);
  if (in_bf16 && out_bf16)
    return launch_gather(static_cast<const bf16*>(tokens), src, static_cast<bf16*>(out), S, T, H,
                         stream);
  if (in_bf16)
    return launch_gather(static_cast<const bf16*>(tokens), src, static_cast<float*>(out), S, T,
                         H, stream);
  if (out_bf16)
    return launch_gather(static_cast<const float*>(tokens), src, static_cast<bf16*>(out), S, T,
                         H, stream);
  return launch_gather(static_cast<const float*>(tokens), src, static_cast<float*>(out), S, T, H,
                       stream);
}

// q [S, H] int8 and scale [S] fp32: the rows tokens [T, H] (in_bf16 ? bf16 :
// fp32) at max(src - 1, 0), zero where src == 0 when mask_pad, each quantized
// as one symmetric int8 group, by the plan of ops/transformer/moe.py
// plan_gather_int8 (quant_common.cuh launch_rows: form, vec, lg2p, units,
// blocks); returns the cudaError_t (cudaErrorInvalidValue for a plan the
// forms do not take).
extern "C" int dstt_moe_gather_int8(const void* tokens, const int* src, int8_t* q, float* scale,
                                    int S, int T, int H, int in_bf16, int mask_pad, int form,
                                    int vec, int lg2p, int units, int blocks, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (S == 0 || H == 0) return cudaSuccess;
  if (T < 1) return cudaErrorInvalidValue;
  if (in_bf16)
    return launch_gather_int8(static_cast<const bf16*>(tokens), src, q, scale, S, T, H, mask_pad,
                              form, vec, lg2p, units, blocks, stream);
  return launch_gather_int8(static_cast<const float*>(tokens), src, q, scale, S, T, H, mask_pad,
                            form, vec, lg2p, units, blocks, stream);
}

// out [T, H] fp32 = sum over k of w_tk[t, k] * y[slot_tk[t, k]], y [S, H]
// fp32, K 1 or 2, by the plan of ops/transformer/moe.py plan_combine (1 <<
// lg2l threads a token, `units` units a thread and pick, 16-byte units when
// vec, `blocks` blocks); returns the cudaError_t (cudaErrorInvalidValue for
// what the kernel does not take).
extern "C" int dstt_moe_combine(const float* y, const int* slot_tk, const float* w_tk,
                                float* out, int T, int K, int H, int S, int vec, int lg2l,
                                int units, int blocks, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (T == 0 || H == 0) return cudaSuccess;
  if (S < 1 || blocks < 1 || lg2l < 0 || lg2l > 8) return cudaErrorInvalidValue;
  if (vec && ((H & 3) || (reinterpret_cast<uintptr_t>(y) & 15) ||
              (reinterpret_cast<uintptr_t>(out) & 15)))
    return cudaErrorInvalidValue;
  if (K == 1)
    return vec ? launch_combine<1, true>(y, slot_tk, w_tk, out, T, H, S, lg2l, units, blocks,
                                         stream)
               : launch_combine<1, false>(y, slot_tk, w_tk, out, T, H, S, lg2l, units, blocks,
                                          stream);
  if (K == 2)
    return vec ? launch_combine<2, true>(y, slot_tk, w_tk, out, T, H, S, lg2l, units, blocks,
                                         stream)
               : launch_combine<2, false>(y, slot_tk, w_tk, out, T, H, S, lg2l, units, blocks,
                                          stream);
  return cudaErrorInvalidValue;
}
