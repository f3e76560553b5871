// Symmetric int8 quantization of G group rows of gs values each: the ZeRO++
// int8 wire (qwZ parameter all-gather, qgZ gradient reduce-scatter).
//
//   groups [G, gs] fp32 or bf16  ->  q [G, gs] int8,  scale [G] fp32
//
// Replaces the TPU kernel _quant_rows_kernel in
// deepspeed_tpu/ops/quantizer/pallas_quant.py (reached through
// quantize_rows_int8 -> pl.pallas_call; quantize_blockwise calls it for the
// symmetric int8 wire). The Pallas kernel takes blocks of 32 rows a grid step
// and needs gs to be a multiple of the TPU's 128 lanes; here any group size
// from 1 up serves, including the short tail groups the wire forms for small
// chunks. The row arithmetic, and why it matches the jitted JAX wire bit for
// bit, is in quant_common.cuh (row_scale, quantize_one: a __fmul_rn by
// fp32(1/127), a correctly rounded __fdiv_rn, rintf). The forms below give
// the same bits with one multiply a value where that decides the integer
// (quantize_scaled: x * RN(1/s), and the divide only within 2^-12 of a
// half-integer), which halves the arithmetic a value.
//
// Bound on an H100 SXM: bytes. An element costs its input (4 or 2 bytes) and
// its int8 output; a row adds its 4-byte scale: the wire's main case (22528
// rows of 256 bf16, a tinyllama MLP shard) moves 17.39 MB, 0.0052 ms at 3.35
// TB/s. What the arithmetic costs (an abs and max, then a divide, a round
// and a clip a value) must hide under the loads, so the quantize runs on
// one multiply a value (quantize_scaled), each row is read from device
// memory once, every warp keeps its next rows' loads in flight while it
// quantizes, and the card holds as many warps as it can (8 blocks of 256
// threads an SM, the grid sized to the card by the wrapper's launch plan,
// ops/quantizer/quant.py plan_rows, warps walking the rows). A unit of a
// row is 16 bytes (8 bf16 or 4 fp32 values) where the row length and
// address allow it, else one value. Three forms, by row length:
// - lanes: rows of at most 32 * kUnits units (4 KB of 16-byte units; the
//   wire's groups of 256, and the short ones: gs 1, 7, 255 ...). A row is
//   spread over P lanes (a power of two up to 32, so rows shorter than 32
//   units share a warp on lane groups), CH units a lane in registers; a warp
//   takes a pass of 32 / P rows at a time and issues the next pass's loads
//   before it reduces this one (at the main case a row of 512 bytes a warp,
//   two in flight). Its rows are consecutive: its int8 stores fill one
//   stretch.
// - block: longer rows of up to 256 * kUnits units (gs 4096: 8 or 16 KB).
//   The 256 threads of a block hold one row, up to kUnits units a thread,
//   and reduce it through shared memory; a block walks rows.
// - warp: any longer row, one warp a row, read twice
//   (quant_common.cuh quantize_row_warp).
// 16-byte units are loaded with ld.global.cs (evict-first): a row is read
// once, so its lines are the L2's first victims.
#include "quant_common.cuh"

namespace {

using quant::bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;           // units a lane or thread holds (lanes, block)

// |x * RN(1/s) - RN(x / s)| <= 3 * 2^-24 * |x / s| < 2.3e-5 for every value
// of a row (|x / s| <= 127 * (1 + 2^-23): s = RN(absmax * RN(1/127)); RN(1/s)
// normal or infinite): ten times under this margin.
constexpr float kTieMargin = 1.0f / 4096;

// quant::quantize_one(x, s), bit for bit, from y = x * r with r = RN(1 / s):
// where y lies more than kTieMargin from every half-integer, RN(x / s) lies
// on the same side of each, so it rounds to rint(y) (an integer within
// [-127, 127]: no clip binds). Elsewhere (a half-integer's neighbourhood,
// or a NaN or infinite y when r overflows for a subnormal scale) the
// correctly rounded divide decides, as in quantize_one.
__device__ __forceinline__ int8_t quantize_scaled(float x, float s, float r) {
  const float y = __fmul_rn(x, r);
  const float n = rintf(y);
  if (fabsf(__fsub_rn(y, n)) < 0.5f - kTieMargin) return static_cast<int8_t>(static_cast<int>(n));
  return quant::quantize_one(x, s);
}

// A unit of a row as loaded (Raw), its values, and its V int8 values' store.
template <typename T, bool VEC>
struct Unit {
  typedef uint4 Raw;
  static constexpr int V = 16 / sizeof(T);
  __device__ __forceinline__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ static Raw load(const T* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  // value k of the unit: the little-endian words of the 16 bytes, widened
  __device__ __forceinline__ static float at(const Raw& r, int k) {
    const int w = sizeof(T) == 4 ? k : k >> 1;
    const unsigned h = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
    if (sizeof(T) == 4) return __uint_as_float(h);
    return __uint_as_float(k & 1 ? h & 0xffff0000u : h << 16);   // bf16: the high 16 bits
  }
};

template <typename T>
struct Unit<T, false> {
  typedef T Raw;
  static constexpr int V = 1;
  __device__ __forceinline__ static Raw zero() { return static_cast<T>(0.f); }
  __device__ __forceinline__ static Raw load(const T* p) { return *p; }
  __device__ __forceinline__ static float at(const Raw& r, int) { return quant::widen(r); }
};

// The V int8 values of a unit at row offset p (V-byte aligned for V > 1),
// for the row's scale s and its reciprocal rs = RN(1 / s).
template <typename T, bool VEC>
__device__ __forceinline__ void quantize_unit(const typename Unit<T, VEC>::Raw& r, float s,
                                              float rs, int8_t* p) {
  typedef Unit<T, VEC> U;
  int8_t o[U::V];
#pragma unroll
  for (int k = 0; k < U::V; ++k) o[k] = quantize_scaled(U::at(r, k), s, rs);
  if constexpr (U::V == 1) {
    *p = o[0];
  } else {
    quant::store_q(p, o);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ float unit_absmax(const typename Unit<T, VEC>::Raw& r, float m) {
#pragma unroll
  for (int k = 0; k < Unit<T, VEC>::V; ++k) m = fmaxf(m, fabsf(Unit<T, VEC>::at(r, k)));
  return m;
}

// The max of a row spread over a lane group of 1 << lg2p lanes, and its scale.
__device__ __forceinline__ float group_scale(float m, int lg2p) {
  for (int o = (1 << lg2p) >> 1; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return quant::row_scale(m);
}

// The lanes form: P = 1 << lg2p lanes a row, lane j of a row holding its
// units j, j + P, ... (CH of them); a warp takes 32 / P consecutive rows at
// a time and loads its next pass before it reduces this one. A unit past
// the row, or a row past G, is a zero, which leaves the max alone.
template <typename T, bool VEC, int CH>
__global__ void __launch_bounds__(kThreads)
    quant_rows_lanes(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     long long G, int gs, int lg2p) {
  typedef Unit<T, VEC> U;
  const int P = 1 << lg2p;
  const int lane = threadIdx.x & 31;
  const int j = lane & (P - 1);
  const int rows_pass = 32 >> lg2p;
  const int n = gs / U::V;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long stride = (long long)gridDim.x * kWarps * rows_pass;
  typename U::Raw next[CH];
  auto fetch = [&](long long base, typename U::Raw (&raw)[CH]) {
    const long long row = base + (lane >> lg2p);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = j + c * P;
      raw[c] = row < G && u < n ? U::load(x + row * gs + (long long)u * U::V) : U::zero();
    }
  };
  fetch(warp * rows_pass, next);
  for (long long base = warp * rows_pass; base < G; base += stride) {
    const long long row = base + (lane >> lg2p);
    typename U::Raw raw[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) raw[c] = next[c];
    if (base + stride < G) fetch(base + stride, next);   // the next pass's loads in flight
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) s = unit_absmax<T, VEC>(raw[c], s);
    s = group_scale(s, lg2p);
    if (row < G) {
      const float rs = __frcp_rn(s);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int u = j + c * P;
        if (u < n) quantize_unit<T, VEC>(raw[c], s, rs, q + row * gs + u * U::V);
      }
      if (j == 0) scale[row] = s;   // the group leaders' scales: one store of 32 / P
    }
  }
}

// The block form: the kThreads threads hold one row, thread i its units i,
// i + kThreads, ... (CH of them); the warps' maxima meet in shared memory,
// double-buffered by row so that one barrier a row suffices.
template <typename T, bool VEC, int CH>
__global__ void __launch_bounds__(kThreads)
    quant_rows_block(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     long long G, int gs) {
  typedef Unit<T, VEC> U;
  __shared__ float part[2][kWarps];
  const int n = gs / U::V;
  const int tid = threadIdx.x;
  int buf = 0;
  for (long long row = blockIdx.x; row < G; row += gridDim.x, buf ^= 1) {
    typename U::Raw raw[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = tid + c * kThreads;
      raw[c] = u < n ? U::load(x + row * gs + (long long)u * U::V) : U::zero();
    }
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) m = unit_absmax<T, VEC>(raw[c], m);
    m = quant::warp_max(m);
    if ((tid & 31) == 0) part[buf][tid >> 5] = m;
    __syncthreads();
    m = part[buf][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, part[buf][w]);
    const float s = quant::row_scale(m);
    const float rs = __frcp_rn(s);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = tid + c * kThreads;
      if (u < n) quantize_unit<T, VEC>(raw[c], s, rs, q + row * gs + (long long)u * U::V);
    }
    if (tid == 0) scale[row] = s;
  }
}

// The warp form: one warp a row at a time, the rows strided over the grid.
template <typename T>
__global__ void __launch_bounds__(kThreads) quant_rows_warp(const T* __restrict__ x,
                                                            int8_t* __restrict__ q,
                                                            float* __restrict__ scale,
                                                            long long G, int gs) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < G; r += nwarps)
    quant::quantize_row_warp(x + r * gs, gs, false, q + r * gs, scale + r, lane);
}

template <typename T, bool VEC, int CH>
void launch_form(int form, const T* x, int8_t* q, float* scale, long long G, int gs, int lg2p,
                 int blocks, cudaStream_t stream) {
  if (form == 0) {
    quant_rows_lanes<T, VEC, CH><<<blocks, kThreads, 0, stream>>>(x, q, scale, G, gs, lg2p);
  } else {
    quant_rows_block<T, VEC, CH><<<blocks, kThreads, 0, stream>>>(x, q, scale, G, gs);
  }
}

template <typename T, bool VEC>
int launch_units(int form, int units, const T* x, int8_t* q, float* scale, long long G, int gs,
                 int lg2p, int blocks, cudaStream_t stream) {
  switch (units) {
    case 1: launch_form<T, VEC, 1>(form, x, q, scale, G, gs, lg2p, blocks, stream); break;
    case 2: launch_form<T, VEC, 2>(form, x, q, scale, G, gs, lg2p, blocks, stream); break;
    case 4: launch_form<T, VEC, 4>(form, x, q, scale, G, gs, lg2p, blocks, stream); break;
    case 8: launch_form<T, VEC, 8>(form, x, q, scale, G, gs, lg2p, blocks, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, int8_t* q, float* scale, long long G, int gs, int form, int vec,
           int lg2p, int units, int blocks, cudaStream_t stream) {
  if (form == 2) {
    quant_rows_warp<T><<<blocks, kThreads, 0, stream>>>(x, q, scale, G, gs);
    return cudaGetLastError();
  }
  if (form < 0 || form > 1 || lg2p < 0 || (form == 0 && lg2p > 5)) return cudaErrorInvalidValue;
  if (vec && ((reinterpret_cast<uintptr_t>(x) & 15) || (gs * sizeof(T)) % 16 ||
              (reinterpret_cast<uintptr_t>(q) & 15)))
    return cudaErrorInvalidValue;
  return vec ? launch_units<T, true>(form, units, x, q, scale, G, gs, lg2p, blocks, stream)
             : launch_units<T, false>(form, units, x, q, scale, G, gs, lg2p, blocks, stream);
}

}  // namespace

// q [G, gs] int8 and scale [G] fp32 of groups x [G, gs] (bf16 when x_bf16,
// else fp32), by the plan of ops/quantizer/quant.py plan_rows: form 0
// (lanes: 1 << lg2p lanes a row, `units` units a lane), 1 (block: `units`
// units a thread) or 2 (warp), units of 16 bytes when vec, else values,
// `blocks` blocks;
// returns the cudaError_t (cudaErrorInvalidValue for a plan the kernels do
// not take).
extern "C" int dstt_quant_rows(const void* x, int8_t* q, float* scale, long long G, int gs,
                               int x_bf16, int form, int vec, int lg2p, int units, int blocks,
                               void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (G == 0 || gs == 0) return cudaSuccess;
  if (blocks < 1) return cudaErrorInvalidValue;
  if (x_bf16)
    return launch(static_cast<const bf16*>(x), q, scale, G, gs, form, vec, lg2p, units, blocks,
                  stream);
  return launch(static_cast<const float*>(x), q, scale, G, gs, form, vec, lg2p, units, blocks,
                stream);
}
