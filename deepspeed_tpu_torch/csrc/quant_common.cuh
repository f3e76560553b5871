// Symmetric int8 quantization of rows: the arithmetic and the three row forms
// shared by quant_rows.cu (the ZeRO++ wire quantizer, the rows of a [G, gs]
// array) and moe_dispatch.cu's int8 dispatch gather (the routed row of each
// capacity slot, or a row of zeros for an empty one).
//
//   absmax = max |x|                        (over the row, in fp32)
//   scale  = absmax * fp32(1 / 127)         (1 where that is 0)
//   q      = clip(rint(x / scale), -128, 127)
//
// The two roundings are those of the jitted JAX quantizer
// (deepspeed_tpu/ops/quantizer/quantizer.py quantize_blockwise, and the Pallas
// kernel _quant_rows_kernel of pallas_quant.py): XLA turns the divide by the
// constant 127 into a multiply by its fp32 reciprocal (0.00787401572), and
// keeps x / scale a true divide. Both are explicitly rounded intrinsics here
// (__fmul_rn, __fdiv_rn), so no fast-math rewrite can touch them, and rintf
// rounds half to even, as jnp.round does. The port's plain version
// (ops/quantizer/quant.py) computes the same two operations, so kernel, plain
// version and the jitted JAX wire agree bit for bit. NaN inputs are out of
// contract (fmaxf drops a NaN that jnp.max would carry). The forms give the
// same bits with one multiply a value where that decides the integer
// (quantize_scaled: x * RN(1/s), and the divide only within 2^-12 of a
// half-integer).
//
// A row is read in its own dtype (fp32 or bf16) and widened in registers: the
// fp32 copy of a bf16 row never exists in memory. A unit of a row is 16
// bytes (8 bf16 or 4 fp32 values) where the row length and address allow it,
// else one value; its V int8 values go out in one 4- or 8-byte store. Three
// forms, by row length, picked by a Python launch plan
// (ops/quantizer/quant.py plan_rows; ops/transformer/moe.py plan_gather_int8
// for the gather) that also asks for a grid of up to 8 blocks an SM; the
// launcher takes no more blocks than the kernel's occupancy lets the card
// hold at once (resident_blocks), so the walkers run in one wave:
// - lanes: rows of at most 32 * 8 units (4 KB of 16-byte units; 8 is the
//   plan's quant.UNITS, the most a lane or thread holds). A
//   row is spread over P lanes (a power of two up to 32, so rows shorter than
//   32 units share a warp on lane groups), CH units a lane in registers; a
//   warp takes a pass of 32 / P consecutive rows at a time (its int8 stores
//   fill one stretch).
// - block: longer rows of up to 256 * 8 units (H 4096: 8 or 16 KB).
//   The 256 threads of a block hold one row, CH units a thread, and reduce
//   it through shared memory; a block walks rows in rounds of the grid,
//   the rounds rotated (rows_block).
// - warp: any longer row, one warp a row, read twice (quantize_row_warp).
// Every walker of the lanes and block forms keeps the next row's loads in
// flight while it reduces and stores the row it holds, and the key of the
// row after that (a slot's src entry) loaded before it needs it: a walker
// never waits on a key and then on its row in a row.
//
// The forms are templates over a row source Src:
//   typedef Elem           fp32 or bf16
//   typedef Key            what must be read to find row r (a slot's src
//                          entry), or an empty struct
//   kZeroRows              whether row() may name a row of zeros (nullptr)
//   kEvictFirst            16-byte units loaded with ld.global.cs (a row
//                          read once: its lines are the L2's first victims)
//   Key key(r)             issued one row ahead of row()
//   const Elem* row(k, r)  the row's first value, or nullptr for zeros
// A row of zeros issues no load and no quantize: its int8 row goes out in
// 16-byte stores of zeros where its address and length allow, and its scale
// is 1.0f, what the arithmetic gives for a row of zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace quant {

typedef __nv_bfloat16 bf16;

constexpr float kInv127 = 1.0f / 127.0f;   // fp32(1/127), XLA's reciprocal
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// V consecutive values of a 16-byte aligned address, widened.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&a);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(b[k]);
}

// V int8 values to a V-byte aligned address.
__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&q)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(q[0], q[1], q[2], q[3]);
}
__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&q)[8]) {
  uint2 w;
  int8_t* b = reinterpret_cast<int8_t*>(&w);
#pragma unroll
  for (int k = 0; k < 8; ++k) b[k] = q[k];
  *reinterpret_cast<uint2*>(p) = w;
}

// n int8 zeros at q by `count` threads, thread j of them: 16-byte stores
// where the row's address and length allow, else 8-, 4- or 1-byte stores.
__device__ __forceinline__ void store_zero_row(int8_t* q, int n, int j, int count) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(q)) | unsigned(n);
  if ((a & 15) == 0) {
    for (int i = j; i < n / 16; i += count) reinterpret_cast<uint4*>(q)[i] = make_uint4(0, 0, 0, 0);
  } else if ((a & 7) == 0) {
    for (int i = j; i < n / 8; i += count) reinterpret_cast<uint2*>(q)[i] = make_uint2(0, 0);
  } else if ((a & 3) == 0) {
    for (int i = j; i < n / 4; i += count) reinterpret_cast<unsigned*>(q)[i] = 0u;
  } else {
    for (int i = j; i < n; i += count) q[i] = 0;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_scale(float absmax) {
  const float s = __fmul_rn(absmax, kInv127);
  return s == 0.f ? 1.f : s;
}

__device__ __forceinline__ int8_t quantize_one(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -128.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// |x * RN(1/s) - RN(x / s)| <= 3 * 2^-24 * |x / s| < 2.3e-5 for every value
// of a row (|x / s| <= 127 * (1 + 2^-23): s = RN(absmax * RN(1/127)); RN(1/s)
// normal or infinite): ten times under this margin.
constexpr float kTieMargin = 1.0f / 4096;

// quantize_one(x, s), bit for bit, from y = x * r with r = RN(1 / s): where y
// lies more than kTieMargin from every half-integer, RN(x / s) lies on the
// same side of each, so it rounds to rint(y) (an integer within [-127, 127]:
// no clip binds). Elsewhere (a half-integer's neighbourhood, or a NaN or
// infinite y when r overflows for a subnormal scale) the correctly rounded
// divide decides, as in quantize_one.
__device__ __forceinline__ int8_t quantize_scaled(float x, float s, float r) {
  const float y = __fmul_rn(x, r);
  const float n = rintf(y);
  if (fabsf(__fsub_rn(y, n)) < 0.5f - kTieMargin) return static_cast<int8_t>(static_cast<int>(n));
  return quantize_one(x, s);
}

// A unit of a row as loaded (Raw), its values, and its V int8 values' store.
template <typename T, bool VEC>
struct Unit {
  typedef uint4 Raw;
  static constexpr int V = 16 / sizeof(T);
  __device__ __forceinline__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  template <bool EVICT_FIRST>
  __device__ __forceinline__ static Raw load(const T* p) {
    if constexpr (EVICT_FIRST) return __ldcs(reinterpret_cast<const uint4*>(p));
    return __ldg(reinterpret_cast<const uint4*>(p));
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
  template <bool EVICT_FIRST>
  __device__ __forceinline__ static Raw load(const T* p) {
    if constexpr (EVICT_FIRST) return *p;
    return __ldg(p);
  }
  __device__ __forceinline__ static float at(const Raw& r, int) { return widen(r); }
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
    store_q(p, o);
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
  return row_scale(m);
}

// Quantize the n values of row x into q and *scale_out, by the 32 lanes of
// one warp (every lane calls it with its lane index), reading the row twice:
// its absmax, then its values. A zero row reads nothing.
template <typename T>
__device__ __forceinline__ void quantize_row_warp(const T* __restrict__ x, int n, bool zero_row,
                                                  int8_t* __restrict__ q,
                                                  float* __restrict__ scale_out, int lane) {
  if (zero_row) {
    store_zero_row(q, n, lane, 32);
    if (lane == 0) *scale_out = 1.f;
    return;
  }
  constexpr int V = 16 / sizeof(T);
  const bool vec = n % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   reinterpret_cast<uintptr_t>(q) % V == 0;
  float amax = 0.f;
  if (vec) {
    for (int i = lane * V; i < n; i += 32 * V) {
      float v[V];
      load16(x + i, v);
#pragma unroll
      for (int k = 0; k < V; ++k) amax = fmaxf(amax, fabsf(v[k]));
    }
  } else {
    for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(widen(x[i])));
  }
  const float s = row_scale(warp_max(amax));
  const float rs = __frcp_rn(s);
  if (vec) {
    for (int i = lane * V; i < n; i += 32 * V) {
      float v[V];
      load16(x + i, v);
      int8_t o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = quantize_scaled(v[k], s, rs);
      store_q(q + i, o);
    }
  } else {
    for (int i = lane; i < n; i += 32) q[i] = quantize_scaled(widen(x[i]), s, rs);
  }
  if (lane == 0) *scale_out = s;
}

// The lanes form: P = 1 << lg2p lanes a row, lane j of a row holding its
// units j, j + P, ... (CH of them); a warp takes 32 / P consecutive rows at
// a time and loads its next pass before it reduces this one. A unit past
// the row, a row past G or a row of zeros is a zero, which leaves the max
// alone.
template <class Src, bool VEC, int CH>
__global__ void __launch_bounds__(kRowThreads)
    rows_lanes(Src src, int8_t* __restrict__ q, float* __restrict__ scale, long long G, int gs,
               int lg2p) {
  typedef typename Src::Elem T;
  typedef typename Src::Key Key;
  typedef Unit<T, VEC> U;
  const int P = 1 << lg2p;
  const int lane = threadIdx.x & 31;
  const int j = lane & (P - 1);
  const int rows_pass = 32 >> lg2p;
  const int n = gs / U::V;
  const long long mine = lane >> lg2p;   // this lane group's row of a pass
  const long long warp = ((long long)blockIdx.x * kRowThreads + threadIdx.x) >> 5;
  const long long stride = (long long)gridDim.x * kRowWarps * rows_pass;
  auto key = [&](long long base) {
    const long long row = base + mine;
    return row < G ? src.key(row) : Key();
  };
  auto fetch = [&](long long base, Key k, const T*& p, typename U::Raw (&raw)[CH]) {
    const long long row = base + mine;
    p = row < G ? src.row(k, row) : nullptr;
    const bool live = row < G && !(Src::kZeroRows && p == nullptr);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = j + c * P;
      raw[c] = live && u < n ? U::template load<Src::kEvictFirst>(p + (long long)u * U::V)
                             : U::zero();
    }
  };
  long long base = warp * rows_pass;
  const T* p_next;
  typename U::Raw next[CH];
  fetch(base, key(base), p_next, next);
  Key ahead = key(base + stride);
  for (; base < G; base += stride) {
    const long long row = base + mine;
    const T* p = p_next;
    typename U::Raw raw[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) raw[c] = next[c];
    if (base + stride < G) {   // the next pass's loads, and the key of the one after, in flight
      fetch(base + stride, ahead, p_next, next);
      ahead = key(base + 2 * stride);
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) s = unit_absmax<T, VEC>(raw[c], s);
    s = group_scale(s, lg2p);
    if (row < G) {
      int8_t* qr = q + row * gs;
      if (Src::kZeroRows && p == nullptr) {
        store_zero_row(qr, gs, j, P);
        if (j == 0) scale[row] = 1.f;
      } else {
        const float rs = __frcp_rn(s);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int u = j + c * P;
          if (u < n) quantize_unit<T, VEC>(raw[c], s, rs, qr + u * U::V);
        }
        if (j == 0) scale[row] = s;   // the group leaders' scales: one store of 32 / P
      }
    }
  }
}

// The block form: the kRowThreads threads hold one row, thread i its units i,
// i + kRowThreads, ... (CH of them), and load the block's next row before
// they reduce this one; the warps' maxima meet in shared memory,
// double-buffered by row so that one barrier a row suffices. A row of zeros
// is the same for every thread of the block: it takes no barrier. Round k of
// the walk covers rows [k W, (k + 1) W) of the W blocks, block b taking row
// k W + (b + k t) % W: every row once, and with t near W / phi a block's rows
// fall at scattered offsets of the rounds. Rows can differ in cost (a slot
// filled or empty, and an expert's filled slots come first in its run), and
// a plain stride that is close to a multiple of that run would give some
// blocks only filled rows and others only empty ones.
template <class Src, bool VEC, int CH>
__global__ void __launch_bounds__(kRowThreads)
    rows_block(Src src, int8_t* __restrict__ q, float* __restrict__ scale, long long G, int gs) {
  typedef typename Src::Elem T;
  typedef typename Src::Key Key;
  typedef Unit<T, VEC> U;
  __shared__ float part[2][kRowWarps];
  const int n = gs / U::V;
  const int tid = threadIdx.x;
  const int W = gridDim.x;
  const int turn = static_cast<int>(W * 0.6180339887498949f);
  // row k W + off of round k, and the next round's offset, (off + turn) % W
  auto turned = [&](int off) { return off + turn < W ? off + turn : off + turn - W; };
  auto key = [&](long long row) { return row < G ? src.key(row) : Key(); };
  auto fetch = [&](long long row, Key k, const T*& p, typename U::Raw (&raw)[CH]) {
    p = src.row(k, row);
    const bool live = !(Src::kZeroRows && p == nullptr);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = tid + c * kRowThreads;
      raw[c] = live && u < n ? U::template load<Src::kEvictFirst>(p + (long long)u * U::V)
                             : U::zero();
    }
  };
  int off1 = turned(blockIdx.x), off2 = turned(off1);
  long long row = blockIdx.x, row1 = W + off1;
  if (row >= G) return;
  const T* p_next;
  typename U::Raw next[CH];
  fetch(row, key(row), p_next, next);
  Key ahead = key(row1);
  int buf = 0;
  for (long long k = 0; row < G; ++k) {
    const T* p = p_next;
    typename U::Raw raw[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) raw[c] = next[c];
    const long long row2 = (k + 2) * W + off2;
    if (row1 < G) {   // the next row's loads, and the key of the one after, in flight
      fetch(row1, ahead, p_next, next);
      ahead = key(row2);
    }
    int8_t* qr = q + row * gs;
    if (Src::kZeroRows && p == nullptr) {
      store_zero_row(qr, gs, tid, kRowThreads);
      if (tid == 0) scale[row] = 1.f;
    } else {
      float m = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) m = unit_absmax<T, VEC>(raw[c], m);
      m = warp_max(m);
      if ((tid & 31) == 0) part[buf][tid >> 5] = m;
      __syncthreads();
      m = part[buf][0];
#pragma unroll
      for (int w = 1; w < kRowWarps; ++w) m = fmaxf(m, part[buf][w]);
      buf ^= 1;
      const float s = row_scale(m);
      const float rs = __frcp_rn(s);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int u = tid + c * kRowThreads;
        if (u < n) quantize_unit<T, VEC>(raw[c], s, rs, qr + (long long)u * U::V);
      }
      if (tid == 0) scale[row] = s;
    }
    row = row1;
    row1 = row2;
    off2 = turned(off2);
  }
}

// The warp form: one warp a row at a time, the rows strided over the grid.
template <class Src>
__global__ void __launch_bounds__(kRowThreads)
    rows_warp(Src src, int8_t* __restrict__ q, float* __restrict__ scale, long long G, int gs) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kRowWarps;
  for (long long r = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5); r < G; r += nwarps) {
    const typename Src::Elem* p = src.row(src.key(r), r);
    quantize_row_warp(p, gs, Src::kZeroRows && p == nullptr, q + r * gs, scale + r, lane);
  }
}

// The blocks of `kernel` the card holds at once: its occupancy on each SM
// (its registers decide it) times the SMs. A launch takes no more than that,
// so the walkers run in one wave; each launch site reads it once.
template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowThreads, 0);
  return per_sm * sms > 0 ? per_sm * sms : 1;
}

template <class Src, bool VEC, int CH>
void launch_form(int form, Src src, int8_t* q, float* scale, long long G, int gs, int lg2p,
                 int blocks, cudaStream_t stream) {
  if (form == 0) {
    static const int most = resident_blocks(rows_lanes<Src, VEC, CH>);
    rows_lanes<Src, VEC, CH><<<blocks < most ? blocks : most, kRowThreads, 0, stream>>>(
        src, q, scale, G, gs, lg2p);
  } else {
    static const int most = resident_blocks(rows_block<Src, VEC, CH>);
    rows_block<Src, VEC, CH><<<blocks < most ? blocks : most, kRowThreads, 0, stream>>>(
        src, q, scale, G, gs);
  }
}

template <class Src, bool VEC>
int launch_units(int form, int units, Src src, int8_t* q, float* scale, long long G, int gs,
                 int lg2p, int blocks, cudaStream_t stream) {
  switch (units) {
    case 1: launch_form<Src, VEC, 1>(form, src, q, scale, G, gs, lg2p, blocks, stream); break;
    case 2: launch_form<Src, VEC, 2>(form, src, q, scale, G, gs, lg2p, blocks, stream); break;
    case 4: launch_form<Src, VEC, 4>(form, src, q, scale, G, gs, lg2p, blocks, stream); break;
    case 8: launch_form<Src, VEC, 8>(form, src, q, scale, G, gs, lg2p, blocks, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// G rows of gs values of src into q [G, gs] int8 and scale [G] fp32, by a
// launch plan: form 0 (lanes: 1 << lg2p lanes a row, `units` units a lane),
// 1 (block: `units` units a thread) or 2 (warp), units of 16 bytes when vec
// (the caller has checked its rows' length and alignment for it), else
// values, `blocks` blocks or the most the card holds at once, whichever is
// fewer (G and gs at least 1); returns the cudaError_t (cudaErrorInvalidValue
// for a plan the forms do not take).
template <class Src>
int launch_rows(Src src, int8_t* q, float* scale, long long G, int gs, int form, int vec,
                int lg2p, int units, int blocks, cudaStream_t stream) {
  if (blocks < 1) return cudaErrorInvalidValue;
  if (form == 2) {
    static const int most = resident_blocks(rows_warp<Src>);
    rows_warp<Src><<<blocks < most ? blocks : most, kRowThreads, 0, stream>>>(src, q, scale, G,
                                                                              gs);
    return cudaGetLastError();
  }
  if (form < 0 || form > 1 || lg2p < 0 || (form == 0 && lg2p > 5)) return cudaErrorInvalidValue;
  return vec ? launch_units<Src, true>(form, units, src, q, scale, G, gs, lg2p, blocks, stream)
             : launch_units<Src, false>(form, units, src, q, scale, G, gs, lg2p, blocks, stream);
}

}  // namespace quant
