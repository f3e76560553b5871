// Symmetric int8 quantization of one row by one warp: the arithmetic shared by
// quant_rows.cu (the ZeRO++ wire quantizer) and the int8 dispatch gather of
// moe_dispatch.cu.
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
// contract (fmaxf drops a NaN that jnp.max would carry).
//
// A row is read in its own dtype (fp32 or bf16) and widened in registers: the
// fp32 copy of a bf16 row never exists in memory. Rows whose length and
// address allow it are read 16 bytes a lane and their int8 written 4 or 8
// bytes a lane; any other row element by element. quantize_row_warp reads
// its row twice (absmax, then quantize): the int8 dispatch gather's rows,
// and in quant_rows.cu only rows longer than its other forms hold (those
// forms read a row once and quantize it with one multiply a value).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace quant {

typedef __nv_bfloat16 bf16;

constexpr float kInv127 = 1.0f / 127.0f;   // fp32(1/127), XLA's reciprocal

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

// Quantize the n values of row x into q and *scale_out, by the 32 lanes of
// one warp (every lane calls it with its lane index). A zero row (a masked
// pad slot) reads nothing and writes q 0, scale 1: what the arithmetic gives
// for a row of zeros.
template <typename T>
__device__ __forceinline__ void quantize_row_warp(const T* __restrict__ x, int n, bool zero_row,
                                                  int8_t* __restrict__ q,
                                                  float* __restrict__ scale_out, int lane) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = n % V == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   reinterpret_cast<uintptr_t>(q) % V == 0;
  float amax = 0.f;
  if (!zero_row) {
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
  }
  const float s = row_scale(warp_max(amax));
  if (vec) {
    for (int i = lane * V; i < n; i += 32 * V) {
      float v[V];
      if (zero_row) {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = 0.f;
      } else {
        load16(x + i, v);
      }
      int8_t o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = quantize_one(v[k], s);
      store_q(q + i, o);
    }
  } else {
    for (int i = lane; i < n; i += 32) q[i] = quantize_one(zero_row ? 0.f : widen(x[i]), s);
  }
  if (lane == 0) *scale_out = s;
}

}  // namespace quant
