// Device helpers shared by the fused optimizer kernels (fused_adam.cu,
// fused_lion.cu): typed loads, the counter hash of the stochastic rounding,
// and typed stores.
//
// bf16 moment stores use the Pallas optimizer kernels' stochastic rounding
// (deepspeed_tpu/ops/adam/pallas_adam.py: _hash32, _sr_to_bf16_bits, _store):
// triple32 hash of (element index in the bucket ^ seed), its low 16 bits
// added to the fp32 bits before truncation; the index counts the bucket's
// lane padding, as _global_idx does. Other narrow stores round to nearest.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float load(const void* base, long long i, int dt) {
  switch (dt) {
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
    case kF16: return __half2float(static_cast<const __half*>(base)[i]);
    default: return static_cast<const float*>(base)[i];
  }
}

__device__ __forceinline__ unsigned int hash32(unsigned int x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

// Store x at dtype dt; bf16 with stochastic rounding when sr.
__device__ __forceinline__ void store(void* base, long long i, int dt, float x, bool sr,
                                      unsigned int seed) {
  switch (dt) {
    case kBF16: {
      __nv_bfloat16 out;
      if (sr) {
        unsigned int bits = __float_as_uint(x);
        const unsigned int noise = hash32(static_cast<unsigned int>(i) ^ seed);
        bits = (bits + (noise & 0xFFFFu)) & 0xFFFF0000u;
        out = __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
      } else {
        out = __float2bfloat16_rn(x);
      }
      static_cast<__nv_bfloat16*>(base)[i] = out;
      break;
    }
    case kF16: static_cast<__half*>(base)[i] = __float2half_rn(x); break;
    default: static_cast<float*>(base)[i] = x;
  }
}

}  // namespace
