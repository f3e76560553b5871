// Symmetric int8 quantization of G group rows of gs values each: the ZeRO++
// int8 wire (qwZ parameter all-gather, qgZ gradient reduce-scatter).
//
//   groups [G, gs] fp32 or bf16  ->  q [G, gs] int8,  scale [G] fp32
//
// Replaces the TPU kernel _quant_rows_kernel in
// deepspeed_tpu/ops/quantizer/pallas_quant.py (reached through
// quantize_rows_int8 -> pl.pallas_call; quantize_blockwise calls it for the
// symmetric int8 wire). The Pallas kernel takes blocks of 32 rows a grid step
// and needs gs to be a multiple of the TPU's 128 lanes; here one warp takes one
// row at a time (a grid-stride loop over rows), so any group size from 1 up
// serves, including the short tail groups the wire forms for small chunks.
// The row arithmetic, and why it matches the jitted JAX wire bit for bit, is
// in quant_common.cuh.
//
// Bound on an H100 SXM: bytes. An element costs its input (4 or 2 bytes) and
// its int8 output; a row adds its 4-byte scale. There are 3 operations an
// element (abs/max, divide, round/clip). Reads are 16 bytes a lane where the
// row allows it, so a warp moves 512 contiguous bytes a load.
#include "quant_common.cuh"

namespace {

constexpr int kThreads = 256;              // 8 rows in flight a block
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) quant_rows_kernel(const T* __restrict__ x,
                                                              int8_t* __restrict__ q,
                                                              float* __restrict__ scale,
                                                              long long G, int gs) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < G; r += nwarps)
    quant::quantize_row_warp(x + r * gs, gs, false, q + r * gs, scale + r, lane);
}

}  // namespace

// q [G, gs] int8 and scale [G] fp32 of groups x [G, gs] (bf16 when x_bf16,
// else fp32); returns the cudaError_t.
extern "C" int dstt_quant_rows(const void* x, int8_t* q, float* scale, long long G, int gs,
                               int x_bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (G == 0 || gs == 0) return cudaSuccess;
  const long long want = (G + kWarps - 1) / kWarps;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (x_bf16) {
    quant_rows_kernel<quant::bf16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const quant::bf16*>(x), q, scale, G, gs);
  } else {
    quant_rows_kernel<float><<<blocks, kThreads, 0, stream>>>(static_cast<const float*>(x), q,
                                                             scale, G, gs);
  }
  return cudaGetLastError();
}
