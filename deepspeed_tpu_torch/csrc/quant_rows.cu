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
// chunks. The row arithmetic, why it matches the jitted JAX wire bit for bit
// with one multiply a value (quantize_scaled), and the three row forms are in
// quant_common.cuh, shared with moe_dispatch.cu's int8 dispatch gather; this
// file gives them the rows of groups.
//
// Bound on an H100 SXM: bytes. An element costs its input (4 or 2 bytes) and
// its int8 output; a row adds its 4-byte scale: the wire's main case (22528
// rows of 256 bf16, a tinyllama MLP shard) moves 17.39 MB, 0.0052 ms at 3.35
// TB/s. What the arithmetic costs (an abs and max, then a multiply, a round
// and a clip a value) must hide under the loads, so each row is read from
// device memory once (the lanes and block forms), every walker keeps its
// next rows' loads in flight while it quantizes, and the card holds as many
// warps as it can (the wrapper's launch plan, ops/quantizer/quant.py
// plan_rows, asks for up to 8 blocks of 256 threads an SM; the launcher
// takes no more than the kernel's occupancy lets the card hold). At the
// main case a row of 512 bytes is a warp's, one 16-byte unit a lane, two
// rows in flight; gs 4096 (8 or 16 KB) a block's. 16-byte units are loaded
// with ld.global.cs (evict-first): a row is read once.
#include "quant_common.cuh"

namespace {

using quant::bf16;

// Row r of groups x [G, gs]: no key to read first, never a row of zeros.
template <typename T>
struct GroupRows {
  typedef T Elem;
  struct Key {};
  static constexpr bool kZeroRows = false;
  static constexpr bool kEvictFirst = true;
  const T* x;
  int gs;
  __device__ __forceinline__ Key key(long long) const { return Key(); }
  __device__ __forceinline__ const T* row(Key, long long r) const { return x + r * gs; }
};

template <typename T>
int launch(const T* x, int8_t* q, float* scale, long long G, int gs, int form, int vec,
           int lg2p, int units, int blocks, cudaStream_t stream) {
  if (vec && ((reinterpret_cast<uintptr_t>(x) & 15) || (gs * sizeof(T)) % 16 ||
              (reinterpret_cast<uintptr_t>(q) & 15)))
    return cudaErrorInvalidValue;
  return quant::launch_rows(GroupRows<T>{x, gs}, q, scale, G, gs, form, vec, lg2p, units, blocks,
                            stream);
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
  if (x_bf16)
    return launch(static_cast<const bf16*>(x), q, scale, G, gs, form, vec, lg2p, units, blocks,
                  stream);
  return launch(static_cast<const float*>(x), q, scale, G, gs, form, vec, lg2p, units, blocks,
                stream);
}
