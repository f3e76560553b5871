// Fused Lion step over one flat bucket of parameters.
//
// Replaces the TPU kernel _lion_kernel in deepspeed_tpu/ops/lion/pallas_lion.py
// (reached through lion_bucket_update -> pl.pallas_call). The one-moment
// sibling of fused_adam.cu: same bucket layout, same typed loads and stores,
// same stochastic-rounding stream (opt_common.cuh). Element by element, in
// the Pallas kernel's fp32 order:
//
//   g  = g_in * gscale                 (unscale x clip, a device scalar)
//   c  = b1 * m + (1 - b1) * g
//   u  = sign(c)                       (sign(0) = 0, NaN stays NaN)
//   u  = u + wd * p                    (decoupled weight decay)
//   p2 = p - lr * u
//   m2 = b2 * m + (1 - b2) * g
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn), so nvcc contracts nothing into an FMA. That matters more here
// than for Adam: where b1 * m and (1 - b1) * g cancel, a fused multiply-add
// can flip the sign, which moves the parameter by 2 * lr. With the
// intrinsics the kernel and its plain version agree bit for bit on the card.
// (1 - b) arrives rounded to fp32 once, as the Pallas closure forms it.
//
// One launch per bucket, one element per thread in a grid-stride loop. It
// reads g, p and m once and writes the master (at its stored dtype), the
// optional param-dtype cast and m at its stored dtype (bf16 with stochastic
// rounding, slot 1 of the Adam stream: the same bits as the Adam first
// moment for the same bucket, step and value). Master and m may be updated
// in place (out pointer == in pointer): each element is read and written by
// the same thread, the counterpart of the Pallas call's input_output_aliases.
//
// Bound on an H100 SXM: bytes. 20 bytes an element with bf16 grads, fp32
// master and moment and a bf16 param cast, for about 8 flops. Loads and
// stores are coalesced 2- and 4-byte accesses.
#include "opt_common.cuh"

// Everything a launch reads, passed by value.
struct LionParams {
  const void* g;
  const void* p;
  const void* m;
  void* p_out;      // master out (may alias p)
  void* cast_out;   // param-dtype cast, or null
  void* m_out;      // may alias m
  const float* gscale;  // device scalar, or null for 1
  long long n;
  float lr;
  float beta1, one_minus_beta1, beta2, one_minus_beta2, weight_decay;
  unsigned int seed_m;
  int g_dt, p_dt, m_dt, p_out_dt, cast_dt;
  int sr_m;
};

namespace {

__global__ void __launch_bounds__(256) fused_lion_kernel(const LionParams a) {
  const float gs = a.gscale != nullptr ? *a.gscale : 1.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    const float g = __fmul_rn(load(a.g, i, a.g_dt), gs);
    const float p = load(a.p, i, a.p_dt);
    const float m = load(a.m, i, a.m_dt);
    const float c = __fadd_rn(__fmul_rn(a.beta1, m), __fmul_rn(a.one_minus_beta1, g));
    float u = c > 0.f ? 1.f : (c < 0.f ? -1.f : c);
    if (a.weight_decay != 0.f) u = __fadd_rn(u, __fmul_rn(a.weight_decay, p));
    const float p2 = __fsub_rn(p, __fmul_rn(a.lr, u));
    const float m2 = __fadd_rn(__fmul_rn(a.beta2, m), __fmul_rn(a.one_minus_beta2, g));
    store(a.p_out, i, a.p_out_dt, p2, false, 0u);
    if (a.cast_out != nullptr) store(a.cast_out, i, a.cast_dt, p2, false, 0u);
    store(a.m_out, i, a.m_dt, m2, a.sr_m != 0, a.seed_m);
  }
}

}  // namespace

// One fused step over the bucket's n elements; returns the cudaError_t.
extern "C" int dstt_fused_lion(LionParams a, void* stream) {
  if (a.n == 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (a.n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fused_lion_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
