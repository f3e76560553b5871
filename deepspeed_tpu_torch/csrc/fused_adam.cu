// Fused Adam / AdamW / LAMB step over one flat bucket of parameters.
//
// Replaces the TPU kernel _adam_kernel in deepspeed_tpu/ops/adam/pallas_adam.py
// (reached through adam_bucket_update -> pl.pallas_call). Same function,
// element by element, in the same fp32 order:
//
//   g  = g_in * gscale                 (unscale x clip, a device scalar)
//   g  = g + wd * p                    (adam: coupled weight decay)
//   m2 = b1 * m + (1 - b1) * g
//   v2 = b2 * v + (1 - b2) * g * g
//   u  = (m2 / bcd1) / (sqrt(v2 / bcd2) + eps)   bcd = 1 - b^t, a divide
//   u  = u + wd * p                    (adamw: decoupled)
//   p2 = p - lr * u                    (lamb: u = m2 / (sqrt(v2) + eps) + wd * p,
//                                       written instead of p2)
//
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so nvcc contracts nothing into an FMA and the
// fp32 moments are bit for bit those of the plain version. bf16 moment
// stores use the Pallas kernel's stochastic rounding: triple32 hash of
// (element index in the bucket ^ seed), its low 16 bits added to the fp32
// bits before truncation (_hash32, _sr_to_bf16_bits); the index counts the
// bucket's lane padding, as _global_idx does. Other narrow stores round to
// nearest.
//
// One launch per bucket, one element per thread in a grid-stride loop. It
// reads g, p, m and v once and writes the master (at its stored dtype), the
// optional param-dtype cast and m, v at their stored dtypes. Master, m and
// v may be updated in place (out pointer == in pointer): each element is
// read and written by the same thread, the counterpart of the Pallas call's
// input_output_aliases.
//
// Bound on an H100 SXM: bytes. About 4 flops per byte moved (28 bytes an
// element with bf16 grads, fp32 master and moments, bf16 param cast), far
// below the ~295 flops a byte where the card turns compute-bound. Loads and
// stores are coalesced 2- and 4-byte accesses; wider vector accesses are
// later work.
#include "opt_common.cuh"

// Everything a launch reads, passed by value.
struct AdamParams {
  const void* g;
  const void* p;
  const void* m;
  const void* v;
  void* p_out;      // master out (may alias p)
  void* cast_out;   // param-dtype cast, or null
  void* m_out;      // may alias m
  void* v_out;      // may alias v
  const float* gscale;  // device scalar, or null for 1
  long long n;
  float lr, bcd1, bcd2;
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay;
  unsigned int seed_m, seed_v;
  int mode;
  int g_dt, p_dt, m_dt, v_dt, p_out_dt, cast_dt;
  int sr_m, sr_v;
};

namespace {

enum Mode : int { kAdam = 0, kAdamW = 1, kLamb = 2 };

__global__ void __launch_bounds__(256) fused_adam_kernel(const AdamParams a) {
  const float gs = a.gscale != nullptr ? *a.gscale : 1.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.n; i += stride) {
    float g = __fmul_rn(load(a.g, i, a.g_dt), gs);
    const float p = load(a.p, i, a.p_dt);
    const float m = load(a.m, i, a.m_dt);
    const float v = load(a.v, i, a.v_dt);
    if (a.mode == kAdam && a.weight_decay != 0.f) g = __fadd_rn(g, __fmul_rn(a.weight_decay, p));
    const float m2 = __fadd_rn(__fmul_rn(a.beta1, m), __fmul_rn(a.one_minus_beta1, g));
    const float v2 =
        __fadd_rn(__fmul_rn(a.beta2, v), __fmul_rn(__fmul_rn(a.one_minus_beta2, g), g));
    if (a.mode == kLamb) {
      const float u = __fadd_rn(__fdiv_rn(m2, __fadd_rn(__fsqrt_rn(v2), a.eps)),
                                __fmul_rn(a.weight_decay, p));
      store(a.p_out, i, a.p_out_dt, u, false, 0u);
    } else {
      const float mhat = __fdiv_rn(m2, a.bcd1);
      const float vhat = __fdiv_rn(v2, a.bcd2);
      float u = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), a.eps));
      if (a.mode == kAdamW && a.weight_decay != 0.f) u = __fadd_rn(u, __fmul_rn(a.weight_decay, p));
      const float p2 = __fsub_rn(p, __fmul_rn(a.lr, u));
      store(a.p_out, i, a.p_out_dt, p2, false, 0u);
      if (a.cast_out != nullptr) store(a.cast_out, i, a.cast_dt, p2, false, 0u);
    }
    store(a.m_out, i, a.m_dt, m2, a.sr_m != 0, a.seed_m);
    store(a.v_out, i, a.v_dt, v2, a.sr_v != 0, a.seed_v);
  }
}

}  // namespace

// One fused step over the bucket's n elements; returns the cudaError_t.
extern "C" int dstt_fused_adam(AdamParams a, void* stream) {
  if (a.n == 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (a.n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  fused_adam_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
