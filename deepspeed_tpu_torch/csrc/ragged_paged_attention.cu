// Ragged paged attention: one launch per layer for a mixed prefill/decode
// wave against the paged KV pool.
//
// Replaces the TPU kernel _wave_kernel in
// deepspeed_tpu/inference/v2/kernels/ragged_paged_attention.py (reached
// through ragged_paged_attention -> _wave_call -> pl.pallas_call). Same
// function: per atom (<= block_q query tokens of one sequence), fp32
// online softmax over the atom's pages, bottom-right causal mask
//   (col < valid) & (col + j*ps <= kv_len - q_len + t),
// MASK_VALUE masking with the HALF_MASK floor, so no row produces NaN.
//
// Design: grid (A atoms, kv heads), 128 threads. The Pallas grid's
// sequential page axis becomes a loop inside the block over tiles of 64
// keys (four 16-token pages), double-buffered in shared memory with
// cp.async (paged_attention_common.cuh); there is no per-page program and
// no state shared between blocks. Unlike the Pallas call, the kernel reads
// the flat token stream q [N, H, D] and writes the flat output directly
// (atom a owns rows cu_q_lens[a]..cu_q_lens[a+1]), so the wrapper needs no
// scatter into atom tiles and no gather back. Zero-length padding atoms
// return at once.
//
// Bound on an H100 SXM: bytes. A wave reads each sequence's KV once
// (2 * kv_len * D * itemsize per kv head) plus q and the output; the
// arithmetic is 4 * q_rows * kv_len * D per head, far below the bf16
// tensor-core rate at these sizes. Bound = unique bytes / 3.35 TB/s.
//
// What the simple design leaves on the table (later work), measured in
// PERF.md: on prefill waves the kernel runs some 35x its bound.
// - a prefill chunk's atoms each re-read the sequence's history, so a
//   256-token chunk reads its context 32 times (from L2 when it fits);
// - scores and P.V run on CUDA cores in fp32 (a thread carries up to 4
//   query rows in registers), no tensor cores (mma / wgmma), no TMA.
#include "paged_attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(dstt::kThreads)
ragged_wave_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, T* __restrict__ out,
                   const int* __restrict__ cu_q_lens, const int* __restrict__ kv_lens,
                   const int* __restrict__ page_indices, int H, int kvH, int P, int ps,
                   int D, int MP, int block_q) {
  const int a = blockIdx.x, kvh = blockIdx.y;
  const int row0 = cu_q_lens[a];
  int q_len = cu_q_lens[a + 1] - row0;
  // the wave builder never makes an atom longer than block_q; clamping
  // keeps a malformed descriptor inside the shared-memory tile
  q_len = q_len > block_q ? block_q : q_len;
  if (q_len <= 0) return;
  const long tok = (long)H * D;
  dstt::attend_pages<T, dstt::RaggedMask>(
      q + row0 * tok, out + row0 * tok, k_pages, v_pages, page_indices + (long)a * MP, MP,
      H, kvh, H / kvH, P, ps, D, q_len, kv_lens[a]);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, void* out,
                   const int* cu_q_lens, const int* kv_lens, const int* page_indices, int A,
                   int H, int kvH, int P, int ps, int D, int MP, int block_q,
                   cudaStream_t stream) {
  const size_t smem = dstt::smem_bytes<T>(block_q * (H / kvH), ps, D);
  cudaError_t err = dstt::reserve_smem(ragged_wave_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ragged_wave_kernel<T><<<dim3(A, kvH), dstt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), cu_q_lens, kv_lens,
      page_indices, H, kvH, P, ps, D, MP, block_q);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled) [N, H, D], k_pages / v_pages [kvH, P, ps, D], out [N, H, D]
// (rows outside every atom are left untouched); cu_q_lens [A+1],
// kv_lens [A], page_indices [A, MP] int32. Returns the cudaError_t.
extern "C" int dstt_ragged_paged_attention(const void* q, const void* k_pages,
                                           const void* v_pages, void* out,
                                           const int* cu_q_lens, const int* kv_lens,
                                           const int* page_indices, int A, int H, int kvH,
                                           int P, int ps, int D, int MP, int block_q,
                                           int is_bf16, void* stream) {
  if (A == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k_pages, v_pages, out, cu_q_lens, kv_lens,
                                         page_indices, A, H, kvH, P, ps, D, MP, block_q, s)
                 : launch<float>(q, k_pages, v_pages, out, cu_q_lens, kv_lens, page_indices,
                                 A, H, kvH, P, ps, D, MP, block_q, s);
}
