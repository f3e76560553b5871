// Paged GQA decode attention: one new query token per sequence against its
// block table.
//
// Replaces the TPU kernel _decode_kernel in
// deepspeed_tpu/inference/v2/kernels/pallas_paged_decode.py (reached
// through paged_gqa_decode -> pl.pallas_call). Same function: the GQA group
// of one kv head (g query rows) per program, fp32 online softmax over the
// sequence's pages, NEG_INF masking of columns past the context length.
//
// Design: grid (sequences, kv heads), 128 threads, the Pallas grid's
// sequential page axis as a loop inside the block over tiles of 64 keys,
// double-buffered in shared memory with cp.async
// (paged_attention_common.cuh).
//
// Bound on an H100 SXM: bytes. Each (sequence, kv head) reads its context's
// K and V once, 2 * ctx * D * itemsize, plus q and the output; the
// arithmetic is 4 * g * ctx * D per kv head. Bound = bytes / 3.35 TB/s.
//
// What the simple design leaves on the table (later work), measured in
// PERF.md: with few sequences (8 x 32 heads = 256 blocks) each block
// streams its whole context alone, so the card is far from its memory
// rate; a split over the key axis (flash-decoding) would put more blocks
// on the card, and with g == 1 (llama2-7b's MHA) a block has one query
// row, so half its threads idle in the score loop and the P.V loop is two
// dependent chains a thread.
#include "paged_attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(dstt::kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, T* __restrict__ out,
                    const int* __restrict__ context_lens, const int* __restrict__ block_tables,
                    int H, int kvH, int P, int ps, int D, int mp) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const long tok = (long)H * D;
  dstt::attend_pages<T, dstt::DecodeMask>(
      q + b * tok, out + b * tok, k_pages, v_pages, block_tables + (long)b * mp, mp, H, kvh,
      H / kvH, P, ps, D, /*q_len=*/1, context_lens[b]);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, void* out,
                   const int* context_lens, const int* block_tables, int B, int H, int kvH,
                   int P, int ps, int D, int mp, cudaStream_t stream) {
  const size_t smem = dstt::smem_bytes<T>(H / kvH, ps, D);
  cudaError_t err = dstt::reserve_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T><<<dim3(B, kvH), dstt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), context_lens, block_tables, H,
      kvH, P, ps, D, mp);
  return cudaGetLastError();
}

}  // namespace

// q (pre-scaled) [B, H, D], k_pages / v_pages [kvH, P, ps, D], out [B, H, D];
// context_lens [B], block_tables [B, mp] int32. Returns the cudaError_t.
extern "C" int dstt_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                 void* out, const int* context_lens, const int* block_tables,
                                 int B, int H, int kvH, int P, int ps, int D, int mp,
                                 int is_bf16, void* stream) {
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k_pages, v_pages, out, context_lens, block_tables,
                                         B, H, kvH, P, ps, D, mp, s)
                 : launch<float>(q, k_pages, v_pages, out, context_lens, block_tables, B, H,
                                 kvH, P, ps, D, mp, s);
}
