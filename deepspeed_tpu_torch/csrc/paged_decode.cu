// Paged GQA decode attention: one new query token per sequence against its
// block table, with ALiBi slopes and a causal window when the layer has
// them (the JAX engine's XLA decode path, _xla_paged_decode: slope[h] *
// (key - (ctx - 1)) added in fp32 to the scaled logits; the window keeps
// keys ctx - window .. ctx - 1).
//
// Replaces the TPU kernel _decode_kernel in
// deepspeed_tpu/inference/v2/kernels/pallas_paged_decode.py (reached
// through paged_gqa_decode -> pl.pallas_call). Same function: the GQA group
// of one kv head (g query rows) per program, fp32 online softmax over the
// sequence's pages, NEG_INF masking of keys past the context length (no
// floor), l == 0 -> 0.
//
// Bound on an H100 SXM: bytes. Each (sequence, kv head) reads its context's
// K and V once, 2 * ctx * D * itemsize, plus q and the output; the
// arithmetic is 4 * g * ctx * D a kv head, far below any compute rate.
// Bound = bytes / 3.35 TB/s. A decode step has few (sequence, kv head)
// pairs (llama2-7b's batch of 8: 256; Mixtral's: 64) on 132 SMs, so the
// design is about putting the context's bytes in flight at once:
//
// - Split over the key axis (flash-decoding). A block owns one split of
//   one (sequence, kv head, group of up to GR query rows): the visible keys
//   (from max(0, ctx - window) with a window, else from 0) are cut into
//   units of kUnit keys, at most `splits` splits of whole units a
//   sequence (the host sets `splits` from block_tables.shape[1], with no
//   sync); blocks past a sequence's last split return at once, and the
//   first split of every cell is dispatched first.
// - Coalesced streaming, no shared memory on the way. A lane group of LG
//   lanes reads one K (and V) row as 16-byte vectors (LG = 16 for a 256-byte
//   bf16 row at D 128); each group takes KPG consecutive keys a pass, and
//   the next pass's K and V loads are issued before this pass is consumed.
//   The split's page indices are read once into shared memory (a one-unit
//   split's before its context length arrives, with q's). q (scaled and
//   rounded in the kernel) and the group's slice of the output sit in
//   registers.
// - An online softmax per lane group, so a block synchronizes only twice:
//   once for its pages, once at its end, when its groups' (m, l, acc) are
//   merged in group order.
// - Reduced in the same launch, in a fixed order. With more than one split
//   each block writes its fp32 (m, l, acc) to `partial`; the last block of
//   a (sequence, kv head, row group) to finish, found by a counter, merges
//   the splits in split order, writes the row and resets the counter for
//   the next launch. No float atomics: two runs give the same bits.
//
// Measured (PERF.md): the passes run at the memory system's rate; the
// rest of a block (its page indices, the merges, the counter) is latency
// that only more overlap between blocks would hide.
//
// fp32 runs the same kernel with fp32 loads (4 elements a vector). Any
// head_dim: a row whose byte length is no multiple of 16 (bf16 D 100, odd D)
// takes the NARROW form, whose 16-byte vectors are assembled from loads of
// the widest width the rows' alignment allows (8, 4 or 2 bytes), zero past
// the row, one query row a block; rows above 512 bytes (fp32 D 256, bf16 D
// 512) take 32 lanes a row and at most 2 query rows a block. Rows above
// 1024 bytes are refused (ROADMAP B10).
#include <algorithm>

#include "paged_attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnit = 128;      // keys a split unit
constexpr int kMaxSplits = 16;  // splits a sequence at most
constexpr float kNegInf = -2.3819763e38f;  // pallas_paged_decode NEG_INF

struct DecodeArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  void* out;
  const int* context_lens;
  const int* block_tables;
  float* partial;  // [B, kvH * RC, splits, GR, D + 2]: acc, then m and l
  int* counters;   // [B, kvH * RC], zero between launches
  const float* slopes;  // [H] ALiBi slopes, or null
  int B, H, kvH, P, ps, D, mp, splits, GR, window;
  float scale;
};

// The split plan of one context (mirrored by paged_decode.split_plan):
// the keys lo .. n_keys - 1 (n_keys = min(ctx, mp * ps); lo = max(0, ctx -
// window) with a window, else 0) in units of kUnit from lo; at most
// `splits` splits of `per` whole units each, the last one shorter.
struct Plan {
  int n_keys, lo, per, nsplit;
};
__device__ __forceinline__ Plan plan(int ctx, int mp, int ps, int splits, int window) {
  Plan p;
  p.n_keys = min(max(ctx, 0), mp * ps);
  p.lo = window > 0 ? min(max(ctx - window, 0), p.n_keys) : 0;
  const int units = max(1, (p.n_keys - p.lo + kUnit - 1) / kUnit);
  const int n0 = min(splits, units);
  p.per = (units + n0 - 1) / n0;
  p.nsplit = (units + p.per - 1) / p.per;
  return p;
}

// The 16-byte vector v of a row of `bytes` bytes (row_width w): one load,
// or, NARROW, loads of w bytes, zero past the row's end.
template <bool NARROW>
__device__ __forceinline__ uint4 load_vec(const void* row, int v, int bytes, int w) {
  const char* src = static_cast<const char*>(row) + v * 16;
  if constexpr (!NARROW) {
    return *reinterpret_cast<const uint4*>(src);
  } else {
    union {
      uint4 u;
      uint2 d[2];
      unsigned s[4];
      unsigned short h[8];
    } x;
    x.u = make_uint4(0u, 0u, 0u, 0u);
    const int left = bytes - v * 16;
    if (w == 8) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (8 * i < left) x.d[i] = *reinterpret_cast<const uint2*>(src + 8 * i);
    } else if (w == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * i < left) x.s[i] = *reinterpret_cast<const unsigned*>(src + 4 * i);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (2 * i < left) x.h[i] = *reinterpret_cast<const unsigned short*>(src + 2 * i);
    }
    return x.u;
  }
}

// V elements of type T as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f);
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(h[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// One block: split blockIdx.y of cell blockIdx.x = (sequence, kv head, row
// group) = (b * kvH + kvh) * RC + rc, so the first splits of every cell,
// which always hold keys, are dispatched first. LG lanes a key row, NV
// 16-byte vectors a lane, GR query rows, KPG keys a lane group and pass;
// NARROW rows are no multiple of 16 bytes (load_vec).
template <typename T, int LG, int NV, int GR, int KPG, bool NARROW>
__global__ void __launch_bounds__(kThreads) decode_split(const DecodeArgs a) {
  constexpr int VEC = 16 / sizeof(T);  // elements a vector
  constexpr int NG = kThreads / LG;    // lane groups
  constexpr int PK = NG * KPG;         // keys a pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red_acc = reinterpret_cast<float*>(smem_raw);  // [NG][GR][D]
  float* red_m = red_acc + NG * GR * a.D;                // [NG][GR]: a group's m
  float* red_l = red_m + NG * GR;                        // [NG][GR]: its l
  float* w = red_l + NG * GR;                            // [NG][GR]: its weight
  float* row_l = w + NG * GR;                            // [GR]
  int* pages = reinterpret_cast<int*>(row_l + GR);       // the split's pages
  __shared__ int last;

  const int cell = blockIdx.x, s = blockIdx.y;
  const int g = a.H / a.kvH, RC = (g + GR - 1) / GR;
  const int b = cell / (a.kvH * RC), kvh = cell / RC % a.kvH, r0 = cell % RC * GR;
  const int tid = threadIdx.x, grp = tid / LG, li = tid % LG;
  const int rowb = a.D * (int)sizeof(T), nvec = (rowb + 15) / 16;
  const int lw = dstt::row_width(rowb);  // bytes a load of a NARROW row
  // loads that need no context length, issued before it arrives: q, and
  // the split's pages when it is one unit long (the common case)
  const T* q = static_cast<const T*>(a.q) + ((long long)b * a.H + kvh * g + r0) * a.D;
  uint4 qraw[GR][NV];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * LG;
      qraw[r][j] = r0 + r < g && v < nvec ? load_vec<NARROW>(q + (long long)r * a.D, v, rowb, lw)
                                          : make_uint4(0, 0, 0, 0);
    }
  const int* table = a.block_tables + (long long)b * a.mp;
  const int guess_lo = s * kUnit / a.ps, guess_n = kUnit / a.ps + 2;
  const bool spec = guess_n <= kThreads;
  const int guess = spec && tid < guess_n && guess_lo + tid < a.mp ? table[guess_lo + tid] : 0;
  const int ctx = a.context_lens[b];
  const Plan pl = plan(ctx, a.mp, a.ps, a.splits, a.window);
  if (s >= pl.nsplit) return;
  const int k_lo = pl.lo + s * pl.per * kUnit, k_hi = min(k_lo + pl.per * kUnit, pl.n_keys);
  const int p_lo = k_lo / a.ps;
  if (pl.per == 1 && spec && pl.lo == 0) {
    if (tid < guess_n) pages[tid] = guess;
  } else {
    for (int i = tid; p_lo + i < (k_hi + a.ps - 1) / a.ps; i += kThreads) pages[i] = table[p_lo + i];
  }

  float qf[GR][NV][VEC];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[VEC];
      unpack<T>(qraw[r][j], f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[r][j][e] = dstt::scale_round<T>(f[e], a.scale);
    }

  // ALiBi: each row's slope (0 without), the bias slope * (key - (ctx - 1))
  float slope[GR];
#pragma unroll
  for (int r = 0; r < GR; ++r)
    slope[r] = a.slopes != nullptr && r0 + r < g ? a.slopes[kvh * g + r0 + r] : 0.f;
  const int pos = ctx - 1;

  float m[GR], l[GR], acc[GR][NV][VEC];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][j][e] = 0.f;
  }
  __syncthreads();  // the pages are in shared memory

  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);
  const long long head = (long long)kvh * a.P;
  // pass p: lane group grp takes keys k_lo + p * PK + grp * KPG + i
  auto load = [&](uint4 (&kr)[KPG][NV], uint4 (&vr)[KPG][NV], int p) {
#pragma unroll
    for (int i = 0; i < KPG; ++i) {
      const int key = k_lo + p * PK + grp * KPG + i;
      const bool ok = key < k_hi;
      int page = ok ? pages[key / a.ps - p_lo] : 0;
      page = page < 0 ? 0 : (page >= a.P ? a.P - 1 : page);
      const long long row = ((head + page) * a.ps + key % a.ps) * a.D;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = li + j * LG;
        if (ok && v < nvec) {
          kr[i][j] = load_vec<NARROW>(kp + row, v, rowb, lw);
          vr[i][j] = load_vec<NARROW>(vp + row, v, rowb, lw);
        } else {
          kr[i][j] = vr[i][j] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  };
  // scores (reduced over the group's LG lanes), the online softmax over the
  // pass's keys, then P V
  auto consume = [&](const uint4 (&kr)[KPG][NV], const uint4 (&vr)[KPG][NV], int p) {
    const int k0 = k_lo + p * PK + grp * KPG;
    float sc[KPG][GR];
#pragma unroll
    for (int i = 0; i < KPG; ++i) {
#pragma unroll
      for (int r = 0; r < GR; ++r) sc[i][r] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float kf[VEC];
        unpack<T>(kr[i][j], kf);
#pragma unroll
        for (int r = 0; r < GR; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e) sc[i][r] = fmaf(qf[r][j][e], kf[e], sc[i][r]);
      }
#pragma unroll
      for (int off = LG / 2; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < GR; ++r) sc[i][r] += __shfl_xor_sync(0xffffffffu, sc[i][r], off);
#pragma unroll
      for (int r = 0; r < GR; ++r) sc[i][r] = fmaf(slope[r], (float)(k0 + i - pos), sc[i][r]);
    }
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < KPG; ++i)
        if (k0 + i < k_hi) mx = fmaxf(mx, sc[i][r]);
      const float alpha = expf(m[r] - mx);
      m[r] = mx;
      float pr[KPG], sum = 0.f;
#pragma unroll
      for (int i = 0; i < KPG; ++i) {
        pr[i] = k0 + i < k_hi ? expf(sc[i][r] - mx) : 0.f;
        sum += pr[i];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][j][e] *= alpha;
#pragma unroll
      for (int i = 0; i < KPG; ++i)
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vf[VEC];
          unpack<T>(vr[i][j], vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][j][e] = fmaf(pr[i], vf[e], acc[r][j][e]);
        }
    }
  };
  // two passes in flight: the next pass's loads are issued before this
  // one is consumed (the pass count is the same in every lane: the
  // shuffles take whole warps; a group's keys past k_hi are masked)
  const int n_pass = (k_hi - k_lo + PK - 1) / PK;
  uint4 ka[KPG][NV], va[KPG][NV], kb[KPG][NV], vb[KPG][NV];
  if (n_pass > 0) load(ka, va, 0);
  for (int p = 0; p < n_pass; p += 2) {
    if (p + 1 < n_pass) load(kb, vb, p + 1);
    consume(ka, va, p);
    if (p + 1 >= n_pass) break;
    if (p + 2 < n_pass) load(ka, va, p + 2);
    consume(kb, vb, p + 1);
  }

  // merge the lane groups in group order
#pragma unroll
  for (int r = 0; r < GR; ++r) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = li + j * LG;
      if (v < nvec) {
        float* dst = red_acc + (grp * GR + r) * a.D + v * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (!NARROW || v * VEC + e < a.D) dst[e] = acc[r][j][e];
      }
    }
    if (li == 0) {
      red_m[grp * GR + r] = m[r];
      red_l[grp * GR + r] = l[r];
    }
  }
  __syncthreads();
  if (tid < GR) {
    float mx = kNegInf;
    for (int gi = 0; gi < NG; ++gi) mx = fmaxf(mx, red_m[gi * GR + tid]);
    float sum = 0.f;
    for (int gi = 0; gi < NG; ++gi) {
      const float wg = expf(red_m[gi * GR + tid] - mx);
      w[gi * GR + tid] = wg;
      sum += wg * red_l[gi * GR + tid];
    }
    red_m[tid] = mx;  // group 0's slot, read after the barrier
    row_l[tid] = sum;
  }
  __syncthreads();
  const int rows = min(GR, g - r0);
  T* out = static_cast<T*>(a.out) + ((long long)b * a.H + kvh * g + r0) * a.D;
  if (pl.nsplit == 1) {
    for (int i = tid; i < rows * a.D; i += kThreads) {
      const int r = i / a.D, d = i - r * a.D;
      float o = 0.f;
      for (int gi = 0; gi < NG; ++gi) o = fmaf(w[gi * GR + r], red_acc[(gi * GR + r) * a.D + d], o);
      const float den = row_l[r];
      out[i] = dstt::from_float<T>(den > 0.f ? o / den : 0.f);
    }
    return;
  }

  // this split's partial, then the counter of its (sequence, kv head, row group)
  const int stride = GR * (a.D + 2);
  float* part = a.partial + (long long)cell * a.splits * stride;
  for (int i = tid; i < GR * a.D; i += kThreads) {
    const int r = i / a.D, d = i - r * a.D;
    float o = 0.f;
    for (int gi = 0; gi < NG; ++gi) o = fmaf(w[gi * GR + r], red_acc[(gi * GR + r) * a.D + d], o);
    part[s * stride + r * (a.D + 2) + d] = o;
  }
  if (tid < GR) {
    part[s * stride + tid * (a.D + 2) + a.D] = red_m[tid];
    part[s * stride + tid * (a.D + 2) + a.D + 1] = row_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.counters[cell], 1) == pl.nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block merges the splits in split order, each thread its
  // elements of the rows: every split's m, l and partial loaded at once
  for (int i = tid; i < rows * a.D; i += kThreads) {
    const int r = i / a.D, d = i - r * a.D;
    float v[kMaxSplits], ms[kMaxSplits], ls[kMaxSplits];
#pragma unroll
    for (int t = 0; t < kMaxSplits; ++t) {
      const float* pt = part + t * stride + r * (a.D + 2);
      v[t] = t < pl.nsplit ? __ldcg(pt + d) : 0.f;
      ms[t] = t < pl.nsplit ? __ldcg(pt + a.D) : kNegInf;
      ls[t] = t < pl.nsplit ? __ldcg(pt + a.D + 1) : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < kMaxSplits; ++t) mx = fmaxf(mx, ms[t]);
    float o = 0.f, den = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxSplits; ++t)
      if (t < pl.nsplit) {
        const float wt = expf(ms[t] - mx);
        o = fmaf(wt, v[t], o);
        den = fmaf(wt, ls[t], den);
      }
    out[i] = dstt::from_float<T>(den > 0.f ? o / den : 0.f);
  }
  if (tid == 0) a.counters[cell] = 0;  // ready for the next launch
}

template <typename T, int LG, int NV, int GR, bool NARROW>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  constexpr int KPG = GR >= 8 ? 2 : 4;
  auto kernel = decode_split<T, LG, NV, GR, KPG, NARROW>;
  const int NG = kThreads / LG, g = a.H / a.kvH;
  // a split's pages: per units of kUnit keys and a page on each side
  const int units = std::max(1, (a.mp * a.ps + kUnit - 1) / kUnit);
  const int per = (units + std::min(a.splits, units) - 1) / std::min(a.splits, units);
  const size_t smem = sizeof(float) * ((size_t)NG * GR * a.D + 3 * (size_t)NG * GR + GR) +
                      sizeof(int) * ((size_t)per * kUnit / a.ps + 2);
  cudaError_t err = dstt::reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.kvH * ((g + GR - 1) / GR), a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Rows of 32 lanes (more than 512 bytes) take at most 2 query rows a block
// (paged_decode.row_group): the registers of more would spill. NARROW rows
// take one query row a block: a form built for every row group would double
// this file's build time for shapes no preset has (a GQA group at an odd
// head_dim).
template <typename T, int LG, int NV, bool NARROW>
cudaError_t by_rows(const DecodeArgs& a, cudaStream_t stream) {
  if (a.GR == 1) return launch<T, LG, NV, 1, NARROW>(a, stream);
  if constexpr (!NARROW) {
    if (a.GR == 2) return launch<T, LG, NV, 2, NARROW>(a, stream);
    if constexpr (LG < 32) {
      switch (a.GR) {
        case 4: return launch<T, LG, NV, 4, NARROW>(a, stream);
        case 8: return launch<T, LG, NV, 8, NARROW>(a, stream);
      }
    }
  }
  return cudaErrorInvalidValue;
}

// lanes a row and vectors a lane by the row's 16-byte vectors (the last
// one partial in the NARROW form)
template <typename T, bool NARROW>
cudaError_t by_width(const DecodeArgs& a, cudaStream_t stream) {
  const int nvec = (a.D * (int)sizeof(T) + 15) / 16;
  if (nvec <= 8) return by_rows<T, 8, 1, NARROW>(a, stream);
  if (nvec <= 16) return by_rows<T, 16, 1, NARROW>(a, stream);
  if (nvec <= 32) return by_rows<T, 16, 2, NARROW>(a, stream);
  if (nvec <= 64) return by_rows<T, 32, 2, NARROW>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_type(const DecodeArgs& a, cudaStream_t stream) {
  return a.D * sizeof(T) % 16 ? by_width<T, true>(a, stream) : by_width<T, false>(a, stream);
}

}  // namespace

// q (unscaled) [B, H, D], k_pages / v_pages [kvH, P, ps, D], out [B, H, D];
// context_lens [B], block_tables [B, mp] int32; partial and counters as
// DecodeArgs says, sized by the caller for `splits` splits of GR rows
// (counters zero); slopes [H] fp32 or null; window 0 = global. Any D up to
// 1024 bytes a row; q, the pool and out 16-byte aligned.
// Returns the cudaError_t.
extern "C" int dstt_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                 void* out, const int* context_lens, const int* block_tables,
                                 float* partial, int* counters, const float* slopes, int B,
                                 int H, int kvH, int P, int ps, int D, int mp, int splits, int GR,
                                 int window, float scale, int is_bf16, void* stream) {
  if (B == 0) return cudaSuccess;
  if (splits < 1 || splits > kMaxSplits) return cudaErrorInvalidValue;
  const DecodeArgs a{q, k_pages, v_pages, out, context_lens, block_tables, partial, counters,
                     slopes, B, H, kvH, P, ps, D, mp, splits, GR, window, scale};
  auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_type<__nv_bfloat16>(a, s) : by_type<float>(a, s);
}
