// Ragged paged attention: one launch per layer for a mixed prefill/decode
// wave against the paged KV pool.
//
// Replaces the TPU kernel _wave_kernel in
// deepspeed_tpu/inference/v2/kernels/ragged_paged_attention.py (reached
// through ragged_paged_attention -> _wave_call -> pl.pallas_call). Same
// function: per atom (query tokens of one sequence), fp32 online softmax
// over the atom's pages, bottom-right causal mask (query t of an atom sits
// at position kv_len - q_len + t and sees keys up to it), MASK_VALUE
// masking with the HALF_MASK floor, so no row produces NaN; l == 0 -> 0;
// rows past cu_q_lens[A] (stream padding) are zero. Both forms below scale
// q and round it to its type themselves (bf16(float(q) * scale)) and write
// the padding rows, so a call is one launch. Both take ALiBi slopes ([H]
// fp32, null for none: slope[h] * (key - pos) added in fp32 to the scaled
// logits before the mask) and a causal window (0 = global: a row at pos
// sees keys pos - window + 1 .. pos); the JAX engine sends such waves to its
// XLA path, whose function this is.
//
// Bound on an H100 SXM: bytes. A wave reads each sequence's KV once
// (2 * kv_len * D * itemsize a kv head) plus q and the output; the
// arithmetic, 4 * q_rows * kv_len * D a head, is far below the bf16
// tensor-core rate at these sizes. Bound = unique bytes / 3.35 TB/s.
//
// bf16 (wave_wgmma): tensor cores, one K/V stream a 64-row query tile.
// - A query tile is up to 64 rows (64 / g tokens x g heads of one kv
//   head) of consecutive atoms of one sequence. Atom a continues atom a - 1
//   when kv_lens[a] - q_len[a] == kv_lens[a - 1] and their block tables
//   agree on atom a - 1's pages; a run of such atoms is plainly causal
//   (row t at position pos0 + t), whatever the atoms' lengths. A run is cut
//   into tiles at its first row and at every row whose position is a
//   multiple of 64 / g, so a tile's first row is found from its own atom
//   and the tile ends where the next one begins. Each block builds the
//   list (the rule of ragged_paged_attention.wave_tiles: the descriptors
//   and the first 16 table entries of each atom and its neighbour in
//   one round of loads, a block scan), then walks (tile, kv head) items, a
//   persistent grid of as many blocks as fit on the card.
// - A producer warp TMA-loads the K and V rows of each step of 64 keys,
//   a page at a time by the block table (the pool viewed as
//   [kvH * P * ps, D] rows, 128-byte swizzled; the table's entries read 32
//   at a time, one a lane), into a two-stage mbarrier ring; the ring runs
//   on from one item into the next.
// - The consumer warpgroup loads its Q tile (scaled, rounded, swizzled)
//   itself, computes S = Q K^T with wgmma (both operands K-major in shared
//   memory), an exp2 online softmax in registers, and O += P V with P from
//   registers and V through wgmma's transpose bit, as flash_fwd.cu does.
//   Only steps that reach a row's diagonal or the table's end are masked.
// - ALiBi and windows (the EXTRA form, a template of its own so the plain
//   form's code is unchanged): the steps wholly below the tile's first
//   window are skipped (both roles start at the same step); a step that
//   reaches the last row's lower window edge is masked there too; with
//   ALiBi every step takes the masked path, which adds the bias to the raw
//   dot before the log2 e scaling (x = (dot + slope * (key - pos)) log2 e).
//
// Measured (PERF.md): a 2 x 256 prefill wave spends about a quarter of
// the launch on the tile list, a quarter waiting for its first K/V step and
// the rest in the longest tile's steps, which the two-stage ring paces at
// the memory's latency.
//
// fp32, and shapes the tiles do not take (head_dim other than 64 / 128,
// any of them: open-llama-3b's 100, the tiny presets' 16, odd ones; page
// sizes other than 16, 32 or a multiple of 64, GQA groups above 64 rows),
// keep the CUDA-core kernel (ragged_wave_kernel, one block an atom and kv
// head, attend_rows in paged_attention_common.cuh); the wrapper picks the
// form (kernels/ragged_paged_attention.py).
#include <algorithm>

#include "hopper.cuh"
#include "paged_attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- bf16: the tensor-core wave kernel ------------------------------------------

constexpr int kRows = 64;        // query rows a tile
constexpr int kKeys = 64;        // keys a pipeline step
constexpr int kStages = 2;       // steps in flight
constexpr int kTcThreads = 160;  // a consumer warpgroup and a producer warp
constexpr int kSW = 128;         // swizzle: a region row is 64 bf16 columns
constexpr int kWarp = 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemMax = 232448;  // shared memory a block may use

struct WaveArgs {
  const bf16* q;        // [N, H, D], unscaled
  bf16* out;            // [N, H, D]
  const int* cu;        // [A + 1]
  const int* kv_lens;   // [A]
  const int* pages;     // [A, MP]
  const float* slopes;  // [H] ALiBi slopes, or null
  int N, A, H, kvH, P, ps, MP, max_tiles, window;
  float scale;
};

constexpr int kNoEdge = -(1 << 30);  // a lower key bound below every key

// Floor division and its remainder, for x of any sign (d > 0).
__device__ __forceinline__ int floor_div(int x, int d) { return x >= 0 ? x / d : -((-x + d - 1) / d); }
__device__ __forceinline__ int floor_mod(int x, int d) { return x - floor_div(x, d) * d; }

// The tiles that begin in an atom whose rows start at stream row `row0`
// and position p0 (ql > 0 rows): at its first row when it starts a run
// (`cont` false), and at each of its rows whose position is a multiple of
// TT. Writes their first rows (and the atom i) from list index k when
// `row` is given; returns how many.
__device__ int begin_tiles(int row0, int ql, int p0, bool cont, int TT, int i, int* row,
                           int* atom, int k, int cap) {
  if (ql <= 0) return 0;
  const bool extra = !cont && floor_mod(p0, TT) != 0;
  const int n = floor_div(p0 + ql - 1, TT) - floor_div(p0 - 1, TT) + (extra ? 1 : 0);
  if (row != nullptr) {
    int kk = k;
    for (int pos = extra ? p0 : p0 + floor_mod(-p0, TT); pos < p0 + ql; ++kk) {
      if (kk < cap) row[kk] = row0 + pos - p0, atom[kk] = i;
      pos += extra && pos == p0 ? floor_mod(-p0, TT) : TT;
    }
  }
  return n;
}

struct Tile {
  int row0, rows, pos0, n_keys, steps, first;  // first: the first step any row sees
  const int* table;
};

// Tile k of n: rows [row[k], row[k + 1]) (the last one to cu[A]), the
// position of its first row, the keys its last row sees (capped at the
// table's MP * ps), and the table of the atom of its last row, which
// agrees with every earlier atom of the run on that atom's pages.
__device__ __forceinline__ Tile tile_at(const WaveArgs& a, const int* cu, const int* kv,
                                        const int* row, const int* atom, int n, int k, int g) {
  Tile t;
  t.row0 = row[k];
  const int row1 = k + 1 < n ? row[k + 1] : cu[a.A];
  const int a0 = atom[k];
  int a1 = a0;
  while (a1 + 1 < a.A && cu[a1 + 1] <= row1 - 1) ++a1;
  const int n_tok = row1 - t.row0;
  t.rows = n_tok * g;
  t.pos0 = kv[a0] - (cu[a0 + 1] - cu[a0]) + (t.row0 - cu[a0]);
  t.n_keys = max(0, min(t.pos0 + n_tok, a.MP * a.ps));
  t.steps = (t.n_keys + kKeys - 1) / kKeys;
  t.first = a.window > 0 ? max(0, t.pos0 - a.window + 1) / kKeys : 0;
  t.table = a.pages + (long long)a1 * a.MP;
  return t;
}

// S = Q K^T of the 64-row tile against one step's 64 keys; one commit group.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[kKeys / 2], const char* q_t, const char* k_t) {
  using namespace hopper;
  wg_fence();
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint64_t dq = desc_k<kSW>(q_t, kRows, 0, j), dk = desc_k<kSW>(k_t, kKeys, 0, j);
    if (j == 0) mma_ss0<kKeys>(sc, dq, dk);
    else mma_ss<kKeys>(sc, dq, dk);
  }
  wg_commit();
}

// O += P V, P in registers, V MN-major in shared memory; one commit group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[kKeys / 16][4],
                                         const char* v_t) {
  using namespace hopper;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) mma_rs_mn<D>(o, p[kk], desc_mn<kSW>(v_t, kKeys, kk));
  wg_commit();
}

// The online softmax of one step in the log2 domain: the raw dots in sc
// become p = 2^(x - m) in place (x = dot * log2 e, or MASK_VALUE where the
// key is not visible: at or past hi[r] of the thread's two rows, offsets
// from its first column; EXTRA: also below lo[r], and x = (dot + slope[r] *
// (c + cb[r])) * log2 e, cb[r] the key minus the position at offset 0);
// m, l (this lane's columns) and O's factor alpha follow. `inner`: every
// key of the step is visible to every row, with no bias.
template <bool EXTRA>
__device__ __forceinline__ void softmax(float (&sc)[kKeys / 2], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], bool inner, const int (&hi)[2],
                                        const int (&lo)[2], const float (&slope)[2],
                                        const float (&cb)[2]) {
  using dstt::kFloor;
  using dstt::kMask;
  using hopper::ex2;
  float mx[2] = {kMask, kMask};
  if (inner) {
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    mx[0] *= kLog2e;
    mx[1] *= kLog2e;
  } else {
#pragma unroll
    for (int e = 0; e < kKeys / 2; ++e) {
      const int r = (e >> 1) & 1, c = 8 * (e >> 2) + (e & 1);
      if constexpr (EXTRA) {
        const float x = fmaf(slope[r], (float)c + cb[r], sc[e]);
        sc[e] = c < hi[r] && c >= lo[r] ? x * kLog2e : kMask;
      } else {
        sc[e] = c < hi[r] ? sc[e] * kLog2e : kMask;
      }
      mx[r] = fmaxf(mx[r], sc[e]);
    }
  }
  float m_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_next = fmaxf(m[r], mx[r]);
    m_safe[r] = fmaxf(m_next, kFloor);
    alpha[r] = ex2(fmaxf(m[r], kFloor) - m_safe[r]);
    m[r] = m_next;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < kKeys / 2; ++e) {
    const int r = (e >> 1) & 1;
    sc[e] = inner ? ex2(fmaf(sc[e], kLog2e, -m_safe[r])) : ex2(sc[e] - m_safe[r]);
    rs[r] += sc[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
}

template <int D>
__host__ __device__ constexpr int tile_bytes() { return kRows * D * 2; }

// Shared memory: Q tile, K and V rings (1024-byte aligned), barriers, then
// the descriptors and the tile list.
inline size_t wave_smem(int D, int A, int max_tiles) {
  return 1024 + (size_t)(1 + 2 * kStages) * kRows * D * 2 + 2 * kStages * sizeof(uint64_t) +
         sizeof(int) * ((size_t)2 * A + 1 + 2 * (size_t)max_tiles + 8) + A;
}

template <int D, bool EXTRA>
__global__ void __launch_bounds__(kTcThreads, 2)
wave_wgmma(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
           const WaveArgs a) {
  using namespace hopper;
  constexpr int NR = D / 64;  // 64-column regions of a row
  constexpr int T = tile_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  char* sQ = align1024(smem_raw);
  char* sK = sQ + T;
  char* sV = sK + kStages * T;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * T);
  uint64_t* empty = full + kStages;
  int* cu = reinterpret_cast<int*>(empty + kStages);
  int* kv = cu + a.A + 1;
  int* trow = kv + a.A;
  int* tatom = trow + a.max_tiles;
  int* scan = tatom + a.max_tiles;  // 5 warps' bases, then the tile count
  unsigned char* cont = reinterpret_cast<unsigned char*>(scan + 8);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = a.H / a.kvH, TT = kRows / g;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4);
    }
    bar_init_fence();
  }
  // the tile list: each thread takes the atoms i0 .. i1 - 1, tests whether
  // each continues the one before it (its descriptors, its neighbour's and
  // their first kCmp table entries loaded in one round), counts the tiles
  // that begin in it; a block scan places them, and each thread writes its
  // own. Atom i continues atom i - 1 when both hold rows, i's first
  // position is i - 1's context length, and their tables agree on i - 1's
  // pages.
  constexpr int kCmp = 16;
  const int per = (a.A + kTcThreads - 1) / kTcThreads;
  const int i0 = min(a.A, tid * per), i1 = min(a.A, i0 + per);
  if (tid == 0) cu[a.A] = a.cu[a.A];
  int count = 0;
  for (int i = i0; i < i1; ++i) {
    const int c0 = a.cu[i], c1 = a.cu[i + 1], k1 = a.kv_lens[i];
    const int cm = i > 0 ? a.cu[i - 1] : c0, km = i > 0 ? a.kv_lens[i - 1] : 0;
    const int* x = a.pages + (long long)(i > 0 ? i - 1 : i) * a.MP;
    const int* y = a.pages + (long long)i * a.MP;
    int xo[kCmp];
#pragma unroll
    for (int u = 0; u < kCmp; ++u) xo[u] = u < a.MP ? x[u] ^ y[u] : 0;
    cu[i] = c0;
    kv[i] = k1;
    const int ql = c1 - c0;
    bool c = i > 0 && ql > 0 && c0 - cm > 0 && k1 - ql == km;
    if (c) {
      const int npg = min(a.MP, (max(km, 0) + a.ps - 1) / a.ps);
      int diff = 0;
#pragma unroll
      for (int u = 0; u < kCmp; ++u)
        if (u < npg) diff |= xo[u];
      for (int j0 = kCmp; j0 < npg && diff == 0; j0 += kCmp) {
#pragma unroll
        for (int u = 0; u < kCmp; ++u)
          if (j0 + u < npg) diff |= x[j0 + u] ^ y[j0 + u];
      }
      c = diff == 0;
    }
    cont[i] = c;
    count += begin_tiles(c0, ql, k1 - ql, c, TT, i, nullptr, nullptr, 0, 0);
  }
  int x = count;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int w = 0; w < kTcThreads / 32; ++w) {
      const int c = scan[w];
      scan[w] = run;
      run += c;
    }
    scan[5] = run;
  }
  __syncthreads();
  for (int i = i0, k = scan[warp] + x - count; i < i1; ++i) {
    const int ql = cu[i + 1] - cu[i];
    k += begin_tiles(cu[i], ql, kv[i] - ql, cont[i], TT, i, trow, tatom, k, a.max_tiles);
  }
  __syncthreads();
  const int n_tiles = min(scan[5], a.max_tiles);

  // stream padding: rows from cu[A] to N belong to no tile
  {
    const long long per_row = (long long)a.H * D / 8;  // 16-byte chunks a row
    const long long hi = a.N * per_row;
    const long long lo = min(hi, max(0ll, (long long)cu[a.A] * per_row));
    uint4* o = reinterpret_cast<uint4*>(a.out);
    for (long long i = lo + (long long)blockIdx.x * kTcThreads + tid; i < hi;
         i += (long long)gridDim.x * kTcThreads)
      o[i] = make_uint4(0, 0, 0, 0);
  }

  // items (kv head, tile), a kv head's tiles together, the longest (the
  // last of a run) first
  const int n_items = n_tiles * a.kvH;
  int it = 0;  // pipeline steps so far; both roles count the same
  if (warp == 4) {  // producer
    // pages of a step: 64 / ps whole pages, or part of one when ps >= 64
    const int pps = a.ps < kKeys ? kKeys / a.ps : 1;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const int kvh = w / n_tiles;
      const Tile t = tile_at(a, cu, kv, trow, tatom, n_tiles, n_tiles - 1 - w % n_tiles, g);
      // lane l holds the table entry of page base + l, 32 pages loaded at
      // a time, so a step's copies wait for no table load of their own
      int base = -kWarp, held = 0;
      for (int st = EXTRA ? t.first : 0; st < t.steps; ++st, ++it) {
        const int s = it % kStages;
        const int kp = st * kKeys / a.ps;  // the step's first page
        if (kp + pps > base + kWarp) {
          base = kp;
          const int page = t.table[min(base + lane, a.MP - 1)];
          held = page < 0 ? 0 : (page >= a.P ? a.P - 1 : page);
        }
        const int page = __shfl_sync(0xffffffffu, held, (kp - base + lane) & (kWarp - 1));
        if (it >= kStages) bar_wait(&empty[s], (it / kStages - 1) & 1);
        if (lane == 0) bar_expect(&full[s], 2 * T);
        __syncwarp();
        if (lane < pps) {
          const int row = (kvh * a.P + page) * a.ps + (a.ps < kKeys ? 0 : st * kKeys % a.ps);
          const int off = lane * (a.ps < kKeys ? a.ps : 0) * kSW;
#pragma unroll
          for (int rg = 0; rg < NR; ++rg) {
            tma_load2(sK + s * T + rg * kKeys * kSW + off, &mk, &full[s], rg * 64, row);
            tma_load2(sV + s * T + rg * kKeys * kSW + off, &mv, &full[s], rg * 64, row);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup: rows 16 warp + gq (+ 8) of the tile, columns
  // 2 tq, 2 tq + 1 of each 8
  const int gq = lane / 4, tq = lane % 4;
  constexpr int QV = kRows * D / 8 / 128;  // 16-byte Q chunks a thread
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int kvh = w / n_tiles;
    const Tile t = tile_at(a, cu, kv, trow, tatom, n_tiles, n_tiles - 1 - w % n_tiles, g);
    uint4 qv[QV];
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int i = tid + 128 * j, r = i / (D / 8), c = i % (D / 8);
      qv[j] = make_uint4(0, 0, 0, 0);
      if (r < t.rows)
        qv[j] = *reinterpret_cast<const uint4*>(
            a.q + ((long long)(t.row0 + r / g) * a.H + kvh * g + r % g) * D + 8 * c);
    }
    named_sync(1, 128);  // the previous item's products have read sQ
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int i = tid + 128 * j, r = i / (D / 8), c = i % (D / 8);
      bf16* h = reinterpret_cast<bf16*>(&qv[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16(__bfloat162float(h[e]) * a.scale);
      *reinterpret_cast<uint4*>(sQ + (c / 8) * kRows * kSW + swizzled<kSW>(r, c % 8)) = qv[j];
    }
    fence_async_smem();
    named_sync(1, 128);

    // the keys each of the thread's rows sees: up to its position, within
    // the table
    // (EXTRA) the first key each row's window holds, each row's position
    // and slope, and the lowest key every row of the tile sees
    int row_hi[2], row_lo[2], row_pos[2];
    float slope[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + gq + 8 * h;
      row_pos[h] = t.pos0 + r / g;
      row_hi[h] = min(row_pos[h] + 1, t.n_keys);
      row_lo[h] = EXTRA && a.window > 0 ? row_pos[h] - a.window + 1 : kNoEdge;
      slope[h] = EXTRA && a.slopes != nullptr ? a.slopes[kvh * g + r % g] : 0.f;
    }
    const int tile_lo = EXTRA && a.window > 0 ? t.pos0 + (t.rows - 1) / g - a.window + 1
                                              : kNoEdge;
    const bool biased = EXTRA && a.slopes != nullptr;
    float m[2] = {dstt::kMask, dstt::kMask}, l[2] = {0.f, 0.f}, alpha[2];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int st = EXTRA ? t.first : 0; st < t.steps; ++st, ++it) {
      const int s = it % kStages, k0 = st * kKeys;
      bar_wait(&full[s], (it / kStages) & 1);
      float sc[kKeys / 2];
      issue_s<D>(sc, sQ, sK + s * T);
      wg_wait<0>();
      hold(sc);
      const bool inner =
          !biased && k0 + kKeys <= min(t.pos0 + 1, t.n_keys) && k0 >= tile_lo;
      const int hi[2] = {row_hi[0] - k0 - 2 * tq, row_hi[1] - k0 - 2 * tq};
      const int lo[2] = {row_lo[0] - k0 - 2 * tq, row_lo[1] - k0 - 2 * tq};
      const float cb[2] = {(float)(k0 + 2 * tq - row_pos[0]), (float)(k0 + 2 * tq - row_pos[1])};
      softmax<EXTRA>(sc, m, l, alpha, inner, hi, lo, slope, cb);
      uint32_t p[kKeys / 16][4];
      to_a<kKeys>(p, sc);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      issue_pv<D>(o, p, sV + s * T);
      wg_wait<0>();
      hold(o);
      hold(p);
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int r = 16 * warp + gq + 8 * h;
      if (r >= t.rows) continue;
      const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
      bf16* row = a.out + ((long long)(t.row0 + r / g) * a.H + kvh * g + r % g) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * tq) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 1;
  }
  return n;
}

template <int D, bool EXTRA>
cudaError_t launch_tc(const WaveArgs& a, const void* k_pages, const void* v_pages,
                      cudaStream_t stream) {
  CUtensorMap mk, mv;
  const long long rows = (long long)a.kvH * a.P * a.ps;
  const int box = a.ps < kKeys ? a.ps : kKeys;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hopper::map_2d(&mk, k_pages, bf, 2, rows, D, D, 64, box, sw) ||
      !hopper::map_2d(&mv, v_pages, bf, 2, rows, D, D, 64, box, sw))
    return cudaErrorInvalidValue;
  auto kernel = wave_wgmma<D, EXTRA>;
  static bool raised = false;  // more than 48 KB of shared memory is opt-in, once
  if (!raised) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (rc != cudaSuccess) return rc;
    raised = true;
  }
  const size_t smem = wave_smem(D, a.A, a.max_tiles);
  int occ = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kTcThreads, smem);
  if (err != cudaSuccess) return err;
  if (occ == 0) return cudaErrorInvalidConfiguration;
  const long long items = (long long)a.max_tiles * a.kvH;
  const int grid = (int)std::max(1ll, std::min(items, (long long)occ * sm_count()));
  kernel<<<grid, kTcThreads, smem, stream>>>(mk, mv, a);
  return cudaGetLastError();
}

// ---- fp32 and the other shapes: the CUDA-core kernel -------------------------------

// One block an atom and kv head; an atom longer than block_q is taken
// block_q rows at a time (each such piece an atom of its own, with the
// same positions). Rows from cu[A] to N are zeroed across the grid. NARROW:
// a head_dim that is no multiple of 8 (attend_rows).
template <typename T, bool NARROW>
__global__ void __launch_bounds__(dstt::kThreads)
ragged_wave_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, T* __restrict__ out,
                   const int* __restrict__ cu_q_lens, const int* __restrict__ kv_lens,
                   const int* __restrict__ page_indices, int N, int A, int H, int kvH, int P,
                   int ps, int D, int MP, int block_q, float scale,
                   const float* __restrict__ slopes, int window) {
  const long tok = (long)H * D;
  {
    // 16 bytes a store where a token's row is a multiple of 16 bytes, else
    // an element
    const bool wide = !NARROW || tok * sizeof(T) % 16 == 0;
    const long long per_row = wide ? tok * sizeof(T) / 16 : tok, hi = N * per_row;
    const long long lo = min(hi, max(0ll, (long long)cu_q_lens[A] * per_row));
    const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    for (long long i = lo + b * dstt::kThreads + threadIdx.x; i < hi;
         i += (long long)gridDim.x * gridDim.y * dstt::kThreads) {
      if (wide) reinterpret_cast<uint4*>(out)[i] = make_uint4(0, 0, 0, 0);
      else out[i] = dstt::from_float<T>(0.f);
    }
  }
  const int a = blockIdx.x, kvh = blockIdx.y;
  if (a >= A) return;
  const int row0 = cu_q_lens[a], q_len = cu_q_lens[a + 1] - row0, kv_len = kv_lens[a];
  for (int off = 0; off < q_len; off += block_q) {
    const int n = min(block_q, q_len - off);
    dstt::attend_pages<T, NARROW>(q + (row0 + off) * tok, out + (row0 + off) * tok, k_pages,
                                  v_pages, page_indices + (long)a * MP, MP, H, kvh, H / kvH, P,
                                  ps, D, n, kv_len - q_len + off + n, scale, slopes, window);
    __syncthreads();  // the shared memory is free for the next piece
  }
}

template <typename T, bool NARROW>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, void* out,
                   const int* cu_q_lens, const int* kv_lens, const int* page_indices, int N,
                   int A, int H, int kvH, int P, int ps, int D, int MP, int block_q, float scale,
                   const float* slopes, int window, cudaStream_t stream) {
  // an atom's tokens go through the block in pieces of block_q tokens x g
  // heads of rows; a wide group (Falcon-7B: 71 query heads on one kv head)
  // takes pieces of fewer tokens, as many as fit a block's shared memory
  while (block_q > 1 && dstt::smem_bytes<T>(block_q * (H / kvH), ps, D) > (size_t)kSmemMax)
    --block_q;
  const size_t smem = dstt::smem_bytes<T>(block_q * (H / kvH), ps, D);
  cudaError_t err = dstt::reserve_smem(ragged_wave_kernel<T, NARROW>, smem);
  if (err != cudaSuccess) return err;
  ragged_wave_kernel<T, NARROW><<<dim3(std::max(A, 1), kvH), dstt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<T*>(out), cu_q_lens, kv_lens,
      page_indices, N, A, H, kvH, P, ps, D, MP, block_q, scale, slopes, window);
  return cudaGetLastError();
}

}  // namespace

// The CUDA-core form. q (unscaled) [N, H, D], k_pages / v_pages
// [kvH, P, ps, D], out [N, H, D]; cu_q_lens [A+1], kv_lens [A],
// page_indices [A, MP] int32; slopes [H] fp32 or null; window 0 = global.
// Returns the cudaError_t.
extern "C" int dstt_ragged_paged_attention(const void* q, const void* k_pages,
                                           const void* v_pages, void* out,
                                           const int* cu_q_lens, const int* kv_lens,
                                           const int* page_indices, const float* slopes,
                                           int N, int A, int H, int kvH, int P, int ps, int D,
                                           int MP, int block_q, int window, float scale,
                                           int is_bf16, void* stream) {
  if (N == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
#define RAGGED_CC(T, NARROW)                                                                  \
  launch<T, NARROW>(q, k_pages, v_pages, out, cu_q_lens, kv_lens, page_indices, N, A, H, kvH, \
                    P, ps, D, MP, block_q, scale, slopes, window, s)
  if (D % 8)
    return is_bf16 ? RAGGED_CC(__nv_bfloat16, true) : RAGGED_CC(float, true);
  return is_bf16 ? RAGGED_CC(__nv_bfloat16, false) : RAGGED_CC(float, false);
#undef RAGGED_CC
}

// The tensor-core form, bf16: the same operands; head_dim 64 or 128, H / kvH
// at most 64, ps 16, 32 or a multiple of 64, kvH * P * ps < 2^31, q, the
// pool and out 16-byte aligned. Returns the cudaError_t.
extern "C" int dstt_ragged_paged_attention_tc(const void* q, const void* k_pages,
                                              const void* v_pages, void* out,
                                              const int* cu_q_lens, const int* kv_lens,
                                              const int* page_indices, const float* slopes,
                                              int N, int A, int H, int kvH, int P, int ps, int D,
                                              int MP, int window, float scale, void* stream) {
  if (N == 0) return cudaSuccess;
  const int TT = kRows / (H / kvH);
  const WaveArgs a{static_cast<const bf16*>(q), static_cast<bf16*>(out), cu_q_lens, kv_lens,
                   page_indices, slopes, N, A, H, kvH, P, ps, MP,
                   2 * A + (N + TT - 1) / TT + 1, window, scale};
  auto s = static_cast<cudaStream_t>(stream);
  const bool extra = slopes != nullptr || window > 0;
  switch (D) {
    case 64: return extra ? launch_tc<64, true>(a, k_pages, v_pages, s)
                          : launch_tc<64, false>(a, k_pages, v_pages, s);
    case 128: return extra ? launch_tc<128, true>(a, k_pages, v_pages, s)
                           : launch_tc<128, false>(a, k_pages, v_pages, s);
    default: return cudaErrorInvalidValue;
  }
}
