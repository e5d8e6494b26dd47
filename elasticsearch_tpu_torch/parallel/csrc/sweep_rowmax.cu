// K2 sweep_rowmax, K6 sweep_rowmax_bitset and K7 sweep_rowmax_conj: score
// QC queries over the int8 column cache, keep each 128-doc row's max and,
// per 65536-doc superwindow, the top NCAND rows.
//
// Replaces the Pallas kernels of elasticsearch_tpu/parallel/kernels.py
// sweep_rowmax (:148, pallas_call :190, body _sweep_kernel :87),
// sweep_rowmax_conj (:270, pallas_call :318, body _sweep_conj_kernel :204)
// and sweep_rowmax_bitset (:534, pallas_call :581, body
// _sweep_bitset_kernel :457). Each ran four dense int8 matmuls over every
// slot of the cache for every query on the MXU (the conjunctive one a fifth
// for coverage, the bitset one skipping chunks no query of its block
// keeps), then a 17-pass row-max cascade per superwindow.
//
// The four products hh, hl, lh, ll are exact integer sums, so any order of
// evaluation gives the same int32s, and a query's zero-weight slots add
// nothing: a kernel walks only the nonzero slots and is bitwise the dense
// one. A query with no nonzero score weight writes its empty result
// without touching the columns (every val is 0, never > 0).
//
// One kernel serves the three, sweep_group_kernel<MODE>: one block per
// (group of G consecutive queries, superwindow); blockIdx.x is the group,
// so all groups of a superwindow run together and a hot column chunk comes
// from device memory once. The block compacts its queries' nonzero (slot,
// wh, wl) into shared memory (in batches of queries when they do not
// fit). Eight threads score a 128-doc row, 16 docs each, and a warp's four
// rows are adjacent: its load of one slot and layer is 512 contiguous
// bytes, one 16-byte load a thread. For 64 rows at a time each thread
// reads its docs' `live` once into 16 alive bits, then for every query
// sums the query's slots, combines, keeps the max of its 16 docs, and
// three shuffles give the row max, stored to shared memory, [G][512].
// Queries whose weights allow it sum in exact f32 with no conversion
// instruction (docs_fast); the others form the int32 products (docs_int).
// One warp per query then picks the top NCAND of its 512 row maxima by
// (rowmax desc, row asc) with two warp reductions a round and no block
// barrier. Values are kept as their bit patterns (every kept val is > 0,
// and positive floats order as their bits; 0 = no doc).
//
// The modes differ only in a gate ANDed into a query's alive bits before
// its scores are summed. DISJ (K2): none. CONJ (K7): a doc counts only if
// cov = sum wp * ((hi | lo) != 0) == nreq (cover_bits); a query's list
// also holds the slots where only its coverage weight wp is nonzero
// (filters, must_nots), after its score slots, and wp beside each entry.
// BITSET (K6): bit row % 32 of the doc's word in the query's intersected
// mask (mask_bits). A thread whose gate is empty reads no columns: a row
// with no surviving doc is -inf, what the reference's chunk skip gives it.
//
// What bounds them on the H100: bytes -- the nonzero slots' columns (2
// bytes per doc per slot; for K6 only in chunks with a surviving bit), the
// live mask and K6's mask, read once. The kernel reaches about a third of
// that: its warps wait in turn on each query's loads, gate, combine and
// shuffles (PERF.md).
//
// The fused S > 1 sweeps (F1-F3: the reference's _fused_sweep_disj,
// _fused_sweep_bool and _fused_sweep_bitset, elasticsearch_tpu/parallel/
// turbo.py :2099, :2128, :2148, which ran these Pallas kernels once per
// partition under one shard_map) take a table of the partitions (PartTable,
// up to MAX_PARTS, 2 KB in the launch's parameters: each one's column
// cache, live mask, superwindows and slots), so nothing is stacked or
// copied. The query inputs are stacked on a leading partition axis: qscale
// [S, qc], wq [S, 2, qc, ws] (ws >= every partition's hpt; slots past a
// partition's hpt are not read), CONJ's nreq [S, qc] and wp [S, qc, ws],
// BITSET's mask [S, qc, nsw_max * 16, 128]; the output [S, nsw_max, qc,
// CAND_PAD]. A superwindow past its partition's nsw gets what the
// reference's dead padding gives (live 0): -inf rows with row 0, reading
// nothing. Below a QC threshold a fused launch is sweep_group_kernel with
// the partition a third grid axis, grid ((qc + G - 1) / G, nsw_max, S);
// the solo entries are sweep_group_kernel with a one-entry table.
//
// From the threshold F1-F3's sweeps are fused_sweep_kernel<MODE>, the gate
// its template parameter. The parents ran them on sweep_group_kernel at
// 17-32% of their byte bound (PERF.md): every group of 16 queries re-read
// its superwindow's columns and live mask, a query cost about twelve issue
// slots a doc, and a CONJ query waited on its coverage loads from device
// memory before its score loads. Here a cluster of F_CL blocks takes a
// (partition, superwindow), each block F_RB contiguous rows, and a block
// takes all of a tile's queries (F_GQ, F_GQ_BITSET, F_GQ_CONJ):
//   - set-up, once per partition and tile: each rank counts and lists its
//     own queries (j = rank mod F_CL; CONJ in sweep_group_kernel's three
//     parts, each entry's wp beside it, a query's score count, coverage
//     start and nreq beside its counts), every rank gathers them through
//     distributed shared memory; the queries with a fast_query list within
//     a batch are staged, the others (the integer path, long lists) direct;
//     the staged ones go in batches of consecutive queries whose union of
//     slots (CONJ: score and coverage slots) fits half the ring (k chunks,
//     k = 1, 2, 4, ... F_KMAX);
//   - a stage a (row group of F_R rows, batch): the producer warp copies
//     each union slot's rows (two pieces of F_R * 128 contiguous bytes)
//     with 16-byte cp.async into a ring completed on mbarriers, and
//     prefetches the next 16-row chunk's union columns to L2 whole; F3
//     skips the row groups no query of the batch keeps (the reference's
//     chunk skip, from each query's mask words);
//   - the consumer warps score every query of the batch from the stage on
//     an exact int32 path (docs_staged: a byte permute, a dp2a and an imad
//     a (slot, doc), T = the float path's Y + ll, whose fl() is its pre);
//     CONJ reads each entry of its list from the stage once, scoring its
//     score entries so and summing its coverage entries' presence exactly,
//     two 16-bit fields a word, then keeps the max T over the docs that
//     pass the gate (docs_conj_staged); the direct queries as
//     sweep_group_kernel scores them, from device memory;
//   - each row value goes to the query's owning rank by a store to
//     distributed shared memory, and after a cluster barrier each rank
//     picks its queries' top NCAND of the superwindow's 512 rows with
//     sweep_group_kernel's rounds, in its own shared memory;
//   - the grid is the clusters the card holds at once, each taking a
//     contiguous range of the live (partition, superwindow) items.
// Cluster barriers order every access to another rank's shared memory:
// a rank's own counts and lists (own, ownc, olist, owp) are read by the
// others only between the barrier after it writes them and the one after
// the set-up, and its gather buffer (gat) takes the set-up's scratch
// before that barrier and the other ranks' row values only after it,
// until the barrier that ends the superwindow's selection.
// What bounds it: bytes, as for the others (F2: the union of score and
// coverage slots once, live, the weights). Measured (tools/k2_ab.py,
// PERF.md), the consumers' issue and the per-stage handshakes bound it
// instead; the constants (F_CW, F_GQ, F_GQ_BITSET, F_GQ_CONJ, F_CL) are
// the A/B's. F2 stages its coverage slots with its score slots in one
// ring: a design that staged a row group's coverage slots first and its
// score slots only where a query of the batch keeps a doc would copy no
// byte less on the engine's traffic (every score slot there is also a
// coverage slot; PERF.md), so it was not built. Its consumers take a
// query's gate and scores in one pass: forming the gate first and scoring
// under it (a warp whose rows keep no doc scoring nothing) read the
// shared entries twice and was slower on the engine's traffic.
// Each mode runs sweep_group_kernel below fused_min_qc (F_MIN_QC,
// F_MIN_QC_BITSET, F_MIN_QC_CONJ; tools/k2_ab.py's crossovers): a
// cluster walks its superwindows in turn whatever the QC, so few queries
// leave its warps idle (F1 loses at QC 32, wins from 64); and F2 and F3
// copy each batch's union for every row group (F3: any query of the batch
// keeps), so where a tile's union takes two batches (k2_ab's synthetic
// bools) they move more bytes than the parent's per-query reads and lose
// at every QC; both win on the engine's traffic at QC 256 (PERF.md).
//
// The combine is the reference's, in f32:
//   val = ((16384 * hh + 128 * (hl + lh)) + ll) * qscale
// Both products are exact (powers of two times integers below 2^24), so
// fused or not the result is the same; __fmul_rn/__fadd_rn keep it explicit.
// A doc counts only if live > 0 and val > 0 (and the mode's gate); an
// empty row is -inf.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int SW_ROWS = 512;          // 128-doc rows per 65536-doc superwindow
constexpr int CHUNK_ROWS = 16;        // rows per 2048-doc chunk-major
constexpr int NCAND = 17;
constexpr int CAND_PAD = 32;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SW_WORD_ROWS = SW_ROWS / 32;   // packed mask word rows
constexpr int N_CHUNKS_SW = SW_ROWS / CHUNK_ROWS;   // chunks a superwindow

enum Mode { DISJ = 0, CONJ = 1, BITSET = 2 };

constexpr int G = 16;            // queries a block (measured: tools/k2_ab.py)
constexpr int LIST_MIN = 256;    // list entries a block may always hold
constexpr int TPR = 8;           // threads a row
constexpr int DPT = 128 / TPR;   // docs a thread
constexpr int NW = DPT / 4;      // 32-bit words a thread per slot and layer
constexpr int ROWS_IT = THREADS / TPR;   // rows a block scores at once
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_PARTS = 64;    // partitions one fused launch takes

// one partition's column cache, live mask, superwindows and slots
struct Part {
  const int8_t* hi;
  const int8_t* lo;
  const float* live;
  int nsw;
  int hpt;
};

// the launch's partitions, in its parameters (32 bytes a partition)
struct PartTable {
  Part p[MAX_PARTS];
};

struct Words {
  unsigned w[NW];
};

// one slot and layer of the thread's DPT docs (a warp: 512 contiguous bytes)
__device__ __forceinline__ Words ld_words(const int8_t* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  return Words{{v.x, v.y, v.z, v.w}};
}

// Float path, for queries whose weights keep every partial sum exact in
// f32 (fast_query). Per doc it sums Y = 16384 hh + 128 (hl + lh) and
// ll directly: Y += h * (16384 a + 128 b) + l * 128 a, ll += l * b. Every
// product and partial sum is an integer (Y's a multiple of 128) below
// 2^31 (ll's below 2^24), so each fma is exact, Y equals the reference's
// fl(16384 * (float)hh + 128 * (float)(hl + lh)) and pre = fl(Y + ll) is
// its pre-scale value. A byte b becomes a float with no conversion
// instruction: the bits 0x4B0000uu are 2^23 + uu, uu = b + 128.
__device__ __forceinline__ float byte_f(unsigned biased, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u,
                                               0x7440u | j)),
                   8388736.f);
}

// 0xFF in byte j where bit j (j < 4) of bits is set
__device__ __forceinline__ unsigned byte_mask(unsigned bits) {
  return (((bits & 0xFu) * 0x204081u) & 0x01010101u) * 0xFFu;
}

// f32 exactness of the float path: |Y| <= 128 (16512 sum|a| + 128 sum|b|)
// below 2^31 (so also |hh|, |hl + lh|, |ll| below 2^24), and qs > 0
__device__ __forceinline__ bool fast_query(int sum_a, int sum_b, float qs) {
  return 16512LL * sum_a + 128LL * sum_b < (1LL << 24) && qs > 0.f;
}

// the float path over the thread's DPT docs of a row: the max pre over
// its live docs with pre > 0, as bits (0: none). msk holds 0xFF per live
// doc: dead docs' bytes are masked to 0, so their pre is 0 and never
// counts.
__device__ __forceinline__ unsigned docs_fast(const int4* ent, int n,
                                              const int8_t* hi,
                                              const int8_t* lo,
                                              const Words& msk) {
  float y[DPT], z[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) {
    y[d] = 0.f;
    z[d] = 0.f;
  }
  for (int k = 0; k < n; ++k) {
    const int4 e = ent[k];
    const int64_t o = (int64_t)(e.x & 0xFFFF) * 2048;
    const Words h = ld_words(hi + o), l = ld_words(lo + o);
    const float wa = __int_as_float(e.y), wb = __int_as_float(e.z);
    const float wl = __int_as_float(e.w);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned hb = (h.w[w] & msk.w[w]) ^ 0x80808080u;
      const unsigned lb = (l.w[w] & msk.w[w]) ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 4 * w + j;
        const float hf = byte_f(hb, j), lf = byte_f(lb, j);
        y[d] = __fmaf_rn(hf, wa, y[d]);
        y[d] = __fmaf_rn(lf, wb, y[d]);
        z[d] = __fmaf_rn(lf, wl, z[d]);
      }
    }
  }
  float m = 0.f;
#pragma unroll
  for (int d = 0; d < DPT; ++d) m = fmaxf(m, __fadd_rn(y[d], z[d]));
  return m > 0.f ? __float_as_uint(m) : 0u;
}

// Integer path, for any other query: the four int32 products as the
// reference forms them, four docs at a time, converted and combined doc by
// doc; the max val over live docs with val > 0, as bits (0: none).
__device__ __forceinline__ unsigned docs_int(const int4* ent, int n,
                                             const int8_t* hi,
                                             const int8_t* lo,
                                             unsigned alive, float qs) {
  unsigned best = 0;
  for (int w = 0; w < NW; ++w) {
    int hh[4] = {0, 0, 0, 0}, hl[4] = {0, 0, 0, 0};
    int lh[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0};
    for (int k = 0; k < n; ++k) {
      const int e = ent[k].x;
      const int64_t o = (int64_t)(e & 0xFFFF) * 2048 + 4 * w;
      const char4 h = *reinterpret_cast<const char4*>(hi + o);
      const char4 l = *reinterpret_cast<const char4*>(lo + o);
      const int a = (int8_t)(e >> 16), b = (int8_t)(e >> 24);
      hh[0] += a * h.x; hh[1] += a * h.y; hh[2] += a * h.z; hh[3] += a * h.w;
      hl[0] += a * l.x; hl[1] += a * l.y; hl[2] += a * l.z; hl[3] += a * l.w;
      lh[0] += b * h.x; lh[1] += b * h.y; lh[2] += b * h.z; lh[3] += b * h.w;
      ll[0] += b * l.x; ll[1] += b * l.y; ll[2] += b * l.z; ll[3] += b * l.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = __fadd_rn(__fmul_rn(16384.f, (float)hh[j]),
                          __fmul_rn(128.f, (float)(hl[j] + lh[j])));
      v = __fmul_rn(__fadd_rn(v, (float)ll[j]), qs);
      if (((alive >> (4 * w + j)) & 1u) && v > 0.f) {
        best = max(best, __float_as_uint(v));
      }
    }
  }
  return best;
}

// The coverage gate (K7) over the thread's DPT docs of a row: bit d set
// where cov = sum wp * present equals need, present = (hi | lo) != 0 (the
// build forces lo >= 1 where a term occurs). Each byte's presence becomes
// 0x01 with no compare: (x & 0x7F) + 0x7F sets bit 7 iff the low seven
// bits are not all 0, or-ing x adds its own bit 7. cov is an exact
// integer, |cov| <= 128 n < 2^31 for any n <= 0xFFFF entries. The gate is
// known before any score is summed, so the float path masks the bytes of
// the docs it fails, as it does dead docs': their pre is 0, never counted.
__device__ __forceinline__ unsigned cover_bits(const int4* ent,
                                               const int* wps, int n,
                                               const int8_t* hi,
                                               const int8_t* lo, int need) {
  int cov[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) cov[d] = 0;
  for (int k = 0; k < n; ++k) {
    const int64_t o = (int64_t)(ent[k].x & 0xFFFF) * 2048;
    const Words h = ld_words(hi + o), l = ld_words(lo + o);
    const int c = wps[k];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned x = h.w[w] | l.w[w];
      const unsigned p =
          ((((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) >> 7) & 0x01010101u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cov[4 * w + j] += c * (int)__byte_perm(p, 0u, 0x4440u | j);
      }
    }
  }
  unsigned g = 0;
#pragma unroll
  for (int d = 0; d < DPT; ++d) g |= (unsigned)(cov[d] == need) << d;
  return g;
}

// The mask gate (K6) of the thread's DPT docs of a row: bit row % 32 of
// each of its DPT words in the query's intersected mask (K5's output),
// four 16-byte loads; a warp's four rows share one word row.
struct MaskWords {
  uint4 v[DPT / 4];
};

__device__ __forceinline__ MaskWords mask_load(const int32_t* p) {
  MaskWords m;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    m.v[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  return m;
}

__device__ __forceinline__ unsigned mask_gate(const MaskWords& m, int bit) {
  unsigned g = 0;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const uint4 v = m.v[i];
    g |= (((v.x >> bit) & 1u) | (((v.y >> bit) & 1u) << 1)
          | (((v.z >> bit) & 1u) << 2) | (((v.w >> bit) & 1u) << 3))
         << (4 * i);
  }
  return g;
}

__device__ __forceinline__ unsigned mask_bits(const int32_t* p, int bit) {
  return mask_gate(mask_load(p), bit);
}

// whether a slot with score weight (sc) and coverage weight c is in part
// `part` of a query's list: its nonzero score slots for DISJ and BITSET;
// for CONJ the score-only slots (part 0), those with score and coverage
// weight (1), then the coverage-only ones (2)
template <int MODE>
__device__ __forceinline__ bool in_part(int part, bool sc, int c) {
  return MODE != CONJ ? sc
         : part == 0  ? sc && c == 0
         : part == 1  ? sc && c != 0
                      : !sc && c != 0;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
sweep_group_kernel(const __grid_constant__ PartTable parts,
                   const float* __restrict__ qscale,     // [S, qc]
                   const int32_t* __restrict__ nreq,     // CONJ: [S, qc]
                   const int8_t* __restrict__ wq,        // [S, 2, qc, ws]
                   const int8_t* __restrict__ wp,        // CONJ: [S, qc, ws]
                   // BITSET: [S, qc, nsw_max * 16, 128]
                   const int32_t* __restrict__ mask,
                   float* __restrict__ out_m, int32_t* __restrict__ out_r,
                   int qc, int ws, int cap) {
  extern __shared__ int4 group_smem[];
  // [cap] entries: x = slot | wh << 16 | wl << 24, then the float path's
  // weights 16384 wh + 128 wl, 128 wh, wl as f32 bits; CONJ: each entry's
  // wp beside it, [cap]
  int4* s_ent = group_smem;
  int* s_wp = reinterpret_cast<int*>(s_ent + cap);
  unsigned* s_rm = reinterpret_cast<unsigned*>(
      s_wp + (MODE == CONJ ? cap : 0));                          // [G][512]
  __shared__ int s_cnt[G], s_off[G], s_fast[G];
  __shared__ float s_qs[G];
  // CONJ: a query's list is its score-only entries, then those with score
  // and coverage weight, then the coverage-only ones: scores read
  // [0, s_nsc), coverage [s_c0, s_cnt)
  __shared__ int s_nsc[G], s_c0[G], s_need[G];

  const int q0 = blockIdx.x * G;
  const int ng = min(G, qc - q0);
  const int sw = blockIdx.y;
  const int nsw_max = gridDim.y;
  const int z = blockIdx.z;                 // the partition
  const int tid = threadIdx.x;
  // this partition's slice of the stacked inputs and output
  qscale += (int64_t)z * qc;
  wq += (int64_t)z * 2 * qc * ws;
  out_m += (int64_t)z * nsw_max * qc * CAND_PAD;
  out_r += (int64_t)z * nsw_max * qc * CAND_PAD;
  if (MODE == CONJ) {
    nreq += (int64_t)z * qc;
    wp += (int64_t)z * qc * ws;
  }
  if (MODE == BITSET) mask += (int64_t)z * qc * nsw_max * SW_WORD_ROWS * 128;
  const int8_t* __restrict__ cols_hi = parts.p[z].hi;
  const int8_t* __restrict__ cols_lo = parts.p[z].lo;
  const float* __restrict__ live = parts.p[z].live;
  const int hpt = parts.p[z].hpt;
  if (sw >= parts.p[z].nsw) {
    // past the partition's superwindows: dead padding, -inf rows
    for (int i = tid; i < ng * CAND_PAD; i += THREADS) {
      const int64_t o = ((int64_t)sw * qc + q0 + i / CAND_PAD) * CAND_PAD
                        + i % CAND_PAD;
      out_m[o] = -INFINITY;
      out_r[o] = 0;
    }
    return;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // TPR threads a row, 16 docs each; a warp's rows are adjacent, so a
  // warp's load of one slot and layer is 512 contiguous bytes
  const int sub = lane % TPR;

  // each query's nonzero slots and weight sums, a warp per query. A CONJ
  // query with no score weight keeps an empty list: every val is 0, never
  // > 0, so it writes its empty result and takes no list room
  for (int j = warp; j < ng; j += WARPS) {
    const int8_t* wh = wq + (int64_t)(q0 + j) * ws;
    const int8_t* wl = wq + (int64_t)(qc + q0 + j) * ws;
    const int8_t* wc = MODE == CONJ ? wp + (int64_t)(q0 + j) * ws : nullptr;
    int n = 0, sa = 0, sb = 0, nc = 0, nb = 0;
    for (int s = lane; s < hpt; s += 32) {
      const int a = wh[s], b = wl[s];
      n += (a | b) != 0;
      sa += abs(a);
      sb += abs(b);
      if (MODE == CONJ) {
        const int c = wc[s];
        nc += c != 0;
        nb += c != 0 && (a | b) != 0;
      }
    }
    n = __reduce_add_sync(FULL, n);
    sa = __reduce_add_sync(FULL, sa);
    sb = __reduce_add_sync(FULL, sb);
    if (MODE == CONJ) {
      nc = __reduce_add_sync(FULL, nc);
      nb = __reduce_add_sync(FULL, nb);
    }
    if (lane == 0) {
      const float qs = qscale[q0 + j];
      s_cnt[j] = MODE == CONJ && n != 0 ? n + nc - nb : n;
      s_qs[j] = qs;
      s_fast[j] = fast_query(sa, sb, qs);
      if (MODE == CONJ) {
        s_nsc[j] = n;
        s_c0[j] = n - nb;
        s_need[j] = nreq[q0 + j];
      }
    }
  }

  // batches of queries whose lists fit in cap (cap >= hpt)
  for (int qb = 0; qb < ng;) {
    __syncthreads();
    int qe = qb, used = 0;
    while (qe < ng && used + s_cnt[qe] <= cap) used += s_cnt[qe++];
    for (int j = qb + warp; j < qe; j += WARPS) {
      if (MODE == CONJ && s_cnt[j] == 0) continue;
      int pos = 0;
      for (int i = qb; i < j; ++i) pos += s_cnt[i];
      if (lane == 0) s_off[j] = pos;
      const int8_t* wh = wq + (int64_t)(q0 + j) * ws;
      const int8_t* wl = wq + (int64_t)(qc + q0 + j) * ws;
      const int8_t* wc = MODE == CONJ ? wp + (int64_t)(q0 + j) * ws
                                      : nullptr;
      // CONJ: three passes, one per part of the list
      for (int part = 0; part < (MODE == CONJ ? 3 : 1); ++part) {
        for (int s0 = 0; s0 < hpt; s0 += 32) {
          const int s = s0 + lane;
          const int a = s < hpt ? wh[s] : 0;
          const int b = s < hpt ? wl[s] : 0;
          const int c = MODE == CONJ && s < hpt ? wc[s] : 0;
          const bool nz = in_part<MODE>(part, (a | b) != 0, c);
          const unsigned bal = __ballot_sync(FULL, nz);
          if (nz) {
            const int e = pos + __popc(bal & ((1u << lane) - 1u));
            s_ent[e] = make_int4(
                (int)((unsigned)s | ((unsigned)(a & 0xFF) << 16)
                      | ((unsigned)b << 24)),
                __float_as_int((float)(16384 * a + 128 * b)),
                __float_as_int((float)(128 * a)), __float_as_int((float)b));
            if (MODE == CONJ) s_wp[e] = c;
          }
          pos += __popc(bal);
        }
      }
    }
    __syncthreads();

    // ROWS_IT rows at a time: the thread's docs' live bits, then every
    // weighted query of the batch; the row max is a max over the row's TPR
    // lanes
    for (int it = 0; it < SW_ROWS / ROWS_IT; ++it) {
      const int row = it * ROWS_IT + tid / TPR;
      const int64_t doc0 = ((int64_t)sw * SW_ROWS + row) * 128 + sub * DPT;
      unsigned alive = 0;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const float4 lv = *reinterpret_cast<const float4*>(live + doc0 + 4 * i);
        alive |= ((unsigned)(lv.x > 0.f) | ((unsigned)(lv.y > 0.f) << 1)
                  | ((unsigned)(lv.z > 0.f) << 2)
                  | ((unsigned)(lv.w > 0.f) << 3)) << (4 * i);
      }
      Words msk;
#pragma unroll
      for (int w = 0; w < NW; ++w) msk.w[w] = byte_mask(alive >> (4 * w));
      const int64_t rbase =
          ((int64_t)(sw * (SW_ROWS / CHUNK_ROWS) + row / CHUNK_ROWS) * hpt)
              * 2048 + (row % CHUNK_ROWS) * 128 + sub * DPT;
      const int8_t* hi = cols_hi + rbase;
      const int8_t* lo = cols_lo + rbase;
      for (int j = qb; j < qe; ++j) {
        const int n = s_cnt[j];
        if (n == 0) continue;
        const int4* ent = s_ent + s_off[j];
        unsigned v;
        if (MODE == DISJ) {
          v = s_fast[j] ? docs_fast(ent, n, hi, lo, msk)
                        : docs_int(ent, n, hi, lo, alive, s_qs[j]);
        } else {
          // the query's gate first, then the scores of the docs it keeps;
          // a thread whose docs all fail reads no columns (a warp whose
          // four rows all fail skips the score loop)
          unsigned gate = alive;
          int ns = n;
          if (MODE == CONJ) {
            const int c0 = s_c0[j];
            gate &= cover_bits(ent + c0, s_wp + s_off[j] + c0, n - c0, hi,
                               lo, s_need[j]);
            ns = s_nsc[j];
          } else {
            gate &= mask_bits(mask + ((int64_t)(q0 + j) * nsw_max
                                      * SW_WORD_ROWS + sw * SW_WORD_ROWS
                                      + row / 32) * 128 + sub * DPT,
                              row & 31);
          }
          v = 0u;
          if (gate != 0u) {
            if (s_fast[j]) {
              Words g;
#pragma unroll
              for (int w = 0; w < NW; ++w) g.w[w] = byte_mask(gate >> (4 * w));
              v = docs_fast(ent, ns, hi, lo, g);
            } else {
              v = docs_int(ent, ns, hi, lo, gate, s_qs[j]);
            }
          }
        }
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1) {
          v = max(v, __shfl_xor_sync(FULL, v, o));
        }
        if (sub == 0) s_rm[j * SW_ROWS + row] = v;
      }
    }
    qb = qe;
  }
  __syncthreads();

  // top NCAND rows of each query by (rowmax desc, row asc), a warp per
  // query: lane l holds rows l + 32 t. A float-path query's row maxima
  // are of pre and become vals first: with qs > 0, val = fl(pre * qs) is
  // non-decreasing in pre and > 0 only where pre > 0, so the row's max
  // val is fl(max pre * qs), kept if > 0. A round takes the warp's
  // largest value, then the lowest row holding it, and that lane rescans
  // its rows.
  for (int j = warp; j < ng; j += WARPS) {
    float om = -INFINITY;
    int orow = 0;
    if (s_cnt[j] != 0) {
      unsigned* rm = s_rm + j * SW_ROWS;
      const float qs = s_qs[j];
      unsigned best = 0;
      int bt = 0;
      for (int t = 0; t < SW_ROWS / 32; ++t) {
        unsigned x = rm[lane + 32 * t];
        if (s_fast[j] && x != 0u) {
          const float v = __fmul_rn(__uint_as_float(x), qs);
          x = v > 0.f ? __float_as_uint(v) : 0u;
          rm[lane + 32 * t] = x;
        }
        if (x > best) {
          best = x;
          bt = t;
        }
      }
      for (int p = 0; p < NCAND; ++p) {
        const unsigned m = __reduce_max_sync(FULL, best);
        if (m == 0u) break;
        const unsigned c =
            best == m ? (unsigned)(SW_ROWS - (lane + 32 * bt)) : 0u;
        const int r = SW_ROWS - (int)__reduce_max_sync(FULL, c);
        if (lane == p) {
          om = __uint_as_float(m);
          orow = r + sw * SW_ROWS;
        }
        if ((r & 31) == lane) {
          rm[r] = 0u;
          best = 0;
          bt = 0;
          for (int t = 0; t < SW_ROWS / 32; ++t) {
            const unsigned x = rm[lane + 32 * t];
            if (x > best) {
              best = x;
              bt = t;
            }
          }
        }
      }
    }
    const int64_t obase = ((int64_t)sw * qc + q0 + j) * CAND_PAD;
    out_m[obase + lane] = om;
    out_r[obase + lane] = orow;
  }
}

// ---------------------------------------------------------------------------
// F1-F3's sweep: fused_sweep_kernel<MODE> (see the header)
// ---------------------------------------------------------------------------

constexpr int F_CL = 8;                      // blocks a cluster
constexpr int F_RB = SW_ROWS / F_CL;         // rows a block (64)
constexpr int F_R = 4;                       // rows a stage: a warp's four
constexpr int F_NG = F_RB / F_R;             // stages of a block's rows (16)
constexpr int F_KW = F_RB / 32;              // keep words a query (2)
constexpr int F_GQ = 256;                    // queries a tile: F1
constexpr int F_GQ_BITSET = 128;             // F3 (measured)
constexpr int F_GQ_CONJ = 128;               // F2 (measured)
constexpr int F_CW = 15;                     // consumer warps (measured)
constexpr int F_WARPS = F_CW + 1;            // and the producer warp
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_MAX_ST = 8;                  // ring stages at most
constexpr int F_SLOT_BYTES = 2 * F_R * 128;  // one slot's two layers a stage
constexpr int F_LC = 1024;                   // staged list entries a tile
constexpr int F_KMAX = 32;                   // batches the planner tries
constexpr int F_SMEM = 232448;               // a block's shared memory
constexpr int F_DP2A_K = 0x00010080;         // (128, 1): c = 128 h + l
constexpr int F_MIN_QC = 64;                 // F1: the cluster kernel from
constexpr int F_MIN_QC_BITSET = 256;         // F3 (measured)
constexpr int F_MIN_QC_CONJ = 256;           // F2 (measured)
constexpr int F_MEMO = 8;                    // plans a device remembers
constexpr int F_MAX_DEVICES = 16;

// a mode's tile and the QC from which its launch runs fused_sweep_kernel
constexpr int fused_tile(int mode) {
  return mode == BITSET ? F_GQ_BITSET : mode == CONJ ? F_GQ_CONJ : F_GQ;
}

constexpr int fused_min_qc(int mode) {
  return mode == BITSET ? F_MIN_QC_BITSET
                        : mode == CONJ ? F_MIN_QC_CONJ : F_MIN_QC;
}

// the shared-memory layout of a launch, a function of (qc, hpt_max, mode)
// only (kernels.fused_sweep_plan mirrors it): byte offsets of the regions
// and the capacities they give
struct FusedPlan {
  int gq;          // queries a tile: min(qc, fused_tile(mode))
  int oq;          // a rank's queries of a tile: ceil(gq / F_CL)
  int lc;          // staged list entries (slot | W << 16) a tile holds
  int dc;          // direct list entries (int4) held at once, >= hpt_max
  int ring_slots;  // slot-stages (F_SLOT_BYTES each) the ring holds
  int slot_cap;    // union slots a batch may take: ring_slots / 2, <= 255
  int smem;        // dynamic shared memory bytes
  int o_own, o_olist, o_qi, o_keep, o_alive, o_tof, o_uslot, o_map,
      o_misc, o_bkw, o_list, o_dlist, o_ownc, o_qx, o_owp, o_lwp, o_dwp,
      o_gat, o_ring;
};

FusedPlan fused_plan(int qc, int hpt_max, int mode) {
  FusedPlan p{};
  const int tile = fused_tile(mode);
  p.gq = qc < tile ? qc : tile;
  p.oq = (p.gq + F_CL - 1) / F_CL;
  p.lc = F_LC;
  p.dc = hpt_max > 256 ? hpt_max : 256;
  int o = 2 * F_MAX_ST * 8;                  // full and empty barriers
  auto take = [&o](int bytes) {
    const int at = o;
    o += (bytes + 15) & ~15;
    return at;
  };
  p.o_own = take(p.oq * 16);
  p.o_olist = take(p.lc * 4);
  p.o_qi = take(p.gq * 16);
  p.o_keep = take(p.gq * F_KW * 4);
  p.o_alive = take(F_RB * 16);
  p.o_tof = take(p.gq * 2);
  p.o_uslot = take(p.lc * 2);
  p.o_map = take(hpt_max * 4);
  p.o_misc = take((16 + F_KMAX + 2 * (p.gq + 1)) * 4);
  p.o_bkw = take(p.gq * F_KW * 4);
  p.o_list = take(p.lc * 4);
  p.o_dlist = take(p.dc * 16);
  // CONJ: each query's (score entries, coverage start, nreq), a rank's own
  // and the tile's, and each list entry's coverage weight wp
  const bool conj = mode == CONJ;
  p.o_ownc = take(conj ? p.oq * 16 : 0);
  p.o_qx = take(conj ? p.gq * 16 : 0);
  p.o_owp = take(conj ? p.lc : 0);
  p.o_lwp = take(conj ? p.lc : 0);
  p.o_dwp = take(conj ? p.dc * 4 : 0);
  p.o_gat = take(p.oq * SW_ROWS * 4);
  o = (o + 127) & ~127;
  p.o_ring = o;
  p.ring_slots = F_SMEM > o ? (F_SMEM - o) / F_SLOT_BYTES : 0;
  p.slot_cap = p.ring_slots / 2 < 255 ? p.ring_slots / 2 : 255;
  p.smem = o + p.ring_slots * F_SLOT_BYTES;
  return p;
}

// a rank's own queries of a tile, read by every rank of the cluster
struct OwnQ {
  int n;        // list entries: nonzero score slots (CONJ: and coverage)
  int off;      // own list offset, -1: not staged
  float qs;
  int fast;     // fast_query
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// a 16-byte copy into shared memory; no memory clobber, so the caller's
// loads of addresses are not held behind it (the stage's barrier orders
// what the consumers read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// an arrival on the barrier once the thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar))
               : "memory");
}

// waits for phase `parity` of the barrier; a copy that never lands traps
// (a launch failure) instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One staged word (4 docs) of a slot: c = 128 h + l per doc from the
// masked bytes, two docs a dp2a, then T (+)= W c.
template <bool FIRST>
__device__ __forceinline__ void dp2a_word(int* t, unsigned h, unsigned l,
                                          unsigned m, int wt) {
  const unsigned hm = h & m, lm = l & m;
  const int b01 = (int)__byte_perm(hm, lm, 0x5140);   // h0 l0 h1 l1
  const int b23 = (int)__byte_perm(hm, lm, 0x7362);   // h2 l2 h3 l3
  const int c[4] = {__dp2a_lo(F_DP2A_K, b01, 0), __dp2a_hi(F_DP2A_K, b01, 0),
                    __dp2a_lo(F_DP2A_K, b23, 0), __dp2a_hi(F_DP2A_K, b23, 0)};
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = FIRST ? wt * c[j] : t[j] + wt * c[j];
}

// The staged fast path over the thread's DPT docs of a row, from a stage
// in shared memory (`st`: the thread's 16 bytes of the stage's first slot
// and hi layer): T = sum W (128 h + l) over the query's entries (slot in
// the stage | W << 16, W = 128 wh + wl), the exact int32 of the float
// path's Y + ll (fast_query bounds it below 2^31), so fl(T) is its pre.
// msk drops dead (and gated) docs' bytes: their T is 0. Returns the max T
// over the docs, 0 if none is > 0.
__device__ __forceinline__ int docs_staged(const uint32_t* ent, int n,
                                           const unsigned char* st,
                                           const Words& msk) {
  int t[DPT];
  {
    const uint32_t e = ent[0];
    const unsigned char* p = st + (e & 0xFFFF) * F_SLOT_BYTES;
    const uint4 h = *reinterpret_cast<const uint4*>(p);
    const uint4 l = *reinterpret_cast<const uint4*>(p + F_R * 128);
    const int wt = (int)e >> 16;
    dp2a_word<true>(t, h.x, l.x, msk.w[0], wt);
    dp2a_word<true>(t + 4, h.y, l.y, msk.w[1], wt);
    dp2a_word<true>(t + 8, h.z, l.z, msk.w[2], wt);
    dp2a_word<true>(t + 12, h.w, l.w, msk.w[3], wt);
  }
  for (int k = 1; k < n; ++k) {
    const uint32_t e = ent[k];
    const unsigned char* p = st + (e & 0xFFFF) * F_SLOT_BYTES;
    const uint4 h = *reinterpret_cast<const uint4*>(p);
    const uint4 l = *reinterpret_cast<const uint4*>(p + F_R * 128);
    const int wt = (int)e >> 16;
    dp2a_word<false>(t, h.x, l.x, msk.w[0], wt);
    dp2a_word<false>(t + 4, h.y, l.y, msk.w[1], wt);
    dp2a_word<false>(t + 8, h.z, l.z, msk.w[2], wt);
    dp2a_word<false>(t + 12, h.w, l.w, msk.w[3], wt);
  }
  // a tree: four levels, not sixteen (constant bounds: t stays in
  // registers)
#pragma unroll
  for (int d = 0; d < 8; ++d) t[d] = max(t[d], t[d + 8]);
#pragma unroll
  for (int d = 0; d < 4; ++d) t[d] = max(t[d], t[d + 4]);
  t[0] = max(max(t[0], t[2]), max(t[1], t[3]));
  return max(t[0], 0);
}

// One staged entry's presence (cover_bits' test: bit 7 of ((x & 0x7F) +
// 0x7F) | x, x = hi | lo) times its coverage weight c, added to the
// thread's DPT docs' cov: a word's four docs as two 16-bit fields of two
// int32s (docs 0 and 2 in ev, 1 and 3 in od), two imads a word.
__device__ __forceinline__ void cover_entry(int* ev, int* od, const uint4& h,
                                            const uint4& l, int c) {
  const unsigned x[NW] = {h.x | l.x, h.y | l.y, h.z | l.z, h.w | l.w};
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const unsigned b7 = ((x[w] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x[w];
    ev[w] += c * (int)((b7 >> 7) & 0x00010001u);
    od[w] += c * (int)((b7 >> 15) & 0x00010001u);
  }
}

// One staged entry's score, T += W (128 h + l) (docs_staged's, the bytes
// unmasked)
__device__ __forceinline__ void score_entry(int* t, const uint4& h,
                                            const uint4& l, int wt) {
  dp2a_word<false>(t, h.x, l.x, FULL, wt);
  dp2a_word<false>(t + 4, h.y, l.y, FULL, wt);
  dp2a_word<false>(t + 8, h.z, l.z, FULL, wt);
  dp2a_word<false>(t + 12, h.w, l.w, FULL, wt);
}

// CONJ's staged path over the thread's DPT docs of a row, one pass over a
// query's list, each entry read from the stage once: [0, c0) scored,
// [c0, ns) scored and summed for coverage, [ns, n) summed for coverage
// (cover_entry), a loop a part. cov is exact: a staged list holds at most
// 255 entries of |wp| <= 128, so each 16-bit field's |cov| <= 32640 <
// 2^15 and no int32 partial sum overflows. Returns the max T over the
// docs alive and with cov == need, 0 if none is > 0 (what docs_staged
// returns with the other docs' bytes masked).
__device__ __forceinline__ int docs_conj_staged(const uint32_t* ent,
                                                const int8_t* wps, int ns,
                                                int c0, int n,
                                                const unsigned char* st,
                                                unsigned alive, int need) {
  int t[DPT], ev[NW], od[NW];
#pragma unroll
  for (int d = 0; d < DPT; ++d) t[d] = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    ev[w] = 0;
    od[w] = 0;
  }
  auto stage = [&](uint32_t e, uint4& h, uint4& l) {
    const unsigned char* p = st + (e & 0xFFFF) * F_SLOT_BYTES;
    h = *reinterpret_cast<const uint4*>(p);
    l = *reinterpret_cast<const uint4*>(p + F_R * 128);
  };
  int k = 0;
  for (; k < c0; ++k) {
    const uint32_t e = ent[k];
    uint4 h, l;
    stage(e, h, l);
    score_entry(t, h, l, (int)e >> 16);
  }
  for (; k < ns; ++k) {
    const uint32_t e = ent[k];
    uint4 h, l;
    stage(e, h, l);
    score_entry(t, h, l, (int)e >> 16);
    cover_entry(ev, od, h, l, wps[k]);
  }
  for (; k < n; ++k) {
    uint4 h, l;
    stage(ent[k], h, l);
    cover_entry(ev, od, h, l, wps[k]);
  }
  int m = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int e0 = (short)ev[w], e2 = (ev[w] - e0) >> 16;
    const int o1 = (short)od[w], o3 = (od[w] - o1) >> 16;
    const int cv[4] = {e0, o1, e2, o3};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (cv[j] == need && ((alive >> (4 * w + j)) & 1u)) {
        m = max(m, t[4 * w + j]);
      }
    }
  }
  return m;
}

// a float-path row max of pre (bits) as a val's bits: fl(pre * qs), kept
// if > 0 (the selection of sweep_group_kernel, done at the store)
__device__ __forceinline__ unsigned pre_val(unsigned pre, float qs) {
  if (pre == 0u) return 0u;
  const float v = __fmul_rn(__uint_as_float(pre), qs);
  return v > 0.f ? __float_as_uint(v) : 0u;
}

// BITSET: whether row group g (rows F_R g ..) of the block has a row the
// keep words mark; every group for DISJ
template <int MODE>
__device__ __forceinline__ bool row_group_kept(const uint32_t* kw, int g) {
  if (MODE != BITSET) return true;
  return ((kw[F_R * g / 32] >> (F_R * g % 32)) & ((1u << F_R) - 1u)) != 0u;
}

// a query's row value into its owning rank's gather buffer (raw query j
// belongs to rank j mod F_CL, at index j / F_CL): a store to distributed
// shared memory that nothing waits on
__device__ __forceinline__ void put_row(const cg::cluster_group& cluster,
                                        uint32_t* gat, int j, int row,
                                        unsigned v) {
  cluster.map_shared_rank(gat, j % F_CL)[(j / F_CL) * SW_ROWS + row] = v;
}

// the gate's bytes: 0xFF per kept doc of the thread's DPT
__device__ __forceinline__ Words gate_words(unsigned gate) {
  Words g;
#pragma unroll
  for (int w = 0; w < NW; ++w) g.w[w] = byte_mask(gate >> (4 * w));
  return g;
}

template <int MODE>
__global__ void __cluster_dims__(F_CL, 1, 1) __launch_bounds__(F_THREADS, 1)
fused_sweep_kernel(const __grid_constant__ PartTable parts,
                   const float* __restrict__ qscale,     // [S, qc]
                   const int32_t* __restrict__ nreq,     // CONJ: [S, qc]
                   const int8_t* __restrict__ wq,        // [S, 2, qc, ws]
                   const int8_t* __restrict__ wp,        // CONJ: [S, qc, ws]
                   // BITSET: [S, qc, nsw_max * 16, 128]
                   const int32_t* __restrict__ mask,
                   float* __restrict__ out_m, int32_t* __restrict__ out_r,
                   int n_parts, int qc, int ws, int nsw_max,
                   const FusedPlan pl) {
  extern __shared__ __align__(128) unsigned char f_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_cl = gridDim.y;
  // dead padding, the superwindows past a partition's nsw: -inf rows,
  // cluster c taking every n_cl-th, rank r writing queries q = r mod F_CL
  int n_items = 0;                          // the live (partition, sw)
  for (int zz = 0; zz < n_parts; ++zz) {
    const int nz = parts.p[zz].nsw;
    n_items += nz;
    const int64_t ob = (int64_t)zz * nsw_max * qc * CAND_PAD;
    for (int sw = nz + (int)(((int64_t)blockIdx.y - nz) % n_cl + n_cl)
                           % n_cl;
         sw < nsw_max; sw += n_cl) {
      const int per = (qc - rank + F_CL - 1) / F_CL;
      for (int i = tid; i < per * CAND_PAD; i += F_THREADS) {
        const int64_t o = ob + ((int64_t)sw * qc + rank
                                + F_CL * (i / CAND_PAD)) * CAND_PAD
                          + i % CAND_PAD;
        out_m[o] = -INFINITY;
        out_r[o] = 0;
      }
    }
  }
  // the cluster's live items: a contiguous range of the partitions' live
  // superwindows in order, so it sets a partition's queries up once or
  // twice
  const int it0 = (int)((int64_t)blockIdx.y * n_items / n_cl);
  const int it1 = (int)((int64_t)(blockIdx.y + 1) * n_items / n_cl);
  if (it0 == it1) return;                   // the whole cluster

  uint64_t* full = reinterpret_cast<uint64_t*>(f_smem);
  uint64_t* empty = full + F_MAX_ST;
  OwnQ* own = reinterpret_cast<OwnQ*>(f_smem + pl.o_own);
  uint32_t* olist = reinterpret_cast<uint32_t*>(f_smem + pl.o_olist);
  // per query of the tile by its compact index t: x = raw index | fast <<
  // 16, y = n, z = list offset, w = qs bits
  int4* qi = reinterpret_cast<int4*>(f_smem + pl.o_qi);
  // BITSET: [t][F_KW], bit r % 32 of word r / 32: the query keeps row r of
  // the block in this superwindow
  uint32_t* keep = reinterpret_cast<uint32_t*>(f_smem + pl.o_keep);
  uint32_t* alive = reinterpret_cast<uint32_t*>(f_smem + pl.o_alive);
  short* tof = reinterpret_cast<short*>(f_smem + pl.o_tof);
  // every batch's union slots, batch b's from ubase[b]
  unsigned short* uslot =
      reinterpret_cast<unsigned short*>(f_smem + pl.o_uslot);
  uint32_t* map = reinterpret_cast<uint32_t*>(f_smem + pl.o_map);
  int* misc = reinterpret_cast<int*>(f_smem + pl.o_misc);
  int* cnt_u = misc + 16;                       // [F_KMAX] planner unions
  int* bat = cnt_u + F_KMAX;                    // [gq + 1] batch starts
  int* ubase = bat + pl.gq + 1;                 // [gq + 1] union offsets
  // BITSET: [b][F_KW] the block's rows some query of batch b keeps
  uint32_t* bkw = reinterpret_cast<uint32_t*>(f_smem + pl.o_bkw);
  uint32_t* list = reinterpret_cast<uint32_t*>(f_smem + pl.o_list);
  int4* dlist = reinterpret_cast<int4*>(f_smem + pl.o_dlist);
  // CONJ: a query's list is its score-only entries, then those with score
  // and coverage weight, then the coverage-only ones (sweep_group_kernel's
  // order): scores read [0, x), coverage [y, n), need z; ownc by own index,
  // qx by compact index; each entry's wp beside it, in owp (olist), lwp
  // (list) and dwp (dlist)
  int4* ownc = reinterpret_cast<int4*>(f_smem + pl.o_ownc);
  int4* qx = reinterpret_cast<int4*>(f_smem + pl.o_qx);
  int8_t* owp = reinterpret_cast<int8_t*>(f_smem + pl.o_owp);
  int8_t* lwp = reinterpret_cast<int8_t*>(f_smem + pl.o_lwp);
  int* dwp = reinterpret_cast<int*>(f_smem + pl.o_dwp);
  // the superwindow's row maxima of this rank's queries, [i][SW_ROWS] for
  // raw query rank + F_CL i, written by every rank of the cluster
  uint32_t* gat = reinterpret_cast<uint32_t*>(f_smem + pl.o_gat);
  unsigned char* ring = f_smem + pl.o_ring;

  const int row0 = rank * F_RB;             // the block's rows of a sw
  if (tid == 0) {
    for (int s = 0; s < F_MAX_ST; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(
                       smem_u32(full + s))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + s)),
                   "r"(F_CW)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage parities: bit s of fpar is the phase of full[s] a consumer waits
  // for next, epar empty[s]'s for the producer; pend: stages filled and not
  // yet released
  uint32_t fpar = 0, epar = 0, pend = 0;
  const int lsub = lane & 7;                // the thread's 16 docs of a row
  const float* __restrict__ qs_z = nullptr;
  const int8_t* __restrict__ wq_z = nullptr;
  const int32_t* __restrict__ mask_z = nullptr;
  const int32_t* __restrict__ nreq_z = nullptr;
  const int8_t* __restrict__ wp_z = nullptr;
  float* __restrict__ om_z = nullptr;
  int32_t* __restrict__ or_z = nullptr;
  const int8_t* __restrict__ cols_hi = nullptr;
  const int8_t* __restrict__ cols_lo = nullptr;
  const float* __restrict__ live = nullptr;
  int hpt = 0;
  for (int w0 = 0; w0 < qc; w0 += pl.gq) {
    const int ng = min(pl.gq, qc - w0);
    const int n_own = rank < ng ? (ng - rank + F_CL - 1) / F_CL : 0;
    int z = -1, zend = 0;                   // the partition; its items end
    int n_act = 0, n_st = 0, n_bat = 0, max_nu = 0;
    for (int item = it0; item < it1; ++item) {
      if (item >= zend) {
        // the next partition: its tile's queries set up once
        int zs = 0;
        for (z = 0; zs + parts.p[z].nsw <= item; ++z) zs += parts.p[z].nsw;
        zend = zs + parts.p[z].nsw;
        qs_z = qscale + (int64_t)z * qc;
        wq_z = wq + (int64_t)z * 2 * qc * ws;
        om_z = out_m + (int64_t)z * nsw_max * qc * CAND_PAD;
        or_z = out_r + (int64_t)z * nsw_max * qc * CAND_PAD;
        if (MODE == BITSET) {
          mask_z = mask + (int64_t)z * qc * nsw_max * SW_WORD_ROWS * 128;
        }
        if (MODE == CONJ) {
          nreq_z = nreq + (int64_t)z * qc;
          wp_z = wp + (int64_t)z * qc * ws;
        }
        cols_hi = parts.p[z].hi;
        cols_lo = parts.p[z].lo;
        live = parts.p[z].live;
        hpt = parts.p[z].hpt;
        __syncthreads();

        // ---- 1. this rank's queries j = rank + F_CL i: counts and lists.
        // A CONJ query with no score weight keeps an empty list (its rows
        // are -inf, as K7's)
        for (int i = warp; i < n_own; i += F_WARPS) {
          const int q = w0 + rank + F_CL * i;
          const int8_t* wh = wq_z + (int64_t)q * ws;
          const int8_t* wl = wq_z + (int64_t)(qc + q) * ws;
          const int8_t* wc = MODE == CONJ ? wp_z + (int64_t)q * ws : nullptr;
          int n = 0, sa = 0, sb = 0, nc = 0, nb = 0;
          for (int s = lane; s < hpt; s += 32) {
            const int a = wh[s], b = wl[s];
            n += (a | b) != 0;
            sa += abs(a);
            sb += abs(b);
            if (MODE == CONJ) {
              const int c = wc[s];
              nc += c != 0;
              nb += c != 0 && (a | b) != 0;
            }
          }
          n = __reduce_add_sync(FULL, n);
          sa = __reduce_add_sync(FULL, sa);
          sb = __reduce_add_sync(FULL, sb);
          if (MODE == CONJ) {
            nc = __reduce_add_sync(FULL, nc);
            nb = __reduce_add_sync(FULL, nb);
          }
          if (lane == 0) {
            const float qs = qs_z[q];
            own[i] = OwnQ{MODE == CONJ && n != 0 ? n + nc - nb : n, -1, qs,
                          (int)fast_query(sa, sb, qs)};
            if (MODE == CONJ) ownc[i] = make_int4(n, n - nb, nreq_z[q], 0);
          }
        }
        __syncthreads();
        // own list offsets of the queries the staged path may take: fast, with
        // a list within one batch's union, in order while lc holds them
        if (warp == 0) {
          int base = 0;
          for (int i0 = 0; i0 < n_own; i0 += 32) {
            const int i = i0 + lane;
            const OwnQ o = i < n_own ? own[i] : OwnQ{0, -1, 0.f, 0};
            const int len = o.fast && o.n > 0 && o.n <= pl.slot_cap ? o.n : 0;
            int x = len;                         // inclusive scan
    #pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const int y = __shfl_up_sync(FULL, x, d);
              if (lane >= d) x += y;
            }
            if (len > 0 && base + x <= pl.lc) own[i].off = base + x - len;
            base += __shfl_sync(FULL, x, 31);
          }
        }
        __syncthreads();
        for (int i = warp; i < n_own; i += F_WARPS) {
          const int off = own[i].off;
          if (off < 0) continue;
          const int q = w0 + rank + F_CL * i;
          const int8_t* wh = wq_z + (int64_t)q * ws;
          const int8_t* wl = wq_z + (int64_t)(qc + q) * ws;
          const int8_t* wc = MODE == CONJ ? wp_z + (int64_t)q * ws : nullptr;
          int pos = off;
          // CONJ: three passes, one per part of the list
          for (int part = 0; part < (MODE == CONJ ? 3 : 1); ++part) {
            for (int s0 = 0; s0 < hpt; s0 += 32) {
              const int s = s0 + lane;
              const int a = s < hpt ? wh[s] : 0;
              const int b = s < hpt ? wl[s] : 0;
              const int c = MODE == CONJ && s < hpt ? wc[s] : 0;
              const bool nz = in_part<MODE>(part, (a | b) != 0, c);
              const unsigned bal = __ballot_sync(FULL, nz);
              if (nz) {
                const int e = pos + __popc(bal & ((1u << lane) - 1u));
                olist[e] = (unsigned)s | ((unsigned)(128 * a + b) << 16);
                if (MODE == CONJ) owp[e] = (int8_t)c;
              }
              pos += __popc(bal);
            }
          }
        }
        cluster.sync();                          // every rank's own region

        // ---- 2. every query of the tile from its rank. Staged: a list its
        // rank holds, while the tile's candidates' lists add up to lc; then
        // direct: the rest with a score weight. Compact indices t: the staged
        // (in order), then the direct ones (in order)
        int4* raw = reinterpret_cast<int4*>(gat);  // scratch: [ng] by raw j
        int4* rawc = raw + pl.gq;                  // CONJ: ownc, by raw j
        for (int j = tid; j < ng; j += F_THREADS) {
          const OwnQ o = cluster.map_shared_rank(own, j % F_CL)[j / F_CL];
          raw[j] = make_int4(o.n, o.off, __float_as_int(o.qs), o.fast);
          if (MODE == CONJ) {
            rawc[j] = cluster.map_shared_rank(ownc, j % F_CL)[j / F_CL];
          }
        }
        __syncthreads();
        if (warp == 0) {
          int e = 0, n_st = 0;
          for (int j0 = 0; j0 < ng; j0 += 32) {
            const int j = j0 + lane;
            const int4 r = j < ng ? raw[j] : make_int4(0, -1, 0, 0);
            const int len = r.y >= 0 ? r.x : 0;
            int x = len;                         // inclusive scan
    #pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
              const int y = __shfl_up_sync(FULL, x, d);
              if (lane >= d) x += y;
            }
            const bool st = len > 0 && e + x <= pl.lc;
            const unsigned bal = __ballot_sync(FULL, st);
            if (st) {
              const int t = n_st + __popc(bal & ((1u << lane) - 1u));
              qi[t] = make_int4(j | (r.w << 16), r.x, e + x - len, r.z);
              if (MODE == CONJ) qx[t] = rawc[j];
              tof[j] = (short)t;
            } else if (j < ng) {
              tof[j] = -1;
            }
            n_st += __popc(bal);
            e += __shfl_sync(FULL, x, 31);
          }
          int n_act = n_st;
          for (int j0 = 0; j0 < ng; j0 += 32) {
            const int j = j0 + lane;
            const int4 r = j < ng ? raw[j] : make_int4(0, -1, 0, 0);
            const bool dir = j < ng && r.x > 0 && tof[j] < 0;
            const unsigned bal = __ballot_sync(FULL, dir);
            if (dir) {
              const int t = n_act + __popc(bal & ((1u << lane) - 1u));
              qi[t] = make_int4(j | (r.w << 16), r.x, 0, r.z);
              if (MODE == CONJ) qx[t] = rawc[j];
              tof[j] = (short)t;
            }
            n_act += __popc(bal);
          }
          if (lane == 0) {
            misc[0] = n_act;
            misc[1] = n_st;
          }
        }
        __syncthreads();
        n_act = misc[0];
        n_st = misc[1];
        for (int t = warp; t < n_st; t += F_WARPS) {
          const int4 info = qi[t];
          const int j = info.x & 0xFFFF;
          const uint32_t* ro =
              cluster.map_shared_rank(olist, j % F_CL) + raw[j].y;
          for (int i = lane; i < info.y; i += 32) list[info.z + i] = ro[i];
          if (MODE == CONJ) {
            const int8_t* rw =
                cluster.map_shared_rank(owp, j % F_CL) + raw[j].y;
            for (int i = lane; i < info.y; i += 32) lwp[info.z + i] = rw[i];
          }
        }
        // no rank reads another's own region or its own scratch (raw, in
        // gat) past here, and no rank stores a row value into another's
        // gat before here
        cluster.sync();

        // ---- 3. batches of the staged queries whose union fits the ring
        // twice: k chunks of consecutive queries, k = 1, 2, 4, ..., F_KMAX,
        // chunk c = {t : floor(t k / n_st) = c}; past F_KMAX, a query a batch
        n_bat = 0;
        for (int kk = 1; n_st > 0; kk *= 2) {
          if (kk > F_KMAX || kk > n_st) {
            for (int b = tid; b <= n_st; b += F_THREADS) bat[b] = b;
            n_bat = n_st;
            break;
          }
          __syncthreads();
          for (int s = tid; s < hpt; s += F_THREADS) map[s] = 0u;
          if (tid < kk) cnt_u[tid] = 0;
          __syncthreads();
          for (int t = warp; t < n_st; t += F_WARPS) {
            const int4 info = qi[t];
            const unsigned bit = 1u << (int)((int64_t)t * kk / n_st);
            for (int i = lane; i < info.y; i += 32) {
              atomicOr(map + (list[info.z + i] & 0xFFFF), bit);
            }
          }
          __syncthreads();
          for (int s = tid; s < hpt; s += F_THREADS) {
            for (unsigned m = map[s]; m; m &= m - 1u) {
              atomicAdd(cnt_u + __ffs(m) - 1, 1);
            }
          }
          __syncthreads();
          bool ok = true;
          for (int c = 0; c < kk; ++c) ok = ok && cnt_u[c] <= pl.slot_cap;
          if (ok) {
            for (int c = tid; c <= kk; c += F_THREADS) {
              bat[c] = (int)(((int64_t)c * n_st + kk - 1) / kk);
            }
            n_bat = kk;
            break;
          }
        }
        // each batch's union in stage order (batch b's at ubase[b], within
        // lc: a union is no longer than its lists), its entries rewritten to
        // (stage index | W << 16)
        for (int b = 0; b < n_bat; ++b) {
          __syncthreads();
          const int t0 = bat[b], t1 = bat[b + 1];
          for (int s = tid; s < hpt; s += F_THREADS) map[s] = 0u;
          __syncthreads();
          for (int t = t0 + warp; t < t1; t += F_WARPS) {
            const int4 info = qi[t];
            for (int i = lane; i < info.y; i += 32) {
              map[list[info.z + i] & 0xFFFF] = 1u;
            }
          }
          __syncthreads();
          if (warp == 0) {
            const int u0 = b == 0 ? 0 : ubase[b];
            int u = 0;
            for (int s0 = 0; s0 < hpt; s0 += 32) {
              const int s = s0 + lane;
              const bool in = s < hpt && map[s] != 0u;
              const unsigned bal = __ballot_sync(FULL, in);
              if (in) {
                const int x = u + __popc(bal & ((1u << lane) - 1u));
                map[s] = (unsigned)x;
                uslot[u0 + x] = (unsigned short)s;
              }
              u += __popc(bal);
            }
            if (lane == 0) {
              ubase[b] = u0;
              ubase[b + 1] = u0 + u;
            }
          }
          __syncthreads();
          for (int t = t0 + warp; t < t1; t += F_WARPS) {
            const int4 info = qi[t];
            for (int i = lane; i < info.y; i += 32) {
              const uint32_t e = list[info.z + i];
              list[info.z + i] = map[e & 0xFFFF] | (e & 0xFFFF0000u);
            }
          }
        }
        __syncthreads();
        max_nu = 0;
        for (int b = 0; b < n_bat; ++b) {
          max_nu = max(max_nu, ubase[b + 1] - ubase[b]);
        }
      }

      // ---- the cluster's superwindows of the partition, each: its rows'
      // alive bits (and the queries' kept rows), the batches' stages, the
      // direct queries, and the selection over the cluster
      {
        const int sw = item - (zend - parts.p[z].nsw);
        for (int p0 = warp; p0 < F_RB * 4; p0 += F_WARPS * 4) {
          float v[4];
  #pragma unroll
          for (int u = 0; u < 4; ++u) {         // loads first, then ballots
            const int p = p0 + u * F_WARPS;
            v[u] = p < F_RB * 4
                       ? live[((int64_t)sw * SW_ROWS + row0 + p / 4) * 128
                              + 32 * (p % 4) + lane]
                       : 0.f;
          }
  #pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = p0 + u * F_WARPS;
            const unsigned bl = __ballot_sync(FULL, v[u] > 0.f);
            if (lane == 0 && p < F_RB * 4) alive[p] = bl;
          }
        }
        if (MODE == BITSET) {
          // which of the block's rows each query keeps: bit r % 32 of word
          // row r / 32, any doc (the reference's chunk skip)
          for (int t0 = warp; t0 < n_act; t0 += F_WARPS * 2) {
            uint4 v[2][F_KW];
  #pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int t = t0 + u * F_WARPS;
              const int q = w0 + (t < n_act ? qi[t].x & 0xFFFF : 0);
              const uint4* m4 = reinterpret_cast<const uint4*>(
                  mask_z + (((int64_t)q * nsw_max + sw) * SW_WORD_ROWS
                          + F_KW * rank) * 128);
  #pragma unroll
              for (int i = 0; i < F_KW; ++i) {
                v[u][i] = t < n_act ? __ldg(m4 + i * 32 + lane)
                                    : make_uint4(0, 0, 0, 0);
              }
            }
  #pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int t = t0 + u * F_WARPS;
  #pragma unroll
              for (int i = 0; i < F_KW; ++i) {
                const unsigned o = __reduce_or_sync(
                    FULL, v[u][i].x | v[u][i].y | v[u][i].z | v[u][i].w);
                if (lane == i && t < n_act) keep[t * F_KW + i] = o;
              }
            }
          }
        }
        __syncthreads();
        if (MODE == BITSET) {                  // each batch's kept rows
          for (int b = warp; b < n_bat; b += F_WARPS) {
  #pragma unroll
            for (int i = 0; i < F_KW; ++i) {
              uint32_t a = 0u;
              for (int t = bat[b] + lane; t < bat[b + 1]; t += 32) {
                a |= keep[t * F_KW + i];
              }
              a = __reduce_or_sync(FULL, a);
              if (lane == 0) bkw[b * F_KW + i] = a;
            }
          }
          __syncthreads();
        }

        // ---- 4. a stage a (row group, batch): the batch's union slots'
        // rows (cp.async into a ring, completed on mbarriers, by the producer
        // warp), every query of the batch scored from the stage; each chunk's
        // union columns prefetched to L2 whole a chunk ahead
        if (n_bat > 0) {
          const int nst = min(F_MAX_ST, pl.ring_slots / max_nu);
          const int sbytes = max_nu * F_SLOT_BYTES;
          if (warp == F_CW) {
            // the producer: each union slot's rows two pieces (hi, lo) of
            // F_R * 128 contiguous bytes, a warp's 16-byte cp.asyncs a piece;
            // each lane arrives on the stage's barrier when its copies have
            // landed
            auto prefetch = [&](int ch) {     // chunk ch of the block's rows
              const int64_t cb =
                  (int64_t)(sw * N_CHUNKS_SW + (row0 >> 4) + ch) * hpt * 2048;
              for (int p = lane; p < 2 * ubase[n_bat]; p += 32) {
                const int8_t* src = (p & 1 ? cols_lo : cols_hi) + cb
                                    + (int64_t)uslot[p >> 1] * 2048;
                asm volatile("cp.async.bulk.prefetch.L2.global [%0], 2048;\n"
                             ::"l"(src)
                             : "memory");
              }
            };
            prefetch(0);
            int c = 0;
            for (int g = 0; g < F_NG; ++g) {
              if (g % (CHUNK_ROWS / F_R) == 0
                  && g / (CHUNK_ROWS / F_R) + 1 < F_RB / CHUNK_ROWS) {
                prefetch(g / (CHUNK_ROWS / F_R) + 1);
              }
              const int r = row0 + g * F_R;
              const int64_t base =
                  (int64_t)(sw * N_CHUNKS_SW + r / CHUNK_ROWS) * hpt * 2048
                  + (r % CHUNK_ROWS) * 128 + lane * 16;
              for (int b = 0; b < n_bat; ++b) {
                if (!row_group_kept<MODE>(bkw + b * F_KW, g)) continue;
                const int s = c++ % nst;
                if ((pend >> s) & 1u) {
                  bar_wait(empty + s, (epar >> s) & 1u);
                  epar ^= 1u << s;
                }
                const int nu = ubase[b + 1] - ubase[b];
                const unsigned short* us = uslot + ubase[b];
                const uint32_t st = smem_u32(ring) + s * sbytes + lane * 16;
                const int8_t* hb = cols_hi + base;
                const int8_t* lb = cols_lo + base;
  #pragma unroll 4
                for (int u = 0; u < nu; ++u) {
                  const uint32_t so = (uint32_t)us[u] * 2048u;
                  cp_async16(st + u * F_SLOT_BYTES, hb + so);
                  cp_async16(st + u * F_SLOT_BYTES + F_R * 128, lb + so);
                }
                cp_async_arrive(full + s);
                pend |= 1u << s;
              }
            }
            for (int s = 0; s < nst; ++s) {     // drain: every stage released
              if ((pend >> s) & 1u) {
                bar_wait(empty + s, (epar >> s) & 1u);
                epar ^= 1u << s;
              }
            }
            pend = 0;
          } else {
            // the consumers: on a stage of batch b, warp w scores queries
            // bat[b] + w + F_CW i on its four rows, 16 docs a thread
            int c = 0;
            for (int g = 0; g < F_NG; ++g) {
              const int rl = g * F_R + (lane >> 3);
              const int row = row0 + rl;
              const unsigned a16 =
                  (alive[rl * 4 + (lsub >> 1)] >> ((lsub & 1) * 16)) & 0xFFFFu;
              const Words msk = gate_words(a16);
              // BITSET: the queries that keep a row of the group (the
              // others' rows stay 0), each one's mask words loaded while the
              // one before it is scored
              const int32_t* mrow =
                  MODE == BITSET ? mask_z + ((int64_t)sw * SW_WORD_ROWS
                                             + row / 32) * 128 + lsub * DPT
                                 : nullptr;
              const int64_t mstride = (int64_t)nsw_max * SW_WORD_ROWS * 128;
              for (int b = 0; b < n_bat; ++b) {
                const int t1 = bat[b + 1];
                if (!row_group_kept<MODE>(bkw + b * F_KW, g)) {
                  // no stage: every query of the batch keeps none of the rows
                  for (int t = bat[b] + warp; lsub == 0 && t < t1;
                       t += F_CW) {
                    put_row(cluster, gat, qi[t].x & 0xFFFF, row, 0u);
                  }
                  continue;
                }
                const int s = c++ % nst;
                bar_wait(full + s, (fpar >> s) & 1u);
                fpar ^= 1u << s;
                const unsigned char* st =
                    ring + (int64_t)s * sbytes + lane * 16;
                auto kept_from = [&](int t) {
                  while (MODE == BITSET && t < t1
                         && !row_group_kept<MODE>(keep + t * F_KW, g)) {
                    t += F_CW;
                  }
                  return t;
                };
                // the warp's queries of the batch: those that keep a row of
                // the group scored (F3: each one's mask words loaded while the
                // one before it is scored), the others' rows 0
                int tk = kept_from(bat[b] + warp);
                MaskWords mw;
                if (MODE == BITSET && tk < t1) {
                  mw = mask_load(mrow + (w0 + (qi[tk].x & 0xFFFF)) * mstride);
                }
                for (int t = bat[b] + warp; t < t1; t += F_CW) {
                  const int4 info = qi[t];
                  if (t != tk) {
                    if (lsub == 0) {
                      put_row(cluster, gat, info.x & 0xFFFF, row, 0u);
                    }
                    continue;
                  }
                  tk = kept_from(t + F_CW);
                  int m;
                  if (MODE == BITSET) {
                    const unsigned gate = a16 & mask_gate(mw, row & 31);
                    if (tk < t1) {
                      mw = mask_load(mrow + (w0 + (qi[tk].x & 0xFFFF))
                                                * mstride);
                    }
                    m = __any_sync(FULL, gate != 0u)
                            ? docs_staged(list + info.z, info.y, st,
                                          gate_words(gate))
                            : 0;
                  } else if (MODE == CONJ) {
                    const int4 cx = qx[t];
                    m = docs_conj_staged(list + info.z, lwp + info.z, cx.x,
                                         cx.y, info.y, st, a16, cx.z);
                  } else {
                    m = docs_staged(list + info.z, info.y, st, msk);
                  }
  #pragma unroll
                  for (int o = TPR / 2; o > 0; o >>= 1) {
                    m = max(m, __shfl_xor_sync(FULL, m, o));
                  }
                  if (lsub == 0) {
                    put_row(cluster, gat, info.x & 0xFFFF, row,
                            m > 0 ? pre_val(__float_as_uint(__int2float_rn(m)),
                                            __int_as_float(info.w))
                                  : 0u);
                  }
                }
                __syncwarp();
                if (lane == 0) bar_arrive(empty + s);
              }
            }
          }
        }

        // ---- 5. the direct queries (the integer path, or a list past a
        // batch): their lists as sweep_group_kernel keeps them, in batches
        // that fit dc, each warp (the producer's too) taking a row group,
        // read from device memory
        for (int d0 = n_st; d0 < n_act;) {
          __syncthreads();
          int d1 = d0, used = 0;
          while (d1 < n_act && used + qi[d1].y <= pl.dc) used += qi[d1++].y;
          for (int t = d0 + warp; t < d1; t += F_WARPS) {
            int pos = 0;
            for (int i = d0; i < t; ++i) pos += qi[i].y;
            const int q = w0 + (qi[t].x & 0xFFFF);
            if (lane == 0) qi[t].z = pos;
            const int8_t* wh = wq_z + (int64_t)q * ws;
            const int8_t* wl = wq_z + (int64_t)(qc + q) * ws;
            const int8_t* wc = MODE == CONJ ? wp_z + (int64_t)q * ws
                                            : nullptr;
            for (int part = 0; part < (MODE == CONJ ? 3 : 1); ++part) {
              for (int s0 = 0; s0 < hpt; s0 += 32) {
                const int s = s0 + lane;
                const int a = s < hpt ? wh[s] : 0;
                const int b = s < hpt ? wl[s] : 0;
                const int c = MODE == CONJ && s < hpt ? wc[s] : 0;
                const bool nz = in_part<MODE>(part, (a | b) != 0, c);
                const unsigned bal = __ballot_sync(FULL, nz);
                if (nz) {
                  const int e = pos + __popc(bal & ((1u << lane) - 1u));
                  dlist[e] = make_int4(
                      (int)((unsigned)s | ((unsigned)(a & 0xFF) << 16)
                            | ((unsigned)b << 24)),
                      __float_as_int((float)(16384 * a + 128 * b)),
                      __float_as_int((float)(128 * a)),
                      __float_as_int((float)b));
                  if (MODE == CONJ) dwp[e] = c;
                }
                pos += __popc(bal);
              }
            }
          }
          __syncthreads();
          for (int g = warp; g < F_NG; g += F_WARPS) {
            const int rl = g * F_R + (lane >> 3);
            const int row = row0 + rl;
            const unsigned a16 =
                (alive[rl * 4 + (lsub >> 1)] >> ((lsub & 1) * 16)) & 0xFFFFu;
            const int64_t rbase =
                ((int64_t)(sw * N_CHUNKS_SW + row / CHUNK_ROWS) * hpt) * 2048
                + (row % CHUNK_ROWS) * 128 + lsub * DPT;
            const int8_t* hi = cols_hi + rbase;
            const int8_t* lo = cols_lo + rbase;
            for (int t = d0; t < d1; ++t) {
              const int4 info = qi[t];
              const bool fast = (info.x >> 16) != 0;
              const float qs = __int_as_float(info.w);
              unsigned gate = a16;
              int ns = info.y;
              if (MODE == BITSET) {
                const int q = w0 + (info.x & 0xFFFF);
                gate &= mask_bits(mask_z + (((int64_t)q * nsw_max + sw)
                                          * SW_WORD_ROWS + row / 32) * 128
                                      + lsub * DPT,
                                  row & 31);
              }
              if (MODE == CONJ) {
                const int4 cx = qx[t];
                gate &= cover_bits(dlist + info.z + cx.y,
                                   dwp + info.z + cx.y, info.y - cx.y, hi,
                                   lo, cx.z);
                ns = cx.x;
              }
              unsigned v = 0u;
              if (MODE == DISJ || gate != 0u) {
                v = fast ? docs_fast(dlist + info.z, ns, hi, lo,
                                     gate_words(gate))
                         : docs_int(dlist + info.z, ns, hi, lo, gate, qs);
              }
  #pragma unroll
              for (int o = TPR / 2; o > 0; o >>= 1) {
                v = max(v, __shfl_xor_sync(FULL, v, o));
              }
              if (lsub == 0) {
                put_row(cluster, gat, info.x & 0xFFFF, row,
                        fast ? pre_val(v, qs) : v);
              }
            }
          }
          d0 = d1;
        }
        cluster.sync();                        // every rank's row maxima

        // ---- 6. the top NCAND rows of each query of the tile over the
        // superwindow's 512 in the rank's gather buffer, rank r writing
        // queries j = r mod F_CL: a warp a query, lane l holding rows l + 32 k,
        // sweep_group_kernel's rounds
        for (int i = warp; i < n_own; i += F_WARPS) {
          const int j = rank + F_CL * i;
          const int t = tof[j];
          float om = -INFINITY;
          int orow = 0;
          if (t >= 0) {
            uint32_t* rv = gat + i * SW_ROWS;
            unsigned best = 0u;
            int bt = 0;
            for (int k = 0; k < SW_ROWS / 32; ++k) {
              const unsigned x = rv[lane + 32 * k];
              if (x > best) {
                best = x;
                bt = k;
              }
            }
            for (int p = 0; p < NCAND; ++p) {
              const unsigned m = __reduce_max_sync(FULL, best);
              if (m == 0u) break;
              const unsigned cc =
                  best == m ? (unsigned)(SW_ROWS - (lane + 32 * bt)) : 0u;
              const int r = SW_ROWS - (int)__reduce_max_sync(FULL, cc);
              if (lane == p) {
                om = __uint_as_float(m);
                orow = r + sw * SW_ROWS;
              }
              if ((r & 31) == lane) {
                rv[r] = 0u;
                best = 0u;
                bt = 0;
                for (int k = 0; k < SW_ROWS / 32; ++k) {
                  const unsigned x = rv[lane + 32 * k];
                  if (x > best) {
                    best = x;
                    bt = k;
                  }
                }
              }
            }
          }
          const int64_t o = ((int64_t)sw * qc + w0 + j) * CAND_PAD + lane;
          om_z[o] = om;
          or_z[o] = orow;
        }
        cluster.sync();     // no rank reads another's maxima after
      }
    }
  }
}

// list entries a block holds at once: a whole group's slots where they
// fit in LIST_MIN, else at least one query's
int list_cap(int hpt) {
  return G * hpt < LIST_MIN ? G * hpt : (hpt > LIST_MIN ? hpt : LIST_MIN);
}

template <int MODE>
int launch_group(const PartTable& parts, int n_parts, int hpt_max,
                 const void* qscale, const void* nreq, const void* wq,
                 const void* wp, const void* mask, void* out_m, void* out_r,
                 int qc, int ws, int nsw_max, void* stream) {
  if (hpt_max < 1 || hpt_max > 0xFFFF || ws < hpt_max || n_parts < 1
      || n_parts > MAX_PARTS) {
    return (int)cudaErrorInvalidValue;
  }
  const int cap = list_cap(hpt_max);
  const int smem =
      cap * (int)(sizeof(int4) + (MODE == CONJ ? sizeof(int) : 0))
      + G * SW_ROWS * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_group_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (qc <= 0 || nsw_max <= 0) return 0;
  dim3 grid((qc + G - 1) / G, nsw_max, n_parts);
  sweep_group_kernel<MODE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      parts, (const float*)qscale, (const int32_t*)nreq, (const int8_t*)wq,
      (const int8_t*)wp, (const int32_t*)mask, (float*)out_m,
      (int32_t*)out_r, qc, ws, cap);
  return (int)cudaGetLastError();
}

// the solo sweeps (K2, K6, K7): a one-partition table
template <int MODE>
int launch_solo(const void* qscale, const void* nreq, const void* cols_hi,
                const void* cols_lo, const void* wq, const void* wp,
                const void* mask, const void* live, void* out_m,
                void* out_r, int qc, int hpt, int nsw, void* stream) {
  PartTable parts;                     // copied into the launch
  parts.p[0] = Part{(const int8_t*)cols_hi, (const int8_t*)cols_lo,
                    (const float*)live, nsw, hpt};
  return launch_group<MODE>(parts, 1, hpt, qscale, nreq, wq, wp, mask,
                            out_m, out_r, qc, hpt, nsw, stream);
}

// the fused sweeps' table: [n_parts, 5] int64 on the host, a row (cols_hi,
// cols_lo, live, nsw, hpt) a partition, n_parts <= MAX_PARTS; false when it
// does not fit the launch
bool read_table(const int64_t* table, int n_parts, int nsw_max,
                PartTable* parts, int* hpt_max) {
  if (n_parts < 1 || n_parts > MAX_PARTS) return false;
  *hpt_max = 0;
  for (int i = 0; i < n_parts; ++i) {
    const int64_t* r = table + 5 * i;
    const int nsw = (int)r[3], hpt = (int)r[4];
    if (nsw < 1 || nsw > nsw_max || hpt < 1) return false;
    parts->p[i] = Part{(const int8_t*)r[0], (const int8_t*)r[1],
                       (const float*)r[2], nsw, hpt};
    *hpt_max = hpt > *hpt_max ? hpt : *hpt_max;
  }
  return true;
}

// F1-F3 below fused_min_qc: sweep_group_kernel with the partition a third
// grid axis
template <int MODE>
int launch_fused(const int64_t* table, int n_parts, const void* qscale,
                 const void* nreq, const void* wq, const void* wp,
                 const void* mask, void* out_m, void* out_r, int qc, int ws,
                 int nsw_max, void* stream) {
  PartTable parts;                     // copied into the launch
  int hpt_max;
  if (!read_table(table, n_parts, nsw_max, &parts, &hpt_max)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_group<MODE>(parts, n_parts, hpt_max, qscale, nreq, wq, wp,
                            mask, out_m, out_r, qc, ws, nsw_max, stream);
}

// Per device and mode: whether the kernel's shared-memory attribute is
// set (to F_SMEM, the most any plan takes), and up to F_MEMO (smem, the
// clusters the device holds at once) pairs, smem << 16 | clusters, asked
// on a plan's first launch. Read without a lock: every writer of an
// entry stores the same value.
std::atomic<int> f_attr[3][F_MAX_DEVICES];
std::atomic<long long> f_memo[3][F_MAX_DEVICES][F_MEMO];

// the clusters of fused_sweep_kernel<MODE> the card holds at once
template <int MODE>
cudaError_t fused_clusters(const FusedPlan& pl, int* n_cl) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= F_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (f_attr[MODE][dev].load(std::memory_order_relaxed) == 0) {
    err = cudaFuncSetAttribute(fused_sweep_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F_SMEM);
    if (err != cudaSuccess) return err;
    f_attr[MODE][dev].store(1, std::memory_order_relaxed);
  }
  std::atomic<long long>* memo = f_memo[MODE][dev];
  for (int i = 0; i < F_MEMO; ++i) {
    const long long e = memo[i].load(std::memory_order_relaxed);
    if (e == 0) break;
    if ((e >> 16) == pl.smem) {
      *n_cl = (int)(e & 0xFFFF);
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(F_CL, 1, 1);
  cfg.blockDim = dim3(F_THREADS, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  err = cudaOccupancyMaxActiveClusters(n_cl, fused_sweep_kernel<MODE>, &cfg);
  if (err != cudaSuccess || *n_cl < 1 || *n_cl > 0xFFFF) return err;
  const long long e = ((long long)pl.smem << 16) | *n_cl;
  for (int i = 0; i < F_MEMO; ++i) {      // the first free entry, if any
    long long z = 0;
    if (memo[i].compare_exchange_strong(z, e) || z == e) break;
  }
  return cudaSuccess;
}

// F1-F3's sweep: fused_sweep_kernel, a cluster of F_CL blocks per
// (superwindow, partition), from fused_min_qc(MODE) queries;
// sweep_group_kernel with the partition a third grid axis below
template <int MODE>
int launch_fused_cluster(const int64_t* table, int n_parts,
                         const void* qscale, const void* nreq,
                         const void* wq, const void* wp, const void* mask,
                         void* out_m, void* out_r, int qc, int ws,
                         int nsw_max, void* stream) {
  if (qc < fused_min_qc(MODE)) {
    return launch_fused<MODE>(table, n_parts, qscale, nreq, wq, wp, mask,
                              out_m, out_r, qc, ws, nsw_max, stream);
  }
  PartTable parts;                     // copied into the launch
  int hpt_max;
  if (!read_table(table, n_parts, nsw_max, &parts, &hpt_max)
      || hpt_max > 0xFFFF || ws < hpt_max) {
    return (int)cudaErrorInvalidValue;
  }
  const FusedPlan pl = fused_plan(qc, hpt_max, MODE);
  if (pl.slot_cap < 1) return (int)cudaErrorInvalidValue;
  // persistent clusters: as many as the card holds at once, each taking a
  // contiguous range of the partitions' live superwindows
  int n_cl = 0;
  const cudaError_t err = fused_clusters<MODE>(pl, &n_cl);
  if (err != cudaSuccess) return (int)err;
  int n_items = 0;
  for (int i = 0; i < n_parts; ++i) n_items += parts.p[i].nsw;
  const int gy = n_cl < 1 ? 1 : (n_cl > n_items ? n_items : n_cl);
  dim3 grid(F_CL, gy, 1);
  fused_sweep_kernel<MODE><<<grid, F_THREADS, pl.smem,
                             (cudaStream_t)stream>>>(
      parts, (const float*)qscale, (const int32_t*)nreq, (const int8_t*)wq,
      (const int8_t*)wp, (const int32_t*)mask, (float*)out_m,
      (int32_t*)out_r, n_parts, qc, ws, nsw_max, pl);
  return (int)cudaGetLastError();
}

// the mode of the plan entries: 0 F1 (DISJ), 1 F3 (BITSET), 2 F2 (CONJ);
// -1 for any other value
int plan_mode(int mode) {
  return mode == 0 ? DISJ : mode == 1 ? BITSET : mode == 2 ? CONJ : -1;
}

}  // namespace

extern "C" int es_sweep_rowmax(const void* qscale, const void* cols_hi,
                               const void* cols_lo, const void* wq,
                               const void* live, void* out_m, void* out_r,
                               int qc, int hpt, int nsw, void* stream) {
  return launch_solo<DISJ>(qscale, nullptr, cols_hi, cols_lo, wq, nullptr,
                           nullptr, live, out_m, out_r, qc, hpt, nsw, stream);
}

// the group size and list capacity as built, for the wrapper's mirror of
// them (kernels.SWEEP_GROUP, kernels.sweep_list_cap) and chip_smoke.py
extern "C" int es_sweep_group() { return G; }

extern "C" int es_sweep_list_cap(int hpt) { return list_cap(hpt); }

extern "C" int es_sweep_rowmax_conj(const void* qscale, const void* nreq,
                                    const void* cols_hi, const void* cols_lo,
                                    const void* wq, const void* wp,
                                    const void* live, void* out_m,
                                    void* out_r, int qc, int hpt, int nsw,
                                    void* stream) {
  return launch_solo<CONJ>(qscale, nreq, cols_hi, cols_lo, wq, wp, nullptr,
                           live, out_m, out_r, qc, hpt, nsw, stream);
}

extern "C" int es_sweep_rowmax_bitset(const void* qscale, const void* cols_hi,
                                      const void* cols_lo, const void* wq,
                                      const void* mask, const void* live,
                                      void* out_m, void* out_r, int qc,
                                      int hpt, int nsw, void* stream) {
  return launch_solo<BITSET>(qscale, nullptr, cols_hi, cols_lo, wq, nullptr,
                             mask, live, out_m, out_r, qc, hpt, nsw, stream);
}

// F1-F3, one launch for up to MAX_PARTS partitions (see the header): table
// [n_parts, 5] int64 on the host; the stacked inputs and output start at
// the launch's first partition
extern "C" int es_fused_sweep_rowmax(const void* table, int n_parts,
                                     const void* qscale, const void* wq,
                                     void* out_m, void* out_r, int qc,
                                     int ws, int nsw_max, void* stream) {
  return launch_fused_cluster<DISJ>((const int64_t*)table, n_parts, qscale,
                                    nullptr, wq, nullptr, nullptr, out_m,
                                    out_r, qc, ws, nsw_max, stream);
}

extern "C" int es_fused_sweep_rowmax_conj(const void* table, int n_parts,
                                          const void* qscale,
                                          const void* nreq, const void* wq,
                                          const void* wp, void* out_m,
                                          void* out_r, int qc, int ws,
                                          int nsw_max, void* stream) {
  return launch_fused_cluster<CONJ>((const int64_t*)table, n_parts, qscale,
                                    nreq, wq, wp, nullptr, out_m, out_r, qc,
                                    ws, nsw_max, stream);
}

extern "C" int es_fused_sweep_rowmax_bitset(const void* table, int n_parts,
                                            const void* qscale,
                                            const void* wq,
                                            const void* mask, void* out_m,
                                            void* out_r, int qc, int ws,
                                            int nsw_max, void* stream) {
  return launch_fused_cluster<BITSET>((const int64_t*)table, n_parts,
                                      qscale, nullptr, wq, nullptr, mask,
                                      out_m, out_r, qc, ws, nsw_max, stream);
}

// the partitions one fused launch takes, for the wrapper's mirror
// (kernels.MAX_FUSED_PARTS)
extern "C" int es_fused_max_parts() { return MAX_PARTS; }

// the clusters of the sweep kernel of F1 (mode 0), F3 (1) or F2 (2) the
// card holds at once for (qc, hpt_max), or -1 on an error
extern "C" int es_fused_sweep_clusters(int qc, int hpt_max, int mode) {
  const int m = plan_mode(mode);
  if (m < 0) return -1;
  const FusedPlan p = fused_plan(qc, hpt_max, m);
  int n = 0;
  const cudaError_t err = m == BITSET ? fused_clusters<BITSET>(p, &n)
                          : m == CONJ ? fused_clusters<CONJ>(p, &n)
                                      : fused_clusters<DISJ>(p, &n);
  return err == cudaSuccess ? n : -1;
}

// the plan of F1 (mode 0), F3 (1) or F2 (2) as built, for
// kernels.fused_sweep_plan and the CPU emulation: out = (gq, oq, lc, dc,
// ring_slots, slot_cap, smem, cluster, rows a stage, 1 if the launch runs
// fused_sweep_kernel and 0 if sweep_group_kernel); -1 for another mode
extern "C" int es_fused_sweep_plan(int qc, int hpt_max, int mode,
                                   int* out) {
  const int m = plan_mode(mode);
  if (m < 0) return -1;
  const FusedPlan p = fused_plan(qc, hpt_max, m);
  const int v[10] = {p.gq, p.oq, p.lc, p.dc, p.ring_slots, p.slot_cap,
                     p.smem, F_CL, F_R, qc >= fused_min_qc(m)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}
