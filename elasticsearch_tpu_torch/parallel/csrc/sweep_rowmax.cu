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
// The combine is the reference's, in f32:
//   val = ((16384 * hh + 128 * (hl + lh)) + ll) * qscale
// Both products are exact (powers of two times integers below 2^24), so
// fused or not the result is the same; __fmul_rn/__fadd_rn keep it explicit.
// A doc counts only if live > 0 and val > 0 (and the mode's gate); an
// empty row is -inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SW_ROWS = 512;          // 128-doc rows per 65536-doc superwindow
constexpr int CHUNK_ROWS = 16;        // rows per 2048-doc chunk-major
constexpr int NCAND = 17;
constexpr int CAND_PAD = 32;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SW_WORD_ROWS = SW_ROWS / 32;   // packed mask word rows

enum Mode { DISJ = 0, CONJ = 1, BITSET = 2 };

constexpr int G = 16;            // queries a block (measured: tools/k2_ab.py)
constexpr int LIST_MIN = 256;    // list entries a block may always hold
constexpr int TPR = 8;           // threads a row
constexpr int DPT = 128 / TPR;   // docs a thread
constexpr int NW = DPT / 4;      // 32-bit words a thread per slot and layer
constexpr int ROWS_IT = THREADS / TPR;   // rows a block scores at once
constexpr unsigned FULL = 0xffffffffu;

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
__device__ __forceinline__ unsigned mask_bits(const int32_t* p, int bit) {
  unsigned g = 0;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
    g |= (((v.x >> bit) & 1u) | (((v.y >> bit) & 1u) << 1)
          | (((v.z >> bit) & 1u) << 2) | (((v.w >> bit) & 1u) << 3))
         << (4 * i);
  }
  return g;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
sweep_group_kernel(const float* __restrict__ qscale,
                   const int32_t* __restrict__ nreq,     // CONJ: [qc]
                   const int8_t* __restrict__ cols_hi,
                   const int8_t* __restrict__ cols_lo,
                   const int8_t* __restrict__ wq,
                   const int8_t* __restrict__ wp,        // CONJ: [qc, hpt]
                   // BITSET: [qc, nsw * 16, 128]
                   const int32_t* __restrict__ mask,
                   const float* __restrict__ live,
                   float* __restrict__ out_m, int32_t* __restrict__ out_r,
                   int qc, int hpt, int cap) {
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
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // TPR threads a row, 16 docs each; a warp's rows are adjacent, so a
  // warp's load of one slot and layer is 512 contiguous bytes
  const int sub = lane % TPR;

  // each query's nonzero slots and weight sums, a warp per query. A CONJ
  // query with no score weight keeps an empty list: every val is 0, never
  // > 0, so it writes its empty result and takes no list room
  for (int j = warp; j < ng; j += WARPS) {
    const int8_t* wh = wq + (int64_t)(q0 + j) * hpt;
    const int8_t* wl = wq + (int64_t)(qc + q0 + j) * hpt;
    const int8_t* wc = MODE == CONJ ? wp + (int64_t)(q0 + j) * hpt : nullptr;
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
      const int8_t* wh = wq + (int64_t)(q0 + j) * hpt;
      const int8_t* wl = wq + (int64_t)(qc + q0 + j) * hpt;
      const int8_t* wc = MODE == CONJ ? wp + (int64_t)(q0 + j) * hpt
                                      : nullptr;
      // CONJ: three passes, one per part of the list
      for (int part = 0; part < (MODE == CONJ ? 3 : 1); ++part) {
        for (int s0 = 0; s0 < hpt; s0 += 32) {
          const int s = s0 + lane;
          const int a = s < hpt ? wh[s] : 0;
          const int b = s < hpt ? wl[s] : 0;
          const int c = MODE == CONJ && s < hpt ? wc[s] : 0;
          const bool sc = (a | b) != 0;
          const bool nz = MODE != CONJ ? sc
                          : part == 0  ? sc && c == 0
                          : part == 1  ? sc && c != 0
                                       : !sc && c != 0;
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
            gate &= mask_bits(mask + ((int64_t)(q0 + j) * gridDim.y
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

// list entries a block holds at once: a whole group's slots where they
// fit in LIST_MIN, else at least one query's
int list_cap(int hpt) {
  return G * hpt < LIST_MIN ? G * hpt : (hpt > LIST_MIN ? hpt : LIST_MIN);
}

template <int MODE>
int launch_group(const void* qscale, const void* nreq, const void* cols_hi,
                 const void* cols_lo, const void* wq, const void* wp,
                 const void* mask, const void* live, void* out_m,
                 void* out_r, int qc, int hpt, int nsw, void* stream) {
  if (hpt < 1 || hpt > 0xFFFF) return (int)cudaErrorInvalidValue;
  const int cap = list_cap(hpt);
  const int smem =
      cap * (int)(sizeof(int4) + (MODE == CONJ ? sizeof(int) : 0))
      + G * SW_ROWS * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_group_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  if (qc <= 0 || nsw <= 0) return 0;
  dim3 grid((qc + G - 1) / G, nsw);
  sweep_group_kernel<MODE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)qscale, (const int32_t*)nreq, (const int8_t*)cols_hi,
      (const int8_t*)cols_lo, (const int8_t*)wq, (const int8_t*)wp,
      (const int32_t*)mask, (const float*)live, (float*)out_m,
      (int32_t*)out_r, qc, hpt, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int es_sweep_rowmax(const void* qscale, const void* cols_hi,
                               const void* cols_lo, const void* wq,
                               const void* live, void* out_m, void* out_r,
                               int qc, int hpt, int nsw, void* stream) {
  return launch_group<DISJ>(qscale, nullptr, cols_hi, cols_lo, wq, nullptr,
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
  return launch_group<CONJ>(qscale, nreq, cols_hi, cols_lo, wq, wp, nullptr,
                            live, out_m, out_r, qc, hpt, nsw, stream);
}

extern "C" int es_sweep_rowmax_bitset(const void* qscale, const void* cols_hi,
                                      const void* cols_lo, const void* wq,
                                      const void* mask, const void* live,
                                      void* out_m, void* out_r, int qc,
                                      int hpt, int nsw, void* stream) {
  return launch_group<BITSET>(qscale, nullptr, cols_hi, cols_lo, wq, nullptr,
                              mask, live, out_m, out_r, qc, hpt, nsw, stream);
}
