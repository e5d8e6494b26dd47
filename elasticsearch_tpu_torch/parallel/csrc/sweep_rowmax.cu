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
// for coverage), then a 17-pass row-max cascade per superwindow. The three
// are one template here, K6 and K7 being K2 with a gate in front.
//
// Design. The four products hh, hl, lh, ll are exact integer sums, so any
// order of evaluation gives the same int32s; a query's zero-weight slots add
// nothing. One block per (query, superwindow) therefore walks only that
// query's nonzero slots — a 2-term query reads 2 columns, not all Hp + 1 —
// and is bitwise the dense kernel. A warp owns one 128-doc row at a time
// (4 docs a thread, one 32-bit load per slot and layer, coalesced), reduces
// the row max with shuffles into shared memory, and the block then selects
// the top NCAND rows by (rowmax desc, row asc) in NCAND block reductions.
// Blocks of one superwindow are adjacent in launch order, so queries that
// share a hot column read it from L2.
//
// K7 (CONJ) also walks the slots where its coverage weight wp is nonzero
// (filters and must_nots carry no score weight) and sums
// cov = sum wp * ((hi != 0) | (lo != 0)) per doc, exact like the products;
// a doc counts only if cov == nreq. K6 (BITSET) reads each row's mask bits
// first (bit row % 32 of word row sw * 16 + row / 32, one 16-byte load per
// thread); a row with no surviving bit reads no columns and is -inf, which
// is what the reference's chunk skip gives it.
//
// What bounds it on the H100: bytes — the nonzero slots' columns (2 bytes
// per doc per slot; for K6 only in rows with a surviving bit), the live
// mask and K6's mask, read once; the integer work is a few operations per
// byte. A query with no nonzero score weight writes its empty result
// without touching the columns (every val is 0, never > 0).
//
// The combine is the reference's, in f32:
//   val = ((16384 * hh + 128 * (hl + lh)) + ll) * qscale
// Both products are exact (powers of two times integers below 2^24), so
// fused or not the result is the same; __fmul_rn/__fadd_rn keep it explicit.
// A doc counts only if live > 0 and val > 0 (and the mode's gate); an empty
// row is -inf.

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

struct Cand {
  float v;
  int r;
};

// (v desc, row asc)
__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.v > b.v || (a.v == b.v && a.r < b.r);
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Cand x;
    x.v = __shfl_xor_sync(0xffffffffu, c.v, o);
    x.r = __shfl_xor_sync(0xffffffffu, c.r, o);
    if (better(x, c)) c = x;
  }
  return c;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const float* __restrict__ qscale,
             const int32_t* __restrict__ nreq,      // CONJ: [qc]
             const int8_t* __restrict__ cols_hi,
             const int8_t* __restrict__ cols_lo,
             const int8_t* __restrict__ wq,
             const int8_t* __restrict__ wp,         // CONJ: [qc, hpt]
             const int32_t* __restrict__ mask,      // BITSET: [qc, nsw*16, 128]
             const float* __restrict__ live,
             float* __restrict__ out_m, int32_t* __restrict__ out_r,
             int qc, int hpt, int nsw) {
  extern __shared__ int dyn[];
  int* s_slot = dyn;                                          // [hpt]
  int* s_wh = s_slot + hpt;                                   // [hpt]
  int* s_wl = s_wh + hpt;                                     // [hpt]
  int* s_wp = s_wl + hpt;                                     // CONJ: [hpt]
  __shared__ float s_rm[SW_ROWS];
  __shared__ Cand s_warp[WARPS];
  __shared__ Cand s_win;
  __shared__ int s_nz;
  __shared__ int s_nw;

  const int q = blockIdx.x;
  const int sw = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t obase = ((int64_t)sw * qc + q) * CAND_PAD;

  // gather the query's nonzero slots; their order in the list is whatever
  // the atomics give, which cannot change the exact integer sums
  if (tid == 0) {
    s_nz = 0;
    s_nw = 0;
  }
  __syncthreads();
  {
    const int8_t* wh = wq + (int64_t)q * hpt;
    const int8_t* wl = wq + (int64_t)(qc + q) * hpt;
    for (int s = tid; s < hpt; s += THREADS) {
      const int a = wh[s], b = wl[s];
      const int c = MODE == CONJ ? (int)wp[(int64_t)q * hpt + s] : 0;
      if (a != 0 || b != 0 || c != 0) {
        const int n = atomicAdd(&s_nz, 1);
        s_slot[n] = s;
        s_wh[n] = a;
        s_wl[n] = b;
        if (MODE == CONJ) s_wp[n] = c;
        if (a != 0 || b != 0) atomicAdd(&s_nw, 1);
      }
    }
  }
  __syncthreads();
  const int nz = s_nz;
  if (s_nw == 0) {
    // every val is 0, never > 0: all rows are empty
    if (tid < CAND_PAD) {
      out_m[obase + tid] = -INFINITY;
      out_r[obase + tid] = 0;
    }
    return;
  }
  const float qs = qscale[q];
  const int need = MODE == CONJ ? nreq[q] : 0;

  for (int row = warp; row < SW_ROWS; row += WARPS) {
    unsigned alive = 0xFu;          // one bit per doc of this thread
    if (MODE == BITSET) {
      const int g = sw * SW_WORD_ROWS + (row >> 5);
      const int4 w = *reinterpret_cast<const int4*>(
          mask + ((int64_t)q * nsw * SW_WORD_ROWS + g) * 128 + lane * 4);
      const int bit = row & 31;
      alive = ((unsigned)(w.x >> bit) & 1u)
              | (((unsigned)(w.y >> bit) & 1u) << 1)
              | (((unsigned)(w.z >> bit) & 1u) << 2)
              | (((unsigned)(w.w >> bit) & 1u) << 3);
      if (!__any_sync(0xffffffffu, alive != 0u)) {
        if (lane == 0) s_rm[row] = -INFINITY;
        continue;
      }
    }
    const int chunk = sw * (SW_ROWS / CHUNK_ROWS) + row / CHUNK_ROWS;
    const int within = (row % CHUNK_ROWS) * 128 + lane * 4;
    int hh[4] = {0, 0, 0, 0}, hl[4] = {0, 0, 0, 0};
    int lh[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0};
    int cov[4] = {0, 0, 0, 0};
    for (int i = 0; i < nz; ++i) {
      const int64_t off = ((int64_t)chunk * hpt + s_slot[i]) * 2048 + within;
      const char4 h = *reinterpret_cast<const char4*>(cols_hi + off);
      const char4 l = *reinterpret_cast<const char4*>(cols_lo + off);
      const int a = s_wh[i], b = s_wl[i];
      hh[0] += a * h.x; hh[1] += a * h.y; hh[2] += a * h.z; hh[3] += a * h.w;
      hl[0] += a * l.x; hl[1] += a * l.y; hl[2] += a * l.z; hl[3] += a * l.w;
      lh[0] += b * h.x; lh[1] += b * h.y; lh[2] += b * h.z; lh[3] += b * h.w;
      ll[0] += b * l.x; ll[1] += b * l.y; ll[2] += b * l.z; ll[3] += b * l.w;
      if (MODE == CONJ) {
        const int c = s_wp[i];
        cov[0] += c * (int)((h.x != 0) | (l.x != 0));
        cov[1] += c * (int)((h.y != 0) | (l.y != 0));
        cov[2] += c * (int)((h.z != 0) | (l.z != 0));
        cov[3] += c * (int)((h.w != 0) | (l.w != 0));
      }
    }
    const int64_t doc0 = ((int64_t)sw * SW_ROWS + row) * 128 + lane * 4;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float val = __fadd_rn(__fmul_rn(16384.f, (float)hh[j]),
                            __fmul_rn(128.f, (float)(hl[j] + lh[j])));
      val = __fmul_rn(__fadd_rn(val, (float)ll[j]), qs);
      bool ok = val > 0.f && live[doc0 + j] > 0.f;
      if (MODE == CONJ) ok = ok && cov[j] == need;
      if (MODE == BITSET) ok = ok && ((alive >> j) & 1u);
      if (ok) m = fmaxf(m, val);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (lane == 0) s_rm[row] = m;
  }
  __syncthreads();

  // top NCAND rows by (rowmax desc, row asc); one row per thread
  for (int p = 0; p < NCAND; ++p) {
    Cand c = {s_rm[tid], tid};
    c = warp_best(c);
    if (lane == 0) s_warp[warp] = c;
    __syncthreads();
    if (warp == 0) {
      Cand w = lane < WARPS ? s_warp[lane] : Cand{-INFINITY, SW_ROWS};
      w = warp_best(w);
      if (lane == 0) s_win = w;
    }
    __syncthreads();
    const Cand w = s_win;
    if (tid == 0) {
      const bool keep = w.v > -INFINITY;
      out_m[obase + p] = keep ? w.v : -INFINITY;
      out_r[obase + p] = keep ? w.r + sw * SW_ROWS : 0;
    }
    if (tid == w.r) s_rm[tid] = -INFINITY;
    __syncthreads();
  }
  if (tid >= NCAND && tid < CAND_PAD) {
    out_m[obase + tid] = -INFINITY;
    out_r[obase + tid] = 0;
  }
}

template <int MODE>
int launch(const void* qscale, const void* nreq, const void* cols_hi,
           const void* cols_lo, const void* wq, const void* wp,
           const void* mask, const void* live, void* out_m, void* out_r,
           int qc, int hpt, int nsw, void* stream) {
  const int smem = (MODE == CONJ ? 4 : 3) * hpt * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem > 48 * 1024 ? smem : 48 * 1024);
  if (err != cudaSuccess) return (int)err;
  if (qc <= 0 || nsw <= 0) return 0;
  dim3 grid(qc, nsw);
  sweep_kernel<MODE><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)qscale, (const int32_t*)nreq, (const int8_t*)cols_hi,
      (const int8_t*)cols_lo, (const int8_t*)wq, (const int8_t*)wp,
      (const int32_t*)mask, (const float*)live, (float*)out_m,
      (int32_t*)out_r, qc, hpt, nsw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int es_sweep_rowmax(const void* qscale, const void* cols_hi,
                               const void* cols_lo, const void* wq,
                               const void* live, void* out_m, void* out_r,
                               int qc, int hpt, int nsw, void* stream) {
  return launch<DISJ>(qscale, nullptr, cols_hi, cols_lo, wq, nullptr,
                      nullptr, live, out_m, out_r, qc, hpt, nsw, stream);
}

extern "C" int es_sweep_rowmax_conj(const void* qscale, const void* nreq,
                                    const void* cols_hi, const void* cols_lo,
                                    const void* wq, const void* wp,
                                    const void* live, void* out_m,
                                    void* out_r, int qc, int hpt, int nsw,
                                    void* stream) {
  return launch<CONJ>(qscale, nreq, cols_hi, cols_lo, wq, wp, nullptr, live,
                      out_m, out_r, qc, hpt, nsw, stream);
}

extern "C" int es_sweep_rowmax_bitset(const void* qscale, const void* cols_hi,
                                      const void* cols_lo, const void* wq,
                                      const void* mask, const void* live,
                                      void* out_m, void* out_r, int qc,
                                      int hpt, int nsw, void* stream) {
  return launch<BITSET>(qscale, nullptr, cols_hi, cols_lo, wq, nullptr, mask,
                        live, out_m, out_r, qc, hpt, nsw, stream);
}
