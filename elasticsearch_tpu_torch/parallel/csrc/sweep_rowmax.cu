// K2 sweep_rowmax: score QC queries over the int8 column cache, keep each
// 128-doc row's max and, per 65536-doc superwindow, the top NCAND rows.
//
// Replaces the Pallas kernel elasticsearch_tpu/parallel/kernels.py
// sweep_rowmax (:148, pallas_call :190, body _sweep_kernel :87), which ran
// four dense int8 matmuls over every slot of the cache for every query on
// the MXU, then a 17-pass row-max cascade per superwindow.
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
// What bounds it on the H100: bytes — the nonzero slots' columns (2 bytes
// per doc per slot) and the live mask, read once; the integer work is a
// few operations per byte. A query with no nonzero slot writes its empty
// result without touching the columns.
//
// The combine is the reference's, in f32:
//   val = ((16384 * hh + 128 * (hl + lh)) + ll) * qscale
// Both products are exact (powers of two times integers below 2^24), so
// fused or not the result is the same; __fmul_rn/__fadd_rn keep it explicit.
// A doc counts only if live > 0 and val > 0; an empty row is -inf.

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

__global__ void __launch_bounds__(THREADS)
sweep_rowmax_kernel(const float* __restrict__ qscale,
                    const int8_t* __restrict__ cols_hi,
                    const int8_t* __restrict__ cols_lo,
                    const int8_t* __restrict__ wq,
                    const float* __restrict__ live,
                    float* __restrict__ out_m, int32_t* __restrict__ out_r,
                    int qc, int hpt) {
  extern __shared__ int dyn[];
  int* s_slot = dyn;                                          // [hpt]
  int* s_wh = s_slot + hpt;                                   // [hpt]
  int* s_wl = s_wh + hpt;                                     // [hpt]
  __shared__ float s_rm[SW_ROWS];
  __shared__ Cand s_warp[WARPS];
  __shared__ Cand s_win;
  __shared__ int s_nz;

  const int q = blockIdx.x;
  const int sw = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t obase = ((int64_t)sw * qc + q) * CAND_PAD;

  // gather the query's nonzero slots; their order in the list is whatever
  // the atomics give, which cannot change the exact integer sums
  if (tid == 0) s_nz = 0;
  __syncthreads();
  {
    const int8_t* wh = wq + (int64_t)q * hpt;
    const int8_t* wl = wq + (int64_t)(qc + q) * hpt;
    for (int s = tid; s < hpt; s += THREADS) {
      const int a = wh[s], b = wl[s];
      if (a != 0 || b != 0) {
        const int n = atomicAdd(&s_nz, 1);
        s_slot[n] = s;
        s_wh[n] = a;
        s_wl[n] = b;
      }
    }
  }
  __syncthreads();
  const int nz = s_nz;
  if (nz == 0) {
    // every val is 0, never > 0: all rows are empty
    if (tid < CAND_PAD) {
      out_m[obase + tid] = -INFINITY;
      out_r[obase + tid] = 0;
    }
    return;
  }
  const float qs = qscale[q];

  for (int row = warp; row < SW_ROWS; row += WARPS) {
    const int chunk = sw * (SW_ROWS / CHUNK_ROWS) + row / CHUNK_ROWS;
    const int within = (row % CHUNK_ROWS) * 128 + lane * 4;
    int hh[4] = {0, 0, 0, 0}, hl[4] = {0, 0, 0, 0};
    int lh[4] = {0, 0, 0, 0}, ll[4] = {0, 0, 0, 0};
    for (int i = 0; i < nz; ++i) {
      const int64_t off = ((int64_t)chunk * hpt + s_slot[i]) * 2048 + within;
      const char4 h = *reinterpret_cast<const char4*>(cols_hi + off);
      const char4 l = *reinterpret_cast<const char4*>(cols_lo + off);
      const int a = s_wh[i], b = s_wl[i];
      hh[0] += a * h.x; hh[1] += a * h.y; hh[2] += a * h.z; hh[3] += a * h.w;
      hl[0] += a * l.x; hl[1] += a * l.y; hl[2] += a * l.z; hl[3] += a * l.w;
      lh[0] += b * h.x; lh[1] += b * h.y; lh[2] += b * h.z; lh[3] += b * h.w;
      ll[0] += b * l.x; ll[1] += b * l.y; ll[2] += b * l.z; ll[3] += b * l.w;
    }
    const int64_t doc0 = ((int64_t)sw * SW_ROWS + row) * 128 + lane * 4;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float val = __fadd_rn(__fmul_rn(16384.f, (float)hh[j]),
                            __fmul_rn(128.f, (float)(hl[j] + lh[j])));
      val = __fmul_rn(__fadd_rn(val, (float)ll[j]), qs);
      if (val > 0.f && live[doc0 + j] > 0.f) m = fmaxf(m, val);
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

}  // namespace

extern "C" int es_sweep_rowmax(const void* qscale, const void* cols_hi,
                               const void* cols_lo, const void* wq,
                               const void* live, void* out_m, void* out_r,
                               int qc, int hpt, int nsw, void* stream) {
  const int smem = 3 * hpt * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_rowmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem > 48 * 1024 ? smem : 48 * 1024);
  if (err != cudaSuccess) return (int)err;
  if (qc <= 0 || nsw <= 0) return 0;
  dim3 grid(qc, nsw);
  sweep_rowmax_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)qscale, (const int8_t*)cols_hi, (const int8_t*)cols_lo,
      (const int8_t*)wq, (const float*)live, (float*)out_m, (int32_t*)out_r,
      qc, hpt);
  return (int)cudaGetLastError();
}
