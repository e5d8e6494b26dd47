// block_scatter: selected postings blocks scored (BM25) or marked (presence)
// into a dense per-doc vector.
//
// Replaces the XLA programs elasticsearch_tpu/ops/scoring.py
// bm25_scatter_scores (:56) and constant_scatter_mask (:83), the dense
// executor's hot loop (the reference's replacement for Lucene's postings
// loop): gather the selected [B, 128] rows of a field's block arrays, score
// each lane, scatter into an [n_docs] vector.
//
// Contract (the executor's, search/executor.py): in bm25 mode the blocks
// are one term's, whose postings hold each doc once, so every lane with
// tf > 0 writes a distinct doc; pad lanes (block row 0 and the tail of a
// term's last row) hold doc 0 with tf 0 and write nothing. The rows may
// come in any order; lanes with tf <= 0, rows outside [0, T) and docs
// outside [0, n_docs) write nothing. The reference scatter-adds every lane
// into zeros, and 0.0 + s == s, so zero-filling the output and storing each
// live lane's score gives its bits. Presence mode marks a doc whose lane
// has tf > 0 in any selected block (any order, so blocks of several terms
// may share docs; every writer stores the same byte).
//
// Arithmetic: the order XLA on the CPU compiles the reference in, which
// contracts tf + k1 * (1 - b + b * dl / avgdl) into one fused multiply-add:
//   t = (1 - b) + (b * dl) / avgdl;  denom = fmaf(k1, t, tf);
//   score = ((idf * tf) * (k1 + 1)) / denom
// with the constants rounded to f32 by the wrapper, each step explicit
// (__fmul_rn, __fdiv_rn, __fadd_rn, __fmaf_rn) so nvcc neither contracts
// nor reorders.
//
// What bounds it on the H100: bytes. Each distinct selected row's 1 KB
// of docs + tfs (a pad row repeated comes from L2), per live lane a
// 4-byte doc_len gather (bm25) and a 4-byte (1-byte) store, and the
// [n_docs] output zero-filled once; a dozen float operations a lane. A
// head term of 7.1M docs in 8M (55,568 distinct rows) moves about 118 MB,
// 0.035 ms at 3.35 TB/s. The first kernel (one thread a lane, a CTA per
// two rows, every thread its own chain ids -> row -> doc_len -> store)
// took 2.5 times that on an H100 80GB HBM3 (700 W). The memory system
// charges here for the 128-byte lines a warp instruction touches more
// than for bytes in flight: a thread that takes 4 neighbouring lanes
// (16-byte loads of docs and tfs) spreads each gather and store of its
// warp over 4 times the lines that 32 neighbouring lanes touch, and ran
// slower than the first kernel; how many rows a warp holds (1 to 8) moved
// the time by a few per cent at most.
//
// Design: a persistent grid, planned here from the card's occupancy. A
// thread takes J lanes of a row, lanes lane + 32 * j apart, so every
// load, gather and store of a warp is 32 neighbouring lanes, and the
// 4 / J warps of a slot share the row. Where the card holds 4 warps for
// every row at once, J is 1: a mid or rare term's few rows get a thread a
// lane, as the first kernel gave them. Past that J is 4, a warp a row,
// each warp ROWS ids a step, and the grid, at most what the card holds,
// walks the steps. A warp starts all its rows' loads before it uses one.
// The rows are read once, with evict-first loads, which leaves L2 to
// doc_len and the output. In bm25 mode each thread starts the doc_len
// gathers of all its live lanes before any arithmetic (a head term's
// docs ascend within a row, so a warp's gathers fall on one or two
// lines). ROWS, the lane layout, the occupancy and the cache hints were
// chosen by timing edits of this source on such a head term (PERF.md);
// loading each step's ids a step ahead measured no faster and was left
// out.
//
// The C entry zero-fills the output first (cudaMemsetAsync). A design that
// writes each output byte once (each row the whole doc span up to the
// next row's first doc) would save that pass and the partial-sector
// rewrites of the scatter, but holds only for ascending, doc-disjoint
// rows, which the contract does not promise. Pad rows (row 0) are read
// like any row: the plain version would score a row 0 with tf > 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;           // a CTA's warps
constexpr int LANES = 128;
constexpr int ROWS = 2;                       // rows a warp has in flight
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Bm25 {
  float avgdl, k1, b, omb, k1p1;
};

struct Args {
  const int* ids;
  const float* idf;
  const int* docs;
  const float* tfs;
  const float* doc_len;
  int64_t n_blocks, t_rows;
  int n_docs;
  Bm25 c;
  void* out;
};

// Lanes 0..ROWS-1 of each warp of slot `slot` (of n_slots in the grid) hold
// the row id (and idf) of block_ids position step * n_slots * ROWS + lane
// * n_slots + slot; -1 (no row) past the end.
template <bool BM25>
__device__ __forceinline__ void load_ids(const Args& a, int64_t step,
                                         int64_t n_slots, int64_t slot,
                                         int lane, int& id, float& w) {
  id = -1;
  w = 0.f;
  const int64_t p = (step * ROWS + lane) * n_slots + slot;
  if (lane < ROWS && p < a.n_blocks) {
    id = __ldg(a.ids + p);
    if (BM25) w = __ldg(a.idf + p);
  }
}

// J lanes of a row a thread; a slot of 4 / J warps a row.
template <bool BM25, int J>
__global__ void __launch_bounds__(THREADS) block_scatter_rows(const Args a) {
  constexpr int SUB = 4 / J;                  // warps a slot
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int64_t n_slots = (int64_t)gridDim.x * (WARPS / SUB);
  const int64_t slot = gw / SUB;
  const int first = (int)(gw % SUB) * 32 * J + lane;  // the thread's lane 0
  for (int64_t step = 0; step * n_slots * ROWS < a.n_blocks; ++step) {
    int id;
    float w;
    load_ids<BM25>(a, step, n_slots, slot, lane, id, w);
    int dd[ROWS][J];
    float tt[ROWS][J];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = __shfl_sync(FULL, id, r);
#pragma unroll
      for (int j = 0; j < J; ++j) dd[r][j] = 0, tt[r][j] = 0.f;
      if (row >= 0 && (int64_t)row < a.t_rows) {
        const int64_t base = (int64_t)row * LANES + first;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          dd[r][j] = __ldcs(a.docs + base + 32 * j);   // read once: evict
          tt[r][j] = __ldcs(a.tfs + base + 32 * j);    // first from L2
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (!(tt[r][j] > 0.0f) || dd[r][j] < 0 || dd[r][j] >= a.n_docs)
          dd[r][j] = -1;                      // writes nothing
    if (BM25) {
      const Bm25& c = a.c;
      float dl[ROWS][J];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < J; ++j)
          dl[r][j] = dd[r][j] >= 0 ? __ldg(a.doc_len + dd[r][j]) : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float wr = __shfl_sync(FULL, w, r);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (dd[r][j] < 0) continue;
          const float tf = tt[r][j];
          const float tn =
              __fadd_rn(c.omb, __fdiv_rn(__fmul_rn(c.b, dl[r][j]), c.avgdl));
          const float denom = __fmaf_rn(c.k1, tn, tf);
          const float num = __fmul_rn(__fmul_rn(wr, tf), c.k1p1);
          static_cast<float*>(a.out)[dd[r][j]] = __fdiv_rn(num, denom);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (dd[r][j] >= 0) static_cast<uint8_t*>(a.out)[dd[r][j]] = 1;
    }
  }
}

// SMs and CTAs an SM holds of each instantiation, asked once per device.
struct DeviceState {
  int sms = 0;
  int per_sm[2][2] = {};                      // [bm25][J == 4]
};
std::mutex mu;
DeviceState devices[MAX_DEVICES];

// CTAs of block_scatter_rows<BM25, J> the current device holds at once.
template <bool BM25, int J>
cudaError_t resident(int* ctas) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceState& d = devices[dev];
  if (d.sms == 0) {
    e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int& per_sm = d.per_sm[BM25][J == 4];
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, block_scatter_rows<BM25, J>, THREADS, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  *ctas = d.sms * per_sm;
  return cudaSuccess;
}

// Launches block_scatter_rows<BM25, J> when the card holds its warps for
// every row at once, or J is 4 (whose grid strides); *done says whether it
// launched.
template <bool BM25, int J>
cudaError_t launch_rows(const Args& a, cudaStream_t s, bool* done) {
  int ctas = 0;
  const cudaError_t e = resident<BM25, J>(&ctas);
  if (e != cudaSuccess) return e;
  const int64_t want = (a.n_blocks * (4 / J) + WARPS - 1) / WARPS;
  if (J < 4 && want > ctas) return cudaSuccess;
  block_scatter_rows<BM25, J>
      <<<(unsigned)std::min<int64_t>(want, ctas), THREADS, 0, s>>>(a);
  *done = true;
  return cudaGetLastError();
}

template <bool BM25>
int launch(const Args& a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a.n_docs <= 0) return 0;
  cudaError_t e = cudaMemsetAsync(
      a.out, 0, (size_t)a.n_docs * (BM25 ? sizeof(float) : 1), s);
  if (e != cudaSuccess || a.n_blocks <= 0) return (int)e;
  bool done = false;
  e = launch_rows<BM25, 1>(a, s, &done);
  if (e == cudaSuccess && !done) e = launch_rows<BM25, 4>(a, s, &done);
  return (int)e;
}

}  // namespace

// ids [n_blocks] i32, idf [n_blocks] f32, docs / tfs [t_rows, 128] i32 /
// f32, doc_len [n_docs] f32 -> out [n_docs] f32. k1, b, omb = 1 - b and
// k1p1 = k1 + 1 arrive rounded to f32 as the reference's constants are.
extern "C" int es_bm25_block_scatter(const void* ids, const void* idf,
                                     const void* docs, const void* tfs,
                                     const void* doc_len, int n_blocks,
                                     long long t_rows, int n_docs,
                                     float avgdl, float k1, float b,
                                     float omb, float k1p1, void* out,
                                     void* stream) {
  return launch<true>(
      Args{(const int*)ids, (const float*)idf, (const int*)docs,
           (const float*)tfs, (const float*)doc_len, n_blocks, t_rows,
           n_docs, Bm25{avgdl, k1, b, omb, k1p1}, out},
      stream);
}

// The same gather -> out [n_docs] bool (one byte a doc).
extern "C" int es_block_presence(const void* ids, const void* docs,
                                 const void* tfs, int n_blocks,
                                 long long t_rows, int n_docs, void* out,
                                 void* stream) {
  return launch<false>(
      Args{(const int*)ids, nullptr, (const int*)docs, (const float*)tfs,
           nullptr, n_blocks, t_rows, n_docs, Bm25{0.f, 0.f, 0.f, 0.f, 0.f},
           out},
      stream);
}
