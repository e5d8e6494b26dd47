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
// term's last row) hold doc 0 with tf 0 and write nothing. The reference
// scatter-adds every lane into zeros, and 0.0 + s == s, so zero-filling the
// output and storing each live lane's score gives its bits. Presence mode
// marks a doc whose lane has tf > 0 in any selected block (any order, so
// blocks of several terms may share docs).
//
// Arithmetic: the order XLA on the CPU compiles the reference in, which
// contracts tf + k1 * (1 - b + b * dl / avgdl) into one fused multiply-add:
//   t = (1 - b) + (b * dl) / avgdl;  denom = fmaf(k1, t, tf);
//   score = ((idf * tf) * (k1 + 1)) / denom
// with the constants rounded to f32 by the wrapper, each step explicit
// (__fmul_rn, __fdiv_rn, __fadd_rn, __fmaf_rn) so nvcc neither contracts
// nor reorders.
//
// Design: the C entry zero-fills the output (cudaMemsetAsync), then one
// thread per lane, 256 threads = two block rows per CUDA block; a thread
// skips a lane with tf <= 0, a row id outside [0, T) or a doc outside
// [0, n_docs). The gathered rows are read once, coalesced (a warp reads 128
// contiguous bytes of docs and of tfs); doc_len and the output are touched
// at the live lanes' docs, a scattered 4-byte access each.
//
// What bounds it on the H100: bytes. The zero fill of the [n_docs] output
// and the 1 KB of docs + tfs per selected row; a few float operations per
// lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 128;

template <bool BM25>
__global__ void __launch_bounds__(THREADS)
block_scatter_kernel(const int* __restrict__ ids,
                     const float* __restrict__ idf,
                     const int* __restrict__ docs,
                     const float* __restrict__ tfs,
                     const float* __restrict__ doc_len,
                     int64_t n_lanes, int64_t t_rows, int n_docs,
                     float avgdl, float k1, float b, float omb, float k1p1,
                     void* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n_lanes) return;
  const int64_t i = g / LANES;
  const int row = __ldg(ids + i);
  if (row < 0 || (int64_t)row >= t_rows) return;
  const int64_t off = (int64_t)row * LANES + (g % LANES);
  const float tf = __ldg(tfs + off);
  if (!(tf > 0.0f)) return;
  const int d = __ldg(docs + off);
  if (d < 0 || d >= n_docs) return;
  if (BM25) {
    const float dl = __ldg(doc_len + d);
    const float t = __fadd_rn(omb, __fdiv_rn(__fmul_rn(b, dl), avgdl));
    const float denom = __fmaf_rn(k1, t, tf);
    const float num = __fmul_rn(__fmul_rn(__ldg(idf + i), tf), k1p1);
    static_cast<float*>(out)[d] = __fdiv_rn(num, denom);
  } else {
    static_cast<uint8_t*>(out)[d] = 1;
  }
}

template <bool BM25>
int launch(const void* ids, const void* idf, const void* docs,
           const void* tfs, const void* doc_len, int n_blocks,
           int64_t t_rows, int n_docs, float avgdl, float k1, float b,
           float omb, float k1p1, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_docs <= 0) return 0;
  cudaError_t e = cudaMemsetAsync(
      out, 0, (size_t)n_docs * (BM25 ? sizeof(float) : 1), s);
  if (e != cudaSuccess) return (int)e;
  if (n_blocks > 0) {
    const int64_t n_lanes = (int64_t)n_blocks * LANES;
    const int64_t grid = (n_lanes + THREADS - 1) / THREADS;
    block_scatter_kernel<BM25><<<(unsigned)grid, THREADS, 0, s>>>(
        (const int*)ids, (const float*)idf, (const int*)docs,
        (const float*)tfs, (const float*)doc_len, n_lanes, t_rows, n_docs,
        avgdl, k1, b, omb, k1p1, out);
  }
  return (int)cudaGetLastError();
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
  return launch<true>(ids, idf, docs, tfs, doc_len, n_blocks, t_rows,
                      n_docs, avgdl, k1, b, omb, k1p1, out, stream);
}

// The same gather -> out [n_docs] bool (one byte a doc).
extern "C" int es_block_presence(const void* ids, const void* docs,
                                 const void* tfs, int n_blocks,
                                 long long t_rows, int n_docs, void* out,
                                 void* stream) {
  return launch<false>(ids, nullptr, docs, tfs, nullptr, n_blocks, t_rows,
                       n_docs, 0.f, 0.f, 0.f, 0.f, 0.f, out, stream);
}
