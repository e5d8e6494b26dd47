// K8 agg_counts: masked segment counts for the device analytics tier,
// counts[q, s] = #{pairs (d, s) of a layout section : mask[q, d]}.
//
// Replaces _agg_counts of elasticsearch_tpu/parallel/kernels.py (:996,
// pallas_call :1007), behind agg_segment_counts (:1037) and
// agg_two_level_counts (:1057). The TPU kernel scattered each 128-pair row
// into a [128, 128] f32 tile accumulator as a one-hot outer product on the
// MXU (exact below 2^24). Here the scatter is what Hopper does natively: a
// shared-memory histogram with integer atomics.
//
// Layout of a section (the layout blob, see agg_device.py): doc[p], seg[p],
// ct0[p / 1024], ct1[p / 1024] (i32). A pair in 1024-pair chunk c counts iff
// 0 <= seg < n_segments, its bucket tile seg / 16384 lies in [ct0[c], ct1[c]]
// (pad chunks carry (1, 0); pad pairs carry bucket -1), 0 <= doc < n_docs
// (layouts never hold another doc; the test only keeps a bad one from
// reading outside the mask) and mask[q, doc] != 0.
//
// Grid: (chunk group of CPB chunks, query, section). A block reads its
// chunks' tile ranges, then for each tile in their union: zeroes a
// shared-memory histogram of the tile's buckets (at most 16384 i32, 64 KB;
// n_segments of them when there are fewer), walks the chunks whose range
// holds the tile, gathers mask[q, doc] per pair and counts the selected
// pairs, and adds each nonzero bucket to the zero-filled int32 output with
// one global atomicAdd. Pairs grouped by bucket (terms layouts) touch one or
// two tiles per block; doc-ordered pairs (histogram ranks, up to 65536
// buckets) walk up to four tiles, each pass exact on its own.
//
// Hot buckets: the head Zipf term holds about a fifth of the pairs in
// contiguous chunks, so whole warps select the same bucket. Each warp
// aggregates first: __match_any_sync groups the lanes by bucket, and one
// leader adds __popc of its group.
//
// Bit-exactness: integer adds commute, so any order gives the plain
// version's counts.
//
// What bounds it on the H100: bytes — the section's pairs (8 bytes each)
// once, the masks (Q x n_docs bytes, gathered) and the output. Blocks of
// one query run together, so its mask row (10 MB at 10M docs) stays in the
// 50 MB L2 while the pairs stream past; a section's pairs are read once
// per query and per tile of its blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GRAN = 1024;            // pairs per chunk
constexpr int TILE = 16384;           // buckets per tile
constexpr int CPB = 8;                // chunks per block
constexpr int THREADS = 256;          // GRAN / THREADS steps per chunk

struct Section {
  const int32_t* doc;                 // [p]
  const int32_t* seg;                 // [p]
  const int32_t* ct0;                 // [nc]
  const int32_t* ct1;                 // [nc]
  int32_t* out;                       // [Q, n_segments], zero-filled
  int nc;                             // chunks
};

__global__ void __launch_bounds__(THREADS)
agg_counts_kernel(const uint8_t* __restrict__ mask, int64_t n_docs,
                  Section s0, Section s1, int n_segments, int n_tiles) {
  extern __shared__ int32_t hist[];   // [min(n_segments, TILE)]
  __shared__ int32_t t0[CPB], t1[CPB];
  __shared__ int tlo, thi;
  const Section sec = blockIdx.z ? s1 : s0;
  const int c0 = blockIdx.x * CPB;
  if (c0 >= sec.nc) return;           // the shorter section's spare blocks
  const int nch = min(CPB, sec.nc - c0);
  const int64_t q = blockIdx.y;
  const uint8_t* mrow = mask + q * n_docs;

  if (threadIdx.x < CPB) {
    const int j = threadIdx.x;
    t0[j] = j < nch ? sec.ct0[c0 + j] : 1;
    t1[j] = j < nch ? sec.ct1[c0 + j] : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = n_tiles, hi = -1;
    for (int j = 0; j < nch; ++j) {
      const int a = max(t0[j], 0), b = min(t1[j], n_tiles - 1);
      if (a <= b) {
        lo = min(lo, a);
        hi = max(hi, b);
      }
    }
    tlo = lo;
    thi = hi;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;

  for (int t = tlo; t <= thi; ++t) {
    const int base = t * TILE;
    const int len = min(TILE, n_segments - base);   // > 0: t < n_tiles
    for (int i = threadIdx.x; i < len; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int j = 0; j < nch; ++j) {
      if (t < t0[j] || t > t1[j]) continue;          // uniform in the block
      const int64_t off = (int64_t)(c0 + j) * GRAN;
      for (int i = threadIdx.x; i < GRAN; i += THREADS) {
        const int d = sec.doc[off + i];
        const int rel = sec.seg[off + i] - base;
        bool ok = rel >= 0 && rel < len && d >= 0 && (int64_t)d < n_docs;
        if (ok) ok = mrow[d] != 0;
        // every lane of the warp reaches this ballot (GRAN % THREADS == 0)
        const unsigned sel = __ballot_sync(0xffffffffu, ok);
        if (ok) {
          const unsigned peers = __match_any_sync(sel, rel);
          if (lane == __ffs(peers) - 1) atomicAdd(&hist[rel], __popc(peers));
        }
      }
    }
    __syncthreads();
    int32_t* orow = sec.out + q * (int64_t)n_segments + base;
    for (int i = threadIdx.x; i < len; i += THREADS) {
      const int v = hist[i];
      if (v) atomicAdd(&orow[i], v);
    }
    __syncthreads();
  }
}

Section make_section(const int32_t* blob, long long off, int p, void* out) {
  Section s;
  const int nc = p / GRAN;
  s.doc = blob + off;
  s.seg = s.doc + p;
  s.ct0 = s.seg + p;
  s.ct1 = s.ct0 + nc;
  s.out = (int32_t*)out;
  s.nc = nc;
  return s;
}

}  // namespace

// One launch over n_sections (1 or 2) sections of a layout blob; section k
// starts at blob + off_k, holds p_k pairs (a multiple of 1024) and writes
// out_k [q, n_segments] i32, which the caller zero-fills.
extern "C" int es_agg_counts(const void* mask, long long n_docs, int q,
                             const void* blob, long long off0, int p0,
                             void* out0, long long off1, int p1, void* out1,
                             int n_sections, int n_segments, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      agg_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TILE * (int)sizeof(int32_t));
  if (err != cudaSuccess) return (int)err;
  if (q <= 0 || n_segments <= 0 || n_docs <= 0 || n_sections < 1 ||
      n_sections > 2)
    return 0;
  const int32_t* b = (const int32_t*)blob;
  const Section s0 = make_section(b, off0, p0, out0);
  const Section s1 = n_sections > 1 ? make_section(b, off1, p1, out1) : s0;
  const int nc = max(s0.nc, n_sections > 1 ? s1.nc : 0);
  const int n_tiles = (n_segments + TILE - 1) / TILE;
  const int smem = min(n_segments, TILE) * (int)sizeof(int32_t);
  const dim3 grid((nc + CPB - 1) / CPB, q, n_sections);
  agg_counts_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)mask, (int64_t)n_docs, s0, s1, n_segments, n_tiles);
  return (int)cudaGetLastError();
}
