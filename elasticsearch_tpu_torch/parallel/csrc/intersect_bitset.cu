// K5 intersect_bitset: per (query, superwindow), AND up to 8 clause blocks
// of the packed presence bitsets and AND-NOT up to 4, and count each
// query's 2048-doc chunks with a surviving bit in the same pass.
//
// Replaces the Pallas kernel elasticsearch_tpu/parallel/kernels.py
// intersect_bitset (:398, pallas_call :432, body _intersect_kernel :382),
// which gathered the 12 clause blocks through scalar-prefetch-indexed
// BlockSpecs (grid (QC, nsw)) and combined them on the VPU, and the XLA
// program mask_chunk_counts (:445), which read the whole mask again.
//
// Layout. bits [n_slots, rows, 128] int32 (uint32 bit patterns): a
// superwindow's block of one slot is 16 word rows x 128 lanes = 8 KB,
// contiguous. Slot n_slots - 2 is all zeros (the AND-NOT identity and the
// empty mask) and slot n_slots - 1 all ones (the AND identity), as
// pack_presence_bits makes them. Output mask [qc, nsw * 16, 128] and
// counts [qc] int32; word row g holds chunks 2g (low 16 bits) and 2g + 1
// (high 16 bits).
//
// Design. One block of 256 threads per (query, superwindow), the queries
// of a superwindow consecutive in the grid, so its hot clause blocks are
// read from L2 by the queries that share them (measured slower at config
// 2's shapes: a block per superwindow and 2-16 queries, 64 or 128
// threads, 2-8 superwindows a block). Every thread
// reduces the query's 12 slots to the slots to read, in registers: a
// repeated slot is read once, the ones sentinel in the AND list and the
// zeros sentinel in the AND-NOT list are identities and are not read, and
// the zeros sentinel in the AND list (an inactive row) or the ones
// sentinel in the AND-NOT list makes the whole block zero without a read.
// Thread t owns the block's 16-byte words t + 256v, v < 2 (word row
// t / 32 + 8v, so a warp holds whole word rows): its clause loads are
// independent and in flight together, and the mask is written with
// streaming stores (st.global.cs), so the 258 MB of mask at QC 256 do not
// evict the clause blocks from L2. The counts: a warp's two ballots over
// (w & 0xFFFF) != 0 and (w >> 16) != 0 are the flags of chunks 2g and
// 2g + 1 of its word row; __syncthreads_count sums the warps' flags and
// one atomicAdd adds the block's total to counts[q] (exact and
// order-free). The C entry zeroes counts before the launch.
//
// The slots come from the host: the C entry copies up to TABLE_Q = 256
// queries' slots into the launch's parameters (a 12 KB __grid_constant__
// table, Hopper's counterpart of the reference's scalar prefetch), so no
// copy to the card and no wait precede the launch; the wrapper launches
// once per 256 queries.
//
// The fused bitset sweep (F3: the reference's _fused_sweep_bitset,
// elasticsearch_tpu/parallel/turbo.py:2148, which ran intersect_bitset and
// mask_chunk_counts once per partition under one shard_map) takes the same
// block with the partition as a third grid axis: grid (qc, nsw_max, S),
// each partition's bitsets, superwindows, word rows and slot count from a
// table in the launch's parameters (BitsTable, up to MAX_PARTS), the slots
// of every partition's queries from device memory (q_slots [S, qc, 8],
// q_neg [S, qc, 4]: S * 256 queries do not fit the parameters), the mask
// [S, qc, nsw_max * 16, 128] and counts [S, qc] stacked. A block past its
// partition's nsw writes nothing and counts nothing: the gated sweep
// skips those superwindows too (the reference's padding bits are zero,
// so its mask there is zero and adds no chunk).
//
// What bounds it on the H100: bytes — each distinct clause block read once
// (queries sharing a hot clause read it from L2) and the mask written once;
// the work is one AND per 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int SW_WORD_ROWS = 16;
constexpr int VEC_PER_ROW = 128 / 4;                    // int4 per word row
constexpr int VEC_PER_BLOCK = SW_WORD_ROWS * VEC_PER_ROW;   // 512
constexpr int CLAUSES = 8;
constexpr int NEGS = 4;
constexpr int THREADS = 256;
constexpr int VPT = VEC_PER_BLOCK / THREADS;            // int4 a thread
static_assert(2 * VPT <= 32, "a warp's flags must fit its lanes");
constexpr int TABLE_Q = 256;                            // queries a table
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_PARTS = 64;                           // partitions a launch

// one partition's bitsets, as pack_presence_bits made them
struct BitsPart {
  const int4* bits;
  int nsw;
  int rows;
  int n_slots;
};

struct BitsTable {                                      // 1.5 KB
  BitsPart p[MAX_PARTS];
};

struct SlotTable {                                      // 12 KB
  int32_t slots[TABLE_Q * CLAUSES];
  int32_t neg[TABLE_Q * NEGS];
};

__device__ __forceinline__ void and_in(int4& a, const int4 b) {
  a.x &= b.x; a.y &= b.y; a.z &= b.z; a.w &= b.w;
}

__device__ __forceinline__ void and_not_in(int4& a, const int4 b) {
  a.x &= ~b.x; a.y &= ~b.y; a.z &= ~b.z; a.w &= ~b.w;
}

// one (query, superwindow) block: qs / qn the query's 8 and 4 slots,
// dst the query's mask [nsw_out * 16, 128], count its chunk count
__device__ __forceinline__ void intersect_block(
    const int32_t* qs, const int32_t* qn, const int4* __restrict__ bits,
    int4* __restrict__ dst, int32_t* __restrict__ count, int sw, int rows,
    int n_slots) {
  const int64_t off = (int64_t)sw * VEC_PER_BLOCK + threadIdx.x;
  const int64_t slot_stride = (int64_t)rows * VEC_PER_ROW;
  const int zero_s = n_slots - 2, ones_s = n_slots - 1;
  int pos[CLAUSES], neg[NEGS];          // -1: not read
  bool empty = false;
#pragma unroll
  for (int c = 0; c < CLAUSES; ++c) {
    const int s = qs[c];
    bool skip = s == ones_s || s == zero_s;
    empty |= s == zero_s;
#pragma unroll
    for (int j = 0; j < c; ++j) skip |= pos[j] == s;
    pos[c] = skip ? -1 : s;
  }
#pragma unroll
  for (int n = 0; n < NEGS; ++n) {
    const int s = qn[n];
    bool skip = s == zero_s || s == ones_s;
    empty |= s == ones_s;
#pragma unroll
    for (int j = 0; j < n; ++j) skip |= neg[j] == s;
    neg[n] = skip ? -1 : s;
  }
  const int4* src = bits + off;
  int4 acc[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    acc[v] = empty ? make_int4(0, 0, 0, 0) : make_int4(-1, -1, -1, -1);
  }
  if (!empty) {
#pragma unroll
    for (int j = 0; j < CLAUSES; ++j) {
      if (pos[j] >= 0) {
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          and_in(acc[v], __ldg(src + pos[j] * slot_stride + v * THREADS));
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NEGS; ++n) {
      if (neg[n] >= 0) {
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          and_not_in(acc[v], __ldg(src + neg[n] * slot_stride + v * THREADS));
        }
      }
    }
  }
  int flags = 0;                        // this warp's chunks with a bit
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    __stcs(dst + off + v * THREADS, acc[v]);
    const uint32_t w = (uint32_t)(acc[v].x | acc[v].y | acc[v].z | acc[v].w);
    flags += (__ballot_sync(FULL, (w & 0xFFFFu) != 0u) != 0u)
             + (__ballot_sync(FULL, (w >> 16) != 0u) != 0u);
  }
  // flags <= 2 * VPT <= 32: lanes below it each count one
  const int total = __syncthreads_count((int)(threadIdx.x & 31) < flags);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

__global__ void __launch_bounds__(THREADS)
intersect_counts_kernel(const __grid_constant__ SlotTable tab,
                        const int4* __restrict__ bits,
                        int4* __restrict__ out, int32_t* __restrict__ counts,
                        int nsw, int rows, int n_slots) {
  const int q = blockIdx.x;
  intersect_block(tab.slots + q * CLAUSES, tab.neg + q * NEGS, bits,
                  out + (int64_t)q * nsw * VEC_PER_BLOCK, counts + q,
                  blockIdx.y, rows, n_slots);
}

// F3's first stage: grid (qc, nsw_max, S)
__global__ void __launch_bounds__(THREADS)
fused_intersect_counts_kernel(const __grid_constant__ BitsTable parts,
                              const int32_t* __restrict__ q_slots,
                              const int32_t* __restrict__ q_neg,
                              int4* __restrict__ out,
                              int32_t* __restrict__ counts, int qc) {
  const int q = blockIdx.x, sw = blockIdx.y, z = blockIdx.z;
  const int nsw_max = gridDim.y;
  const BitsPart& pt = parts.p[z];
  if (sw >= pt.nsw) return;             // uniform over the block
  const int64_t zq = (int64_t)z * qc + q;
  intersect_block(q_slots + zq * CLAUSES, q_neg + zq * NEGS, pt.bits,
                  out + zq * nsw_max * VEC_PER_BLOCK, counts + zq, sw,
                  pt.rows, pt.n_slots);
}

}  // namespace

// q_slots [qc, 8], q_neg [qc, 4] int32 on the host, qc <= TABLE_Q: they
// ride in the launch's parameters.
extern "C" int es_intersect_bitset(const void* q_slots, const void* q_neg,
                                   const void* bits, void* out, void* counts,
                                   int qc, int nsw, int rows, int n_slots,
                                   void* stream) {
  if (qc > TABLE_Q) return (int)cudaErrorInvalidValue;
  if (qc <= 0 || nsw <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(counts, 0, (size_t)qc * sizeof(int32_t),
                                   st);
  if (rc != cudaSuccess) return (int)rc;
  SlotTable tab;                        // copied into the launch
  memcpy(tab.slots, q_slots, (size_t)qc * CLAUSES * sizeof(int32_t));
  memcpy(tab.neg, q_neg, (size_t)qc * NEGS * sizeof(int32_t));
  intersect_counts_kernel<<<dim3(qc, nsw), THREADS, 0, st>>>(
      tab, (const int4*)bits, (int4*)out, (int32_t*)counts, nsw, rows,
      n_slots);
  return (int)cudaGetLastError();
}

// The most queries one es_intersect_bitset call takes.
extern "C" int es_intersect_table_q() { return TABLE_Q; }

// F3's first stage, one launch for up to MAX_PARTS partitions: table
// [n_parts, 4] int64 on the host, a row (bits, nsw, rows, n_slots) a
// partition; q_slots [n_parts, qc, 8], q_neg [n_parts, qc, 4] int32 on the
// card; out [n_parts, qc, nsw_max * 16, 128], counts [n_parts, qc].
extern "C" int es_fused_intersect_bitset(const void* table, int n_parts,
                                         const void* q_slots,
                                         const void* q_neg, void* out,
                                         void* counts, int qc, int nsw_max,
                                         void* stream) {
  if (n_parts < 1 || n_parts > MAX_PARTS) return (int)cudaErrorInvalidValue;
  BitsTable parts;                      // copied into the launch
  const int64_t* t = (const int64_t*)table;
  for (int i = 0; i < n_parts; ++i) {
    const int64_t* r = t + 4 * i;
    parts.p[i] = BitsPart{(const int4*)r[0], (int)r[1], (int)r[2], (int)r[3]};
    if (parts.p[i].nsw < 1 || parts.p[i].nsw > nsw_max
        || parts.p[i].rows < parts.p[i].nsw * SW_WORD_ROWS
        || parts.p[i].n_slots < 2) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (qc <= 0 || nsw_max <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(
      counts, 0, (size_t)n_parts * qc * sizeof(int32_t), st);
  if (rc != cudaSuccess) return (int)rc;
  fused_intersect_counts_kernel<<<dim3(qc, nsw_max, n_parts), THREADS, 0,
                                  st>>>(
      parts, (const int32_t*)q_slots, (const int32_t*)q_neg, (int4*)out,
      (int32_t*)counts, qc);
  return (int)cudaGetLastError();
}
