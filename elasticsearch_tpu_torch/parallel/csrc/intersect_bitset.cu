// K5 intersect_bitset: per (query, superwindow), AND up to 8 clause blocks
// of the packed presence bitsets and AND-NOT up to 4.
//
// Replaces the Pallas kernel elasticsearch_tpu/parallel/kernels.py
// intersect_bitset (:398, pallas_call :432, body _intersect_kernel :382),
// which gathered the 12 clause blocks through scalar-prefetch-indexed
// BlockSpecs (grid (QC, nsw)) and combined them on the VPU.
//
// Layout. bits [n_slots, rows, 128] int32 (uint32 bit patterns): a
// superwindow's block of one slot is 16 word rows x 128 lanes = 8 KB,
// contiguous. Slot n_slots - 2 is all zeros (the AND-NOT identity and the
// empty mask) and slot n_slots - 1 all ones (the AND identity), as
// pack_presence_bits makes them. Output mask [qc, nsw * 16, 128].
//
// Design. One block of 128 threads per (query, superwindow); each thread
// owns 4 of the block's 512 16-byte words. The block first reduces the
// query's 12 slots in registers: a repeated slot is read once, the ones
// sentinel in the AND list and the zeros sentinel in the AND-NOT list are
// identities and are not read, and the zeros sentinel in the AND list (an
// inactive row) or the ones sentinel in the AND-NOT list makes the whole
// block zero without a read. So a 2-clause query with no must_not reads two
// 8 KB blocks and writes one.
//
// What bounds it on the H100: bytes — each distinct clause block read once
// (queries sharing a hot clause read it from L2) and the mask written once;
// the work is one AND per 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SW_WORD_ROWS = 16;
constexpr int VEC_PER_ROW = 128 / 4;                    // int4 per word row
constexpr int VEC_PER_BLOCK = SW_WORD_ROWS * VEC_PER_ROW;   // 512
constexpr int CLAUSES = 8;
constexpr int NEGS = 4;
constexpr int THREADS = 128;

__device__ __forceinline__ void and_in(int4& a, const int4 b) {
  a.x &= b.x; a.y &= b.y; a.z &= b.z; a.w &= b.w;
}

__device__ __forceinline__ void and_not_in(int4& a, const int4 b) {
  a.x &= ~b.x; a.y &= ~b.y; a.z &= ~b.z; a.w &= ~b.w;
}

__global__ void __launch_bounds__(THREADS)
intersect_kernel(const int32_t* __restrict__ q_slots,
                 const int32_t* __restrict__ q_neg,
                 const int4* __restrict__ bits, int4* __restrict__ out,
                 int nsw, int rows, int n_slots) {
  const int q = blockIdx.x;
  const int sw = blockIdx.y;
  const int zero_s = n_slots - 2, ones_s = n_slots - 1;

  // the distinct slots to read, in registers (every thread computes the
  // same lists from the same 12 cached loads)
  int pos[CLAUSES], neg[NEGS];
  int npos = 0, nneg = 0;
  bool empty = false;
#pragma unroll
  for (int c = 0; c < CLAUSES; ++c) {
    const int s = q_slots[q * CLAUSES + c];
    bool dup = s == ones_s;
    empty |= s == zero_s;
#pragma unroll
    for (int j = 0; j < c; ++j) dup |= j < npos && pos[j] == s;
    if (!dup && s != zero_s) pos[npos++] = s;
  }
#pragma unroll
  for (int n = 0; n < NEGS; ++n) {
    const int s = q_neg[q * NEGS + n];
    bool dup = s == zero_s;
    empty |= s == ones_s;
#pragma unroll
    for (int j = 0; j < n; ++j) dup |= j < nneg && neg[j] == s;
    if (!dup && s != ones_s) neg[nneg++] = s;
  }

  const int64_t obase =
      ((int64_t)q * nsw * SW_WORD_ROWS + (int64_t)sw * SW_WORD_ROWS)
      * VEC_PER_ROW;
  for (int i = threadIdx.x; i < VEC_PER_BLOCK; i += THREADS) {
    int4 acc = make_int4(0, 0, 0, 0);
    if (!empty) {
      acc = make_int4(-1, -1, -1, -1);
#pragma unroll
      for (int j = 0; j < CLAUSES; ++j) {
        if (j < npos) {
          and_in(acc, bits[((int64_t)pos[j] * rows + (int64_t)sw * SW_WORD_ROWS)
                           * VEC_PER_ROW + i]);
        }
      }
#pragma unroll
      for (int j = 0; j < NEGS; ++j) {
        if (j < nneg) {
          and_not_in(acc, bits[((int64_t)neg[j] * rows
                                + (int64_t)sw * SW_WORD_ROWS)
                               * VEC_PER_ROW + i]);
        }
      }
    }
    out[obase + i] = acc;
  }
}

}  // namespace

extern "C" int es_intersect_bitset(const void* q_slots, const void* q_neg,
                                   const void* bits, void* out, int qc,
                                   int nsw, int rows, int n_slots,
                                   void* stream) {
  if (qc <= 0 || nsw <= 0) return 0;
  dim3 grid(qc, nsw);
  intersect_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q_slots, (const int32_t*)q_neg, (const int4*)bits,
      (int4*)out, nsw, rows, n_slots);
  return (int)cudaGetLastError();
}
