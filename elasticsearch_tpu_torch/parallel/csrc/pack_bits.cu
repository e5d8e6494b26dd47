// pack_presence_bits: the column cache's presence packed into per-slot doc
// bitsets, 32 posting rows a word.
//
// Replaces the XLA program elasticsearch_tpu/parallel/kernels.py
// pack_presence_bits (:358), which the reference runs beside the Pallas K5
// intersect_bitset after every column build. Bit j of word [s, g, l] is
// (hi[2g + j/16, s, j%16, l] | lo[2g + j/16, s, j%16, l]) != 0; slot Hp+1,
// the AND identity, is all ones. The output is int32 holding the uint32
// bit patterns.
//
// Layout. cols [dpc, Hp+1, 16, 128] int8: one (chunk, slot) block is 16
// rows x 128 lanes = 2 KB, contiguous, and the slots of a chunk follow each
// other. bits [Hp+2, dpc / 2, 128] int32: word row g of slot s packs chunks
// 2g (bits 0-15) and 2g + 1 (bits 16-31).
//
// Design. One warp per (slot, word row); lane t owns lanes 4t..4t+3. For
// each of the 32 posting rows it loads 4 bytes of hi and 4 of lo (a warp
// reads a whole 128-byte row), all 64 loads unrolled and independent so
// they are in flight together; __vcmpne4 tests the four lanes at once, the
// 0/1 bytes of 8 rows are summed into one word (byte b = lane 4t+b's 8
// bits), and a 4x4 byte transpose (__byte_perm) turns the four such words
// into the four lanes' 32-bit words, stored as one 16-byte write. Warps
// take the slots of one word row in turn, so a block reads 8 neighbouring
// 2 KB blocks of each chunk. Slot Hp+1 is written without a read.
//
// What bounds it on the H100: bytes. Both column layers are read once
// (2 x dpc x (Hp+1) x 2 KB, 3.6 GB at 8M docs) and the bits written once
// (1/16 of that); the work is a few integer operations per 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                  // 8 warps, 8 word rows
constexpr int ROWS = 16;                      // posting rows per chunk
constexpr int LANE_BYTES = 128;

__device__ __forceinline__ uint32_t row_bits(uint32_t h, uint32_t l) {
  return __vcmpne4(h | l, 0u) & 0x01010101u;  // byte b: lane 4t+b present
}

__global__ void __launch_bounds__(THREADS)
pack_bits_kernel(const int8_t* __restrict__ hi, const int8_t* __restrict__ lo,
                 int4* __restrict__ bits, int wgr, int hp1) {
  const int64_t warp =
      (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int n_slots = hp1 + 1;
  if (warp >= (int64_t)wgr * n_slots) return;
  const int lane = threadIdx.x & 31;
  const int s = (int)(warp % n_slots);
  const int g = (int)(warp / n_slots);
  int4* out = bits + ((int64_t)s * wgr + g) * (LANE_BYTES / 4) + lane;
  if (s == hp1) {                             // the AND identity
    __stcs(out, make_int4(-1, -1, -1, -1));
    return;
  }
  uint32_t h[2 * ROWS], l[2 * ROWS];
#pragma unroll
  for (int j = 0; j < 2 * ROWS; ++j) {
    const int64_t off =
        (((int64_t)(2 * g + j / ROWS) * hp1 + s) * ROWS + j % ROWS)
        * LANE_BYTES + 4 * lane;
    h[j] = __ldcs(reinterpret_cast<const unsigned int*>(hi + off));
    l[j] = __ldcs(reinterpret_cast<const unsigned int*>(lo + off));
  }
  // a[k]: byte b holds lane 4t+b's bits of rows 8k..8k+7
  uint32_t a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc |= row_bits(h[8 * k + i], l[8 * k + i]) << i;
    }
    a[k] = acc;
  }
  // 4x4 byte transpose: word b = (a0.b, a1.b, a2.b, a3.b)
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);
  const uint32_t t1 = __byte_perm(a[2], a[3], 0x5140);
  const uint32_t t2 = __byte_perm(a[0], a[1], 0x7362);
  const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);
  __stcs(out, make_int4((int)__byte_perm(t0, t1, 0x5410),
                        (int)__byte_perm(t0, t1, 0x7632),
                        (int)__byte_perm(t2, t3, 0x5410),
                        (int)__byte_perm(t2, t3, 0x7632)));
}

}  // namespace

extern "C" int es_pack_presence_bits(const void* hi, const void* lo,
                                     void* bits, int dpc, int hp1,
                                     void* stream) {
  if (dpc <= 0 || hp1 <= 0) return 0;
  const int wgr = dpc / 2;
  const int64_t warps = (int64_t)wgr * (hp1 + 1);
  const int64_t blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  pack_bits_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)hi, (const int8_t*)lo, (int4*)bits, wgr, hp1);
  return (int)cudaGetLastError();
}
