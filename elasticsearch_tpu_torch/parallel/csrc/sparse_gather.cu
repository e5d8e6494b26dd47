// K3 sparse_gather: cold-term eager sparse scoring — accumulate every
// dispatched slice chunk into per-doc totals, then read each lane's total
// back.
//
// Replaces the two Pallas kernels of elasticsearch_tpu/parallel/kernels.py
// sparse_gather (:876): _sparse_scatter_kernel (pallas_call :901), which
// scattered chunks into [128, 128] tile accumulators as one-hot outer
// products on the MXU, and _sparse_pick_kernel (pallas_call :920), which
// gathered the totals back with a second matmul. Here both are one kernel:
// one block per 16384-doc tile keeps the tile's f32 accumulator in 64 KB of
// shared memory, walks the chunks in rc order (skipping those whose
// [ct0, ct1] tile range excludes it) adding float(imp) * cw, then walks them
// again and writes out[rc, lane] for the lanes whose doc lies in its tile.
//
// Bit-exactness. A chunk holds one term's postings, so its docs are
// distinct: no atomics. A __syncthreads between chunks makes every doc's
// sum ((0 + c0) + c1) + ... in rc order, the reference's order, with each
// addend f32(imp) * cw rounded on its own (__fmul_rn then __fadd_rn: a
// contracted fma would round once and differ). Every lane's doc lies in
// exactly one tile, so exactly one block writes each output lane; the
// wrapper zero-fills `out` for the others. The wrapper refuses a coff
// outside [0, n_gran) before launch; the range test below only keeps the
// kernel from reading outside the pool if that check is ever bypassed.
//
// What bounds it on the H100: bytes — each dispatched granule (4 KB) is
// read by the blocks of the tiles it spans, and the output is as large as
// the granules. A packed lane is doc << 8 | imp (uint8 impact); shifts are
// logical on uint32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16384;
constexpr int GRAN = 1024;            // lanes per granule / chunk
constexpr int THREADS = 512;

__global__ void __launch_bounds__(THREADS)
sparse_gather_kernel(const int32_t* __restrict__ coff,
                     const float* __restrict__ cw,
                     const int32_t* __restrict__ ct0,
                     const int32_t* __restrict__ ct1, int n_rc,
                     const uint32_t* __restrict__ pool, int n_gran,
                     float* __restrict__ out) {
  extern __shared__ float acc[];      // [TILE] f32
  const int t = blockIdx.x;
  const int base = t * TILE;
  for (int i = threadIdx.x; i < TILE; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  for (int rc = 0; rc < n_rc; ++rc) {
    const int g = coff[rc];
    if (t < ct0[rc] || t > ct1[rc] || g < 0 || g >= n_gran) continue;
    const float w = cw[rc];
    const uint32_t* lanes = pool + (int64_t)g * GRAN;
    for (int i = threadIdx.x; i < GRAN; i += THREADS) {
      const uint32_t v = lanes[i];
      const uint32_t imp = v & 255u;
      const int rel = (int)(v >> 8) - base;
      if (imp > 0u && rel >= 0 && rel < TILE) {
        acc[rel] = __fadd_rn(acc[rel], __fmul_rn((float)imp, w));
      }
    }
    __syncthreads();
  }

  for (int rc = 0; rc < n_rc; ++rc) {
    const int g = coff[rc];
    if (t < ct0[rc] || t > ct1[rc] || g < 0 || g >= n_gran) continue;
    const uint32_t* lanes = pool + (int64_t)g * GRAN;
    for (int i = threadIdx.x; i < GRAN; i += THREADS) {
      const uint32_t v = lanes[i];
      const int rel = (int)(v >> 8) - base;
      if ((v & 255u) > 0u && rel >= 0 && rel < TILE) {
        out[(int64_t)rc * GRAN + i] = acc[rel];
      }
    }
  }
}

}  // namespace

extern "C" int es_sparse_gather(const void* coff, const void* cw,
                                const void* ct0, const void* ct1, int n_rc,
                                const void* pool, int n_gran, void* out,
                                int n_tiles, void* stream) {
  const int smem = TILE * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles <= 0 || n_rc <= 0) return 0;
  sparse_gather_kernel<<<n_tiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)coff, (const float*)cw, (const int32_t*)ct0,
      (const int32_t*)ct1, n_rc, (const uint32_t*)pool, n_gran, (float*)out);
  return (int)cudaGetLastError();
}
