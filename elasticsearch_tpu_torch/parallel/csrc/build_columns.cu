// K1 build_columns: fill int8 hi/lo impact-column tiles from posting lanes.
//
// Replaces the Pallas kernel elasticsearch_tpu/parallel/kernels.py
// build_columns (:730, pallas_call :780, body _build_kernel :677), which
// scattered lanes into a tile as a one-hot outer product on the MXU because
// the TPU has no scatter. Hopper has one: one block per (slot, 16384-doc
// tile) group scatters its lanes straight into a 64 KB f32 tile in shared
// memory, then quantizes the tile and writes its 8 chunk-majors.
//
// What bounds it on the H100: bytes. Each group reads nrows * 128 lanes of
// (doc i32, score f32) and writes 2 * 16384 int8 cells; there is a handful
// of float operations per cell. The Pallas kernel DMA'd 144 rows per group
// every time; this one reads only the group's own nrows.
//
// Semantics held bitwise against the reference and the plain torch version
// (kernels.build_columns_plain):
// * Each (term, doc) has one lane, and unused lanes carry score 0, so a
//   tile cell receives at most one nonzero value. Storing the nonzero
//   lanes is therefore exactly the reference's sum, and no atomics are
//   needed. A group with nrows = 0 writes a zero tile (eviction, padding).
// * hi = clip(rint(t * (1/COLSCALE)), -127, 127) — a multiply by the f32
//   constant, never a divide; rintf rounds half to even like jnp.round.
// * lo = clip(rint(fma(-hi, COLSCALE, t) * (1/COLSCALE2)), -127, 127):
//   XLA on the CPU contracts `t - hi * COLSCALE` into a fused multiply-add
//   (measured against the reference), so the kernel uses __fmaf_rn there and
//   __fmul_rn elsewhere, whatever nvcc would contract on its own.
// * a present cell (t > 0) with hi == lo == 0 gets lo = 1.
// Groups of one launch must target distinct (slot, tile) pairs, except
// zero groups, which may repeat: blocks run in no order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16384;
constexpr int CHUNK = 2048;           // docs per chunk-major (16 x 128)
constexpr int THREADS = 512;

__device__ __forceinline__ float clip127(float x) {
  return fminf(fmaxf(x, -127.f), 127.f);
}

__global__ void __launch_bounds__(THREADS)
build_columns_kernel(const int32_t* __restrict__ g_rows,
                     const int32_t* __restrict__ g_nrows,
                     const int32_t* __restrict__ g_base,
                     const int32_t* __restrict__ g_slot,
                     const int32_t* __restrict__ lane_docs,
                     const float* __restrict__ lane_scores,
                     int n_lane_rows,
                     int8_t* __restrict__ cols_hi,
                     int8_t* __restrict__ cols_lo,
                     int dp_chunks, int hpt,
                     float inv_cs, float cs, float inv_cs2) {
  extern __shared__ float tile[];     // [TILE] f32
  const int g = blockIdx.x;
  const int r0 = g_rows[g];
  const int nrows = g_nrows[g];
  const int base = g_base[g];
  const int slot = g_slot[g];
  // a malformed group writes nothing rather than out of bounds
  if (slot < 0 || slot >= hpt || base < 0 || (base % TILE) != 0 ||
      base / CHUNK + TILE / CHUNK > dp_chunks || nrows < 0 || r0 < 0 ||
      r0 + nrows > n_lane_rows) {
    return;
  }

  float4* tile4 = reinterpret_cast<float4*>(tile);
  for (int i = threadIdx.x; i < TILE / 4; i += THREADS) {
    tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int64_t lane0 = (int64_t)r0 * 128;
  const int n_lanes = nrows * 128;
  for (int i = threadIdx.x; i < n_lanes; i += THREADS) {
    const int d = lane_docs[lane0 + i];
    const float v = lane_scores[lane0 + i];
    const int rel = d - base;
    if (rel >= 0 && rel < TILE && v != 0.f) {
      tile[rel] = v;
    }
  }
  __syncthreads();

  // quantize 4 consecutive cells per thread and store them as one 32-bit
  // word per layer: cell c of the tile lives in chunk-major base/2048 + c/2048
  const int chunk0 = base / CHUNK;
  for (int c4 = threadIdx.x; c4 < TILE / 4; c4 += THREADS) {
    const float4 t4 = tile4[c4];
    const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
    uint32_t hw = 0, lw = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t = tv[j];
      const float hi = clip127(rintf(__fmul_rn(t, inv_cs)));
      float lo = clip127(rintf(__fmul_rn(__fmaf_rn(-hi, cs, t), inv_cs2)));
      if (t > 0.f && hi == 0.f && lo == 0.f) lo = 1.f;
      hw |= (uint32_t)(uint8_t)(int8_t)(int)hi << (8 * j);
      lw |= (uint32_t)(uint8_t)(int8_t)(int)lo << (8 * j);
    }
    const int cell = c4 * 4;
    const int64_t off = ((int64_t)(chunk0 + cell / CHUNK) * hpt + slot) * CHUNK
                        + (cell % CHUNK);
    *reinterpret_cast<uint32_t*>(cols_hi + off) = hw;
    *reinterpret_cast<uint32_t*>(cols_lo + off) = lw;
  }
}

}  // namespace

extern "C" int es_build_columns(const void* g_rows, const void* g_nrows,
                                const void* g_base, const void* g_slot,
                                int n_groups, const void* lane_docs,
                                const void* lane_scores, int n_lane_rows,
                                void* cols_hi, void* cols_lo, int dp_chunks,
                                int hpt, float inv_cs, float cs, float inv_cs2,
                                void* stream) {
  const int smem = TILE * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      build_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_groups <= 0) return 0;
  build_columns_kernel<<<n_groups, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)g_rows, (const int32_t*)g_nrows, (const int32_t*)g_base,
      (const int32_t*)g_slot, (const int32_t*)lane_docs,
      (const float*)lane_scores, n_lane_rows, (int8_t*)cols_hi,
      (int8_t*)cols_lo, dp_chunks, hpt, inv_cs, cs, inv_cs2);
  return (int)cudaGetLastError();
}
