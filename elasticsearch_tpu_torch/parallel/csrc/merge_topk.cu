// K4 merge_topk: merge each query's per-partition top-k candidate lanes into
// one top-k by (score desc, partition asc, ord asc).
//
// Replaces the Pallas kernel of elasticsearch_tpu/parallel/kernels.py
// merge_topk (:633, pallas_call :654, body _merge_kernel :600): a k-step
// max cascade over a [QB, S*k] VMEM tile, each step a max reduction and two
// nested min reductions (lowest partition, then lowest ord among the lanes
// holding the max), then clearing every lane that holds the chosen triple.
//
// Design. One warp per query: the query's S*k lanes are staged in shared
// memory (non-positive scores as 0, empty), and each of the k steps is one
// warp-wide argmax by (score desc, partition asc, ord asc) over lanes with a
// positive score, followed by clearing every lane equal to the winner, as
// the reference clears them. When no positive lane is left the remaining
// slots are (0, 0, 0). The partition of a lane is lane / k (lanes are
// partition-major). Every step permutes exact f32 values; nothing is
// recomputed, so kernel and plain version agree bitwise.
//
// What bounds it on the H100: nothing that matters at the serving shapes
// (Q x S*k x 8 bytes read, Q x k x 12 written: 80 KB at Q = 256, S = 4,
// k = 10); it is latency, a handful of microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Cand {
  float v;
  int p;
  int o;
};

// (v desc, p asc, o asc)
__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.v > b.v || (a.v == b.v && (a.p < b.p || (a.p == b.p && a.o < b.o)));
}

__global__ void merge_kernel(const float* __restrict__ scores,
                             const int32_t* __restrict__ ords,
                             float* __restrict__ out_s,
                             int32_t* __restrict__ out_p,
                             int32_t* __restrict__ out_o, int L, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  int* o = reinterpret_cast<int*>(s + L);
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < L; i += 32) {
    const float v = scores[(int64_t)q * L + i];
    s[i] = v > 0.f ? v : 0.f;
    o[i] = ords[(int64_t)q * L + i];
  }
  __syncwarp();
  int j = 0;
  for (; j < k; ++j) {
    Cand c = {0.f, 0x7fffffff, 0x7fffffff};
    for (int i = lane; i < L; i += 32) {
      const Cand x = {s[i], i / k, o[i]};
      if (x.v > 0.f && better(x, c)) c = x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Cand x;
      x.v = __shfl_xor_sync(0xffffffffu, c.v, off);
      x.p = __shfl_xor_sync(0xffffffffu, c.p, off);
      x.o = __shfl_xor_sync(0xffffffffu, c.o, off);
      if (better(x, c)) c = x;
    }
    if (!(c.v > 0.f)) break;
    if (lane == 0) {
      out_s[(int64_t)q * k + j] = c.v;
      out_p[(int64_t)q * k + j] = c.p;
      out_o[(int64_t)q * k + j] = c.o;
    }
    for (int i = lane; i < L; i += 32) {
      if (s[i] == c.v && i / k == c.p && o[i] == c.o) s[i] = 0.f;
    }
    __syncwarp();
  }
  for (int r = j + lane; r < k; r += 32) {
    out_s[(int64_t)q * k + r] = 0.f;
    out_p[(int64_t)q * k + r] = 0;
    out_o[(int64_t)q * k + r] = 0;
  }
}

}  // namespace

extern "C" int es_merge_topk(const void* scores, const void* ords,
                             void* out_s, void* out_p, void* out_o, int Q,
                             int L, int k, void* stream) {
  if (Q <= 0) return 0;
  const int smem = L * 8;
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem > 48 * 1024 ? smem : 48 * 1024);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<Q, 32, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const int32_t*)ords, (float*)out_s,
      (int32_t*)out_p, (int32_t*)out_o, L, k);
  return (int)cudaGetLastError();
}
