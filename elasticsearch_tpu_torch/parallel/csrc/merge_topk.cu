// K4 merge_topk: merge each query's per-partition top-k candidate lanes into
// one top-k by (score desc, partition asc, ord asc).
//
// Replaces the Pallas kernel of elasticsearch_tpu/parallel/kernels.py
// merge_topk (:633, pallas_call :654, body _merge_kernel :600): a k-step
// max cascade over a [QB, S*k] VMEM tile, each step a max reduction and two
// nested min reductions (lowest partition, then lowest ord among the lanes
// holding the max), then clearing every lane that holds the chosen triple.
//
// Design: one pass, no sequential step chain. The cascade's output j is the
// j-th best *distinct* positive triple (score, partition, ord), because each
// step clears every copy of its winner. So, per query:
// - lane i (score v_i > 0 ? v_i : 0, so NaN, -0.0 and negatives are empty;
//   partition i / k) is a leader if v_i > 0 and no lower lane of its own
//   partition holds the same (score, ord): copies of a triple share a
//   partition, so a lane compares only within its own k lanes;
// - a leader's rank is the number of leaders better than it; ranks are
//   distinct and cover 0 .. leaders - 1;
// - a leader with rank < k writes its triple to slot rank, and slots from
//   the leader count up to k get (0, 0, 0). Every output slot is written
//   exactly once.
// One warp per query, QPB queries a block (8, fewer where a query's L lanes
// need more shared memory); O(L * k + L^2 / 32) compares a warp. A query
// keeps 8 bytes a lane in shared memory: its scores and ords. Scores are
// stored as v >= +0, so the sign bit is free: once a lane's leader test is
// done its score is stored negated unless it leads (a leader stays > 0,
// every other lane <= 0), and the rank pass reads leaders from the sign.
// Every
// value is an exact copy of an input, so kernel and plain version agree
// bitwise.
//
// What bounds it on the H100: nothing that matters at the serving shapes
// (Q x S*k x 8 bytes read, Q x k x 12 written: 80 KB at Q = 256, S = 4,
// k = 10); it is latency, a few microseconds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int QPB = 8;                // queries (warps) a block
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int MAX_DEVICES = 64;

// (v desc, p asc, o asc)
__device__ __forceinline__ bool better(float va, int pa, int oa, float vb,
                                       int pb, int ob) {
  return va > vb || (va == vb && (pa < pb || (pa == pb && oa < ob)));
}

// shared per query: v[L] (scores, empty as 0; after the leader test a
// leader's score, -v for every other lane), o[L] (ords)
__global__ void merge_kernel(const float* __restrict__ scores,
                             const int32_t* __restrict__ ords,
                             float* __restrict__ out_s,
                             int32_t* __restrict__ out_p,
                             int32_t* __restrict__ out_o, int Q, int L,
                             int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + w;
  if (q >= Q) return;                 // whole warps: no block barrier below
  float* v = reinterpret_cast<float*>(smem) + (int64_t)w * 2 * L;
  int* o = reinterpret_cast<int*>(v + L);
  const float* sq = scores + (int64_t)q * L;
  const int32_t* oq = ords + (int64_t)q * L;
  for (int i = lane; i < L; i += 32) {
    const float x = sq[i];
    v[i] = x > 0.f ? x : 0.f;
    o[i] = oq[i];
  }
  __syncwarp();
  // 32 lanes at a time: the test reads |v| of lower lanes, some already
  // marked; the marks are written after the whole warp has read
  int leaders = 0;                    // the same in every lane
  for (int i0 = 0; i0 < L; i0 += 32) {
    const int i = i0 + lane;
    float x = 0.f;
    bool lead = false;
    if (i < L) {
      x = v[i];
      lead = x > 0.f;
      const int oi = o[i];
      for (int j = i - i % k; lead && j < i; ++j)
        lead = !(fabsf(v[j]) == x && o[j] == oi);
    }
    leaders += __popc(__ballot_sync(0xffffffffu, lead));
    __syncwarp();
    if (i < L && !lead) v[i] = -x;
    __syncwarp();
  }
  for (int i = lane; i < L; i += 32) {
    const float x = v[i];
    if (!(x > 0.f)) continue;
    const int pi = i / k, oi = o[i];
    int rank = 0;
    for (int j = 0, pj = 0, r = 0; j < L && rank < k; ++j) {
      rank += better(v[j], pj, o[j], x, pi, oi);
      if (++r == k) {
        r = 0;
        ++pj;
      }
    }
    if (rank < k) {
      out_s[(int64_t)q * k + rank] = x;
      out_p[(int64_t)q * k + rank] = pi;
      out_o[(int64_t)q * k + rank] = oi;
    }
  }
  // the slots past the leaders are empty
  for (int r = leaders + lane; r < k; r += 32) {
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
  if (L < 0 || k <= 0 || L % k) return (int)cudaErrorInvalidValue;
  const int per_query = 8 * (L > 0 ? L : 1);
  int qpb = SMEM_DEFAULT / per_query;
  qpb = qpb > QPB ? QPB : qpb < 1 ? 1 : qpb;
  const int smem = qpb * per_query;
  if (smem > SMEM_DEFAULT) {
    // raised once per device (the attribute applies to the current one),
    // as far as asked
    static std::mutex mu;
    static int set[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (smem > set[dev]) {
      err = cudaFuncSetAttribute(
          merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      set[dev] = smem;
    }
  }
  merge_kernel<<<(Q + qpb - 1) / qpb, qpb * 32, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const int32_t*)ords, (float*)out_s,
      (int32_t*)out_p, (int32_t*)out_o, Q, L, k);
  return (int)cudaGetLastError();
}
