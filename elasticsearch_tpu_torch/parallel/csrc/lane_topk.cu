// lane_topk: exact per-(partition, query) top-k over the lanes of culled
// postings blocks (K10).
//
// Replaces the lane half of the XLA programs of
// elasticsearch_tpu/parallel/blockmax.py -- `_lane_candidates` (:911), the
// lane side of `_one_query_topk` (:931) and of `_one_query_topk_bool`
// (:1014) -- and the scoring of elasticsearch_tpu/parallel/spmd.py
// `_local_bm25_topk` (:335). The TPU program sorts every lane of a row by
// doc (`jnp.argsort`) and sums runs of equal docs with a log-step scan,
// because scatter serialises on a TPU. The card needs neither.
//
// A row (one query on one partition) is a list of block positions
// [0, tstart[R]) cut into R runs by tstart: each run holds one term's kept
// blocks in doc order, so within a run a doc sits in at most one lane and
// the first lane of each block is its lowest doc. A lane is real when its
// lane score is > 0 (pad lanes are doc 0 with score 0; positions past
// tstart[R] are padding and are not read).
//
// Design: a CTA of 1024 threads per row (a row of a large bucket has a
// million lanes and the searches are latency-bound, so each row keeps as
// many lanes in flight as a block holds). Each thread takes a lane; a real
// lane finds its doc in every other run (binary search over the run's
// blocks by first doc, then over the block's lanes) and is kept only in
// the first run that holds its doc, so every doc of the row is scored
// once. It sums the weighted lane scores w * s in run order, starting from
// 0, and adds the per-doc addend last (the hybrid and bool modes' hot-term
// row):
// the plain version adds the same values in the same order, so the two
// agree bit for bit. A candidate enters a shared buffer when it beats the
// k-th of the best k so far (score desc, doc asc); when the buffer could
// overflow, a bitonic sort of it keeps the best k and raises the bar.
//
//   lane mode:   ok = tot > 0 && live[d];       value = tot
//   hybrid mode: ok = tot > 0 && live[d];       value = tot + addend[d]
//   bool mode:   value = tot + addend[d];
//                ok = live[d] && |cnt + hp[d] - nm| < 0.5 && value > 0
//                (cnt: the row's must flags of the runs that hold d; no
//                tot > 0 gate, as the reference, blockmax.py:1030-1035)
//
// Output [S, Q, k] (score, doc) ranked by (score desc, doc asc); slots past
// the row's candidates are (-inf, 0).
//
// What bounds it on the H100: neither bytes nor operations at first. The
// lanes' own bytes (8 per lane, each block row read once) and the output
// are small beside the dependent loads of the searches (log2 of the run's
// blocks plus 7 per other run, mostly L1 / L2 hits), and a row with
// millions of lanes runs on one SM. This is the simple kernel; a faster
// one is later work (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 1024;
constexpr int LANES = 128;

struct Args {
  const int* docs;          // [S, T, 128]
  const float* scores;      // [S, T, 128]
  const uint8_t* live;      // [S, D]
  const int* qblocks;       // [Q, S, B]
  const float* qw;          // [Q, S, B]
  const int* tstart;        // [Q, S, R + 1]
  const float* addend;      // [S, Q, D] or null
  const float* qf;          // [Q, S, B] (bool mode) or null
  const float* hp;          // [S, Q, D] (bool mode) or null
  const float* nm;          // [Q] (bool mode) or null
  float* out_s;             // [S, Q, k]
  int* out_d;               // [S, Q, k]
  int S, Q, B, R, D, k, cap;
  long long T;
};

__device__ __forceinline__ bool better(float va, int da, float vb, int db) {
  return va > vb || (va == vb && da < db);
}

// The position of doc d in run [a, e) of the row, or -1; *lane its lane.
__device__ __forceinline__ int find_doc(const Args& g, const int* bd_part,
                                        const float* bs_part, const int* qb,
                                        int a, int e, int d, int* lane) {
  int lo = a, hi = e;                     // first position with lo-doc > d
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int first = __ldg(bd_part + (long long)__ldg(qb + mid) * LANES);
    if (first <= d) lo = mid + 1; else hi = mid;
  }
  const int p = lo - 1;
  if (p < a) return -1;
  const long long row = (long long)__ldg(qb + p) * LANES;
  int l = 0, h = LANES;                   // first lane with key >= d
  while (l < h) {
    const int m = (l + h) >> 1;
    const int doc = __ldg(bd_part + row + m);
    const int key = (m > 0 && doc == 0) ? INT32_MAX : doc;  // pad lanes last
    if (key < d) l = m + 1; else h = m;
  }
  if (l == LANES || __ldg(bd_part + row + l) != d ||
      !(__ldg(bs_part + row + l) > 0.f))
    return -1;
  *lane = l;
  return p;
}

// Sorts the buffer (n live entries, padded to cap) best first.
__device__ void bitonic(float* v, int* d, int n, int cap) {
  for (int i = n + threadIdx.x; i < cap; i += blockDim.x) {
    v[i] = -INFINITY;
    d[i] = INT32_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < cap / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;  // this half ranks best first
        const bool swap = up ? better(v[j], d[j], v[i], d[i])
                             : better(v[i], d[i], v[j], d[j]);
        if (swap) {
          const float tv = v[i];
          v[i] = v[j];
          v[j] = tv;
          const int td = d[i];
          d[i] = d[j];
          d[j] = td;
        }
      }
      __syncthreads();
    }
  }
}

template <int MODE>  // 0 lane, 1 hybrid, 2 bool
__global__ void __launch_bounds__(THREADS) lane_topk_kernel(const Args g) {
  extern __shared__ unsigned char smem[];
  float* cv = reinterpret_cast<float*>(smem);
  int* cd = reinterpret_cast<int*>(cv + g.cap);
  __shared__ int count, n_top;
  __shared__ float thr_v;
  __shared__ int thr_d;

  const int q = blockIdx.x, s = blockIdx.y;
  const long long row = (long long)q * g.S + s;
  const int* ts = g.tstart + row * (g.R + 1);
  const int* qb = g.qblocks + row * g.B;
  const float* w = g.qw + row * g.B;
  const float* f = MODE == 2 ? g.qf + row * g.B : nullptr;
  const int* bd_part = g.docs + (long long)s * g.T * LANES;
  const float* bs_part = g.scores + (long long)s * g.T * LANES;
  const uint8_t* lv = g.live + (long long)s * g.D;
  const long long drow = ((long long)s * g.Q + q) * g.D;
  const int nb = __ldg(ts + g.R);
  const long long n_lanes = (long long)nb * LANES;

  if (threadIdx.x == 0) {
    count = 0;
    n_top = 0;
    thr_v = -INFINITY;
    thr_d = INT32_MAX;
  }
  __syncthreads();
  for (long long base = 0; base < n_lanes; base += THREADS) {
    const long long i = base + threadIdx.x;
    if (i < n_lanes) {
      const int p = (int)(i / LANES), j = (int)(i % LANES);
      const long long off = (long long)__ldg(qb + p) * LANES + j;
      const int d = __ldg(bd_part + off);
      const float sc = __ldg(bs_part + off);
      if (sc > 0.f && d >= 0 && d < g.D) {
        int r = 0;                        // the lane's own run
        while (r + 1 < g.R && __ldg(ts + r + 1) <= p) ++r;
        bool first = true;
        float acc = 0.f, cnt = 0.f;
        for (int t = 0; t < g.R; ++t) {
          if (t == r) {
            acc = __fadd_rn(acc, __fmul_rn(__ldg(w + p), sc));
            if (MODE == 2) cnt = __fadd_rn(cnt, __ldg(f + p));
            continue;
          }
          const int a = __ldg(ts + t), e = __ldg(ts + t + 1);
          if (a >= e) continue;
          int l = 0;
          const int pp = find_doc(g, bd_part, bs_part, qb, a, e, d, &l);
          if (pp < 0) continue;
          if (t < r) {                    // an earlier run holds d
            first = false;
            break;
          }
          const float s2 =
              __ldg(bs_part + (long long)__ldg(qb + pp) * LANES + l);
          acc = __fadd_rn(acc, __fmul_rn(__ldg(w + pp), s2));
          if (MODE == 2) cnt = __fadd_rn(cnt, __ldg(f + pp));
        }
        if (first) {
          bool ok;
          float val = acc;
          if (MODE == 2) {
            val = __fadd_rn(acc, __ldg(g.addend + drow + d));
            const float cov = __fadd_rn(cnt, __ldg(g.hp + drow + d));
            ok = lv[d] && fabsf(__fsub_rn(cov, __ldg(g.nm + q))) < 0.5f &&
                 val > 0.f;
          } else {
            ok = acc > 0.f && lv[d];
            if (MODE == 1) val = __fadd_rn(acc, __ldg(g.addend + drow + d));
          }
          if (ok && (n_top < g.k || better(val, d, thr_v, thr_d))) {
            const int slot = atomicAdd(&count, 1);
            cv[slot] = val;
            cd[slot] = d;
          }
        }
      }
    }
    __syncthreads();
    if (count + THREADS > g.cap) {        // keep the best k, raise the bar
      const int n = count;
      bitonic(cv, cd, n, g.cap);
      if (threadIdx.x == 0) {
        count = n < g.k ? n : g.k;
        n_top = count;
        if (n_top == g.k) {
          thr_v = cv[g.k - 1];
          thr_d = cd[g.k - 1];
        }
      }
      __syncthreads();
    }
  }
  const int n = count;
  bitonic(cv, cd, n, g.cap);
  float* os = g.out_s + ((long long)s * g.Q + q) * g.k;
  int* od = g.out_d + ((long long)s * g.Q + q) * g.k;
  for (int i = threadIdx.x; i < g.k; i += THREADS) {
    const bool has = i < n;
    os[i] = has ? cv[i] : -INFINITY;
    od[i] = has ? cd[i] : 0;
  }
}

// a block's shared memory, less room for the kernel's static variables
constexpr int SMEM_MAX = 226 * 1024;
constexpr int MAX_DEVICES = 64;
std::mutex mu;
bool configured[3][MAX_DEVICES];

// Raises the kernel's dynamic shared memory limit to SMEM_MAX once per
// device (not on every launch, so a launch can be captured in a graph).
template <int MODE>
cudaError_t configure() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!configured[MODE][dev]) {
    e = cudaFuncSetAttribute(lane_topk_kernel<MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return e;
    configured[MODE][dev] = true;
  }
  return cudaSuccess;
}

template <int MODE>
int launch(const Args& g, cudaStream_t st) {
  const size_t smem = (size_t)g.cap * (sizeof(float) + sizeof(int));
  const cudaError_t e = configure<MODE>();
  if (e != cudaSuccess) return (int)e;
  lane_topk_kernel<MODE><<<dim3(g.Q, g.S), THREADS, smem, st>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// The buffer a launch holds in shared memory: a power of two >= k + THREADS.
extern "C" int es_lane_topk_cap(int k) {
  int cap = 512;
  while (cap < k + THREADS) cap <<= 1;
  return cap;
}

// mode 0 lane, 1 hybrid (addend), 2 bool (addend, qf, hp, nm).
extern "C" int es_lane_topk(const void* docs, const void* scores,
                            const void* live, const void* qblocks,
                            const void* qw, const void* tstart,
                            const void* addend, const void* qf,
                            const void* hp, const void* nm, void* out_s,
                            void* out_d, int S, int Q, long long T, int B,
                            int R, int D, int k, int mode, void* stream) {
  if (S <= 0 || Q <= 0) return 0;
  if (k <= 0 || R <= 0 || S > 65535) return (int)cudaErrorInvalidValue;
  if ((mode >= 1 && !addend) || (mode == 2 && (!qf || !hp || !nm)))
    return (int)cudaErrorInvalidValue;
  const int cap = es_lane_topk_cap(k);
  if ((size_t)cap * 8 > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Args g{(const int*)docs,   (const float*)scores, (const uint8_t*)live,
               (const int*)qblocks, (const float*)qw,    (const int*)tstart,
               (const float*)addend, (const float*)qf,   (const float*)hp,
               (const float*)nm,   (float*)out_s,        (int*)out_d,
               S, Q, B, R, D, k, cap, T};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) return launch<0>(g, st);
  if (mode == 1) return launch<1>(g, st);
  if (mode == 2) return launch<2>(g, st);
  return (int)cudaErrorInvalidValue;
}
