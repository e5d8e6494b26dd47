// K3 sparse_gather: cold-term eager sparse scoring — for every lane of every
// dispatched slice chunk, the total of its doc's contributions over all the
// chunks of the same query.
//
// Replaces the two Pallas kernels of elasticsearch_tpu/parallel/kernels.py
// sparse_gather (:876): _sparse_scatter_kernel (pallas_call :901), which
// scattered chunks into [128, 128] tile accumulators as one-hot outer
// products on the MXU, and _sparse_pick_kernel (pallas_call :920), which
// gathered the totals back with a second matmul. Both become one kernel
// with no doc-space accumulator: each lane gathers its own total by search.
//
// Batch. One launch serves a group of queries: qoff [n_q + 1] gives each
// query's chunk range, and totals never cross queries (qoff == nullptr is
// one query over all n_rc chunks).
//
// Precondition (the serving path packs slices so): a chunk's live lanes
// (imp > 0) come first, with distinct docs in ascending order, followed by
// zero lanes only. The search key of a lane is its doc when imp > 0 and
// INT_MAX otherwise, so every granule is sorted by key.
//
// Design. Four blocks of 256 threads per chunk, one lane a thread:
// 1. the block finds its query's chunk range from qoff and loads its lanes;
//    a lane is live when imp > 0 and its 16384-doc tile lies in the chunk's
//    [ct0, ct1] and below n_tiles (the reference's pick writes the others 0);
// 2. it stages the query's chunk metadata in shared memory, 256 chunks at a
//    time, keeping in rc order only the chunks that can hold one of its
//    live docs: tile range meeting the block's, doc range [first live doc,
//    last lane's doc] meeting the block's (an ordered ballot compaction);
// 3. each live lane walks that list on its own, and for every chunk whose
//    tile range holds its tile and whose doc range holds its doc
//    binary-searches the granule (10 steps, in global memory: the first
//    steps are shared by the block's lanes and hit L1); on a hit it adds
//    f32(imp) * cw of that chunk to its total.
// Lanes of a warp that need different chunks search at the same time, so a
// block's time follows the most chunks one lane needs (about one per term of
// the query), not the union of its lanes' chunks.
//
// Bit-exactness. One thread owns each output lane, and its total is
// ((0 + x_c0) + x_c1) + ... over the chunks holding its doc in rc order (its
// own chunk at its own position): the order in which the reference (and the
// plain version) accumulate chunks into a doc's cell. Each addend is
// f32(imp) * cw rounded on its own (__fmul_rn, then __fadd_rn: nvcc would
// otherwise contract to an fma that rounds once and differs). No atomics,
// no accumulator to zero, and every output lane is written. The wrapper
// refuses a coff outside [0, n_gran) before launch; the range tests below
// only keep the kernel inside the pool (and inside coff) if that check is
// bypassed or qoff is malformed.
//
// What bounds it on the H100: latency — each live lane's searches are ten
// dependent loads (L1 or L2); bytes are a granule read and written per
// chunk. A packed lane is doc << 8 | imp (uint8 impact); shifts are logical
// on uint32.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_SHIFT = 14;        // 16384 docs per tile
constexpr int GRAN = 1024;            // lanes per granule / chunk
constexpr int THREADS = 256;          // lanes per block
constexpr int PARTS = GRAN / THREADS;  // blocks per chunk
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ int key_of(uint32_t v) {
  return (v & 255u) ? (int)(v >> 8) : INT_MAX;
}

__global__ void __launch_bounds__(THREADS)
sparse_gather_kernel(const int32_t* __restrict__ coff,
                     const float* __restrict__ cw,
                     const int32_t* __restrict__ ct0,
                     const int32_t* __restrict__ ct1, int n_rc,
                     const int32_t* __restrict__ qoff, int n_q,
                     const uint32_t* __restrict__ pool, int n_gran,
                     int n_tiles, float* __restrict__ out) {
  __shared__ int s_g[THREADS];
  __shared__ float s_w[THREADS];
  __shared__ int s_t0[THREADS], s_t1[THREADS];
  __shared__ int s_d0[THREADS], s_d1[THREADS];
  __shared__ int s_warp[WARPS];
  __shared__ int s_lo, s_hi, s_q;

  const int tid = threadIdx.x;
  const int wid = tid >> 5, ln = tid & 31;
  const int c = blockIdx.x / PARTS;
  const int lane = (blockIdx.x % PARTS) * THREADS + tid;

  // ---- 1. own lane, and the query that owns chunk c ----
  const int g = coff[c];
  const int t0 = ct0[c], t1 = ct1[c];
  uint32_t v = 0u;
  if (g >= 0 && g < n_gran) v = __ldg(pool + (int64_t)g * GRAN + lane);
  const int doc = (int)(v >> 8);
  const int tile = doc >> TILE_SHIFT;
  const bool live = (v & 255u) && tile >= t0 && tile <= t1 && tile < n_tiles;
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = -1;
    s_q = 0;
  }
  __syncthreads();
  // the block's live doc range
  int lo = live ? doc : INT_MAX, hi = live ? doc : -1;
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (ln == 0 && hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  // q = (number of i in [1, n_q] with qoff[i] <= c): qoff ascends, so chunk
  // c lies in [qoff[q], qoff[q + 1]) and empty queries are stepped over
  if (qoff != nullptr) {
    int cnt = 0;
    for (int i = 1 + tid; i <= n_q; i += THREADS) cnt += qoff[i] <= c;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (ln == 0 && cnt) atomicAdd(&s_q, cnt);
  }
  __syncthreads();
  const int blo = s_lo, bhi = s_hi;
  if (bhi < 0) {                      // no live lane: block-uniform exit
    out[(int64_t)c * GRAN + lane] = 0.f;
    return;
  }
  int q0 = 0, q1 = n_rc;
  if (qoff != nullptr) {
    const int q = min(s_q, n_q - 1);
    q0 = max(0, qoff[q]);
    q1 = min(n_rc, qoff[q + 1]);
  }
  const int btlo = blo >> TILE_SHIFT, bthi = bhi >> TILE_SHIFT;

  float acc = 0.f;
  for (int base = q0; base < q1; base += THREADS) {
    // ---- 2. stage this round's candidate chunks, in rc order ----
    const int i = base + tid;
    bool keep = false;
    int gg = 0, a = 0, b = -1, d0 = 0, d1 = 0;
    if (i < q1) {
      gg = coff[i];
      a = ct0[i];
      b = ct1[i];
      if (gg >= 0 && gg < n_gran && a <= bthi && b >= btlo && a <= b) {
        const uint32_t* gp = pool + (int64_t)gg * GRAN;
        d0 = key_of(__ldg(gp));
        const uint32_t last = __ldg(gp + GRAN - 1);
        d1 = (last & 255u) ? (int)(last >> 8) : INT_MAX - 1;
        keep = d0 <= bhi && d1 >= blo;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (ln == 0) s_warp[wid] = __popc(bal);
    __syncthreads();
    int pos = __popc(bal & ((1u << ln) - 1u)), n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int nw = s_warp[w];
      pos += w < wid ? nw : 0;
      n += nw;
    }
    if (keep) {
      s_g[pos] = gg;
      s_w[pos] = cw[i];
      s_t0[pos] = a;
      s_t1[pos] = b;
      s_d0[pos] = d0;
      s_d1[pos] = d1;
    }
    __syncthreads();

    // ---- 3. each live lane searches the chunks that may hold its doc ----
    if (live) {
      for (int j = 0;; ++j) {
        while (j < n && !(s_t0[j] <= tile && tile <= s_t1[j] &&
                          s_d0[j] <= doc && doc <= s_d1[j]))
          ++j;
        if (j >= n) break;
        const uint32_t* gp = pool + (int64_t)s_g[j] * GRAN;
        int p = 0;
        uint32_t hv = __ldg(gp);
#pragma unroll
        for (int s = GRAN / 2; s >= 1; s >>= 1) {
          const uint32_t x = __ldg(gp + p + s);
          if (key_of(x) <= doc) {
            p += s;
            hv = x;
          }
        }
        if (key_of(hv) == doc)
          acc = __fadd_rn(acc, __fmul_rn((float)(hv & 255u), s_w[j]));
      }
    }
    __syncthreads();                  // the next round overwrites the list
  }
  out[(int64_t)c * GRAN + lane] = live ? acc : 0.f;
}

}  // namespace

extern "C" int es_sparse_gather(const void* coff, const void* cw,
                                const void* ct0, const void* ct1, int n_rc,
                                const void* qoff, int n_q, const void* pool,
                                int n_gran, void* out, int n_tiles,
                                void* stream) {
  if (n_rc <= 0) return 0;
  if (qoff != nullptr && n_q <= 0) return (int)cudaErrorInvalidValue;
  sparse_gather_kernel<<<n_rc * PARTS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)coff, (const float*)cw, (const int32_t*)ct0,
      (const int32_t*)ct1, n_rc, (const int32_t*)qoff, n_q,
      (const uint32_t*)pool, n_gran, n_tiles, (float*)out);
  return (int)cudaGetLastError();
}
