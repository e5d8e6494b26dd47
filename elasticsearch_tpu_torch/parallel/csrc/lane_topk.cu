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
// lane score is > 0 and its doc in [0, D) (pad lanes are doc 0 with score
// 0; positions past tstart[R] are padding and are not read).
//
// A doc is scored once a row, by its lane in the first run that holds it:
// that lane sums the weighted lane scores w * s of every run that holds
// the doc, in run order, starting from 0 (__fmul_rn / __fadd_rn), and adds
// the per-doc addend last (the hybrid and bool modes' hot-term row). The
// plain version adds the same values in the same order, so the two agree
// bit for bit, and since each doc is a candidate once, any split of a row
// into pieces ranks the same (score, doc) pairs.
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
// Design: two passes, issued by one C entry.
//
//  1. The tiles. The caller plans C and the grid's tiles a row
//     (kernels.lane_topk_plan) from the shape alone, at least ceil(B / C),
//     so a launch can be captured in a CUDA graph; tiles past a row's own
//     count exit at once. The kernel takes one of two tile programs from R:
//     tile_kernel, rows of up to RUN_CHUNK runs: a row is cut into
//     doc-range tiles at the first doc of every C-th block of its longest
//     run. A tile finds its range in every run with one 32-way search a
//     run (a warp per run, over the blocks' first docs), stages those
//     block rows (docs and scores, 1 KB a block) into shared memory with
//     1-D bulk copies (cp.async.bulk, completion on an mbarrier), and then
//     each lane whose doc falls in the range finds its doc in the other
//     runs' staged blocks (a search over their first docs, then over the
//     block's lanes) and sums in run order there. A block that straddles a
//     cut is staged by both tiles; each takes only its own docs. A tile
//     whose blocks exceed the staging room (skewed runs) halves its doc
//     range until a pass fits and takes the rest in further passes.
//     Rows of more runs are cut evenly over [0, D), ceil(the row's
//     positions / C) tiles: sort_tile_kernel (below) gathers each tile's
//     lanes, sorts them by (doc, run) and sums; rows of more runs than its
//     shared memory holds take tile_kernel with the runs in chunks of
//     RUN_CHUNK, each lane searching the runs of other chunks in global
//     memory: correct at any R, slow. The tile's
//     best k: for k <= 32 every warp keeps a sorted list in registers (lane
//     i the i-th best) and inserts, by shuffles, only candidates that beat
//     its k-th; the warps' lists merge at the end. For larger k a shared
//     buffer keeps the best k with a bitonic sort when it could overflow.
//     The tile writes its k pairs, ranked, to a scratch [S, Q, tiles, k]
//     (pads (-inf, -1)); when the shape gives one tile a row, it writes the
//     final rows itself and the second launch is skipped.
//  2. merge_kernel: a block per row ranks its tiles' pairs with the same
//     selection and writes [S, Q, k].
//
// What bounds it on the H100: neither bytes nor operations. The lanes'
// own bytes (8 per lane, each block row read once, a straddling row twice)
// and the output are small; a tile's time is the latency of its searches
// (log32 of the run's blocks, two dependent loads a step), its bulk copies
// and its shared-memory searches, so the design spreads a row over every
// SM and keeps two tiles resident on each to overlap them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 128;
constexpr int SMALL_K = 32;          // k up to this: per-warp lists
constexpr int STAGE_BLOCKS = 96;     // block rows one pass stages at most
// runs a pass stages (<= the staged rows: a one-doc range stages at most a
// block a run); lookups in a row's other runs search global memory
constexpr int RUN_CHUNK = 64;
// rows of more runs take the sorted tiles, whose passes gather at most
// SORT_LANES lanes (a one-doc range holds a lane a run at most, so R <=
// SORT_LANES), where their shared memory fits; the chunks otherwise
constexpr int SORT_LANES = 4096;
constexpr int SORT_LANE_BYTES = 16;  // key, value, flag a lane
constexpr int SORT_RUN_BYTES = 16;   // a run's spans and its offset
constexpr int BLOCK_BYTES = LANES * 8;          // docs and scores
constexpr int META_BYTES = 16;       // first doc, weight, flag, run a block
// a block's dynamic shared memory at most, less room for the kernels'
// static variables; the big-k buffer's share of it
constexpr int SMEM_MAX = 224 * 1024;
constexpr int BUF_MAX = 128 * 1024;
constexpr unsigned FULL = 0xffffffffu;

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
  float* tile_s;            // [S, Q, tiles, k] (tiles > 1) or null
  int* tile_d;
  int S, Q, B, R, D, k, cap, tiles, tile_blocks, nb;  // tile_blocks: C
  int lanes;                // the sorted tiles' lanes a pass, 0: search
  long long T;
};

__device__ __forceinline__ bool better(float va, int da, float vb, int db) {
  return va > vb || (va == vb && da < db);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the row's runs and tiles ----------------------------------------------

// Run r of a row holds positions [rs[r], rs[r + 1]): rs[0] = 0 and the
// others tstart's, clamped to [0, B] (the plain version's positions).
__device__ __forceinline__ int run_bound(const int* ts, int i, int B) {
  return i == 0 ? 0 : min(max(__ldg(ts + i), 0), B);
}

// The row's longest run (the first run of the most positions, 0 when
// every run is empty) and its tiles, at least 1 (a tile writes an empty
// row's pads): ceil(the longest run's positions / C) for tiles cut at its
// blocks, ceil(all runs' positions / (C / 2)), at most max_tiles, for even
// cuts of [0, D) (`even`: rows of more than RUN_CHUNK runs; their tiles
// have no longest run's blocks to take, half of C keeps them as short).
// Every thread calls it; block-wide reductions in red[2 * WARPS]. Ends
// with the block synchronised.
__device__ void row_tiles(const int* ts, int R, int B, int C, bool even,
                          int max_tiles, unsigned long long* red, int* m_out,
                          int* tiles_out) {
  unsigned long long best = 0, tot = 0;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int len = run_bound(ts, r + 1, B) - run_bound(ts, r, B);
    const unsigned long long key =
        len > 0 ? ((unsigned long long)len << 32) | (0xffffffffu - (unsigned)r)
                : 0ull;
    best = key > best ? key : best;
    tot += len > 0 ? len : 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(FULL, best, o);
    best = x > best ? x : best;
    tot += __shfl_xor_sync(FULL, tot, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = best;
    red[WARPS + (threadIdx.x >> 5)] = tot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < WARPS; ++i) {
      best = red[i] > best ? red[i] : best;
      tot += red[WARPS + i];
    }
    const int len = (int)(best >> 32);
    *m_out = len > 0 ? (int)(0xffffffffu - (unsigned)best) : 0;
    if (even) {
      const long long n = (2 * (long long)tot + C - 1) / C;
      *tiles_out = n < 1 ? 1 : (n > max_tiles ? max_tiles : (int)n);
    } else {
      *tiles_out = len > 0 ? (len + C - 1) / C : 1;
    }
  }
  __syncthreads();
}

// The first position p in [a, e) whose block's first doc is > x (e when
// none), for a run's blocks in doc order: a 32-way search by one warp
// (every lane calls it with the same arguments), two dependent loads a
// step.
__device__ int warp_ub(const int* qb, const int* bd, int a, int e, int x) {
  const int lane = threadIdx.x & 31;
  while (e - a > 32) {
    const int step = (e - a + 31) / 32;
    const int p = a + (lane + 1) * step - 1;
    const bool le =
        p < e && __ldg(bd + (long long)__ldg(qb + p) * LANES) <= x;
    const int c = __popc(__ballot_sync(FULL, le));
    e = min(e, a + (c + 1) * step - 1);
    a += c * step;
  }
  const int p = a + lane;
  const bool le = p < e && __ldg(bd + (long long)__ldg(qb + p) * LANES) <= x;
  return a + __popc(__ballot_sync(FULL, le));
}

// ---- staging ---------------------------------------------------------------

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase `phase` of the barrier to complete; a copy that never
// lands traps (a launch failure) instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// The staged block of run blocks [b0, b1) that would hold doc d (the last
// whose first doc is <= d), then d's lane in it: true with the block and
// the lane's score when the lane holds d with a score > 0 (pad lanes, doc 0
// past lane 0, sort last).
__device__ __forceinline__ bool find_staged(const int* first, const int* sd,
                                            const float* ss, int b0, int b1,
                                            int d, int* blk, float* sc) {
  int lo = b0, hi = b1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= d) lo = mid + 1; else hi = mid;
  }
  const int b = lo - 1;
  if (b < b0) return false;
  const int* row = sd + b * LANES;
  int l = 0, h = LANES;
  while (l < h) {
    const int m = (l + h) >> 1;
    const int doc = row[m];
    const int key = (m > 0 && doc == 0) ? INT32_MAX : doc;
    if (key < d) l = m + 1; else h = m;
  }
  if (l == LANES || row[l] != d) return false;
  const float s = ss[b * LANES + l];
  if (!(s > 0.f)) return false;
  *blk = b;
  *sc = s;
  return true;
}

// The same two searches over a run's positions [a, e) in global memory
// (a run outside the staged chunk): true with d's position and its lane's
// score when the run holds d with a score > 0.
__device__ __noinline__ bool find_global(const int* qb, const int* bd,
                                         const float* bs, int a, int e, int d,
                                         int* pos, float* sc) {
  int lo = a, hi = e;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(bd + (long long)__ldg(qb + mid) * LANES) <= d) lo = mid + 1;
    else hi = mid;
  }
  const int p = lo - 1;
  if (p < a) return false;
  const long long blk = (long long)__ldg(qb + p) * LANES;
  const int* row = bd + blk;
  int l = 0, h = LANES;
  while (l < h) {
    const int m = (l + h) >> 1;
    const int doc = __ldg(row + m);
    const int key = (m > 0 && doc == 0) ? INT32_MAX : doc;
    if (key < d) l = m + 1; else h = m;
  }
  if (l == LANES || __ldg(row + l) != d) return false;
  const float s = __ldg(bs + blk + l);
  if (!(s > 0.f)) return false;
  *pos = p;
  *sc = s;
  return true;
}

// A doc's verdict from its total `acc` and, in bool mode, its runs' must
// flags `cnt`, by the mode's rule (above): whether it is a candidate, and
// its value.
template <int MODE>
__device__ __forceinline__ bool judge(const Args& g, const uint8_t* lv,
                                      long long drow, int q, int d, float acc,
                                      float cnt, float* val) {
  if (MODE == 2) {
    *val = __fadd_rn(acc, __ldg(g.addend + drow + d));
    const float cov = __fadd_rn(cnt, __ldg(g.hp + drow + d));
    return lv[d] && fabsf(__fsub_rn(cov, __ldg(g.nm + q))) < 0.5f &&
           *val > 0.f;
  }
  const bool ok = acc > 0.f && lv[d];
  *val = MODE == 1 && ok ? __fadd_rn(acc, __ldg(g.addend + drow + d)) : acc;
  return ok;
}

// ---- top-k selection -------------------------------------------------------
//
// Both selections are fed by every thread of the block in the same
// iteration (offer), each thread with at most one candidate, and write the
// block's best k ranked, pads (-inf, pad) (finish).

// k <= 32: each warp's sorted list in registers, lane i its i-th best.
struct WarpTopK {
  float v;
  int d;
  int k;

  __device__ void init(int kk) {
    v = -INFINITY;
    d = INT32_MAX;
    k = kk;
  }

  __device__ void offer(float cv, int cd, bool has) {
    const int lane = threadIdx.x & 31;
    float tv = __shfl_sync(FULL, v, k - 1);
    int td = __shfl_sync(FULL, d, k - 1);
    unsigned m = __ballot_sync(FULL, has && better(cv, cd, tv, td));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float xv = __shfl_sync(FULL, cv, src);
      const int xd = __shfl_sync(FULL, cd, src);
      tv = __shfl_sync(FULL, v, k - 1);
      td = __shfl_sync(FULL, d, k - 1);
      if (!better(xv, xd, tv, td)) continue;
      // the entries x beats are a suffix of the list, from lane pos
      const int pos = __ffs(__ballot_sync(FULL, better(xv, xd, v, d))) - 1;
      const float uv = __shfl_up_sync(FULL, v, 1);
      const int ud = __shfl_up_sync(FULL, d, 1);
      if (lane > pos) {
        v = uv;
        d = ud;
      } else if (lane == pos) {
        v = xv;
        d = xd;
      }
    }
  }

  // fv / fd: WARPS * 32 entries of shared memory
  __device__ void finish(float* fv, int* fd, float* os, int* od, int pad) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    fv[threadIdx.x] = v;
    fd[threadIdx.x] = d;
    __syncthreads();
    if (warp == 0) {
      for (int i = 32 + lane; i < WARPS * 32; i += 32) {
        const bool has = (i & 31) < k && fd[i] != INT32_MAX;
        offer(fv[i], fd[i], has);
      }
      if (lane < k) {
        const bool has = d != INT32_MAX;
        os[lane] = has ? v : -INFINITY;
        od[lane] = has ? d : pad;
      }
    }
  }
};

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

// k > 32: a shared buffer of cap (>= k + THREADS) entries; a candidate
// enters while fewer than k are kept or when it beats the k-th, and a full
// buffer is sorted down to its best k, which raises the bar.
struct BufferTopK {
  float* cv;
  int* cd;
  int k, cap;
  int* count;
  int* n_top;
  float* thr_v;
  int* thr_d;

  __device__ void init() {
    if (threadIdx.x == 0) {
      *count = 0;
      *n_top = 0;
      *thr_v = -INFINITY;
      *thr_d = INT32_MAX;
    }
    __syncthreads();
  }

  __device__ void offer(float v, int d, bool has) {
    if (has && (*n_top < k || better(v, d, *thr_v, *thr_d))) {
      const int slot = atomicAdd(count, 1);
      cv[slot] = v;
      cd[slot] = d;
    }
    __syncthreads();
    if (*count + THREADS > cap) {
      const int n = *count;
      bitonic(cv, cd, n, cap);
      if (threadIdx.x == 0) {
        *count = n < k ? n : k;
        *n_top = *count;
        if (*n_top == k) {
          *thr_v = cv[k - 1];
          *thr_d = cd[k - 1];
        }
      }
      __syncthreads();
    }
  }

  __device__ void finish(float* os, int* od, int pad) {
    const int n = *count;
    bitonic(cv, cd, n, cap);
    for (int i = threadIdx.x; i < k; i += THREADS) {
      const bool has = i < n;
      os[i] = has ? cv[i] : -INFINITY;
      od[i] = has ? cd[i] : pad;
    }
  }
};

// ---- pass 1: the tiles -----------------------------------------------------

template <int MODE, bool SMALL>  // MODE 0 lane, 1 hybrid, 2 bool
__global__ void __launch_bounds__(THREADS, 2) tile_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nb = g.nb;
  int* sdoc = reinterpret_cast<int*>(smem);            // [nb, LANES]
  float* ssc = reinterpret_cast<float*>(sdoc + nb * LANES);
  int* sfirst = reinterpret_cast<int*>(ssc + nb * LANES);   // [nb]
  float* sw = reinterpret_cast<float*>(sfirst + nb);
  float* sqf = sw + nb;
  int* srun = reinterpret_cast<int*>(sqf + nb);        // run in the chunk
  float* cv = reinterpret_cast<float*>(srun + nb);     // selection room
  int* cd = reinterpret_cast<int*>(cv + (SMALL ? THREADS : g.cap));

  // the chunk's run bounds, each run's first staged position and its
  // staged offsets (ends while they are searched)
  __shared__ int rs[RUN_CHUNK + 1], ra[RUN_CHUNK], roff[RUN_CHUNK + 1];
  __shared__ unsigned long long red[2 * WARPS];
  __shared__ int sh_m, sh_tiles, sh_lo, sh_hi, sh_total;
  __shared__ int b_count, b_ntop, b_thrd;
  __shared__ float b_thrv;
  __shared__ __align__(8) uint64_t bar;

  const int t = (int)(blockIdx.x % (unsigned)g.tiles);
  const long long row = blockIdx.x / (unsigned)g.tiles;   // s * Q + q
  const int q = (int)(row % g.Q), s = (int)(row / g.Q);
  const long long qrow = (long long)q * g.S + s;
  const int* ts = g.tstart + qrow * (g.R + 1);
  const int* qb = g.qblocks + qrow * g.B;
  const float* w = g.qw + qrow * g.B;
  const float* f = MODE == 2 ? g.qf + qrow * g.B : nullptr;
  const int* bd = g.docs + (long long)s * g.T * LANES;
  const float* bs = g.scores + (long long)s * g.T * LANES;
  const uint8_t* lv = g.live + (long long)s * g.D;
  const long long drow = row * g.D;
  const int C = g.tile_blocks;
  const int warp = threadIdx.x >> 5;

  // rows of more runs than a chunk (the chunked fallback): even cuts
  const bool even = g.R > RUN_CHUNK;
  row_tiles(ts, g.R, g.B, C, even, g.tiles, red, &sh_m, &sh_tiles);
  const int n_tiles = sh_tiles;
  if (t >= n_tiles) return;
  if (threadIdx.x == 0) {
    // the tile's docs: [first doc of the longest run's block t*C, first
    // doc of its block (t+1)*C), from 0 in the first tile to D in the
    // last; or [D * t / n_tiles, D * (t + 1) / n_tiles)
    const int a = run_bound(ts, sh_m, g.B) + t * C;
    sh_lo = even ? (int)((long long)g.D * t / n_tiles)
            : t == 0 ? 0
                     : __ldg(bd + (long long)__ldg(qb + a) * LANES);
    sh_hi = even ? (int)((long long)g.D * (t + 1) / n_tiles)
            : t == n_tiles - 1
                ? g.D
                : __ldg(bd + (long long)__ldg(qb + a + C) * LANES);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  WarpTopK wk;
  BufferTopK bk{cv, cd, g.k, g.cap, &b_count, &b_ntop, &b_thrv, &b_thrd};
  if (SMALL) wk.init(g.k); else bk.init();   // init syncs the block
  if (SMALL) __syncthreads();

  const int hi = sh_hi, m = sh_m;
  const int am = run_bound(ts, m, g.B) + t * C;
  const int lane = threadIdx.x & 31;
  uint32_t phase = 0;
  for (int c0 = 0; c0 < g.R; c0 += RUN_CHUNK) {
    // the chunk's runs [c0, c0 + nr); mc: the longest run's index in it
    // (whose first pass the cuts give), -1 for even cuts
    const int nr = min(g.R - c0, RUN_CHUNK), mc = even ? -1 : m - c0;
    for (int i = threadIdx.x; i <= nr; i += THREADS)
      rs[i] = run_bound(ts, c0 + i, g.B);
    __syncthreads();
    int plo = sh_lo;
    bool first_pass = true;
    while (plo < hi) {
      // a pass: docs [plo, phi) of the chunk's runs, halving phi until
      // they fit. First each run's start (its last block whose first doc
      // is <= plo) and end (its first block whose first doc is >= phi), a
      // warp a search, all at once; the first pass knows the longest
      // run's, the tile's C blocks [am, am + C).
      int phi = hi;
      for (int j = warp; j < 2 * nr; j += WARPS) {
        const int r = j >> 1, a = rs[r], e = max(rs[r + 1], a);
        if (j & 1) {
          const int x = phi >= g.D || e == a ? e
                        : first_pass && r == mc ? min(am + C, e)
                        : warp_ub(qb, bd, a, e, phi - 1);
          if (lane == 0) roff[r + 1] = x;
        } else {
          const int x = plo <= 0 || e == a ? a
                        : first_pass && r == mc ? am
                        : max(a, warp_ub(qb, bd, a, e, plo) - 1);
          if (lane == 0) ra[r] = x;
        }
      }
      __syncthreads();
      for (;;) {
        if (threadIdx.x == 0) {     // ends -> staged offsets
          int tot = 0;
          roff[0] = 0;
          for (int r = 0; r < nr; ++r) {
            tot += max(roff[r + 1] - ra[r], 0);
            roff[r + 1] = tot;
          }
          if (phi - plo <= 1 && tot > nb) {
            // unreachable for runs in doc order (a doc range of one doc
            // stages at most a block a run, and nr <= nb): keep the
            // staging in bounds whatever the input
            for (int r = 0; r < nr; ++r) roff[r + 1] = min(roff[r + 1], nb);
            tot = nb;
          }
          sh_total = tot;
        }
        __syncthreads();
        if (sh_total <= nb) break;
        phi = plo + (phi - plo) / 2;
        for (int r = warp; r < nr; r += WARPS) {
          const int e = max(rs[r + 1], rs[r]);
          const int x = ra[r] == e ? e : warp_ub(qb, bd, ra[r], e, phi - 1);
          if (lane == 0) roff[r + 1] = x;
        }
        __syncthreads();
      }
      first_pass = false;
      const int total = sh_total;
      if (total > 0) {
        if (threadIdx.x == 0) bar_expect(&bar, (uint32_t)total * BLOCK_BYTES);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int b = threadIdx.x; b < total; b += THREADS) {
          int r = 0;
          while (roff[r + 1] <= b) ++r;
          const int p = ra[r] + (b - roff[r]);
          const long long blk = (long long)__ldg(qb + p) * LANES;
          bulk_load(sdoc + b * LANES, bd + blk, LANES * 4, &bar);
          bulk_load(ssc + b * LANES, bs + blk, LANES * 4, &bar);
          sw[b] = __ldg(w + p);
          if (MODE == 2) sqf[b] = __ldg(f + p);
          srun[b] = r;
        }
        bar_wait(&bar, phase);
        phase ^= 1;
        for (int b = threadIdx.x; b < total; b += THREADS)
          sfirst[b] = sdoc[b * LANES];
        __syncthreads();
      }
      const int n_lanes = total * LANES;
      for (int base = 0; base < n_lanes; base += THREADS) {
        const int i = base + threadIdx.x;
        float val = 0.f;
        int d = 0;
        bool ok = false;
        if (i < n_lanes) {
          const int b = i / LANES;
          d = sdoc[i];
          const float sc = ssc[i];
          if (sc > 0.f && d >= plo && d < phi && d >= 0 && d < g.D) {
            const int r = c0 + srun[b];
            bool first = true;
            float acc = 0.f, cnt = 0.f;
            for (int u = 0; u < g.R; ++u) {
              if (u == r) {
                acc = __fadd_rn(acc, __fmul_rn(sw[b], sc));
                if (MODE == 2) cnt = __fadd_rn(cnt, sqf[b]);
                continue;
              }
              float wu, fu = 0.f, s2;
              const int uc = u - c0;
              if (uc >= 0 && uc < nr) {
                int b2;
                if (!find_staged(sfirst, sdoc, ssc, roff[uc], roff[uc + 1], d,
                                 &b2, &s2))
                  continue;
                wu = sw[b2];
                if (MODE == 2) fu = sqf[b2];
              } else {
                const int a = run_bound(ts, u, g.B);
                int p2;
                if (!find_global(qb, bd, bs, a,
                                 max(run_bound(ts, u + 1, g.B), a), d, &p2,
                                 &s2))
                  continue;
                wu = __ldg(w + p2);
                if (MODE == 2) fu = __ldg(f + p2);
              }
              if (u < r) {                // an earlier run holds d
                first = false;
                break;
              }
              acc = __fadd_rn(acc, __fmul_rn(wu, s2));
              if (MODE == 2) cnt = __fadd_rn(cnt, fu);
            }
            if (first) ok = judge<MODE>(g, lv, drow, q, d, acc, cnt, &val);
          }
        }
        if (SMALL) wk.offer(val, d, ok); else bk.offer(val, d, ok);
      }
      __syncthreads();   // the staged rows are read before the next pass
      plo = phi;
    }
    __syncthreads();     // rs is read before the next chunk's
  }

  float* os;
  int* od;
  int pad;
  if (g.tiles == 1) {
    os = g.out_s + row * g.k;
    od = g.out_d + row * g.k;
    pad = 0;
  } else {
    os = g.tile_s + (row * g.tiles + t) * g.k;
    od = g.tile_d + (row * g.tiles + t) * g.k;
    pad = -1;
  }
  if (SMALL) wk.finish(cv, cd, os, od, pad); else bk.finish(os, od, pad);
}

// ---- pass 1 for rows of many runs: the sorted tiles ------------------------
//
// A row of more runs than a pass stages (R > RUN_CHUNK) would have each
// lane look its doc up in every run. Instead a tile takes an even cut of
// [0, D) (row_tiles) in passes of at most g.lanes lanes: a run's lanes of
// the pass's doc range are one span of its blocks' lanes (a search a run,
// a thread a run: the tile's spans first, a pass's end then only within
// them), the spans are gathered into shared memory as keys (doc, run,
// slot) with the lane's w * score, sorted, and each doc's first key sums
// its values in run order.

// The first lane, as p * LANES + lane, of run positions [a, e) whose doc
// is >= x (pad lanes, doc 0 past lane 0, sort past every doc): the last
// block whose first doc is < x, then its lanes; a * LANES when none.
__device__ int lane_lb(const int* qb, const int* bd, int a, int e, int x) {
  int lo = a, hi = e;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(bd + (long long)__ldg(qb + mid) * LANES) < x) lo = mid + 1;
    else hi = mid;
  }
  const int p = lo - 1;
  if (p < a) return a * LANES;
  const int* row = bd + (long long)__ldg(qb + p) * LANES;
  int l = 0, h = LANES;
  while (l < h) {
    const int m = (l + h) >> 1;
    const int doc = __ldg(row + m);
    const int key = (m > 0 && doc == 0) ? INT32_MAX : doc;
    if (key < x) l = m + 1; else h = m;
  }
  return p * LANES + l;
}

// off[r] = the sum of max(hi[u] - lo[u], 0) over runs u < r, for r in
// [0, R] (off[R] the pass's lanes): each thread sums a segment of runs,
// the segments scanned across the block through wsum[WARPS]. Ends with the
// block synchronised.
__device__ void run_offsets(const int* lo, const int* hi, int* off, int R,
                            int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (R + THREADS - 1) / THREADS;
  const int r0 = min((int)threadIdx.x * per, R), r1 = min(r0 + per, R);
  int sum = 0;
  for (int r = r0; r < r1; ++r) sum += max(hi[r] - lo[r], 0);
  int inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < WARPS; ++i) {
      const int x = wsum[i];
      wsum[i] = acc;
      acc += x;
    }
    off[R] = acc;
  }
  __syncthreads();
  int at = wsum[warp] + inc - sum;
  for (int r = r0; r < r1; ++r) {
    off[r] = at;
    at += max(hi[r] - lo[r], 0);
  }
  __syncthreads();
}

// Sorts key[0, n) ascending, padded with ~0 to n2 (a power of two >= n).
__device__ void sort_keys(unsigned long long* key, int n, int n2) {
  for (int i = n + threadIdx.x; i < n2; i += blockDim.x) key[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n2 / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const unsigned long long a = key[i], b = key[j];
        if ((a > b) == ((i & size) == 0)) {
          key[i] = b;
          key[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <int MODE, bool SMALL>
__global__ void __launch_bounds__(THREADS, 2) sort_tile_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = g.lanes, R = g.R;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);
  float* val = reinterpret_cast<float*>(key + L);      // [L] w * score
  float* flg = val + L;                                 // [L] must flag
  int* lo = reinterpret_cast<int*>(flg + L);            // [R] the pass's
  int* hi = lo + R;                                     // [R] spans
  int* end = hi + R;                                    // [R] the tile's end
  int* off = end + R;                                   // [R + 1]
  float* cv = reinterpret_cast<float*>(off + R + 1);    // selection room
  int* cd = reinterpret_cast<int*>(cv + (SMALL ? THREADS : g.cap));

  __shared__ unsigned long long red[2 * WARPS];
  __shared__ int wsum[WARPS];
  __shared__ int sh_m, sh_tiles, sh_count;
  __shared__ int b_count, b_ntop, b_thrd;
  __shared__ float b_thrv;

  const int t = (int)(blockIdx.x % (unsigned)g.tiles);
  const long long row = blockIdx.x / (unsigned)g.tiles;   // s * Q + q
  const int q = (int)(row % g.Q), s = (int)(row / g.Q);
  const long long qrow = (long long)q * g.S + s;
  const int* ts = g.tstart + qrow * (R + 1);
  const int* qb = g.qblocks + qrow * g.B;
  const float* w = g.qw + qrow * g.B;
  const float* f = MODE == 2 ? g.qf + qrow * g.B : nullptr;
  const int* bd = g.docs + (long long)s * g.T * LANES;
  const float* bs = g.scores + (long long)s * g.T * LANES;
  const uint8_t* lv = g.live + (long long)s * g.D;
  const long long drow = row * g.D;

  row_tiles(ts, R, g.B, g.tile_blocks, true, g.tiles, red, &sh_m, &sh_tiles);
  const int n_tiles = sh_tiles;
  if (t >= n_tiles) return;
  // the tile's docs: [D * t / n_tiles, D * (t + 1) / n_tiles)
  const int tlo = (int)((long long)g.D * t / n_tiles);
  const int thi = (int)((long long)g.D * (t + 1) / n_tiles);

  WarpTopK wk;
  BufferTopK bk{cv, cd, g.k, g.cap, &b_count, &b_ntop, &b_thrv, &b_thrd};
  if (SMALL) wk.init(g.k); else bk.init();   // init syncs the block

  for (int r = threadIdx.x; r < R; r += THREADS) {
    const int a = run_bound(ts, r, g.B);
    const int e = max(run_bound(ts, r + 1, g.B), a);
    lo[r] = lane_lb(qb, bd, a, e, tlo);
    end[r] = lane_lb(qb, bd, a, e, thi);
  }
  int plo = tlo;
  while (plo < thi) {
    // a pass: docs [plo, phi), phi cut in proportion (to 7/8 of L) until
    // their spans hold at most L lanes (a one-doc range holds at most R <=
    // L real lanes); a span's end for phi in [plo, thi] lies in the
    // blocks of [lo, end]
    int phi = thi;
    for (int r = threadIdx.x; r < R; r += THREADS) hi[r] = end[r];
    __syncthreads();
    run_offsets(lo, hi, off, R, wsum);
    while (off[R] > L && phi - plo > 1) {
      const long long cut = (long long)(phi - plo) * (L - L / 8) / off[R];
      phi = plo + (int)(cut > 1 ? cut : 1);
      for (int r = threadIdx.x; r < R; r += THREADS) {
        const int a = run_bound(ts, r, g.B);
        hi[r] = lane_lb(qb, bd, lo[r] / LANES,
                        min(end[r] / LANES + 1,
                            max(run_bound(ts, r + 1, g.B), a)),
                        phi);
      }
      __syncthreads();
      run_offsets(lo, hi, off, R, wsum);
    }
    // more than L only for runs out of doc order: stay in bounds
    const int total = min(off[R], L);
    if (threadIdx.x == 0) sh_count = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += THREADS) {
      int l = 0, h = R;                  // the last run r with off[r] <= i
      while (h - l > 1) {
        const int mid = (l + h) >> 1;
        if (off[mid] <= i) l = mid; else h = mid;
      }
      const int at = lo[l] + (i - off[l]);
      const int p = at / LANES;
      const long long x = (long long)__ldg(qb + p) * LANES + at % LANES;
      const int d = __ldg(bd + x);
      const float sc = __ldg(bs + x);
      if (sc > 0.f && d >= plo && d < phi && d >= 0 && d < g.D) {
        const int slot = atomicAdd(&sh_count, 1);
        key[slot] = ((unsigned long long)(unsigned)d << 32) |
                    ((unsigned long long)l << 13) | (unsigned)slot;
        val[slot] = __fmul_rn(__ldg(w + p), sc);
        if (MODE == 2) flg[slot] = __ldg(f + p);
      }
    }
    __syncthreads();
    const int n = sh_count;
    int n2 = 1;
    while (n2 < n) n2 <<= 1;
    sort_keys(key, n, n2);
    for (int base = 0; base < n; base += THREADS) {
      const int j = base + threadIdx.x;
      float v = 0.f;
      int d = 0;
      bool ok = false;
      if (j < n) {
        d = (int)(key[j] >> 32);
        if (j == 0 || (int)(key[j - 1] >> 32) != d) {  // d's first run
          float acc = 0.f, cnt = 0.f;
          for (int u = j; u < n && (int)(key[u] >> 32) == d; ++u) {
            const int sl = (int)(key[u] & 8191u);
            acc = __fadd_rn(acc, val[sl]);
            if (MODE == 2) cnt = __fadd_rn(cnt, flg[sl]);
          }
          ok = judge<MODE>(g, lv, drow, q, d, acc, cnt, &v);
        }
      }
      if (SMALL) wk.offer(v, d, ok); else bk.offer(v, d, ok);
    }
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += THREADS) lo[r] = hi[r];
    plo = phi;
  }
  __syncthreads();

  float* os;
  int* od;
  int pad;
  if (g.tiles == 1) {
    os = g.out_s + row * g.k;
    od = g.out_d + row * g.k;
    pad = 0;
  } else {
    os = g.tile_s + (row * g.tiles + t) * g.k;
    od = g.tile_d + (row * g.tiles + t) * g.k;
    pad = -1;
  }
  if (SMALL) wk.finish(cv, cd, os, od, pad); else bk.finish(os, od, pad);
}

// ---- pass 2: each row's tiles ----------------------------------------------

template <bool SMALL>
__global__ void __launch_bounds__(THREADS) merge_kernel(const Args g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* cv = reinterpret_cast<float*>(smem);
  int* cd = reinterpret_cast<int*>(cv + (SMALL ? THREADS : g.cap));
  __shared__ unsigned long long red[2 * WARPS];
  __shared__ int sh_m, sh_tiles;
  __shared__ int b_count, b_ntop, b_thrd;
  __shared__ float b_thrv;

  const long long row = blockIdx.x;                    // s * Q + q
  const int q = (int)(row % g.Q), s = (int)(row / g.Q);
  const int* ts = g.tstart + ((long long)q * g.S + s) * (g.R + 1);
  row_tiles(ts, g.R, g.B, g.tile_blocks, g.R > RUN_CHUNK, g.tiles, red,
            &sh_m, &sh_tiles);
  WarpTopK wk;
  BufferTopK bk{cv, cd, g.k, g.cap, &b_count, &b_ntop, &b_thrv, &b_thrd};
  if (SMALL) wk.init(g.k); else bk.init();
  const int n = sh_tiles * g.k;
  const float* ps = g.tile_s + row * g.tiles * g.k;
  const int* pd = g.tile_d + row * g.tiles * g.k;
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + threadIdx.x;
    const float v = i < n ? ps[i] : -INFINITY;
    const int d = i < n ? pd[i] : -1;
    if (SMALL) wk.offer(v, d, d >= 0); else bk.offer(v, d, d >= 0);
  }
  if (SMALL) wk.finish(cv, cd, g.out_s + row * g.k, g.out_d + row * g.k, 0);
  else bk.finish(g.out_s + row * g.k, g.out_d + row * g.k, 0);
}

// ---- launch ----------------------------------------------------------------

constexpr int MAX_DEVICES = 64;
std::mutex mu;
bool configured[14][MAX_DEVICES];

// Raises a kernel's dynamic shared memory limit once per device (not on
// every launch, so a launch can be captured in a graph).
template <typename K>
cudaError_t configure(int slot, K kernel, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!configured[slot][dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    configured[slot][dev] = true;
  }
  return cudaSuccess;
}

template <int MODE, bool SMALL>
int launch(Args g, cudaStream_t st) {
  const int sel = SMALL ? THREADS * 8 : g.cap * 8;   // selection room
  const unsigned grid = (unsigned)((long long)g.tiles * g.Q * g.S);
  cudaError_t e;
  if (g.lanes > 0) {
    const size_t smem1 = (size_t)g.lanes * SORT_LANE_BYTES +
                         (size_t)(g.R + 1) * SORT_RUN_BYTES + sel;
    e = configure(8 + MODE * 2 + (SMALL ? 1 : 0),
                  sort_tile_kernel<MODE, SMALL>, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    sort_tile_kernel<MODE, SMALL><<<grid, THREADS, smem1, st>>>(g);
  } else {
    const size_t smem1 = (size_t)g.nb * (BLOCK_BYTES + META_BYTES) + sel;
    e = configure(MODE * 2 + (SMALL ? 1 : 0), tile_kernel<MODE, SMALL>,
                  SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    tile_kernel<MODE, SMALL><<<grid, THREADS, smem1, st>>>(g);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || g.tiles == 1) return (int)e;
  e = configure(6 + (SMALL ? 1 : 0), merge_kernel<SMALL>, BUF_MAX);
  if (e != cudaSuccess) return (int)e;
  merge_kernel<SMALL><<<(unsigned)(g.Q * g.S), THREADS, sel, st>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// The big-k buffer for a k: a power of two >= k + THREADS (k <= 32 keeps
// its candidates in registers and needs none).
extern "C" int es_lane_topk_cap(int k) {
  int cap = 512;
  while (cap < k + THREADS) cap <<= 1;
  return cap;
}

// mode 0 lane, 1 hybrid (addend), 2 bool (addend, qf, hp, nm). The
// caller's tiling (kernels.lane_topk_plan): tile_blocks, C, the blocks of a
// row's longest run a tile takes, and tiles, the grid's tiles a row, at
// least ceil(B / C) so that every row's tiles are in the grid; tile_s /
// tile_d: the [S, Q, tiles, k] scratch, null for one tile.
extern "C" int es_lane_topk(const void* docs, const void* scores,
                            const void* live, const void* qblocks,
                            const void* qw, const void* tstart,
                            const void* addend, const void* qf,
                            const void* hp, const void* nm, void* out_s,
                            void* out_d, void* tile_s, void* tile_d, int S,
                            int Q, long long T, int B, int R, int D, int k,
                            int tile_blocks, int tiles, int mode,
                            void* stream) {
  if (S <= 0 || Q <= 0) return 0;
  if (k <= 0 || R <= 0 || B < 0 || D < 0 || tile_blocks <= 0 || tiles <= 0 ||
      (long long)tiles * tile_blocks < B)
    return (int)cudaErrorInvalidValue;
  if ((mode >= 1 && !addend) || (mode == 2 && (!qf || !hp || !nm)))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)docs | (uintptr_t)scores) & 15)
    return (int)cudaErrorMisalignedAddress;
  const bool small = k <= SMALL_K;
  const int cap = es_lane_topk_cap(k);
  if (!small && cap * 8 > BUF_MAX) return (int)cudaErrorInvalidValue;
  const int sel = small ? THREADS * 8 : cap * 8;
  const int room = (SMEM_MAX - sel) / (BLOCK_BYTES + META_BYTES);
  const int nb = room < STAGE_BLOCKS ? room : STAGE_BLOCKS;
  const long long sort_smem = (long long)SORT_LANES * SORT_LANE_BYTES +
                              (long long)(R + 1) * SORT_RUN_BYTES + sel;
  const int lanes =
      R > RUN_CHUNK && R <= SORT_LANES && sort_smem <= SMEM_MAX ? SORT_LANES
                                                                : 0;
  if (nb < (R < RUN_CHUNK ? R : RUN_CHUNK) ||
      (tiles > 1 && (!tile_s || !tile_d)) ||
      (long long)tiles * Q * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args g{(const int*)docs,   (const float*)scores, (const uint8_t*)live,
               (const int*)qblocks, (const float*)qw,    (const int*)tstart,
               (const float*)addend, (const float*)qf,   (const float*)hp,
               (const float*)nm,   (float*)out_s,        (int*)out_d,
               (float*)tile_s,     (int*)tile_d,
               S, Q, B, R, D, k, cap, tiles, tile_blocks, nb, lanes, T};
  cudaStream_t st = (cudaStream_t)stream;
  if (small) {
    if (mode == 0) return launch<0, true>(g, st);
    if (mode == 1) return launch<1, true>(g, st);
    if (mode == 2) return launch<2, true>(g, st);
  } else {
    if (mode == 0) return launch<0, false>(g, st);
    if (mode == 1) return launch<1, false>(g, st);
    if (mode == 2) return launch<2, false>(g, st);
  }
  return (int)cudaErrorInvalidValue;
}
