// K8 agg_counts: masked segment counts for the device analytics tier,
// counts[q, s] = #{pairs (d, s) of a layout section : mask[q, d]}.
//
// Replaces _agg_counts of elasticsearch_tpu/parallel/kernels.py (:996,
// pallas_call :1007), behind agg_segment_counts (:1037) and
// agg_two_level_counts (:1057). The TPU kernel scattered each 128-pair row
// into a [128, 128] f32 tile accumulator as a one-hot outer product on the
// MXU (exact below 2^24). Here the scatter is a shared-memory histogram with
// integer adds, fed by run-length counts kept in registers.
//
// Layout of a section (the layout blob, see agg_device.py): doc[p], seg[p],
// ct0[p / 1024], ct1[p / 1024] (i32). A pair in 1024-pair chunk c counts iff
// 0 <= seg < n_segments, its bucket tile seg / 16384 lies in [ct0[c], ct1[c]]
// (pad chunks carry (1, 0); pad pairs carry bucket -1), 0 <= doc < n_docs
// (layouts never hold another doc; the test only keeps a bad one from
// reading outside the mask) and mask[q, doc] != 0.
//
// One C entry call per dispatch; it launches:
//
// 1. A pack of the [Q, n_docs] bool mask, read once and coalesced, into
//    words that the count gathers; its threads also zero the outputs, so
//    the entry writes every output entry and the caller need not fill
//    them. At Q = 1, pack_bits_kernel: one bit per
//    doc (1.25 MB at 10M docs), so a warp's gather of 32 consecutive pairs
//    of a bucket touches a sector per 256 docs instead of per 32. For Q > 1,
//    pack_kernel: one word per doc and group of 32 queries, bit q of
//    words[g][d] is mask[32g + q, d]; a word is 8 bits for Q <= 8, 16 for
//    Q <= 16, else 32 bits in ceil(Q / 32) groups (10, 20 or 40 MB per group
//    at 10M docs: one group's words stay in the 50 MB L2). The words are
//    scratch the wrapper allocates (agg_word_bytes).
// 2. count_kernel, once per group of 32 queries: a persistent grid (as many
//    blocks as fit on the 132 SMs) over the concatenated chunks of both
//    sections; each block takes one contiguous run of chunks. Per section part
//    of its run the block zeroes a shared [Qg, W] u32 histogram, its threads
//    count, and it adds each nonzero bin to the output (zeroed by the pack)
//    with one global atomicAdd: a block pays that once per run, not once per 8
//    chunks. Each lane takes 4 pairs a step, 32 apart, so each load and each
//    word gather of a warp covers 32 consecutive pairs (on a terms layout,
//    docs ascending within a bucket: few sectors an instruction); it gathers
//    each counted pair's word and counts in registers while the bucket stays
//    the same; at a change of bucket it adds its run to the histogram, one
//    shared atomicAdd per query with a nonzero count. At Q = 1 the run count
//    is one integer; for Q > 1 it is 8 bit-sliced carry-save planes over the
//    word (bit i of plane j: bit j of query i's count; a run is flushed at 255
//    pairs). A lane's run carries across steps and chunk boundaries: on a
//    terms layout (pairs grouped by bucket) a lane flushes about once per
//    bucket it meets, with no __match_any_sync and no per-pair shared atomic.
//    On a doc-ordered layout (the hour ranks of a date field) a run is one
//    selected pair, so the kernel makes one shared atomic per selected pair
//    and query, and reads the words in doc order.
//
// The histogram's budget: W = min(n_segments, HIST_BINS / Qg) buckets per
// query, HIST_BINS = 57344 u32 (224 KB). n_segments <= W, as for every
// layout at every Q <= 32 where Qg * n_segments <= 57344 (256 tag buckets at
// any Q; 2,161 hour ranks up to Q = 26), takes one pass: the layout's pairs
// are read once per count launch, so once per launch for every Q <= 32 and
// once per group of 32 queries beyond. Otherwise the buckets are split into
// ceil(n_segments / W) sub-tiles, each a further pass over the block's pairs
// (chunks whose tile range misses the sub-tile are skipped): 2 passes for
// 2,161 ranks at Q = 32 and for 60,000 buckets at Q = 1. es_agg_plan
// reports this plan (groups, W and passes) as the launch makes it.
//
// Bit-exactness: integer adds commute, so any order gives the plain
// version's counts.
//
// What bounds it on the H100: bytes — each section's pairs (8 bytes each)
// once, the mask once (Q x n_docs bytes) and the outputs; the packed words
// stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int GRAN = 1024;            // pairs per chunk
constexpr int TILE_SHIFT = 14;        // 16384 buckets per tile
constexpr int PPL = 4;                // pairs per lane per step
constexpr int MAX_THREADS = 1024;
constexpr int PLANES = 8;             // carry-save planes: runs of <= 255
constexpr int RUN_MAX = (1 << PLANES) - 1;
constexpr int HIST_BINS = 57344;      // 224 KB of u32 bins
constexpr int GROUP = 32;             // queries per word group
constexpr int PACK_THREADS = 256;

struct Section {
  const int32_t* doc;                 // [p]
  const int32_t* seg;                 // [p]
  const int32_t* ct0;                 // [nc]
  const int32_t* ct1;                 // [nc]
  int32_t* out;                       // [Q, n_segments], zeroed by the pack
  int nc;                             // chunks
};

struct CountArgs {
  const void* words;                  // [n_docs] words of this group
  int n_docs;
  Section s0, s1;
  int n_sections;
  int n_segments;
  int qg;                             // queries of this group (bits used)
  int q0;                             // the group's first output row
  int width;                          // W: histogram buckets per query
  int passes;                         // ceil(n_segments / W)
};

// One lane's open run: its bucket and its count (ONE) or carry-save planes.
template <bool ONE>
struct Run {
  int bucket = -1;
  uint32_t n = 0;                     // pairs in the run
  uint32_t seen = 0;                  // queries with a nonzero count
  uint32_t plane[ONE ? 1 : PLANES] = {};

  __device__ __forceinline__ void flush(uint32_t* hist, int width, int b0) {
    if (n == 0) return;
    const int rel = bucket - b0;
    if (ONE) {
      atomicAdd(&hist[rel], n);
    } else {
      uint32_t m = seen;
      while (m) {
        const int q = __ffs(m) - 1;
        m &= m - 1;
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < PLANES; ++i) v |= ((plane[i] >> q) & 1u) << i;
        atomicAdd(&hist[q * width + rel], v);
      }
#pragma unroll
      for (int i = 0; i < (ONE ? 1 : PLANES); ++i) plane[i] = 0;
      seen = 0;
    }
    n = 0;
  }

  __device__ __forceinline__ void add(uint32_t w, int b, uint32_t* hist,
                                      int width, int b0) {
    if (b != bucket) {
      flush(hist, width, b0);
      bucket = b;
    }
    if (!ONE) {
      uint32_t carry = w;
#pragma unroll
      for (int i = 0; i < (ONE ? 1 : PLANES); ++i) {
        const uint32_t t = plane[i] & carry;
        plane[i] ^= carry;
        carry = t;
      }
      seen |= w;
    }
    if (++n == (ONE ? 0xffffffffu : (uint32_t)RUN_MAX)) flush(hist, width, b0);
  }
};

// The block's chunks [lo, hi) of one section, for buckets [b0, b0 + wlen).
template <typename WordT, bool ONE>
__device__ void count_part(const CountArgs& a, const Section& s, int lo,
                           int hi, int b0, int wlen, uint32_t* hist) {
  const WordT* __restrict__ words = static_cast<const WordT*>(a.words);
  const int tlo = b0 >> TILE_SHIFT, thi = (b0 + wlen - 1) >> TILE_SHIFT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t step = (int64_t)blockDim.x * PPL;
  const int64_t end = (int64_t)hi * GRAN;
  Run<ONE> run;
  // a warp's 32 * PPL pairs lie in one chunk (32 * PPL divides GRAN): the
  // chunk test and the loop bound are uniform in the warp
  for (int64_t base = (int64_t)lo * GRAN + warp * (32 * PPL) + lane;
       base < end; base += step) {
    const int c = (int)(base / GRAN);
    const int t0 = __ldg(s.ct0 + c), t1 = __ldg(s.ct1 + c);
    if (max(t0, tlo) > min(t1, thi)) continue;
    int d[PPL], g[PPL];
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      d[j] = __ldcs(s.doc + base + 32 * j);
      g[j] = __ldcs(s.seg + base + 32 * j);
    }
    uint32_t w[PPL];
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      const int t = g[j] >> TILE_SHIFT;
      const bool ok = (unsigned)(g[j] - b0) < (unsigned)wlen && t >= t0 &&
                      t <= t1 && (unsigned)d[j] < (unsigned)a.n_docs;
      if (ONE)                        // doc bits: 32 docs a word
        w[j] = ok ? (__ldg(words + (d[j] >> 5)) >> (d[j] & 31)) & 1u : 0u;
      else
        w[j] = ok ? (uint32_t)__ldg(words + d[j]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < PPL; ++j)
      if (w[j]) run.add(w[j], g[j], hist, wlen, b0);
  }
  run.flush(hist, wlen, b0);
}

template <typename WordT, bool ONE>
__global__ void __launch_bounds__(MAX_THREADS)
count_kernel(CountArgs a) {
  extern __shared__ uint32_t hist[];  // [qg, wlen]
  const int64_t nc = (int64_t)a.s0.nc + (a.n_sections > 1 ? a.s1.nc : 0);
  const int c_begin = (int)(nc * blockIdx.x / gridDim.x);
  const int c_end = (int)(nc * (blockIdx.x + 1) / gridDim.x);
  for (int pass = 0; pass < a.passes; ++pass) {
    const int b0 = pass * a.width;
    const int wlen = min(a.width, a.n_segments - b0);
    const int bins = a.qg * wlen;
    int cbase = 0;
    for (int si = 0; si < a.n_sections; ++si) {
      const Section& s = si ? a.s1 : a.s0;
      const int lo = max(c_begin, cbase) - cbase;
      const int hi = min(c_end, cbase + s.nc) - cbase;
      cbase += s.nc;
      if (lo >= hi) continue;         // uniform in the block
      for (int i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0;
      __syncthreads();
      count_part<WordT, ONE>(a, s, lo, hi, b0, wlen, hist);
      __syncthreads();
      for (int i = threadIdx.x; i < bins; i += blockDim.x) {
        const uint32_t v = hist[i];
        if (v) {
          const int q = i / wlen;
          atomicAdd(&s.out[(int64_t)(a.q0 + q) * a.n_segments + b0 +
                           (i - q * wlen)], (int)v);
        }
      }
      __syncthreads();                // the next part zeroes hist again
    }
  }
}

// The pack's threads zero the n_out output counts first (the count kernel,
// next on the stream, adds into them).
__device__ __forceinline__ void zero_outputs(int32_t* out, int64_t n_out) {
  const int64_t n = (int64_t)gridDim.x * gridDim.y * blockDim.x;
  for (int64_t i = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) *
                       blockDim.x + threadIdx.x;
       i < n_out; i += n)
    out[i] = 0;
}

// 4 docs a thread: bit q of the word of doc d is mask[q0 + q, d]. A bool
// byte is 0 or 1, so (x & 0x01010101) << (q % 8) puts query q's bit of four
// docs into four bytes at once; byte permutes transpose them into words.
template <typename WordT>
__global__ void __launch_bounds__(PACK_THREADS)
pack_kernel(const uint8_t* __restrict__ mask, int n_docs, int q,
            void* words, int64_t stride, int32_t* counts, int64_t n_counts) {
  constexpr int QW = 8 * sizeof(WordT);
  zero_outputs(counts, n_counts);
  const int64_t d4 = ((int64_t)blockIdx.x * PACK_THREADS + threadIdx.x) * 4;
  if (d4 >= stride) return;
  const int q0 = blockIdx.y * GROUP;
  const int qg = min(QW, q - q0);
  const bool fast = (n_docs & 3) == 0 &&
                    ((uintptr_t)mask & 3) == 0 && d4 + 4 <= n_docs;
  uint32_t acc[QW / 8] = {};
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    if (j < qg) {
      const uint8_t* row = mask + (int64_t)(q0 + j) * n_docs + d4;
      uint32_t x;
      if (fast) {
        x = __ldcs(reinterpret_cast<const unsigned int*>(row));
      } else {
        x = 0;
        for (int b = 0; b < 4; ++b)
          if (d4 + b < n_docs) x |= (uint32_t)row[b] << (8 * b);
      }
      acc[j >> 3] |= (x & 0x01010101u) << (j & 7);
    }
  }
  WordT* out = static_cast<WordT*>(words) + blockIdx.y * stride + d4;
  if (QW == 8) {
    *reinterpret_cast<uint32_t*>(out) = acc[0];
  } else if (QW == 16) {
    *reinterpret_cast<uint2*>(out) = make_uint2(
        __byte_perm(acc[0], acc[QW / 8 - 1], 0x5140),
        __byte_perm(acc[0], acc[QW / 8 - 1], 0x7362));
  } else {
    const uint32_t t0 = __byte_perm(acc[0], acc[1 % (QW / 8)], 0x5140);
    const uint32_t t1 = __byte_perm(acc[0], acc[1 % (QW / 8)], 0x7362);
    const uint32_t t2 = __byte_perm(acc[2 % (QW / 8)], acc[QW / 8 - 1],
                                    0x5140);
    const uint32_t t3 = __byte_perm(acc[2 % (QW / 8)], acc[QW / 8 - 1],
                                    0x7362);
    *reinterpret_cast<uint4*>(out) = make_uint4(
        __byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
        __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
  }
}

// Q = 1: bit j of bits[w] is mask[0, 32w + j]. A thread packs one word
// from 32 bool bytes: (x & 0x01010101) * 0x01020408 >> 24 gathers four
// bytes' low bits into a nibble.
__global__ void __launch_bounds__(PACK_THREADS)
pack_bits_kernel(const uint8_t* __restrict__ mask, int n_docs,
                 uint32_t* __restrict__ bits, int32_t* counts,
                 int64_t n_counts) {
  zero_outputs(counts, n_counts);
  const int w = blockIdx.x * PACK_THREADS + threadIdx.x;
  const int64_t d0 = (int64_t)w * 32;
  if (d0 >= n_docs) return;
  uint32_t x[8];
  if (d0 + 32 <= n_docs && ((uintptr_t)mask & 15) == 0) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(mask + d0));
    const uint4 b = __ldcs(reinterpret_cast<const uint4*>(mask + d0 + 16));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    for (int i = 0; i < 8; ++i) {
      x[i] = 0;
      for (int b = 0; b < 4; ++b)
        if (d0 + 4 * i + b < n_docs)
          x[i] |= (uint32_t)mask[d0 + 4 * i + b] << (8 * b);
    }
  }
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    word |= (((x[i] & 0x01010101u) * 0x01020408u) >> 24) << (4 * i);
  bits[w] = word;
}

int word_bytes(int q) { return q <= 1 ? 0 : q <= 8 ? 1 : q <= 16 ? 2 : 4; }

int64_t words_stride(long long n_docs) { return (n_docs + 3) / 4 * 4; }

int word_groups(int q) {
  return word_bytes(q) == 4 ? (q + GROUP - 1) / GROUP : 1;
}

// The histogram plan of word group g: its queries, W and passes.
struct Plan {
  int qg, width, passes;
};

Plan group_plan(int q, int g, int n_segments) {
  Plan p;
  p.qg = q - g * GROUP < GROUP ? q - g * GROUP : GROUP;
  p.width = n_segments < HIST_BINS / p.qg ? n_segments : HIST_BINS / p.qg;
  p.passes = (n_segments + p.width - 1) / p.width;
  return p;
}

// Per-device launch state: cudaFuncSetAttribute applies to the current
// device, and the occupancy plan depends on it. Guarded by mu.
constexpr int MAX_DEVICES = 64;
constexpr int MAX_PLANS = 16;
struct DeviceState {
  int sms = 0;
  uint32_t attr = 0;                  // bit i: instantiation i's attribute
  int plans = 0;
  int plan_smem[MAX_PLANS], plan_threads[MAX_PLANS], plan_per_sm[MAX_PLANS];
  const void* plan_fn[MAX_PLANS];
};
std::mutex mu;
DeviceState devices[MAX_DEVICES];

// threads a block and blocks an SM for fn at smem bytes on the current
// device: 512 threads a block; 1024 where the histogram leaves room for one
// block an SM only. The attribute is set once per device and instantiation,
// the plan asked of the occupancy calculator once per device and histogram
// size (a layout's n_segments and a rung's Qg).
template <typename WordT, bool ONE>
cudaError_t launch_plan(int smem, int bit, int* threads, int* per_sm,
                        int* sms) {
  const void* fn = (const void*)count_kernel<WordT, ONE>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  DeviceState& d = devices[dev];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *sms = d.sms;
  if (!(d.attr >> bit & 1u)) {
    err = cudaFuncSetAttribute(count_kernel<WordT, ONE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               HIST_BINS * (int)sizeof(uint32_t));
    if (err != cudaSuccess) return err;
    d.attr |= 1u << bit;
  }
  for (int i = 0; i < d.plans; ++i)
    if (d.plan_fn[i] == fn && d.plan_smem[i] == smem) {
      *threads = d.plan_threads[i];
      *per_sm = d.plan_per_sm[i];
      return cudaSuccess;
    }
  *threads = 512;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, count_kernel<WordT, ONE>, *threads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm <= 1) {
    *threads = MAX_THREADS;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, count_kernel<WordT, ONE>, *threads, smem);
    if (err != cudaSuccess) return err;
  }
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  const int slot = d.plans < MAX_PLANS ? d.plans++ : MAX_PLANS - 1;
  d.plan_fn[slot] = fn;
  d.plan_smem[slot] = smem;
  d.plan_threads[slot] = *threads;
  d.plan_per_sm[slot] = *per_sm;
  return cudaSuccess;
}

template <typename WordT, bool ONE>
int launch_count(const CountArgs& a, int bit, cudaStream_t stream) {
  const int smem = a.qg * a.width * (int)sizeof(uint32_t);
  int threads = 0, per_sm = 0, sms = 0;
  const cudaError_t err =
      launch_plan<WordT, ONE>(smem, bit, &threads, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const int64_t nc = (int64_t)a.s0.nc + (a.n_sections > 1 ? a.s1.nc : 0);
  const int64_t slots = (int64_t)per_sm * sms;
  const int grid = (int)(nc < slots ? nc : slots);
  count_kernel<WordT, ONE><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename WordT>
int launch_words(const uint8_t* mask, int n_docs, int q, void* words,
                 int64_t n_out, CountArgs a, int bit, cudaStream_t stream) {
  const int64_t stride = words_stride(n_docs);
  const int groups = word_groups(q);
  const dim3 grid((unsigned)((stride / 4 + PACK_THREADS - 1) / PACK_THREADS),
                  groups);
  pack_kernel<WordT><<<grid, PACK_THREADS, 0, stream>>>(
      mask, n_docs, q, words, stride, a.s0.out, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int g = 0; g < groups; ++g) {
    const Plan p = group_plan(q, g, a.n_segments);
    a.words = static_cast<const WordT*>(words) + g * stride;
    a.q0 = g * GROUP;
    a.qg = p.qg;
    a.width = p.width;
    a.passes = p.passes;
    const int rc = launch_count<WordT, false>(a, bit, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

Section make_section(const int32_t* blob, long long off, int p,
                     int32_t* out) {
  Section s;
  const int nc = p / GRAN;
  s.doc = blob + off;
  s.seg = s.doc + p;
  s.ct0 = s.seg + p;
  s.ct1 = s.ct0 + nc;
  s.out = out;
  s.nc = nc;
  return s;
}

}  // namespace

// Bytes of the word scratch es_agg_counts needs for q queries over n_docs
// docs.
extern "C" long long es_agg_word_bytes(int q, long long n_docs) {
  if (q <= 1) return (n_docs + 31) / 32 * 4;
  return (long long)word_groups(q) * words_stride(n_docs) * word_bytes(q);
}

// The histogram plan es_agg_counts makes for q queries over n_segments
// buckets: plan[0] word groups (count launches), plan[1] W and plan[2]
// passes of the first group (the largest), plan[3] passes over the pairs
// summed over the groups. Launches nothing.
extern "C" int es_agg_plan(int q, int n_segments, int* plan) {
  if (q <= 0 || n_segments <= 0) return (int)cudaErrorInvalidValue;
  const int groups = word_groups(q);
  const Plan first = group_plan(q, 0, n_segments);
  int reads = 0;
  for (int g = 0; g < groups; ++g)
    reads += group_plan(q, g, n_segments).passes;
  plan[0] = groups;
  plan[1] = first.width;
  plan[2] = first.passes;
  plan[3] = reads;
  return 0;
}

// One dispatch over n_sections (1 or 2) sections of a layout blob; section
// k starts at blob + off_k, holds p_k pairs (a multiple of 1024) and counts
// into out[k] of out [n_sections, q, n_segments] i32, which the entry
// zeroes first (every entry is written). words is scratch of words_bytes
// >= es_agg_word_bytes(q, n_docs) bytes, 16-byte aligned.
extern "C" int es_agg_counts(const void* mask, long long n_docs, int q,
                             void* words, long long words_bytes,
                             const void* blob, long long off0, int p0,
                             long long off1, int p1, int n_sections,
                             int n_segments, void* out, void* stream) {
  if (q <= 0 || n_segments <= 0 || n_docs <= 0 || n_sections < 1 ||
      n_sections > 2)
    return (int)cudaErrorInvalidValue;
  if (n_docs > 0x7fffffffLL || words_bytes < es_agg_word_bytes(q, n_docs) ||
      (words_bytes > 0 && ((uintptr_t)words & 15)))
    return (int)cudaErrorInvalidValue;
  const int32_t* b = (const int32_t*)blob;
  int32_t* o = (int32_t*)out;
  const int64_t per_section = (int64_t)q * n_segments;
  CountArgs a;
  a.n_docs = (int)n_docs;
  a.s0 = make_section(b, off0, p0, o);
  a.s1 = n_sections > 1 ? make_section(b, off1, p1, o + per_section) : a.s0;
  a.n_sections = n_sections;
  a.n_segments = n_segments;
  const int64_t n_out = per_section * n_sections;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  switch (word_bytes(q)) {
    case 0: {
      const Plan p = group_plan(1, 0, n_segments);
      a.q0 = 0;
      a.qg = 1;
      a.width = p.width;
      a.passes = p.passes;
      const int n_words = (int)((n_docs + 31) / 32);
      pack_bits_kernel<<<(n_words + PACK_THREADS - 1) / PACK_THREADS,
                         PACK_THREADS, 0, s>>>(m, (int)n_docs,
                                               (uint32_t*)words, o, n_out);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      a.words = words;
      return launch_count<uint32_t, true>(a, 0, s);
    }
    case 1:
      return launch_words<uint8_t>(m, (int)n_docs, q, words, n_out, a, 1, s);
    case 2:
      return launch_words<uint16_t>(m, (int)n_docs, q, words, n_out, a, 2, s);
    default:
      return launch_words<uint32_t>(m, (int)n_docs, q, words, n_out, a, 3, s);
  }
}
