// K9 knn_int8_window_topc: the quantized kNN first pass. For every query and
// 2048-doc window, every doc's optimistic score from its exact int8 dot, and
// the window's top KNN_CANDW docs by (score desc, row asc).
//
// Replaces the Pallas kernel of elasticsearch_tpu/parallel/kernels.py
// knn_int8_window_topc (:1153, pallas_call :1210, body _knn_pass_kernel
// :1092), which ran one grid step per window: one [QC, dimsP] x [dimsP, 2048]
// int8 MXU product for all queries, the epilogue on the [QC, 2048] tile, and
// a 32-pass max cascade over it.
//
// Design: two kernels per chunk of windows, both launched from the one C
// entry. The wrapper sizes the chunk (cw windows) by a scratch budget for
// the chunk's [S, cw, QC, 2048] f32 scores, and for each chunk:
//
// * Pass A, knn_score_pass, is a tiled int8 GEMM with the epilogue fused in.
//   A block owns BM = 128 queries x BN = 128 docs of one window; 4 warps of
//   64 x 64 each run mma.sync m16n8k32 s8 x s8 -> s32, two blocks an SM. The query tile and
//   the doc rows (stored doc-major, so a row's k bytes are contiguous) move
//   through a ring of shared-memory stages by cp.async.cg, 128 bytes of k a
//   stage (three stages; two in the masked variant, whose filter tile takes
//   the room). Odd tile rows swap the halves of their 128 bytes, so the
//   16-byte fragment reads of a quarter warp hit all 32 banks once. Within a
//   64-byte k step the logical k order is a fixed permutation of the
//   physical bytes (thread t of an mma group holds bytes 16t..16t+15 and
//   feeds .x/.y to one mma and .z/.w to the next), the same for queries and
//   rows, which an exact integer sum does not see. The grid's x axis is the
//   query tile, so the query tiles of one doc tile run side by side and the
//   second reads the rows from L2. The epilogue reads the doc tile's meta
//   from shared memory (and, masked, the filter bytes of the tile, copied
//   coalesced), writes the score or -inf into a shared f32 tile that reuses
//   the ring, and the tile leaves for the scratch as whole 512-byte rows. A
//   block whose queries all skip the window writes -inf without the product.
// * Pass B, knn_select_pass, is one warp per (partition, window, query). Each
//   lane holds 64 of the window's 2048 scores in registers. The 32nd largest
//   of the lanes' top-2 scores (a 64-element warp bitonic sort) bounds the
//   32nd best from below, and on continuous scores about 36 docs lie at or
//   above it. Each lane marks its own in a bitmask and lists their docs in
//   shared memory after the lanes below it (a prefix sum, no per-value
//   ballot). With at most 64 listed, one bitonic sort of (score key << 32 |
//   ~doc) gives lane k the rank-k doc; with more (ties), 32 warp-wide argmax
//   passes (redux.sync on the key, then on the doc) run over the list, or
//   over the whole row once it passes CAP.
//
// Why it is bitwise equal to the plain version: the int32 dots are exact in
// any k order, the epilogue runs the same float operations on the same
// inputs, and the selection returns the same (score desc, row asc) top 32:
// the score key orders as the floats do (-0 as +0, as they compare), and
// every doc at or above the 32nd best is listed. The epilogue is the
// reference's in the order XLA on the CPU compiles it, fused multiply-adds
// included (ROADMAP W11):
//   slack = fma(q5, row_l1, q1*scale); slack = fma(q2*0.0079, nrm, slack)
//   e     = fma(f32(dot), scale*sq, slack*1.05)
//   cosine      fma(e + 1e-6, q4, 1) * 0.5
//   dot_product (e + f32(1 + 1e-6)) * 0.5
//   l2_norm     1 / (1 + sqrt(max(fma(nrm, nrm, q3) - 2*(e + 1e-6), 0)))
// written with __fmaf_rn / __fmul_rn / __fadd_rn so nvcc contracts nothing
// else. A doc counts only if okf > 0, its window is active for the query
// (act > 0) and, in the masked variant, fmask > 0; otherwise it is -inf.
//
// What bounds it on the H100: at QC = 256 over 2M 768-d rows the rows are
// 1.5 GB read once from device memory (0.46 ms at 3.35 TB/s) against 0.40 ms
// of int8 tensor-core work, so bytes. This design moves more: the query
// tile is re-read per 128 docs and the rows once per query tile (about
// 3 KB a doc from L2), the scores go out and back (2 GB at QC 256), and the
// register-fed mma.sync reads its fragments from shared memory (about
// 12 GB at QC 256). Pass B is bound by
// its own instructions per (query, window). wgmma, which reads its operands
// from shared memory itself, is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W = 2048;            // docs per window
constexpr int CANDW = 32;          // candidates kept per (query, window)
constexpr int KSTEP = 64;          // bytes of k per mma pair

// pass A
constexpr int BM = 128;            // queries per block tile
constexpr int BN = 128;            // docs per block tile
constexpr int WM = 64;             // queries per warp
constexpr int WN = 64;             // docs per warp
constexpr int WARPS_M = BM / WM;   // warps along queries
constexpr int WARPS_N = BN / WN;   // warps along docs
constexpr int A_THREADS = WARPS_M * WARPS_N * 32;
constexpr int MT = WM / 16;        // mma m-tiles per warp
constexpr int NT = WN / 8;         // mma n-tiles per warp
constexpr int KSTAGE = 128;        // bytes of k per pipeline stage
constexpr int CPR = KSTAGE / 16;   // 16-byte chunks per tile row
constexpr int STAGES = 3;          // cp.async ring depth (unmasked)
constexpr int STAGES_MASKED = 2;   // leaves room for the filter tile
constexpr int STAGE_BYTES = (BM + BN) * KSTAGE;
constexpr int MROW = BN + 16;      // filter tile row stride (spreads banks)
constexpr int OROW = BN + 8;       // f32 score tile row stride (spreads banks)

// Bytes of the stage ring, which the score tile reuses after the k loop;
// the filter tile follows it.
__host__ __device__ constexpr int ring_bytes(bool masked) {
  return (masked ? STAGES_MASKED : STAGES) * STAGE_BYTES > BM * OROW * 4
             ? (masked ? STAGES_MASKED : STAGES) * STAGE_BYTES
             : BM * OROW * 4;
}
constexpr int TILES_PER_WINDOW = W / BN;

// pass B
constexpr int B_WARPS = 4;
constexpr int CAP = 512;           // listed candidates per warp

enum Sim { COSINE = 0, DOT_PRODUCT = 1, L2_NORM = 2 };

__device__ __forceinline__ float vat(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A 32-bit key whose unsigned order is the float order of scores (-0 taken
// as +0, as the float comparison takes it); 0 is below every score.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Bitonic sort of 64 values, descending, across a warp: x[r] of lane l is
// element r * 32 + l. The partners of steps below 32 sit in other lanes.
template <typename T>
__device__ __forceinline__ void sort64_desc(T (&x)[2], int lane) {
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {       // k == 64: the lower element keeps the larger
        const T hi = x[0] > x[1] ? x[0] : x[1];
        x[1] = x[0] > x[1] ? x[1] : x[0];
        x[0] = hi;
        continue;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r * 32 + lane;
        const T p = __shfl_xor_sync(0xffffffffu, x[r], j);
        const bool keep_max = ((i & k) == 0) == ((i & j) == 0);
        x[r] = keep_max ? (x[r] > p ? x[r] : p) : (x[r] < p ? x[r] : p);
      }
    }
  }
}

// Where chunk c of tile row r lies: with 128-byte rows, odd rows swap their
// halves, so the 8 lanes of a quarter warp, reading 16 bytes of two
// neighbouring rows at the same k, hit all 32 banks once.
__device__ __forceinline__ int chunk_at(int r, int c) {
  static_assert(CPR == 8, "the swizzle is for 128-byte rows");
  return c ^ ((r & 1) << 2);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int SIM>
__device__ __forceinline__ float epilogue(int dot, float scale, float row_l1,
                                          float nrm, const float* qm) {
  float slack = __fmaf_rn(qm[5], row_l1, __fmul_rn(qm[1], scale));
  slack = __fmaf_rn(__fmul_rn(qm[2], (float)0.0079), nrm, slack);
  const float e = __fmaf_rn(__int2float_rn(dot), __fmul_rn(scale, qm[0]),
                            __fmul_rn(slack, (float)1.05));
  if (SIM == COSINE) {
    return __fmul_rn(__fmaf_rn(__fadd_rn(e, (float)1e-6), qm[4], 1.0f), 0.5f);
  }
  if (SIM == DOT_PRODUCT) {
    return __fmul_rn(__fadd_rn(e, __fadd_rn(1.0f, (float)1e-6)), 0.5f);
  }
  float d2 = __fsub_rn(__fmaf_rn(nrm, nrm, qm[3]),
                       __fmul_rn(2.0f, __fadd_rn(e, (float)1e-6)));
  d2 = d2 > 0.0f ? d2 : 0.0f;
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, __fsqrt_rn(d2)));
}

// One stage (two 64-byte k steps) of a warp's 64 x 64 tile from the stage
// at sa (queries) and sb (docs). FULL: every m-tile of the warp holds
// queries; otherwise the m-tiles of padding rows are skipped, a branch kept
// out of the full path.
template <bool FULL>
__device__ __forceinline__ void mma_stage(const int8_t* sa, const int8_t* sb,
                                          int (&acc)[MT][NT][4], int wm,
                                          int wn, int g, int t, int nq) {
#pragma unroll
  for (int kk = 0; kk < KSTAGE / KSTEP; ++kk) {
    const int c = kk * 4 + t;      // this thread's 16-byte k chunk
    int4 b[NT];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int n = wn * WN + ni * 8 + g;
      b[ni] = *reinterpret_cast<const int4*>(sb + n * KSTAGE +
                                             chunk_at(n, c) * 16);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m = wm * WM + mi * 16 + g;   // rows m and m + 8: same parity
      if (!FULL && m - g >= nq) continue;
      const int off = chunk_at(m, c) * 16;
      const int4 a0 = *reinterpret_cast<const int4*>(sa + m * KSTAGE + off);
      const int4 a1 =
          *reinterpret_cast<const int4*>(sa + (m + 8) * KSTAGE + off);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        mma_s8(acc[mi][ni], a0.x, a1.x, a0.y, a1.y, b[ni].x, b[ni].y);
        mma_s8(acc[mi][ni], a0.z, a1.z, a0.w, a1.w, b[ni].z, b[ni].w);
      }
    }
  }
}

// Pass A. grid (ceil(QC / BM), chunk windows * W / BN, partitions); the
// chunk starts at window w0, and scratch holds cw windows per partition.
template <int SIM, bool MASKED>
__global__ void __launch_bounds__(A_THREADS, 2)
knn_score_pass(const int8_t* __restrict__ qi8, const float* __restrict__ qmeta,
               const int8_t* __restrict__ q8, const float* __restrict__ meta,
               const float* __restrict__ act,
               const int8_t* __restrict__ fmask, float* __restrict__ scratch,
               int qc, int dims_p, int nw, int w0, int cw) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_tiles = reinterpret_cast<int8_t*>(smem);   // [stages][BM+BN][128]
  float* s_out = reinterpret_cast<float*>(smem);        // [BM][OROW], after
  int8_t* s_mask = s_tiles + ring_bytes(MASKED);        // [BM][MROW]
  __shared__ float s_qm[BM][8];
  __shared__ float s_act[BM];
  __shared__ float s_meta[4][BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BM;
  const int dl0 = blockIdx.y * BN;       // first doc of the tile in the chunk
  const int p = blockIdx.z;
  const int wl = dl0 / W;                // window within the chunk
  const int w = w0 + wl;
  const int d0 = dl0 % W;                // first doc of the tile in its window
  const int nq = min(BM, qc - q0);
  float* out = scratch + (((int64_t)p * cw + wl) * qc + q0) * W + d0;

  float my_act = 0.f;
  if (tid < BM) {
    my_act = tid < nq ? act[((int64_t)p * qc + q0 + tid) * nw + w] : 0.f;
    s_act[tid] = my_act;
  }
  if (!__syncthreads_or(my_act > 0.f)) {
    // no query of the tile probes this window
    const float4 ninf = make_float4(-INFINITY, -INFINITY, -INFINITY,
                                    -INFINITY);
    for (int i = tid; i < nq * (BN / 4); i += A_THREADS) {
      const int r = i / (BN / 4), c = i % (BN / 4);
      *reinterpret_cast<float4*>(out + (int64_t)r * W + c * 4) = ninf;
    }
    return;
  }

  if (MASKED) {   // joins the first stage's copy group
    for (int i = tid; i < nq * (BN / 16); i += A_THREADS) {
      const int r = i / (BN / 16), c = i % (BN / 16);
      cp_async16(s_mask + r * MROW + c * 16,
                 fmask + (((int64_t)p * qc + q0 + r) * nw + w) * W + d0 +
                     c * 16,
                 16);
    }
  }

  const int8_t* rows = q8 + (((int64_t)p * nw + w0) * W + dl0) * dims_p;
  constexpr int NSTAGE = MASKED ? STAGES_MASKED : STAGES;
  const int nk = (dims_p + KSTAGE - 1) / KSTAGE;
  auto load_stage = [&](int buf, int ks) {
    int8_t* sa = s_tiles + buf * STAGE_BYTES;
    int8_t* sb = sa + BM * KSTAGE;
    const int kb = ks * KSTAGE;
    // k past dimsP (a 64-byte tail) and rows past QC are zeros
#pragma unroll
    for (int i = tid; i < BM * CPR; i += A_THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = r < nq && kb + c * 16 < dims_p;
      cp_async16(sa + r * KSTAGE + chunk_at(r, c) * 16,
                 ok ? qi8 + (int64_t)(q0 + r) * dims_p + kb + c * 16 : qi8,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = tid; i < BN * CPR; i += A_THREADS) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = kb + c * 16 < dims_p;
      cp_async16(sb + r * KSTAGE + chunk_at(r, c) * 16,
                 ok ? rows + (int64_t)r * dims_p + kb + c * 16 : rows,
                 ok ? 16 : 0);
    }
  };

  const int wm = warp / WARPS_N;  // warp's 64 queries
  const int wn = warp % WARPS_N;  // warp's 64 docs
  const int g = lane >> 2;        // mma group: query g / g + 8, doc g of a tile
  const int t = lane & 3;         // thread in group: its 16-byte k slice
  const bool full = wm * WM + WM <= nq;   // warp-uniform
  int acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  // the per-query values and the doc tile's meta, while the stages land
  for (int i = tid; i < BM * 8; i += A_THREADS) {
    const int r = i >> 3;
    s_qm[r][i & 7] = r < nq ? qmeta[(int64_t)(q0 + r) * 8 + (i & 7)] : 0.f;
  }
  for (int i = tid; i < 4 * BN; i += A_THREADS) {
    const int c = i / BN, d = i % BN;
    s_meta[c][d] = meta[(((int64_t)p * 4 + c) * nw + w) * W + d0 + d];
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();       // stage ks landed; stage ks - 1 is free again
    const int nx = ks + NSTAGE - 1;
    if (nx < nk) load_stage(nx % NSTAGE, nx);
    cp_async_commit();

    const int8_t* sa = s_tiles + (ks % NSTAGE) * STAGE_BYTES;
    if (full) {
      mma_stage<true>(sa, sa + BM * KSTAGE, acc, wm, wn, g, t, nq);
    } else {
      mma_stage<false>(sa, sa + BM * KSTAGE, acc, wm, wn, g, t, nq);
    }
  }
  cp_async_wait<0>();
  __syncthreads();         // the ring is free; the filter tile landed

  // accumulator c0,c1: query g, docs 2t, 2t+1 of the n-tile; c2,c3: g + 8
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = wm * WM + mi * 16 + g + 8 * h;
      if (q >= nq) continue;
      const float* qm = s_qm[q];
      const bool qa = s_act[q] > 0.f;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int d = wn * WN + ni * 8 + t * 2;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bool ok = qa && s_meta[3][d + j] > 0.f;
          if (MASKED) ok = ok && s_mask[q * MROW + d + j] > 0;
          const float x = epilogue<SIM>(acc[mi][ni][h * 2 + j],
                                        s_meta[0][d + j], s_meta[1][d + j],
                                        s_meta[2][d + j], qm);
          v[j] = ok ? x : -INFINITY;
        }
        *reinterpret_cast<float2*>(s_out + q * OROW + d) =
            make_float2(v[0], v[1]);
      }
    }
  }
  __syncthreads();
  // each row of the tile leaves as whole 512-byte runs
  for (int r = warp; r < nq; r += A_THREADS / 32) {
#pragma unroll
    for (int c = lane; c < BN / 4; c += 32) {
      *reinterpret_cast<float4*>(out + (int64_t)r * W + c * 4) =
          *reinterpret_cast<const float4*>(s_out + r * OROW + c * 4);
    }
  }
}

// Pass B. grid (ceil(QC / B_WARPS), chunk windows, partitions); one warp
// per query selects the window's top CANDW from the chunk's scratch.
__global__ void __launch_bounds__(B_WARPS * 32)
knn_select_pass(float* scratch, float* __restrict__ out_s,
                int32_t* __restrict__ out_r, int qc, int nw, int w0, int cw) {
  __shared__ int s_ld[B_WARPS][CAP];     // the listed docs

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * B_WARPS + warp;
  const int wl = blockIdx.y;
  const int p = blockIdx.z;
  const int w = w0 + wl;
  if (q >= qc) return;
  float* row = scratch + (((int64_t)p * cw + wl) * qc + q) * W;

  // lane l holds docs 128 i + 4 l + j (i < 16, j < 4) in registers
  float4 v4[W / 128];
#pragma unroll
  for (int i = 0; i < W / 128; ++i) {
    v4[i] = reinterpret_cast<const float4*>(row)[i * 32 + lane];
  }
  // The threshold: the 32nd largest of the lanes' top-2 scores. Those are 64
  // distinct docs, so at least 32 docs are at or above it, and anything
  // below it is beaten by 32 of them; on continuous scores about 36 are at
  // or above it. -inf docs are never kept.
  float top2[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < W / 128; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = vat(v4[i], j);
      top2[1] = fmaxf(top2[1], fminf(top2[0], v));
      top2[0] = fmaxf(top2[0], v);
    }
  }
  sort64_desc(top2, lane);
  const float thr_v = __shfl_sync(0xffffffffu, top2[0], 31);
  // the docs at or above it, in any order (ties break on the doc itself):
  // each lane marks its own in a 64-bit mask over its values i * 4 + j and
  // lists their docs after the lanes below it
  unsigned long long mine = 0ull;
#pragma unroll
  for (int i = 0; i < W / 128; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = vat(v4[i], j);
      if (v >= thr_v && v > -INFINITY) mine |= 1ull << (i * 4 + j);
    }
  }
  const int cnt = __popcll(mine);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  const int base = __shfl_sync(0xffffffffu, incl, 31);
  int* ld = s_ld[warp];
  for (int at = incl - cnt; mine; mine &= mine - 1, ++at) {
    const int b = __ffsll(mine) - 1;
    if (at < CAP) ld[at] = (b >> 2) * 128 + lane * 4 + (b & 3);
  }
  __syncwarp();
  const unsigned kninf = order_key(-INFINITY);
  const int64_t o = (((int64_t)p * nw + w) * qc + q) * CANDW + lane;
  if (base <= 64) {
    // one sort of (key desc, doc asc) as a 64-bit key; lane k gets rank k
    unsigned long long kd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int at = r * 32 + lane;
      kd[r] = 0ull;
      if (at < base) {
        const int d = ld[at];
        kd[r] = ((unsigned long long)order_key(row[d]) << 32) |
                (0xffffffffu - (unsigned)d);
      }
    }
    sort64_desc(kd, lane);
    float v = -INFINITY;
    int r = 0;
    if ((unsigned)(kd[0] >> 32) > kninf) {
      const int d = (int)(0xffffffffu - (unsigned)kd[0]);
      v = row[d];
      r = d + w * W;
    }
    out_s[o] = v;
    out_r[o] = r;
    return;
  }

  // More than 64 (ties): 32 warp-wide argmax passes by (score desc, doc
  // asc) over the list, or, past CAP, over the whole row, in place in the
  // scratch, which no other warp reads. Each lane keeps
  // the best of its own items (list positions lane, lane + 32, ...); a pass
  // takes the largest key and then the smallest doc among lanes holding it
  // (two redux.sync), and only the lane that gave the winner rescans.
  const bool compact = base <= CAP;
  const int n_list = compact ? base : W;
  unsigned my_key;
  int my_d, my_pos;
  float my_v;
  auto rescan = [&]() {
    my_key = 0u;
    my_d = 0x7fffffff;
    my_pos = -1;
    my_v = -INFINITY;
    for (int i = lane; i < n_list; i += 32) {
      const int d = compact ? ld[i] : i;
      if (d < 0) continue;               // taken from the list
      const float v = row[d];
      const unsigned key = order_key(v);
      if (key > my_key || (key == my_key && d < my_d)) {
        my_key = key;
        my_d = d;
        my_pos = i;
        my_v = v;
      }
    }
  };
  rescan();
  float mine_v = -INFINITY;
  int mine_r = 0;
  for (int k = 0; k < CANDW; ++k) {
    const unsigned kmax = __reduce_max_sync(0xffffffffu, my_key);
    if (kmax <= kninf) break;           // the remaining slots stay empty
    const unsigned dmin = __reduce_min_sync(
        0xffffffffu, my_key == kmax ? (unsigned)my_d : 0xffffffffu);
    const bool won = my_key == kmax && (unsigned)my_d == dmin;
    const int src = __ffs(__ballot_sync(0xffffffffu, won)) - 1;
    const float v = __shfl_sync(0xffffffffu, my_v, src);
    if (lane == k) {
      mine_v = v;
      mine_r = (int)dmin + w * W;
    }
    if (won) {
      if (compact) {
        ld[my_pos] = -1;
      } else {
        row[my_pos] = -INFINITY;
      }
      rescan();
    }
    __syncwarp();
  }
  out_s[o] = mine_v;
  out_r[o] = mine_r;
}

template <int SIM, bool MASKED>
int launch(const void* qi8, const void* qmeta, const void* q8,
           const void* meta, const void* act, const void* fmask, void* out_s,
           void* out_r, void* scratch, int qc, int dims_p, int nw,
           int n_parts, int cw, void* stream) {
  const int smem_a = ring_bytes(MASKED) + (MASKED ? BM * MROW : 0);
  cudaError_t err = cudaFuncSetAttribute(
      knn_score_pass<SIM, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_a);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  for (int w0 = 0; w0 < nw; w0 += cw) {
    const int nwc = nw - w0 < cw ? nw - w0 : cw;
    dim3 grid_a((qc + BM - 1) / BM, nwc * TILES_PER_WINDOW, n_parts);
    knn_score_pass<SIM, MASKED><<<grid_a, A_THREADS, smem_a, s>>>(
        (const int8_t*)qi8, (const float*)qmeta, (const int8_t*)q8,
        (const float*)meta, (const float*)act, (const int8_t*)fmask,
        (float*)scratch, qc, dims_p, nw, w0, cw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid_b((qc + B_WARPS - 1) / B_WARPS, nwc, n_parts);
    knn_select_pass<<<grid_b, B_WARPS * 32, 0, s>>>(
        (float*)scratch, (float*)out_s, (int32_t*)out_r, qc, nw, w0,
        cw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// similarity: 0 cosine, 1 dot_product, 2 l2_norm; fmask may be null.
// scratch holds [n_parts, cw, qc, 2048] f32; the windows are taken cw at a
// time, and each chunk is one pass A and one pass B launch.
extern "C" int es_knn_int8_window_topc(const void* qi8, const void* qmeta,
                                       const void* q8, const void* meta,
                                       const void* act, const void* fmask,
                                       void* out_s, void* out_r,
                                       void* scratch, int qc, int dims_p,
                                       int nw, int n_parts, int similarity,
                                       int cw, void* stream) {
  if (qc <= 0 || nw <= 0 || n_parts <= 0) return 0;
  if (cw <= 0 || (int64_t)cw * TILES_PER_WINDOW > 65535 || n_parts > 65535 ||
      dims_p <= 0 || dims_p % KSTEP) {
    return (int)cudaErrorInvalidValue;
  }
  const bool masked = fmask != nullptr;
#define ES_KNN_LAUNCH(S, M)                                                  \
  return launch<S, M>(qi8, qmeta, q8, meta, act, fmask, out_s, out_r,       \
                      scratch, qc, dims_p, nw, n_parts, cw, stream)
  switch (similarity) {
    case COSINE:
      if (masked) ES_KNN_LAUNCH(COSINE, true);
      ES_KNN_LAUNCH(COSINE, false);
    case DOT_PRODUCT:
      if (masked) ES_KNN_LAUNCH(DOT_PRODUCT, true);
      ES_KNN_LAUNCH(DOT_PRODUCT, false);
    case L2_NORM:
      if (masked) ES_KNN_LAUNCH(L2_NORM, true);
      ES_KNN_LAUNCH(L2_NORM, false);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ES_KNN_LAUNCH
}
