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
// Design. One block per (16-query tile, window, partition); stacked
// partitions are the grid's z axis, so S partitions run in one launch. The
// int dots are tensor-core products, mma.sync m16n8k32 s8 x s8 -> s32: the
// 16 queries are the M side, read once per block from shared memory; rows
// are stored doc-major ([.., 2048, dimsP], each row's dims contiguous), so a
// thread reads 16 contiguous bytes of one doc row per 64-byte k step and
// feeds them to two mma. Within a k step the logical k order is a fixed
// permutation of the physical bytes, the same for queries and rows, which an
// exact integer sum does not see. Each of the 16 warps owns 128 docs, 32 at
// a time (4 mma n-tiles), and writes the epilogue's scores to a 16 x 2048
// f32 tile in shared memory. Then each warp selects one query's top 32: the
// smallest of its 32 lanes' maxima bounds the 32nd best from below, the
// docs at or above it (usually far fewer than 2048) are compacted into a
// list, and 32 warp-wide argmax passes over the list (over the whole row if
// the list overflows) pick (score desc, row asc).
//
// The epilogue is the reference's in the order XLA on the CPU compiles it,
// fused multiply-adds included (ROADMAP W11), so this kernel, the plain torch
// version and the reference agree bitwise:
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
// of int8 tensor-core work, so bytes. This first version re-reads a window's
// rows once per 16-query tile (from L2 while the window's tiles run side by
// side) and keeps one block per SM for its 128 KB score tile: simple and
// right first, fast in a later change.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W = 2048;            // docs per window
constexpr int CANDW = 32;          // candidates kept per (query, window)
constexpr int QT = 16;             // queries per block (the mma M side)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int DOCS_PER_WARP = W / WARPS;     // 128
constexpr int NT = 4;              // 8-doc mma n-tiles per warp step
constexpr int KSTEP = 64;          // bytes of k per step (two mma)
constexpr int QPAD = 64;           // query row padding in shared memory
constexpr int CAP = 128;           // compacted candidates per warp

enum Sim { COSINE = 0, DOT_PRODUCT = 1, L2_NORM = 2 };

struct Cand {
  float v;
  int d;      // doc within the window (unique per row)
  int pos;    // position in the list the warp selects from
};

// (v desc, doc asc)
__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.v > b.v || (a.v == b.v && a.d < b.d);
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Cand x;
    x.v = __shfl_xor_sync(0xffffffffu, c.v, o);
    x.d = __shfl_xor_sync(0xffffffffu, c.d, o);
    x.pos = __shfl_xor_sync(0xffffffffu, c.pos, o);
    if (better(x, c)) c = x;
  }
  return c;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

template <int SIM, bool MASKED>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const int8_t* __restrict__ qi8, const float* __restrict__ qmeta,
           const int8_t* __restrict__ q8, const float* __restrict__ meta,
           const float* __restrict__ act, const int8_t* __restrict__ fmask,
           float* __restrict__ out_s, int32_t* __restrict__ out_r,
           int qc, int dims_p, int nw) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_opt = reinterpret_cast<float*>(smem);                  // [QT][W]
  float* s_lv = s_opt + QT * W;                                   // [WARPS][CAP]
  int* s_ld = reinterpret_cast<int*>(s_lv + WARPS * CAP);         // [WARPS][CAP]
  int8_t* s_q = reinterpret_cast<int8_t*>(s_ld + WARPS * CAP);    // [QT][dims_p+QPAD]
  __shared__ float s_qm[QT][8];
  __shared__ float s_act[QT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int w = blockIdx.y;
  const int p = blockIdx.z;
  const int nq = min(QT, qc - q0);
  const int qstride = dims_p + QPAD;

  const int8_t* rows = q8 + ((int64_t)p * nw + w) * W * dims_p;
  const float* m = meta + (int64_t)p * 4 * nw * W;
  const float* m_scale = m + (int64_t)w * W;
  const float* m_l1 = m + ((int64_t)nw + w) * W;
  const float* m_nrm = m + ((int64_t)2 * nw + w) * W;
  const float* m_ok = m + ((int64_t)3 * nw + w) * W;

  // the query tile (rows past QC are zeros) and its per-query values
  for (int i = tid * 16; i < QT * dims_p; i += THREADS * 16) {
    const int r = i / dims_p, c = i % dims_p;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < nq) {
      v = *reinterpret_cast<const int4*>(qi8 + (int64_t)(q0 + r) * dims_p + c);
    }
    *reinterpret_cast<int4*>(s_q + r * qstride + c) = v;
  }
  if (tid < QT * 8) {
    const int r = tid >> 3;
    s_qm[r][tid & 7] = r < nq ? qmeta[(int64_t)(q0 + r) * 8 + (tid & 7)] : 0.f;
  }
  if (tid < QT) {
    s_act[tid] = tid < nq ? act[((int64_t)p * qc + q0 + tid) * nw + w] : 0.f;
  }
  __syncthreads();

  // ---- int8 products and the epilogue into s_opt ----
  const int g = lane >> 2;        // mma group: query g / g + 8, doc g of a tile
  const int t = lane & 3;         // thread in group: its 16-byte k slice
  const int8_t* arow0 = s_q + g * qstride + t * 16;
  const int8_t* arow1 = s_q + (g + 8) * qstride + t * 16;
  for (int step = 0; step < DOCS_PER_WARP / (8 * NT); ++step) {
    const int d0 = warp * DOCS_PER_WARP + step * 8 * NT;
    int acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
    }
    const int8_t* brow = rows + (int64_t)(d0 + g) * dims_p + t * 16;
#pragma unroll 2
    for (int kb = 0; kb < dims_p; kb += KSTEP) {
      const int4 a0 = *reinterpret_cast<const int4*>(arow0 + kb);
      const int4 a1 = *reinterpret_cast<const int4*>(arow1 + kb);
      int4 b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        b[n] = __ldg(reinterpret_cast<const int4*>(
            brow + (int64_t)n * 8 * dims_p + kb));
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_s8(acc[n], a0.x, a1.x, a0.y, a1.y, b[n].x, b[n].y);
        mma_s8(acc[n], a0.z, a1.z, a0.w, a1.w, b[n].z, b[n].w);
      }
    }
    // accumulator c0,c1: query g, docs 2t, 2t+1 of the tile; c2,c3: query g+8
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = d0 + n * 8 + t * 2 + j;
        const float scale = m_scale[d], row_l1 = m_l1[d], nrm = m_nrm[d];
        const bool live = m_ok[d] > 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = g + 8 * h;
          bool ok = live && q < nq && s_act[q] > 0.f;
          if (MASKED && ok) {
            ok = fmask[(((int64_t)p * qc + q0 + q) * nw + w) * W + d] > 0;
          }
          const float v =
              epilogue<SIM>(acc[n][h * 2 + j], scale, row_l1, nrm, s_qm[q]);
          s_opt[q * W + d] = ok ? v : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // ---- per query, the top CANDW by (score desc, doc asc) ----
  const int q = warp;
  if (q >= nq) return;
  float* row = s_opt + q * W;
  float lmax = -INFINITY;
  for (int d = lane; d < W; d += 32) lmax = fmaxf(lmax, row[d]);
  float thr = lmax;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    thr = fminf(thr, __shfl_xor_sync(0xffffffffu, thr, o));
  }
  // every lane's maximum is >= thr, so at least 32 docs are: anything below
  // thr is beaten by 32 of them. -inf docs are never kept.
  int cnt = 0;
  for (int d = lane; d < W; d += 32) {
    const float v = row[d];
    cnt += (v >= thr && v > -INFINITY) ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  float* lv = s_lv + warp * CAP;
  int* ld = s_ld + warp * CAP;
  int n_list;
  const bool compact = cnt <= CAP;
  if (compact) {
    int base = 0;
    for (int d0 = 0; d0 < W; d0 += 32) {
      const float v = row[d0 + lane];
      const bool take = v >= thr && v > -INFINITY;
      const unsigned bal = __ballot_sync(0xffffffffu, take);
      if (take) {
        const int at = base + __popc(bal & ((1u << lane) - 1u));
        lv[at] = v;
        ld[at] = d0 + lane;
      }
      base += __popc(bal);
    }
    n_list = base;
  } else {
    n_list = W;      // select over the whole row
  }
  __syncwarp();

  float mine_v = -INFINITY;
  int mine_r = 0;
  for (int k = 0; k < CANDW; ++k) {
    Cand c = {-INFINITY, 0x7fffffff, -1};
    for (int i = lane; i < n_list; i += 32) {
      const Cand x = {compact ? lv[i] : row[i], compact ? ld[i] : i, i};
      if (better(x, c)) c = x;
    }
    c = warp_best(c);
    if (!(c.v > -INFINITY)) break;       // the remaining slots stay empty
    if (lane == k) {
      mine_v = c.v;
      mine_r = c.d + w * W;
    }
    if (lane == 0) {
      if (compact) {
        lv[c.pos] = -INFINITY;
      } else {
        row[c.pos] = -INFINITY;
      }
    }
    __syncwarp();
  }
  const int64_t o = (((int64_t)p * nw + w) * qc + q0 + q) * CANDW + lane;
  out_s[o] = mine_v;
  out_r[o] = mine_r;
}

template <int SIM, bool MASKED>
int launch(const void* qi8, const void* qmeta, const void* q8,
           const void* meta, const void* act, const void* fmask, void* out_s,
           void* out_r, int qc, int dims_p, int nw, int n_parts,
           void* stream) {
  const int smem = QT * W * 4 + WARPS * CAP * 8 + QT * (dims_p + QPAD);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<SIM, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((qc + QT - 1) / QT, nw, n_parts);
  knn_kernel<SIM, MASKED><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)qi8, (const float*)qmeta, (const int8_t*)q8,
      (const float*)meta, (const float*)act, (const int8_t*)fmask,
      (float*)out_s, (int32_t*)out_r, qc, dims_p, nw);
  return (int)cudaGetLastError();
}

}  // namespace

// similarity: 0 cosine, 1 dot_product, 2 l2_norm; fmask may be null
extern "C" int es_knn_int8_window_topc(const void* qi8, const void* qmeta,
                                       const void* q8, const void* meta,
                                       const void* act, const void* fmask,
                                       void* out_s, void* out_r, int qc,
                                       int dims_p, int nw, int n_parts,
                                       int similarity, void* stream) {
  if (qc <= 0 || nw <= 0 || n_parts <= 0) return 0;
  const bool masked = fmask != nullptr;
#define ES_KNN_LAUNCH(S, M)                                                  \
  return launch<S, M>(qi8, qmeta, q8, meta, act, fmask, out_s, out_r, qc,   \
                      dims_p, nw, n_parts, stream)
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
