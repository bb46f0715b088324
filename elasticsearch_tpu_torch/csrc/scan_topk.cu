// scan_topk: fused scan + top-k + exact match count, for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticsearch_tpu/ops/kernels.py
// `_scan_topk_kernel` (launched by `_scan_topk_pallas`, public `scan_topk`).
// Per query row it computes
//
//   dots   = q[r] . mat_t[:, n]          (matmul mode; plain f32 mul + add)
//          | scores[r, n]                (streamed mode)
//   s      = transform(dots)             (identity / cosine / dot_product /
//                                         l2_norm / max_inner_product)
//   s      = live[n] ? s : -inf;  count_positive: s = s > 0 ? s : -inf
//   total  = #(s > 0) | #live
//
// and returns the top k lanes by (score desc, docid asc), k <= 128.
//
// Design. The TPU grid runs in order on one core and carries the running
// top-k in VMEM from one doc tile to the next. Here blocks run in parallel,
// so the work is split in two passes, whose selection code and 64-bit
// (score, docid) order key live in topk_select.cuh:
//   pass 1  one block per (row, or row tile in matmul mode; doc span):
//           computes the lane scores and keeps the span's k best keys by a
//           threshold filter (a lane is staged only if it beats the k-th key
//           kept so far; the few staged are folded in by a small sort), and
//           the span's int32 match count. The span count is chosen from the
//           shape: about SPAN_BLOCKS blocks in all, so a long span per row
//           at B=512 (one block per row) and still >= 132 blocks at B=1;
//   pass 2  one block per row: the same filter over the spans' candidates,
//           and the integer sum of their counts.
// The top k of distinct keys is one set whatever order lanes arrive in, so
// the result does not depend on the filter's order or the atomics'.
//
// Arithmetic. Built with --fmad=false: every product and sum rounds on its
// own, in the order the PyTorch twin (`scan_topk_reference`) spells out:
// dot products sum d = 0 .. D-1 from 0.0, then the transform in the JAX
// package's operation order. The kernel and its twin therefore agree bit for
// bit. No tensor cores: TF32 is not f32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
//   streamed  B*N*4 + N*5 bytes (scores, live, aux_doc when the transform
//             reads it; N*1 otherwise) -> memory bound; at B=512, N=1M
//             0.61 ms. Scores are read with 16-byte loads (a scalar edge
//             where a row is not 16-byte aligned), neighbouring threads on
//             neighbouring addresses; live and aux_doc stay in L2.
//   matmul    2*B*D*N f32 operations on CUDA cores against the D*N*4 bytes
//             of mat_t -> operation bound above B ~ 17. Each pass-1 block
//             holds ROWS query rows over a span of chunks, so mat_t is read
//             ceil(B / ROWS) times; the row tiles of one span are adjacent
//             in launch order so those reads mostly hit L2.

#include "topk_select.cuh"

namespace {

constexpr int ROWS = 8;            // query rows per pass-1 block (matmul)
constexpr int DT = 64;             // q columns staged per step (matmul)
constexpr int SPAN_BLOCKS = 264;   // pass-1 blocks aimed at (2 per SM)
constexpr int VPT = 8;             // streamed lanes per thread per step
constexpr int STEP = SEL_THREADS * VPT;

// four consecutive floats of the flat scores at g (a multiple of 4); lanes
// past `total` read 0 and are masked by the caller
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long g, long long total,
                                        bool vec) {
  if (vec && g + 3 < total) return __ldg(reinterpret_cast<const float4*>(p + g));
  float4 v;
  v.x = g < total ? __ldg(p + g) : 0.0f;
  v.y = g + 1 < total ? __ldg(p + g + 1) : 0.0f;
  v.z = g + 2 < total ? __ldg(p + g + 2) : 0.0f;
  v.w = g + 3 < total ? __ldg(p + g + 3) : 0.0f;
  return v;
}

__global__ void __launch_bounds__(SEL_THREADS)
scan_streamed_kernel(const float* __restrict__ scores,
                     const uint8_t* __restrict__ live,
                     const float* __restrict__ aux_doc,
                     const float* __restrict__ aux_q, int B, long long N,
                     long long span, int nspans, int k, int transform,
                     int count_positive, unsigned long long* __restrict__ cand,
                     int* __restrict__ partial) {
  __shared__ SelRow row;
  __shared__ SelStage st;
  __shared__ int scratch[32];
  const int r = blockIdx.x % B;
  const int sp = blockIdx.x / B;
  const long long s0 = static_cast<long long>(sp) * span;
  const long long s1 = min(N, s0 + span);
  const long long off = static_cast<long long>(r) * N;  // the row in flat scores
  const long long total = static_cast<long long>(B) * N;
  const bool vec = (reinterpret_cast<uintptr_t>(scores) & 15) == 0;
  const float auxq = aux_q != nullptr ? aux_q[r] : 0.0f;
  if (threadIdx.x == 0) {
    sel_init(&row);
    st.n = 0;
  }
  __syncthreads();
  int cnt = 0;
  int staged = 0;  // an upper bound of st.n, the same in every thread
  for (long long g0 = (off + s0) & ~3ll; g0 < off + s1; g0 += STEP) {
    if (staged + STEP > SEL_CAP - MAX_K) {
      sel_fold(&row, &st, k);
      staged = 0;
    }
    const unsigned long long thr = row.thr;
    float4 v[VPT / 4];
#pragma unroll
    for (int j = 0; j < VPT / 4; ++j)
      v[j] = load4(scores, g0 + 4 * (j * SEL_THREADS + threadIdx.x), total, vec);
#pragma unroll
    for (int j = 0; j < VPT / 4; ++j) {
      const long long n0 = g0 + 4 * (j * SEL_THREADS + threadIdx.x) - off;
      const float f[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long n = n0 + e;
        const unsigned long long key =
            n >= s0 ? lane_key(f[e], n, s1, transform, count_positive, live,
                               aux_doc, auxq, &cnt)
                    : 0ull;
        sel_push(key, thr, &st);
      }
    }
    staged += STEP;
  }
  sel_fold(&row, &st, k);
  sel_emit(&row, cnt, scratch, k, static_cast<long long>(r) * nspans + sp,
           cand, partial);
}

__global__ void __launch_bounds__(THREADS)
scan_matmul_kernel(const float* __restrict__ q, const float* __restrict__ mat,
                   const uint8_t* __restrict__ live,
                   const float* __restrict__ aux_doc,
                   const float* __restrict__ aux_q, int B, int D, long long N,
                   int chunks_per_span, int nspans, int k, int transform,
                   int count_positive, unsigned long long* __restrict__ cand,
                   int* __restrict__ partial) {
  __shared__ SelRow rows[ROWS];
  __shared__ SelStage st;
  __shared__ int scratch[32];
  __shared__ float qs[ROWS][DT];
  const int ntiles = (B + ROWS - 1) / ROWS;
  const int rt = blockIdx.x % ntiles;  // row tiles of one span are adjacent
  const int sp = blockIdx.x / ntiles;
  const int r0 = rt * ROWS;
  const int nchunks = static_cast<int>((N + CHUNK - 1) / CHUNK);
  const int c0 = sp * chunks_per_span;
  const int c1 = min(nchunks, c0 + chunks_per_span);
  if (threadIdx.x < ROWS) sel_init(&rows[threadIdx.x]);
  if (threadIdx.x == 0) st.n = 0;
  int cnt[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) cnt[i] = 0;

  for (int c = c0; c < c1; ++c) {
    const long long base = static_cast<long long>(c) * CHUNK;
    float acc[ROWS][EPT];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += DT) {
      const int dn = min(DT, D - d0);
      __syncthreads();
      for (int t = threadIdx.x; t < ROWS * DT; t += THREADS) {
        const int i = t / DT;
        const int dd = t % DT;
        qs[i][dd] = (r0 + i < B && dd < dn)
                        ? q[static_cast<long long>(r0 + i) * D + d0 + dd]
                        : 0.0f;
      }
      __syncthreads();
      for (int dd = 0; dd < dn; ++dd) {
        const float* mrow = mat + static_cast<long long>(d0 + dd) * N;
        float m[EPT];
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const long long n = base + e * THREADS + threadIdx.x;
          m[e] = n < N ? mrow[n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float qv = qs[i][dd];
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[i][e] = acc[i][e] + qv * m[e];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = r0 + i;
      if (r >= B) break;  // uniform across the block
      const float auxq = aux_q != nullptr ? aux_q[r] : 0.0f;
      __syncthreads();  // rows[i] as the last fold left it
      unsigned long long thr = rows[i].thr;
      int staged = 0;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        if (staged + THREADS > SEL_CAP - MAX_K) {
          sel_fold(&rows[i], &st, k);
          thr = rows[i].thr;
          staged = 0;
        }
        sel_push(lane_key(acc[i][e], base + e * THREADS + threadIdx.x, N,
                          transform, count_positive, live, aux_doc, auxq,
                          &cnt[i]),
                 thr, &st);
        staged += THREADS;
      }
      sel_fold(&rows[i], &st, k);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    if (r >= B) break;  // uniform across the block
    sel_emit(&rows[i], cnt[i], scratch, k,
             static_cast<long long>(r) * nspans + sp, cand, partial);
  }
}

__global__ void __launch_bounds__(SEL_THREADS)
scan_merge_kernel(const unsigned long long* __restrict__ cand,
                  const int* __restrict__ partial, int nspans, int k,
                  float* __restrict__ out_v, int* __restrict__ out_i,
                  int* __restrict__ out_t) {
  select_merge_row(cand, partial, nspans, k, out_v, out_i, out_t);
}

// the pass-1 geometry: -> spans per row; *span_len: docs per span
// (streamed) or chunks per span (matmul)
int spans_for(int B, long long N, int matmul, long long* span_len) {
  const long long units = matmul ? (N + CHUNK - 1) / CHUNK : (N + STEP - 1) / STEP;
  const int groups = matmul ? (B + ROWS - 1) / ROWS : B;
  long long want = (SPAN_BLOCKS + groups - 1) / groups;
  if (want > units) want = units;
  if (want < 1) want = 1;
  const long long per = (units + want - 1) / want;  // units per span
  *span_len = matmul ? per : per * STEP;
  return static_cast<int>((units + per - 1) / per);
}

}  // namespace

extern "C" {

// pass-1 spans per row, for the size of the cand/partial scratch
int scan_topk_spans(int B, long long N, int matmul) {
  long long len;
  return spans_for(B, N, matmul, &len);
}

// q == nullptr selects streamed mode (mat = scores [B, N]); otherwise
// mat = mat_t [D, N]. aux_doc / aux_q may be nullptr, read as zeros.
// cand: [B, nspans, k] u64 scratch; partial: [B, nspans] i32 scratch, with
// nspans = scan_topk_spans(B, N, q != nullptr). Returns cudaGetLastError()
// after the launches.
int scan_topk_launch(const float* q, const float* mat, const uint8_t* live,
                     const float* aux_doc, const float* aux_q, int B, int D,
                     long long N, int k, int transform, int count_positive,
                     unsigned long long* cand, int* partial, float* out_v,
                     int* out_i, int* out_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long len;
  const int nspans = spans_for(B, N, q != nullptr, &len);
  if (q == nullptr) {
    scan_streamed_kernel<<<nspans * B, SEL_THREADS, 0, st>>>(
        mat, live, aux_doc, aux_q, B, N, len, nspans, k, transform,
        count_positive, cand, partial);
  } else {
    const int ntiles = (B + ROWS - 1) / ROWS;
    scan_matmul_kernel<<<nspans * ntiles, THREADS, 0, st>>>(
        q, mat, live, aux_doc, aux_q, B, D, N, static_cast<int>(len), nspans,
        k, transform, count_positive, cand, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_merge_kernel<<<B, SEL_THREADS, 0, st>>>(cand, partial, nspans, k,
                                               out_v, out_i, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
