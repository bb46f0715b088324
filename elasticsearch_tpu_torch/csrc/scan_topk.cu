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
//   pass 1  one block per (row tile, chunk of CHUNK docs): computes the
//           lane scores, the chunk's int32 match count and its k best keys;
//   pass 2  one block per row: merges the chunks' candidates, sums counts.
//
// Arithmetic. Built with --fmad=false: every product and sum rounds on its
// own, in the order the PyTorch twin (`scan_topk_reference`) spells out:
// dot products sum d = 0 .. D-1 from 0.0, then the transform in the JAX
// package's operation order. The kernel and its twin therefore agree bit for
// bit. No tensor cores: TF32 is not f32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 on CUDA cores):
//   streamed  B*N*4 + N*5 bytes (scores, live, aux_doc when the transform
//             reads it; N*1 otherwise) -> memory bound; at B=1, N=1M about
//             1.5 us. This simple design pays a fixed cost of two launches
//             and the shared-memory sorts on top (several tens of us).
//   matmul    2*B*D*N f32 operations on CUDA cores against the D*N*4 bytes
//             of mat_t -> operation bound above B ~ 17. Each pass-1 block
//             holds ROWS query rows, so mat_t is read ceil(B / ROWS) times;
//             the blocks of one chunk are adjacent in launch order so those
//             reads mostly hit L2.

#include "topk_select.cuh"

namespace {

constexpr int ROWS = 8;                  // query rows per pass-1 block (matmul)
constexpr int DT = 64;                   // q columns staged per step (matmul)

__global__ void __launch_bounds__(THREADS)
scan_streamed_kernel(const float* __restrict__ scores,
                     const uint8_t* __restrict__ live,
                     const float* __restrict__ aux_doc,
                     const float* __restrict__ aux_q, int B, long long N,
                     int nchunks, int k, int transform, int count_positive,
                     unsigned long long* __restrict__ cand,
                     int* __restrict__ partial) {
  __shared__ unsigned long long keys[CHUNK];
  __shared__ int scratch[THREADS / 32];
  const int r = blockIdx.x % B;
  const int c = blockIdx.x / B;
  const long long base = static_cast<long long>(c) * CHUNK;
  const float* row = scores + static_cast<long long>(r) * N;
  const float auxq = aux_q != nullptr ? aux_q[r] : 0.0f;
  int cnt = 0;
  for (int e = 0; e < EPT; ++e) {
    const int lane = e * THREADS + threadIdx.x;
    const long long n = base + lane;
    const float dots = n < N ? row[n] : 0.0f;
    keys[lane] = lane_key(dots, n, N, transform, count_positive, live,
                          aux_doc, auxq, &cnt);
  }
  emit_chunk(keys, scratch, cnt, k, static_cast<long long>(r) * nchunks + c,
             cand, partial);
}

__global__ void __launch_bounds__(THREADS)
scan_matmul_kernel(const float* __restrict__ q, const float* __restrict__ mat,
                   const uint8_t* __restrict__ live,
                   const float* __restrict__ aux_doc,
                   const float* __restrict__ aux_q, int B, int D, long long N,
                   int nchunks, int k, int transform, int count_positive,
                   unsigned long long* __restrict__ cand,
                   int* __restrict__ partial) {
  __shared__ unsigned long long keys[CHUNK];
  __shared__ int scratch[THREADS / 32];
  __shared__ float qs[ROWS][DT];
  const int ntiles = (B + ROWS - 1) / ROWS;
  const int rt = blockIdx.x % ntiles;  // row tiles of one chunk are adjacent
  const int c = blockIdx.x / ntiles;
  const int r0 = rt * ROWS;
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
    int cnt = 0;
    __syncthreads();  // previous row's keys fully consumed
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int lane = e * THREADS + threadIdx.x;
      keys[lane] = lane_key(acc[i][e], base + lane, N, transform,
                            count_positive, live, aux_doc, auxq, &cnt);
    }
    emit_chunk(keys, scratch, cnt, k, static_cast<long long>(r) * nchunks + c,
               cand, partial);
  }
}

__global__ void __launch_bounds__(THREADS)
scan_merge_kernel(const unsigned long long* __restrict__ cand,
                  const int* __restrict__ partial, int nchunks, int k,
                  float* __restrict__ out_v, int* __restrict__ out_i,
                  int* __restrict__ out_t) {
  merge_row(cand, partial, nchunks, k, out_v, out_i, out_t);
}

}  // namespace

extern "C" {

int scan_topk_chunk() { return CHUNK; }

// q == nullptr selects streamed mode (mat = scores [B, N]); otherwise
// mat = mat_t [D, N]. aux_doc / aux_q may be nullptr, read as zeros.
// cand: [B, nchunks, k] u64 scratch; partial:
// [B, nchunks] i32 scratch. Returns cudaGetLastError() after the launches.
int scan_topk_launch(const float* q, const float* mat, const uint8_t* live,
                     const float* aux_doc, const float* aux_q, int B, int D,
                     long long N, int k, int transform, int count_positive,
                     unsigned long long* cand, int* partial, float* out_v,
                     int* out_i, int* out_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = static_cast<int>((N + CHUNK - 1) / CHUNK);
  if (q == nullptr) {
    scan_streamed_kernel<<<nchunks * B, THREADS, 0, st>>>(
        mat, live, aux_doc, aux_q, B, N, nchunks, k, transform,
        count_positive, cand, partial);
  } else {
    const int ntiles = (B + ROWS - 1) / ROWS;
    scan_matmul_kernel<<<nchunks * ntiles, THREADS, 0, st>>>(
        q, mat, live, aux_doc, aux_q, B, D, N, nchunks, k, transform,
        count_positive, cand, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_merge_kernel<<<B, THREADS, 0, st>>>(cand, partial, nchunks, k, out_v,
                                           out_i, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
