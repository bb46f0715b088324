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
// so the work is split in two passes:
//   pass 1  one block per (row tile, chunk of CHUNK docs): computes the
//           lane scores, writes the chunk's int32 match count and its k best
//           (score, id) keys, found by a bitonic sort of the chunk's keys in
//           shared memory;
//   pass 2  one block per row: merges the chunks' candidates with the same
//           sort over tiles of CHUNK keys (the running top k plus the next
//           CHUNK - k candidates) and sums the counts. Integer sums keep
//           totals exact and deterministic.
// A lane's order key is one 64-bit integer: the order-preserving map of the
// float's bits (all bits flipped if negative, only the sign bit otherwise)
// above the inverted docid, so a descending key order is score descending,
// docid ascending, negative scores included. NaN lanes rank as -inf and -0
// as +0; -inf lanes keep their ids, ascending, like lax.top_k's.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int CHUNK = 4096;              // docs per pass-1 block, keys per sort
constexpr int EPT = CHUNK / THREADS;     // lanes per thread
constexpr int ROWS = 8;                  // query rows per pass-1 block (matmul)
constexpr int DT = 64;                   // q columns staged per step (matmul)

enum Transform {
  IDENTITY = 0,
  COSINE = 1,
  DOT_PRODUCT = 2,
  L2_NORM = 3,
  MAX_INNER_PRODUCT = 4,
};

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

__device__ __forceinline__ bool reads_aux_doc(int transform) {
  return transform == COSINE || transform == L2_NORM;
}

// _apply_transform of the JAX package, operation for operation
__device__ __forceinline__ float apply_transform(float dots, int transform,
                                                 float auxd, float auxq) {
  switch (transform) {
    case COSINE:
      return (1.0f + dots * auxd * auxq) / 2.0f;
    case DOT_PRODUCT:
      return (1.0f + dots) / 2.0f;
    case L2_NORM: {
      float l2 = auxd - 2.0f * dots + auxq;
      l2 = l2 < 0.0f ? 0.0f : l2;  // maximum(l2, 0), NaN propagating
      return 1.0f / (1.0f + l2);
    }
    case MAX_INNER_PRODUCT:
      return dots < 0.0f ? 1.0f / (1.0f - dots) : dots + 1.0f;
    default:
      return dots;
  }
}

__device__ __forceinline__ unsigned long long make_key(float s, int id) {
  uint32_t u = __float_as_uint(s);
  if ((u & 0x7fffffffu) > 0x7f800000u) u = 0xff800000u;  // NaN -> -inf
  if ((u << 1) == 0u) u = 0u;                            // -0 -> +0
  const uint32_t f = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(f) << 32) |
         static_cast<unsigned long long>(~static_cast<uint32_t>(id));
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t f = static_cast<uint32_t>(key >> 32);
  const uint32_t u = (f & 0x80000000u) ? (f & 0x7fffffffu) : ~f;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_id(unsigned long long key) {
  return static_cast<int>(~static_cast<uint32_t>(key));
}

// descending bitonic sort of CHUNK keys in shared memory, THREADS threads
__device__ void sort_desc(unsigned long long* s) {
  for (int size = 2; size <= CHUNK; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < CHUNK / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = s[lo];
        const unsigned long long b = s[hi];
        if ((a < b) == desc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
    }
  }
  __syncthreads();
}

__device__ int block_sum(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < THREADS / 32; ++w) total += scratch[w];
  }
  return total;  // valid in thread 0
}

// mask, count and key one lane; key 0 (below every real key) pads the chunk
__device__ __forceinline__ unsigned long long lane_key(
    float dots, long long n, long long N, int transform, int count_positive,
    const uint8_t* live, const float* aux_doc, float auxq, int* cnt) {
  if (n >= N) return 0ull;
  const float auxd =
      (aux_doc != nullptr && reads_aux_doc(transform)) ? aux_doc[n] : 0.0f;
  float s = apply_transform(dots, transform, auxd, auxq);
  const bool ok = live[n] != 0;
  if (!ok) s = neg_inf();
  if (count_positive) {
    if (!(s > 0.0f)) s = neg_inf();
    *cnt += s > 0.0f;
  } else {
    *cnt += ok;
  }
  return make_key(s, static_cast<int>(n));
}

// the chunk's count and its k best keys, from keys already in shared memory
__device__ void emit_chunk(unsigned long long* keys, int* scratch, int cnt,
                           int k, long long slot,
                           unsigned long long* cand, int* partial) {
  const int total = block_sum(cnt, scratch);
  if (threadIdx.x == 0) partial[slot] = total;
  sort_desc(keys);
  for (int j = threadIdx.x; j < k; j += THREADS) cand[slot * k + j] = keys[j];
  __syncthreads();
}

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
merge_kernel(const unsigned long long* __restrict__ cand,
             const int* __restrict__ partial, int nchunks, int k,
             float* __restrict__ out_v, int* __restrict__ out_i,
             int* __restrict__ out_t) {
  __shared__ unsigned long long buf[CHUNK];
  __shared__ int scratch[THREADS / 32];
  const int r = blockIdx.x;
  const long long total = static_cast<long long>(nchunks) * k;
  const unsigned long long* src = cand + r * total;

  int cnt = 0;
  for (int c = threadIdx.x; c < nchunks; c += THREADS)
    cnt += partial[static_cast<long long>(r) * nchunks + c];
  const int matches = block_sum(cnt, scratch);

  // first tile fills the whole buffer; each later tile keeps the running
  // top k in buf[0, k) and brings CHUNK - k new candidates
  long long pos = 0;
  int keep = 0;
  do {
    for (int j = keep + threadIdx.x; j < CHUNK; j += THREADS) {
      const long long p = pos + (j - keep);
      buf[j] = p < total ? src[p] : 0ull;
    }
    pos += CHUNK - keep;
    sort_desc(buf);
    keep = k;
  } while (pos < total);

  for (int j = threadIdx.x; j < k; j += THREADS) {
    out_v[static_cast<long long>(r) * k + j] = key_score(buf[j]);
    out_i[static_cast<long long>(r) * k + j] = key_id(buf[j]);
  }
  if (threadIdx.x == 0) out_t[r] = matches;
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
  merge_kernel<<<B, THREADS, 0, st>>>(cand, partial, nchunks, k, out_v, out_i,
                                      out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
