// tiered_candidates: split-bf16 selection scan + top-kb + exact match count,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticsearch_tpu/ops/kernels.py
// `_tiered_scan_kernel` (launched by `_tiered_candidates_pallas`, public
// `tiered_candidates`). Per query row r and doc lane n it computes
//
//   dots   = sum_d qh[r,d] * hi[d,n]  +  sum_d qh[r,d] * lo[d,n]
//            (qh: the query cut to bf16 by integer masking; hi, lo: the
//             split-bf16 halves of the f32 matrix; each sum in f32, d order)
//   s      = transform(dots); s = live[n] ? s : -inf;
//            count_positive: s = s > 0 ? s : -inf
//   total  = #(s > 0) | #live
//
// and returns the top kb lanes by (score desc, docid asc), kb <= 128. The
// scores are SELECTION scores: callers rescore the kb candidates in f32 and
// apply the margin test (ops/batched.py, the dense-only tiered arm).
//
// Design. The Pallas kernel walks doc tiles in order and carries a running
// top-kb in VMEM. Here the two-pass structure of scan_topk.cu is reused
// through topk_select.cuh: pass 1 is one block per (row tile of TROWS rows,
// chunk of CHUNK docs) emitting the chunk's kb best keys and int32 count,
// pass 2 one block per row merging them. Only the score producer differs:
// the block stages TDT query columns in shared memory and streams the hi
// and lo columns of its chunk, each thread keeping TROWS x EPT hi sums and
// as many lo sums in registers.
//
// Arithmetic. A bf16 x bf16 product has at most 16 significant bits, so it
// is exact in f32, and one fused multiply-add rounds exactly as the twin's
// separate multiply (exact) and add (rounded) do: the kernel and its twin
// (`tiered_candidates_reference`, which sums d = 0 .. D-1 from 0.0) agree
// bit for bit. The explicit __fmaf_rn is unaffected by --fmad=false. Both
// sums are then added, and the transform runs in the JAX package's order.
// No tensor cores: their summation order is not the twin's.
//
// Bound on an H100 SXM at the msearch path's shape (B=512, D=896, N=1M):
// 4*B*D*N = 1.84e12 operations at the 989 TFLOP/s bf16 tensor-core peak
// = 1.86 ms, above the 2*D*N*2 bytes of hi and lo at 3.35 TB/s = 1.07 ms,
// so operation bound. This simple kernel runs on CUDA cores (33.5 T FMA/s,
// about 27 ms of FMAs alone at that shape) and pays the shared-memory sorts
// of the selection on top. Each hi/lo column is read ceil(B / TROWS) times;
// the blocks of one chunk are adjacent in launch order so those reads
// mostly hit L2.

#include "topk_select.cuh"

namespace {

constexpr int TROWS = 4;   // query rows per pass-1 block
constexpr int TDT = 64;    // query columns staged per step

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__global__ void __launch_bounds__(THREADS)
tiered_scan_kernel(const float* __restrict__ qh,
                   const uint16_t* __restrict__ hi,
                   const uint16_t* __restrict__ lo,
                   const uint8_t* __restrict__ live,
                   const float* __restrict__ aux_doc,
                   const float* __restrict__ aux_q, int B, int D, long long N,
                   int nchunks, int k, int transform, int count_positive,
                   unsigned long long* __restrict__ cand,
                   int* __restrict__ partial) {
  __shared__ unsigned long long keys[CHUNK];
  __shared__ int scratch[THREADS / 32];
  __shared__ float qs[TROWS][TDT];
  const int ntiles = (B + TROWS - 1) / TROWS;
  const int rt = blockIdx.x % ntiles;  // row tiles of one chunk are adjacent
  const int c = blockIdx.x / ntiles;
  const int r0 = rt * TROWS;
  const long long base = static_cast<long long>(c) * CHUNK;

  float ah[TROWS][EPT];
  float al[TROWS][EPT];
#pragma unroll
  for (int i = 0; i < TROWS; ++i)
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      ah[i][e] = 0.0f;
      al[i][e] = 0.0f;
    }

  for (int d0 = 0; d0 < D; d0 += TDT) {
    const int dn = min(TDT, D - d0);
    __syncthreads();
    for (int t = threadIdx.x; t < TROWS * TDT; t += THREADS) {
      const int i = t / TDT;
      const int dd = t % TDT;
      qs[i][dd] = (r0 + i < B && dd < dn)
                      ? qh[static_cast<long long>(r0 + i) * D + d0 + dd]
                      : 0.0f;
    }
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd) {
      const long long row = static_cast<long long>(d0 + dd) * N;
      float mh[EPT];
      float ml[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const long long n = base + e * THREADS + threadIdx.x;
        mh[e] = n < N ? bf16_bits_to_float(hi[row + n]) : 0.0f;
        ml[e] = n < N ? bf16_bits_to_float(lo[row + n]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < TROWS; ++i) {
        const float qv = qs[i][dd];
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          ah[i][e] = __fmaf_rn(qv, mh[e], ah[i][e]);
          al[i][e] = __fmaf_rn(qv, ml[e], al[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TROWS; ++i) {
    const int r = r0 + i;
    if (r >= B) break;  // uniform across the block
    const float auxq = aux_q != nullptr ? aux_q[r] : 0.0f;
    int cnt = 0;
    __syncthreads();  // previous row's keys fully consumed
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int lane = e * THREADS + threadIdx.x;
      keys[lane] = lane_key(ah[i][e] + al[i][e], base + lane, N, transform,
                            count_positive, live, aux_doc, auxq, &cnt);
    }
    emit_chunk(keys, scratch, cnt, k, static_cast<long long>(r) * nchunks + c,
               cand, partial);
  }
}

__global__ void __launch_bounds__(THREADS)
tiered_merge_kernel(const unsigned long long* __restrict__ cand,
                    const int* __restrict__ partial, int nchunks, int k,
                    float* __restrict__ out_v, int* __restrict__ out_i,
                    int* __restrict__ out_t) {
  merge_row(cand, partial, nchunks, k, out_v, out_i, out_t);
}

}  // namespace

extern "C" {

int tiered_candidates_chunk() { return CHUNK; }

// qh: [B, D] f32 (bf16-representable); hi, lo: [D, N] bf16 bit patterns;
// aux_doc / aux_q may be nullptr, read as zeros. cand: [B, nchunks, k] u64
// scratch; partial: [B, nchunks] i32 scratch. Returns cudaGetLastError()
// after the launches.
int tiered_candidates_launch(const float* qh, const uint16_t* hi,
                             const uint16_t* lo, const uint8_t* live,
                             const float* aux_doc, const float* aux_q, int B,
                             int D, long long N, int k, int transform,
                             int count_positive, unsigned long long* cand,
                             int* partial, float* out_v, int* out_i,
                             int* out_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunks = static_cast<int>((N + CHUNK - 1) / CHUNK);
  const int ntiles = (B + TROWS - 1) / TROWS;
  tiered_scan_kernel<<<nchunks * ntiles, THREADS, 0, st>>>(
      qh, hi, lo, live, aux_doc, aux_q, B, D, N, nchunks, k, transform,
      count_positive, cand, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tiered_merge_kernel<<<B, THREADS, 0, st>>>(cand, partial, nchunks, k, out_v,
                                             out_i, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
