// impact_gather: gather quantized impact-code blocks and dequantize, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel elasticsearch_tpu/ops/kernels.py
// `_impact_gather_kernel` (launched by `_impact_gather_pallas`, public
// `impact_gather`): the sparse arm of a batch of BM25 term disjunctions over
// the impact tier (BM25S). For query q, block row j of its R rows and lane l
// of the row's BLOCK = 128 lanes:
//
//   ids[q, j*128 + l]    = docids[rows[q, j], l]
//   scores[q, j*128 + l] = row_w[q, j] * float(codes[rows[q, j], l])
//
// Padding rows (row 0, weight 0) give docid num_docs at score 0. One f32
// multiply per lane, so the kernel and its twin (`impact_gather_reference`)
// agree bit for bit.
//
// Design. The TPU kernel scalar-prefetches the row ids and groups _IMPACT_G
// = 8 block-row DMAs per grid step, padding R to a multiple of 8. Here one
// thread writes one output lane: a block of 128 x RB threads covers RB rows
// of one query, loads its own RB row ids and weights into shared memory, and
// each warp then reads 32 neighbouring code and docid lanes of one block
// row and writes 32 neighbouring outputs. No padding of R is needed. The
// kernel is templated on the code type (uint16, int8); both convert to f32
// exactly.
//
// Bound on an H100 SXM: bytes. Per lane it reads the code (2 or 1 bytes)
// and the docid (4) and writes the id (4) and the score (4); per row it
// reads the row id and weight (8). At 3.35 TB/s, Q=512 and R=64 with uint16
// codes that is 59.0 MB, about 0.018 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;  // lanes per postings block row
constexpr int RB = 8;       // block rows per thread block

template <typename CodeT>
__global__ void __launch_bounds__(BLOCK * RB)
impact_gather_kernel(const CodeT* __restrict__ codes,
                     const int* __restrict__ docids,
                     const int* __restrict__ rows,
                     const float* __restrict__ row_w, int R,
                     int* __restrict__ out_ids,
                     float* __restrict__ out_scores) {
  __shared__ int srow[RB];
  __shared__ float sw[RB];
  const long long q = blockIdx.y;
  const int r0 = blockIdx.x * RB;
  const int t = threadIdx.y * BLOCK + threadIdx.x;
  if (t < RB) {
    const int r = r0 + t;
    srow[t] = r < R ? rows[q * R + r] : 0;
    sw[t] = r < R ? row_w[q * R + r] : 0.0f;
  }
  __syncthreads();
  const int r = r0 + threadIdx.y;
  if (r >= R) return;
  const long long src = static_cast<long long>(srow[threadIdx.y]) * BLOCK +
                        threadIdx.x;
  const long long dst = (q * R + r) * BLOCK + threadIdx.x;
  out_ids[dst] = docids[src];
  out_scores[dst] = sw[threadIdx.y] * static_cast<float>(codes[src]);
}

}  // namespace

extern "C" {

int impact_gather_block() { return BLOCK; }

// codes: [nb, BLOCK] uint16 (code_bytes 2) or int8 (code_bytes 1); docids:
// [nb, BLOCK] i32; rows, row_w: [Q, R] i32 / f32, every row id in [0, nb);
// out_ids, out_scores: [Q, R * BLOCK]. Returns cudaGetLastError() after the
// launch (and cudaErrorInvalidValue for an unknown code width).
int impact_gather_launch(const void* codes, int code_bytes, const int* docids,
                         const int* rows, const float* row_w, int Q, int R,
                         int* out_ids, float* out_scores, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + RB - 1) / RB, Q);
  const dim3 block(BLOCK, RB);
  if (code_bytes == 2) {
    impact_gather_kernel<uint16_t><<<grid, block, 0, st>>>(
        static_cast<const uint16_t*>(codes), docids, rows, row_w, R, out_ids,
        out_scores);
  } else if (code_bytes == 1) {
    impact_gather_kernel<int8_t><<<grid, block, 0, st>>>(
        static_cast<const int8_t*>(codes), docids, rows, row_w, R, out_ids,
        out_scores);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
