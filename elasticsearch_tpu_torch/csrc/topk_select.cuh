// topk_select.cuh: the two-pass top-k selection shared by the scan kernels.
//
// Included by scan_topk.cu and tiered_candidates.cu, each built into its own
// library (one translation unit each), so everything here has internal
// linkage. A kernel source supplies the score producer of pass 1 and thin
// __global__ wrappers; this header supplies what both passes share:
//
//   pass 1  per (row, chunk of CHUNK docs): `lane_key` masks, counts and
//           keys each lane, `emit_chunk` writes the chunk's int32 match
//           count and its k best keys, found by a bitonic sort of the
//           chunk's keys in shared memory;
//   pass 2  per row: `merge_row` merges the chunks' candidates with the same
//           sort over tiles of CHUNK keys (the running top k plus the next
//           CHUNK - k candidates) and sums the counts. Integer sums keep
//           totals exact and deterministic.
//
// A lane's order key is one 64-bit integer: the order-preserving map of the
// float's bits (all bits flipped if negative, only the sign bit otherwise)
// above the inverted docid, so a descending key order is score descending,
// docid ascending, negative scores included. NaN lanes rank as -inf and -0
// as +0; -inf lanes keep their ids, ascending, like lax.top_k's. Key 0 sits
// below every real key and pads a chunk past the last doc.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;           // threads of every selection block
constexpr int CHUNK = 4096;            // docs per pass-1 block, keys per sort
constexpr int EPT = CHUNK / THREADS;   // lanes per thread

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

// pass 2 for row blockIdx.x: merge its nchunks x k candidates and counts
__device__ void merge_row(const unsigned long long* __restrict__ cand,
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
