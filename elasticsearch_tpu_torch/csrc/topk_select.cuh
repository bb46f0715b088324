// topk_select.cuh: the top-k selections shared by the scan kernels.
//
// Included by each kernel source (one translation unit, one library each),
// so everything here has internal linkage. A kernel source supplies the
// score producer and thin __global__ wrappers; this header supplies the
// order key, the per-lane masks and three selections:
//
// Threshold-filtered selection (scan_topk.cu). A block walks one row (or a
// few rows) over a long doc span and keeps, per row, its k best keys so far
// (`SelRow::top`, sorted) and their k-th as a threshold. A lane is appended
// to a shared staging buffer (`SelStage`, warp-aggregated atomicAdd) only if
// its key beats the threshold; `sel_fold` merges the staged keys into the
// row's top k with a bitonic sort of the few keys staged, and raises the
// threshold. On random or mostly-masked rows only O(k log(span / k)) lanes
// per span reach a sort (Johnson, Douze, Jegou, "Billion-scale similarity
// search with GPUs", 2017). `select_merge_row` (pass 2 of scan_topk,
// tiered_candidates and ann_gather_scan) runs the same filter over the
// spans' candidates of one row.
//
// Warp selection (tiered_candidates.cu, fused_tile_candidates.cu,
// ann_gather_scan.cu). One warp owns a row's top k in shared memory and its
// threshold: each lane keys 4 lanes of the row, and `warp_fold` merges the
// keys that beat the threshold: one or two by ballot insertion, up to 32 by
// ranks (a shuffle sort of the staged keys, then binary searches), more by
// a bitonic sort in the warp's scratch. No block barrier is needed, so the
// rows of a block select independently.
//
// Chunk sort (fused_tile_candidates.cu, its route for t > MAX_K): a block
// keys the CHUNK lanes of a tile (`lane_key`), sums the count (`block_sum`)
// and sorts all CHUNK keys (`sort_desc`).
//
// A lane's order key is one 64-bit integer: the order-preserving map of the
// float's bits (all bits flipped if negative, only the sign bit otherwise)
// above the inverted docid, so a descending key order is score descending,
// docid ascending, negative scores included. NaN lanes rank as -inf and -0
// as +0; -inf lanes keep their ids, ascending, like lax.top_k's. Key 0 sits
// below every real key and pads a chunk past the last doc. Every real key is
// distinct (it carries the docid), so the top k of a set of lanes is one set
// whatever order lanes are filtered, staged and folded in: every selection
// returns the same keys.

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

// the high word of a lane's key: the float's order-preserving bits
__device__ __forceinline__ uint32_t order_bits(float s) {
  uint32_t u = __float_as_uint(s);
  if ((u & 0x7fffffffu) > 0x7f800000u) u = 0xff800000u;  // NaN -> -inf
  if ((u << 1) == 0u) u = 0u;                            // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long make_key(float s, int id) {
  return (static_cast<unsigned long long>(order_bits(s)) << 32) |
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

// Four neighbouring lanes nb .. nb + 3 of one row: what `lane_key` does
// (transform, live mask, count_positive; lanes past N are dead), with a
// lane's key compared on its order bits first. -> the mask of the lanes
// the row's total counts.
__device__ __forceinline__ unsigned lanes4(float4 d4, long long nb, long long N,
                                           int transform, int count_positive,
                                           uint32_t lv, float4 ad, float auxq,
                                           unsigned long long th,
                                           unsigned long long* key, bool* p,
                                           int* np) {
  unsigned counted = 0u;
  const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
  const float av[4] = {ad.x, ad.y, ad.z, ad.w};
  const uint32_t th_hi = static_cast<uint32_t>(th >> 32);
  const uint32_t th_lo = static_cast<uint32_t>(th);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long n = nb + e;
    const bool valid = n < N;
    const bool ok = ((lv >> (8 * e)) & 0xffu) != 0u;
    float s = apply_transform(dv[e], transform, av[e], auxq);
    if (!ok) s = neg_inf();
    if (count_positive) {
      if (!(s > 0.0f)) s = neg_inf();
      counted |= static_cast<unsigned>(valid && s > 0.0f) << e;
    } else {
      counted |= static_cast<unsigned>(valid && ok) << e;
    }
    const uint32_t hi32 = order_bits(s);
    const uint32_t lo32 = ~static_cast<uint32_t>(n);
    p[e] = valid && (hi32 > th_hi || (hi32 == th_hi && lo32 > th_lo));
    key[e] = (static_cast<unsigned long long>(hi32) << 32) | lo32;
    *np += p[e];
  }
  return counted;
}

// ---------------------------------------------------------------------------
// threshold-filtered selection
// ---------------------------------------------------------------------------

constexpr int MAX_K = 128;       // the largest k of every selection
constexpr int SEL_CAP = 4096;    // keys staged between folds
constexpr int SEL_THREADS = 256; // threads of the streamed and merge blocks

// one row's running selection, in shared memory
struct SelRow {
  unsigned long long top[MAX_K];  // the ntop best keys folded so far, sorted
  unsigned long long thr;         // top[k - 1] once ntop == k, else 0
  int ntop;
};

// keys staged since the last fold (of the row being filtered)
struct SelStage {
  unsigned long long buf[SEL_CAP];
  int n;
};

__device__ __forceinline__ void sel_init(SelRow* row) {
  row->thr = 0ull;
  row->ntop = 0;
}

// descending bitonic sort of n keys (a power of two) by the whole block
__device__ void sort_desc_n(unsigned long long* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
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

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// stage `key` if it beats `thr`; all 32 lanes of the warp must call. Key 0
// (padding) never beats a threshold, so it is never staged.
__device__ __forceinline__ void sel_push(unsigned long long key,
                                         unsigned long long thr,
                                         SelStage* st) {
  const bool pass = key > thr;
  const unsigned mask = __ballot_sync(0xffffffffu, pass);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&st->n, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (pass) st->buf[base + __popc(mask & ((1u << lane) - 1u))] = key;
}

// Block-wide: merge the staged keys into row's top k, raise its threshold,
// empty the stage. The caller keeps st->n + MAX_K <= SEL_CAP. Every thread
// reads the new row->thr after this returns.
__device__ __noinline__ void sel_fold(SelRow* row, SelStage* st, int k) {
  __syncthreads();  // every staged key written
  const int n = st->n;
  __syncthreads();  // every thread has read n before anyone stages again
  if (n == 0) return;
  const int c = row->ntop;
  for (int i = threadIdx.x; i < c; i += blockDim.x) st->buf[n + i] = row->top[i];
  const int total = n + c;
  const int p = pow2_at_least(total);
  for (int i = total + threadIdx.x; i < p; i += blockDim.x) st->buf[i] = 0ull;
  sort_desc_n(st->buf, p);
  const int keep = min(total, k);
  for (int i = threadIdx.x; i < keep; i += blockDim.x) row->top[i] = st->buf[i];
  if (threadIdx.x == 0) {
    row->ntop = keep;
    if (keep == k) row->thr = st->buf[k - 1];
    st->n = 0;
  }
  __syncthreads();
}

// sum of one int per thread over the block -> valid in thread 0
__device__ int sel_block_sum(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;
}

// a span's k best keys (key 0 past ntop) and its count, into slot
__device__ void sel_emit(const SelRow* row, int cnt, int* scratch, int k,
                         long long slot, unsigned long long* __restrict__ cand,
                         int* __restrict__ partial) {
  const int total = sel_block_sum(cnt, scratch);
  for (int j = threadIdx.x; j < k; j += blockDim.x)
    cand[slot * k + j] = j < row->ntop ? row->top[j] : 0ull;
  if (threadIdx.x == 0) partial[slot] = total;
}

// pass 2 for row blockIdx.x (SEL_THREADS threads): the best k of its
// nspans x k candidates by the same filter, and the sum of its counts
__device__ void select_merge_row(const unsigned long long* __restrict__ cand,
                                 const int* __restrict__ partial, int nspans,
                                 int k, float* __restrict__ out_v,
                                 int* __restrict__ out_i,
                                 int* __restrict__ out_t) {
  __shared__ SelRow row;
  __shared__ SelStage st;
  __shared__ int scratch[32];
  constexpr int V = 4;
  constexpr int STEP = SEL_THREADS * V;
  const int r = blockIdx.x;
  const long long total = static_cast<long long>(nspans) * k;
  const unsigned long long* src = cand + r * total;
  if (threadIdx.x == 0) {
    sel_init(&row);
    st.n = 0;
  }
  int cnt = 0;
  for (int s = threadIdx.x; s < nspans; s += SEL_THREADS)
    cnt += partial[static_cast<long long>(r) * nspans + s];
  __syncthreads();
  int staged = 0;  // an upper bound of st.n, the same in every thread
  for (long long p0 = 0; p0 < total; p0 += STEP) {
    // fold when the stage could overflow, and once after the first step, so
    // that the rest is filtered against a threshold
    if (staged + STEP > SEL_CAP - MAX_K || p0 == STEP) {
      sel_fold(&row, &st, k);
      staged = 0;
    }
    const unsigned long long thr = row.thr;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long p = p0 + j * SEL_THREADS + threadIdx.x;
      sel_push(p < total ? src[p] : 0ull, thr, &st);
    }
    staged += STEP;
  }
  sel_fold(&row, &st, k);
  const int matches = sel_block_sum(cnt, scratch);
  for (int j = threadIdx.x; j < k; j += SEL_THREADS) {
    const unsigned long long key = row.top[j];
    out_v[static_cast<long long>(r) * k + j] = key_score(key);
    out_i[static_cast<long long>(r) * k + j] = key_id(key);
  }
  if (threadIdx.x == 0) out_t[r] = matches;
}

// ---------------------------------------------------------------------------
// warp-level threshold-filtered selection (one warp owns a row's top k)
// ---------------------------------------------------------------------------

constexpr int WARP_FOLD_SCR = 2 * MAX_K;  // keys of one warp's fold scratch

// Warp-wide: insert key x into the row's sorted top (n entries, n < k or x
// above the k-th), by a ballot count of the entries above it and a shift.
// -> the new n; *th: the k-th key once n == k. n and th stay in registers
// (the same in every lane) across a fold's insertions.
__device__ __forceinline__ int warp_insert(unsigned long long* top,
                                          unsigned long long x, int n, int k,
                                          unsigned long long* th) {
  const int lane = threadIdx.x & 31;
  const int nn = min(n + 1, k);
  int pos = 0;
  unsigned long long v[MAX_K / 32];
#pragma unroll
  for (int c = 0; c < MAX_K / 32; ++c) {
    v[c] = 0ull;
    if (c * 32 >= nn) continue;  // uniform: past the entries that can move
    const int j = c * 32 + lane;
    v[c] = j < n ? top[j] : 0ull;
    pos += __popc(__ballot_sync(0xffffffffu, j < n && v[c] > x));
  }
  if (nn == k) {  // the new k-th: x itself, or the entry shifted into place
    unsigned long long below = 0ull;
#pragma unroll
    for (int c = 0; c < MAX_K / 32; ++c)
      if (c == ((k - 2) >> 5)) below = v[c];
    below = __shfl_sync(0xffffffffu, below, (k - 2) & 31);
    *th = pos == k - 1 ? x : below;
  }
  __syncwarp();  // every entry read before any moves
#pragma unroll
  for (int c = 0; c < MAX_K / 32; ++c) {
    const int j = c * 32 + lane;
    if (j >= pos && j < nn - 1) top[j + 1] = v[c];
  }
  if (lane == 0) top[pos] = x;
  __syncwarp();
  return nn;
}

// Warp-wide: merge the keys that beat the row's threshold (bit e of `pass`
// for key e of each lane) into its sorted top k. Up to INSERT_MAX are
// inserted one at a time (each against the threshold as it rises). Up to
// MERGE_MAX (one per lane) are sorted across the lanes by a bitonic network
// of shuffles, and every key then finds its new rank by a binary search in
// the other sorted list (merge path): a staged key goes after the top's
// equal keys. More (the first tiles of a span) go through a bitonic sort
// with the top in the warp's scratch.
constexpr int INSERT_MAX = 2;
constexpr int MERGE_MAX = 32;

// descending bitonic sort of one key per lane across the warp
__device__ __forceinline__ unsigned long long warp_sort32(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, j);
      const bool keep_max = ((lane & k) == 0) == ((lane & j) == 0);
      v = keep_max ? (v > o ? v : o) : (v < o ? v : o);
    }
  return v;
}

__device__ __noinline__ void warp_fold(unsigned long long* top, unsigned long long* thr,
                                       int* ntop, unsigned long long* scr,
                                       unsigned long long k0, unsigned long long k1,
                                       unsigned long long k2, unsigned long long k3,
                                       unsigned pass, int k) {
  const int lane = threadIdx.x & 31;
  const unsigned long long key[4] = {k0, k1, k2, k3};
  bool p[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = (pass >> e) & 1u;
  const int np = __popc(pass);
  int incl = np;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int staged = __shfl_sync(0xffffffffu, incl, 31);
  if (staged <= INSERT_MAX) {
    int n = *ntop;
    unsigned long long th = *thr;
    for (;;) {
      const unsigned m = __ballot_sync(0xffffffffu, p[0] || p[1] || p[2] || p[3]);
      if (m == 0u) break;
      const int src = __ffs(m) - 1;
      unsigned long long x = 0ull;
      if (lane == src) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (p[e] && x == 0ull) {
            x = key[e];
            p[e] = false;
          }
      }
      x = __shfl_sync(0xffffffffu, x, src);
      if (n == k && x <= th) continue;  // the threshold rose past it
      n = warp_insert(top, x, n, k, &th);
    }
    if (lane == 0) {
      *ntop = n;
      *thr = th;
    }
    __syncwarp();
    return;
  }
  if (staged <= MERGE_MAX) {
    const int n = *ntop;
    int pos = incl - np;  // the staged keys, compacted in lane order
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (p[e]) scr[pos++] = key[e];
    __syncwarp();
    const unsigned long long x = warp_sort32(lane < staged ? scr[lane] : 0ull);
    __syncwarp();
    scr[lane] = x;  // sorted, key 0 past `staged`
    unsigned long long v[MAX_K / 32];
#pragma unroll
    for (int c = 0; c < MAX_K / 32; ++c) {
      const int j = c * 32 + lane;
      v[c] = j < n ? top[j] : 0ull;
    }
    __syncwarp();
    // new ranks: a staged key after the top's keys >= it, a top key after
    // the staged keys > it
    int lo = 0;
    int hi = lane < staged ? n : 0;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (top[mid] >= x) lo = mid + 1; else hi = mid;
    }
    const int xpos = lane + lo;
    int vpos[MAX_K / 32];
#pragma unroll
    for (int c = 0; c < MAX_K / 32; ++c) {
      const int j = c * 32 + lane;
      int a = 0;
      int b = j < n ? staged : 0;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (scr[mid] > v[c]) a = mid + 1; else b = mid;
      }
      vpos[c] = j < n ? j + a : k;
    }
    __syncwarp();  // every rank found before the top moves
    if (lane < staged && xpos < k) top[xpos] = x;
#pragma unroll
    for (int c = 0; c < MAX_K / 32; ++c)
      if (vpos[c] < k) top[vpos[c]] = v[c];
    const int nn = min(n + staged, k);
    __syncwarp();
    if (lane == 0) {
      *ntop = nn;
      if (nn == k) *thr = top[k - 1];
    }
    __syncwarp();
    return;
  }
  const int c = *ntop;
  for (int j = lane; j < c; j += 32) scr[j] = top[j];
  int pos = c + incl - np;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (p[e]) scr[pos++] = key[e];
  const int total = c + staged;
  const int P = pow2_at_least(total);
  for (int j = total + lane; j < P; j += 32) scr[j] = 0ull;
  __syncwarp();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < P / 2; i += 32) {
        const int a = 2 * i - (i & (stride - 1));
        const int b = a + stride;
        const bool desc = (a & size) == 0;
        const unsigned long long x = scr[a];
        const unsigned long long y = scr[b];
        if ((x < y) == desc) {
          scr[a] = y;
          scr[b] = x;
        }
      }
      __syncwarp();
    }
  }
  const int keep = min(total, k);
  for (int j = lane; j < keep; j += 32) top[j] = scr[j];
  if (lane == 0) {
    *ntop = keep;
    if (keep == k) *thr = scr[k - 1];
  }
  __syncwarp();
}

}  // namespace
