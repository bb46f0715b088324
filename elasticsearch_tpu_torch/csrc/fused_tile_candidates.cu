// fused_tile_candidates: per (query row, doc tile) BM25 selection scores of
// the fused `_msearch` arm, each tile's top t candidates and its exact
// match count, for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticsearch_tpu/ops/fused.py `_fused_kernel`
// (launched by `fused_tile_candidates`). Per query row q and doc lane n:
//
//   dense  = sum_i wh[q,i] * hi[row[q,i], n]  +  sum_i wh[q,i] * lo[row[q,i], n]
//            (wh: the query's dense-term weights cut to bf16 by integer
//             masking, one entry per distinct tier row in ascending order,
//             padded with weight 0; hi, lo: the split-bf16 halves of the
//             f32 tier; each sum in f32, i order, added last)
//   sparse = the run sum, from 0.0 in sorted order, of the window entries
//            whose key is (q << db) | n: one entry per sparse query term
//            with a posting for doc n
//   s      = dense + sparse;  s = (live[n] && s > 0) ? s : -inf
//   count  = #(s > 0) over the tile
//
// and returns the tile's t best lanes by (score desc, docid asc) with the
// count. The scores are SELECTION scores (the dense half is split-bf16): the
// caller merges the tiles, rescores the winners in f32 and flags a query
// whose ranking the selection cannot prove (ops/fused.py `_fused_pipeline`).
//
// Design. The TPU block is a [256-query, tile] f32 accumulator in VMEM, with
// the sparse tail scatter-added by one-hot MXU products because TPU scatters
// are slow. A Hopper block has 227 KB of shared memory, so one block here
// owns ONE query row and one CHUNK-doc tile; blockIdx.x runs over rows, so
// the blocks of a tile are adjacent in launch order and its tier columns are
// read from L2. The sparse tail is a scatter in shared memory instead: the
// block walks its own window [ptr[q,j], ptr[q,j+1]) of the sorted entries
// straight from global memory; the entry that starts a run of equal keys
// sums the run and stores the sum into its lane of `sacc` (one writer per
// lane, no atomics, deterministic). `sacc` shares its shared memory with the
// selection's keys: each thread moves its lanes' sums into registers before
// the keys are written. The window is read from global memory, so no
// window budget exists and nothing overflows. The dense half is a sum over
// the row's few nonzero query weights (a query has a handful of dense terms
// among V tier rows), not a V-wide product; zero weights are skipped, which
// adds exact zeros in the twin. Selection is pass 1 of topk_select.cuh:
// `lane_key` masks, counts and keys each lane, the bitonic `sort_desc`
// orders the tile; the block writes its t best as (value, id), a lane past
// the last doc (key 0) as (-inf, -1). There is no pass 2: the caller merges
// the tiles.
//
// Arithmetic. wh and hi/lo are bf16-representable, so each product is exact
// in f32 and one __fmaf_rn rounds as the twin's separate multiply (exact)
// and add (rounded); every other add rounds on its own (--fmad=false). The
// kernel and its twin (`fused_tile_candidates_reference` in ops/fused.py)
// agree bit for bit. No tensor cores: their summation order is not the
// twin's.
//
// Bound on an H100 SXM at the C1 chunk (Qc=512, Td=4, N=1M): the bytes of
// the distinct tier rows the chunk touches (hi and lo, 4 B per lane), the
// window entries (8 B each), the live mask and the outputs, at 3.35 TB/s,
// against 4*Qc*Td*N operations at the 67 TFLOP/s CUDA-core f32 rate: bytes
// bound, well under a millisecond. This simple kernel pays one bitonic sort
// of CHUNK keys per (row, tile) block on top, as scan_topk's pass 1 does.

#include "topk_select.cuh"

namespace {

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__global__ void __launch_bounds__(THREADS)
fused_tile_kernel(const uint16_t* __restrict__ hi,
                  const uint16_t* __restrict__ lo, long long N,
                  const int* __restrict__ drows, const float* __restrict__ dwh,
                  int Td, const int* __restrict__ keys,
                  const float* __restrict__ vals, const int* __restrict__ ptr,
                  const uint8_t* __restrict__ live, int njc, int t, int db,
                  float* __restrict__ cand_v, int* __restrict__ cand_i,
                  int* __restrict__ counts) {
  __shared__ unsigned long long tile_keys[CHUNK];
  __shared__ int scratch[THREADS / 32];
  float* sacc = reinterpret_cast<float*>(tile_keys);  // CHUNK floats
  const int q = blockIdx.x;
  const int j = blockIdx.y;
  const long long base = static_cast<long long>(j) * CHUNK;
  const int dmask = (1 << db) - 1;

  // ---- sparse tail: run sums of the block's window into sacc ------------
  for (int i = threadIdx.x; i < CHUNK; i += THREADS) sacc[i] = 0.0f;
  __syncthreads();
  const long long w = static_cast<long long>(q) * (njc + 1) + j;
  const int a = ptr[w];
  const int b = ptr[w + 1];
  for (int p = a + threadIdx.x; p < b; p += THREADS) {
    const int key = keys[p];
    if (p > a && keys[p - 1] == key) continue;  // inside a run
    float s = 0.0f;
    for (int r = p; r < b && keys[r] == key; ++r) s += vals[r];
    sacc[static_cast<long long>(key & dmask) - base] = s;
  }
  __syncthreads();
  float sp[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) sp[e] = sacc[e * THREADS + threadIdx.x];
  __syncthreads();  // sacc is read out before tile_keys overwrites it

  // ---- dense half: the row's nonzero split-bf16 query weights -----------
  float hs[EPT];
  float ls[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    hs[e] = 0.0f;
    ls[e] = 0.0f;
  }
  for (int i = 0; i < Td; ++i) {
    const float wv = dwh[static_cast<long long>(q) * Td + i];
    if (wv == 0.0f) continue;  // uniform across the block
    const long long row = static_cast<long long>(drows[static_cast<long long>(q) * Td + i]) * N;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const long long n = base + e * THREADS + threadIdx.x;
      if (n < N) {
        hs[e] = __fmaf_rn(wv, bf16_bits_to_float(hi[row + n]), hs[e]);
        ls[e] = __fmaf_rn(wv, bf16_bits_to_float(lo[row + n]), ls[e]);
      }
    }
  }

  // ---- mask, count, key; the tile's t best ------------------------------
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int lane = e * THREADS + threadIdx.x;
    const float dense = hs[e] + ls[e];
    tile_keys[lane] = lane_key(dense + sp[e], base + lane, N, IDENTITY, 1, live,
                               nullptr, 0.0f, &cnt);
  }
  const int total = block_sum(cnt, scratch);
  const long long slot = static_cast<long long>(q) * njc + j;
  if (threadIdx.x == 0) counts[slot] = total;
  sort_desc(tile_keys);
  for (int s = threadIdx.x; s < t; s += THREADS) {
    const unsigned long long key = tile_keys[s];
    cand_v[slot * t + s] = key == 0ull ? neg_inf() : key_score(key);
    cand_i[slot * t + s] = key_id(key);  // key 0 -> -1
  }
}

}  // namespace

extern "C" {

int fused_tile_candidates_tile() { return CHUNK; }

// hi, lo: [V, N] bf16 bit patterns; drows, dwh: [Qc, Td] tier rows and
// bf16-representable weights (0 = unused); keys, vals: sorted window
// entries (key (q << db) | docid, value its BM25 part); ptr: [Qc, njc + 1]
// window starts; live: [N] bool. cand_v, cand_i: [Qc, njc, t]; counts:
// [Qc, njc]. Returns cudaGetLastError() after the launch.
int fused_tile_candidates_launch(const uint16_t* hi, const uint16_t* lo,
                                 long long N, const int* drows,
                                 const float* dwh, int Td, const int* keys,
                                 const float* vals, const int* ptr,
                                 const uint8_t* live, int Qc, int njc, int t,
                                 int db, float* cand_v, int* cand_i,
                                 int* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_tile_kernel<<<dim3(Qc, njc), THREADS, 0, st>>>(
      hi, lo, N, drows, dwh, Td, keys, vals, ptr, live, njc, t, db, cand_v,
      cand_i, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
