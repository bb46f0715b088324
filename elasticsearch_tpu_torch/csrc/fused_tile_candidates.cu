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
// are slow. Here the work of a (row, tile) pair is small: ~12 window entries
// and <= Td gathered tier rows at the C1 chunk, to keep t = 7 of 4,096
// lanes. What costs is selecting, so the kernel is built around a warp's
// selection (route SELECT, t <= MAX_K = 128):
//
//   * one 256-thread block per (tile, group of ROWS = 32 query rows); the
//     blocks of a tile are adjacent in launch order, so its tier columns
//     come from L2. The tile's live bytes are staged once per block.
//   * warp w owns rows w, w + 8, ... of the group, one at a time, and walks
//     the tile in 16 steps of 256 docs, 8 neighbouring docs per lane: the
//     dense half by 16-byte loads of the row's nonzero tier rows (the loads
//     of its first 4 rows issued together, before any sum), the sparse
//     tail from the row's window, consumed in doc order 32 entries at a time
//     (the entry that starts a run of equal keys sums the run and stores it
//     into the step's 256-float buffer of the warp: one writer per lane, no
//     atomics, deterministic; the buffer is zeroed again after it is read).
//   * each lane keys its 8 docs (`make_key`: (score desc, docid asc); key 0
//     past N) and counts its positive live docs; only keys above the row's
//     t-th key so far (its threshold) go further. For t <= 32 the row's top
//     t lives in registers (lane i holds rank i) and a passing key is
//     inserted by a ballot (its rank) and a shuffle (the shift); the first
//     step's filter starts at the t-th largest of the lanes' best keys
//     (`warp_kth`), since t lanes hold a key at or above it. For t > 32
//     the top lives in shared memory and `warp_fold` (topk_select.cuh)
//     merges the passing keys. On a tile of n positive lanes about
//     t (1 + ln(n / t)) keys pass. No block barrier stands between one
//     row's selection and the next.
//   * a row with no nonzero weight and an empty window scores nothing: its
//     t best are the tile's first t docs at -inf, written directly.
//
// Keys are distinct (they carry the docid), so the t best are one set in
// any order of filtering and folding: the result is the sort's.
//
// Route SORT (any t <= CHUNK; the wrapper takes it for t > MAX_K, decided
// from t before the launch) is the previous design: one 512-thread block
// per (row, tile), the window's run sums scattered into a 16 KB lane
// buffer, and a bitonic sort of all CHUNK keys (78 barrier stages) to keep
// t.
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
// bound, ~0.76 ms. What the SELECT route pays on top: each (row, tile)
// gathers 8 KB per nonzero weight and tier (mostly from device memory:
// the chunk's rows are distinct) with the loads of its first four weights
// in flight together, and 16 steps of keying and filtering per warp.
//
// Occupancy (ptxas -v, sm_90a): fused_select_kernel 128 registers, no
// spills, 36,960 bytes of static shared memory per block (live 4 KB, step
// buffers 8 KB, per warp a 1 KB top and a 2 KB fold scratch): 2 blocks (16
// warps) per SM, bound by registers. fused_tile_kernel (route SORT) 40
// registers, 32,832 bytes.

#include "topk_select.cuh"

namespace {

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

constexpr int ROUTE_SORT = 0;    // one block per (row, tile), bitonic sort
constexpr int ROUTE_SELECT = 1;  // warp per row, threshold-filtered selection
constexpr int SEL_WARPS = 8;     // warps of a SELECT block
constexpr int ROWS = 32;         // query rows of a SELECT block
constexpr int DPL = 8;           // neighbouring docs of a lane per step
constexpr int STEP = 32 * DPL;   // docs a warp scores per step
constexpr int WMAX = 4;          // nonzero weights whose loads are issued together
constexpr unsigned FULL = 0xffffffffu;

// eight neighbouring bf16 lanes n0 .. n0 + 7 of a tier row, 0 past N
__device__ __forceinline__ uint4 load8_bf16(const uint16_t* __restrict__ row,
                                            long long n0, long long N, bool vec) {
  if (vec && n0 + 7 < N) return __ldg(reinterpret_cast<const uint4*>(row + n0));
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t a = n0 + 2 * e < N ? __ldg(row + n0 + 2 * e) : 0u;
    const uint32_t b = n0 + 2 * e + 1 < N ? __ldg(row + n0 + 2 * e + 1) : 0u;
    w[e] = a | (b << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16 e of eight packed in u, as a float
__device__ __forceinline__ float bf16_of(const uint4& u, int e) {
  const uint32_t w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// the warp's t-th largest of one key per lane (t <= 32)
__device__ __forceinline__ unsigned long long warp_kth(unsigned long long v, int t) {
  return __shfl_sync(FULL, warp_sort32(v), t - 1);
}

__global__ void __launch_bounds__(SEL_WARPS * 32)
fused_select_kernel(const uint16_t* __restrict__ hi,
                    const uint16_t* __restrict__ lo, long long N,
                    const int* __restrict__ drows,
                    const float* __restrict__ dwh, int Td,
                    const int* __restrict__ keys,
                    const float* __restrict__ vals, const int* __restrict__ ptr,
                    const uint8_t* __restrict__ live, int Qc, int njc, int t,
                    int db, float* __restrict__ cand_v,
                    int* __restrict__ cand_i, int* __restrict__ counts) {
  __shared__ __align__(16) uint8_t slive[CHUNK];
  __shared__ __align__(16) float sbuf[SEL_WARPS][STEP];
  __shared__ unsigned long long top[SEL_WARPS][MAX_K];
  __shared__ unsigned long long scr[SEL_WARPS][WARP_FOLD_SCR];
  __shared__ unsigned long long thr[SEL_WARPS];
  __shared__ int ntop[SEL_WARPS];
  const int j = blockIdx.y;
  const long long base = static_cast<long long>(j) * CHUNK;
  const int tbase = static_cast<int>(base);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dmask = (1 << db) - 1;
  const bool vec = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(hi) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(lo) & 15) == 0;
  float4* mine = reinterpret_cast<float4*>(&sbuf[warp][DPL * lane]);

  // the tile's live bytes (0 past N) and the zeroed step buffers
  for (int i = threadIdx.x; i < CHUNK; i += SEL_WARPS * 32)
    slive[i] = base + i < N ? live[base + i] : 0;
  mine[0] = mine[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  for (int r = warp; r < ROWS; r += SEL_WARPS) {
    const int q = blockIdx.x * ROWS + r;
    if (q >= Qc) break;  // uniform across the warp
    const long long slot = static_cast<long long>(q) * njc + j;
    const long long w = static_cast<long long>(q) * (njc + 1) + j;
    const int a = ptr[w];
    const int b = ptr[w + 1];
    const float* wq = dwh + static_cast<long long>(q) * Td;
    const int* rq = drows + static_cast<long long>(q) * Td;

    // the row's first WMAX nonzero weights in i order, in registers (the
    // same in every lane); `rest`: where the plain loop takes over
    float wv[WMAX];
    long long wrow[WMAX];
    int nw = 0;
    int rest = Td;
    for (int x0 = 0; x0 < Td && nw < WMAX; x0 += 32) {
      const int x = x0 + lane;
      const float wx = x < Td ? wq[x] : 0.0f;
      const int rx = x < Td ? rq[x] : 0;
      unsigned m = __ballot_sync(FULL, wx != 0.0f);
      while (m != 0u && nw < WMAX) {
        const int src = __ffs(m) - 1;
        m &= m - 1u;
        const float wsrc = __shfl_sync(FULL, wx, src);
        const long long rsrc = static_cast<long long>(__shfl_sync(FULL, rx, src)) * N;
#pragma unroll
        for (int i = 0; i < WMAX; ++i)
          if (i == nw) {
            wv[i] = wsrc;
            wrow[i] = rsrc;
          }
        if (++nw == WMAX) rest = x0 + src + 1;
      }
    }
    if (nw == 0 && rest >= Td && a == b) {  // every lane -inf: the first t docs
      for (int x = lane; x < t; x += 32) {
        cand_v[slot * t + x] = neg_inf();
        cand_i[slot * t + x] = base + x < N ? tbase + x : -1;
      }
      if (lane == 0) counts[slot] = 0;
      continue;
    }
    if (lane == 0) {
      ntop[warp] = 0;
      thr[warp] = 0ull;
    }
    __syncwarp();
    unsigned long long th = 0ull;  // the row's t-th key so far (0: fewer kept)
    unsigned long long rtop = 0ull;  // t <= 32: the key of rank `lane`
    int cnt = 0;
    // the window's entries [pb, pb + 32) in ek, one per lane; `used` of
    // them consumed
    int pb = a;
    int used = 0;
    int ek = a + lane < b ? __ldg(keys + a + lane) : 0;

    for (int s = 0; s < CHUNK / STEP; ++s) {
      const int l0 = s * STEP + DPL * lane;  // the lane's first doc in the tile
      const long long n0 = base + l0;

      // dense half: the row's nonzero weights in i order, the first WMAX
      // rows' loads issued together
      float hs[DPL];
      float ls[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) hs[e] = ls[e] = 0.0f;
      uint4 hv[WMAX];
      uint4 lv[WMAX];
#pragma unroll
      for (int i = 0; i < WMAX; ++i)
        if (i < nw) {
          hv[i] = load8_bf16(hi + wrow[i], n0, N, vec);
          lv[i] = load8_bf16(lo + wrow[i], n0, N, vec);
        }
#pragma unroll
      for (int i = 0; i < WMAX; ++i)
        if (i < nw) {
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            hs[e] = __fmaf_rn(wv[i], bf16_of(hv[i], e), hs[e]);
            ls[e] = __fmaf_rn(wv[i], bf16_of(lv[i], e), ls[e]);
          }
        }
      for (int x = rest; x < Td; ++x) {
        const float wx = __ldg(wq + x);
        if (wx == 0.0f) continue;  // uniform across the warp
        const long long row = static_cast<long long>(__ldg(rq + x)) * N;
        const uint4 h = load8_bf16(hi + row, n0, N, vec);
        const uint4 l = load8_bf16(lo + row, n0, N, vec);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          hs[e] = __fmaf_rn(wx, bf16_of(h, e), hs[e]);
          ls[e] = __fmaf_rn(wx, bf16_of(l, e), ls[e]);
        }
      }

      // sparse tail: run sums of the window entries whose docs this step holds
      float sp[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) sp[e] = 0.0f;
      const int step_end = s * STEP + STEP;
      bool had = false;
      for (;;) {
        const int idx = pb + lane;
        const bool in = lane >= used && idx < b && (ek & dmask) - tbase < step_end;
        const unsigned m = __ballot_sync(FULL, in);
        if (m == 0u) break;
        had = true;
        int prev = __shfl_up_sync(FULL, ek, 1);
        if (lane == 0) prev = idx > a ? __ldg(keys + idx - 1) : ~ek;
        if (in && prev != ek) {  // the first entry of its run sums the run
          float sum = 0.0f;
          for (int i = idx; i < b && __ldg(keys + i) == ek; ++i) sum = sum + __ldg(vals + i);
          sbuf[warp][(ek & dmask) - tbase - s * STEP] = sum;
        }
        used += __popc(m);  // the entries in order: lanes [used, used + popc)
        if (used < 32) break;
        pb += 32;
        used = 0;
        ek = pb + lane < b ? __ldg(keys + pb + lane) : 0;
      }
      if (had) {  // uniform across the warp
        __syncwarp();
        const float4 v0 = mine[0];
        const float4 v1 = mine[1];
        sp[0] = v0.x;
        sp[1] = v0.y;
        sp[2] = v0.z;
        sp[3] = v0.w;
        sp[4] = v1.x;
        sp[5] = v1.y;
        sp[6] = v1.z;
        sp[7] = v1.w;
        mine[0] = mine[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        __syncwarp();
      }

      // mask, count, key
      const uint2 lw = *reinterpret_cast<const uint2*>(&slive[l0]);
      unsigned long long key[DPL];
      unsigned long long kmax = 0ull;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        float sc = (hs[e] + ls[e]) + sp[e];
        const uint32_t lb = ((e < 4 ? lw.x : lw.y) >> (8 * (e & 3))) & 0xffu;
        if (lb == 0u || !(sc > 0.0f)) sc = neg_inf();
        cnt += sc > 0.0f;  // a live doc below N (slive is 0 past N)
        key[e] = n0 + e < N ? make_key(sc, static_cast<int>(n0 + e)) : 0ull;
        kmax = key[e] > kmax ? key[e] : kmax;
      }
      // the first step: nothing is kept yet, so the filter starts at the
      // t-th largest of the lanes' best keys (t lanes hold a key at or above
      // it, so no key below it is among the tile's t best)
      unsigned long long lo_key = th + 1ull;  // keys >= lo_key pass
      if (s == 0 && t <= 32) {
        const unsigned long long kth = warp_kth(kmax, t);
        if (kth > lo_key) lo_key = kth;
      }
      if (t <= 32) {  // uniform: the top t in registers, keys inserted one by one
        unsigned pend = 0u;
#pragma unroll
        for (int e = 0; e < DPL; ++e) pend |= static_cast<unsigned>(key[e] >= lo_key) << e;
        for (;;) {
          const unsigned m = __ballot_sync(FULL, pend != 0u);
          if (m == 0u) break;
          const int src = __ffs(m) - 1;
          unsigned long long x = 0ull;
          if (lane == src) {
            const int e0 = __ffs(pend) - 1;
#pragma unroll
            for (int e = 0; e < DPL; ++e)
              if (e == e0) x = key[e];
            pend &= pend - 1u;
          }
          x = __shfl_sync(FULL, x, src);
          if (x <= th) continue;  // the threshold rose past it
          const int pos = __popc(__ballot_sync(FULL, lane < t && rtop > x));
          const unsigned long long up = __shfl_up_sync(FULL, rtop, 1);
          if (lane < t && lane >= pos) rtop = lane == pos ? x : up;
          th = __shfl_sync(FULL, rtop, t - 1);
        }
        continue;
      }
      // filter against the row's t-th key so far, fold, four keys at a time
#pragma unroll
      for (int h = 0; h < DPL / 4; ++h) {
        unsigned pass = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) pass |= static_cast<unsigned>(key[4 * h + e] >= lo_key) << e;
        if (__any_sync(FULL, pass != 0u)) {
          warp_fold(top[warp], &thr[warp], &ntop[warp], scr[warp], key[4 * h],
                    key[4 * h + 1], key[4 * h + 2], key[4 * h + 3], pass, t);
          th = thr[warp];
          if (th + 1ull > lo_key) lo_key = th + 1ull;
        }
      }
    }

    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
    const int nt = ntop[warp];
    for (int x = lane; x < t; x += 32) {
      const unsigned long long kk = t <= 32 ? rtop : x < nt ? top[warp][x] : 0ull;
      cand_v[slot * t + x] = kk == 0ull ? neg_inf() : key_score(kk);
      cand_i[slot * t + x] = key_id(kk);  // key 0 -> -1
    }
    if (lane == 0) counts[slot] = cnt;
    __syncwarp();  // top read before the next row resets it
  }
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
// [Qc, njc]. route: 1 (SELECT, t <= 128) or 0 (SORT, t <= CHUNK), chosen
// by the caller from t. Returns cudaGetLastError() after the launch.
int fused_tile_candidates_launch(const uint16_t* hi, const uint16_t* lo,
                                 long long N, const int* drows,
                                 const float* dwh, int Td, const int* keys,
                                 const float* vals, const int* ptr,
                                 const uint8_t* live, int Qc, int njc, int t,
                                 int db, int route, float* cand_v, int* cand_i,
                                 int* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_SELECT) {
    if (t > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
    fused_select_kernel<<<dim3((Qc + ROWS - 1) / ROWS, njc), SEL_WARPS * 32, 0, st>>>(
        hi, lo, N, drows, dwh, Td, keys, vals, ptr, live, Qc, njc, t, db, cand_v,
        cand_i, counts);
  } else if (route == ROUTE_SORT) {
    fused_tile_kernel<<<dim3(Qc, njc), THREADS, 0, st>>>(
        hi, lo, N, drows, dwh, Td, keys, vals, ptr, live, njc, t, db, cand_v,
        cand_i, counts);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
