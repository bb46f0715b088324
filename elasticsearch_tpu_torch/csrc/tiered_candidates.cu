// tiered_candidates: split-bf16 selection scan + top-kb + exact match count,
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel elasticsearch_tpu/ops/kernels.py
// `_tiered_scan_kernel` (launched by `_tiered_candidates_pallas`, public
// `tiered_candidates`). Per query row r and doc lane n it computes
//
//   dots   = sum_d qh[r,d] * hi[d,n]  +  sum_d qh[r,d] * lo[d,n]
//            (qh: the query cut to bf16 by integer masking; hi, lo: the
//             split-bf16 halves of the f32 matrix; f32 accumulation)
//   s      = transform(dots); s = live[n] ? s : -inf;
//            count_positive: s = s > 0 ? s : -inf
//   total  = #(s > 0) | #live
//
// and returns the top kb lanes by (score desc, docid asc), kb <= 128. The
// scores are SELECTION scores: callers rescore the kb candidates in f32 and
// apply the margin test (ops/batched.py, ops/vector.py).
//
// Design. Pass 1 is one CTA per (tile of BM = 128 query rows, span of doc
// tiles of BN = 256 docs). For each doc tile the CTA computes the 128 x 256
// dots as one product over K = 2 * Dp (hi and lo into one f32 accumulator;
// Dp = D rounded up to BK, zero-filled) with mma.sync m16n8k16 (bf16 in,
// f32 accumulate): 8 warps in a 2 x 4 grid, each a 64 x 64 warp tile.
// Operands are staged through a cp.async ring of 3 stages (2 when kb > 89
// leaves no room): each stage holds a BK-deep slice of A = qh [B, Dp] bf16
// (K-contiguous, ldmatrix) and the same slice of both B tiers, hi and lo
// [D, N] (N-contiguous, an MN-major operand, ldmatrix.trans), so the A
// slice serves both halves of K. The tiles are XOR-swizzled in 16-byte
// chunks so that ldmatrix reads are free of bank conflicts. Per tile the
// CTA pulls (BM + 2 * BN) * Dp * 2 bytes through L2 for 4 * BM * BN * Dp
// operations, 102 per byte at D = 896. Each hi/lo byte is read
// ceil(B / 128) times (4 at B = 512, not 128 as with a 4-row register
// tile); the row tiles of one span are adjacent in launch order, so those
// reads mostly hit L2. mma.sync rather than wgmma: it needs no
// shared-memory matrix descriptors (whose MN-major bf16 swizzle modes could
// not be tried before the first run on the card); a wgmma producer with TMA
// is the next step (PERF.md).
//
// Epilogue, per doc tile, in two halves of 128 docs: the accumulators go
// to a padded score tile in shared memory (it aliases the drained operand
// ring); warp w then owns rows w, w + 8, ... for the whole span: it keys
// each lane (`lane_key`: transform, live mask, count_positive, NaN / -0 /
// docid order), adds the row's count, and filters the lanes against the
// row's threshold, the kb-th key kept so far. Lanes that beat it are merged
// into the row's sorted top kb without a block barrier (`warp_fold`,
// topk_select.cuh): one or two by ballot insertion, up to 32 by ranks (a
// shuffle sort, then binary searches), more (the first tiles of a span) by
// a warp-level bitonic sort.
// A long span per CTA lets the threshold rise early, so few lanes get that
// far. Pass 2 (`select_merge_row`, topk_select.cuh) merges the spans'
// candidates per row and sums the counts.
//
// Arithmetic. The tensor cores add in their own order and align addends by
// truncation, so the dots are not the twin's bit for bit (the twin,
// `tiered_candidates_reference`, sums d = 0 .. D-1 from 0.0 for each half,
// then adds the halves). Every bf16 x bf16 product is exact in f32; the
// difference per lane is within 4 * D * 2^-24 * sum_d |qh_d| (|hi_dn| +
// |lo_dn|), the f32 summation bound of 2D terms doubled for truncation
// (Fasi, Higham, Mikaitis, Pranesh, "Numerical behavior of NVIDIA tensor
// cores", 2021): ~2e-4 relative at D = 896, about 100x inside the callers'
// EPS_TIERED = 2e-2 margin. `check_tiered_selection` (ops/kernels.py) holds
// the kernel to that bound, carried through the transform. Totals stay
// exact. The transform runs in the JAX package's operation order under
// --fmad=false (which does not touch mma).
//
// Bound on an H100 SXM at the msearch path's shape (B=512, D=896, N=1M):
// 4*B*D*N = 1.84e12 operations at the 989 TFLOP/s bf16 tensor-core peak
// = 1.86 ms, above the 2*D*N*2 bytes of hi and lo at 3.35 TB/s = 1.07 ms,
// so operation bound. N not a multiple of 8 (rows of hi / lo not 16-byte
// aligned) takes a scalar load path for the B operand: right, but slow.

#include "topk_select.cuh"

namespace {

constexpr int BM = 128;            // query rows per CTA
constexpr int BN = 256;            // docs per doc tile
constexpr int HN = 128;            // docs per epilogue half
constexpr int BK = 32;             // depth per ring stage (bf16)
constexpr int TC_THREADS = 256;    // 8 warps: 2 (rows) x 4 (docs)
constexpr int WARPS = TC_THREADS / 32;
constexpr int SROW = HN + 8;       // floats per score-tile row (bank spread)
constexpr int A_STAGE = BM * BK * 2;  // bytes: qh
constexpr int B_STAGE = BK * BN * 2;  // bytes: hi, and as many for lo
constexpr int STAGE = A_STAGE + 2 * B_STAGE;
constexpr int TILE_BYTES = BM * SROW * 4;
constexpr int SMEM_MAX = 232448;   // a block's shared memory on sm_90

size_t smem_bytes(int k, int stages) {
  const size_t ring = static_cast<size_t>(stages) * STAGE;
  return (ring > TILE_BYTES ? ring : TILE_BYTES) + static_cast<size_t>(BM) * k * 8 +
         BM * 8 + BM * 4 * 2 + WARPS * WARP_FOLD_SCR * 8;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// swizzled byte offsets of 16-byte chunk `ch` of a row in the A and B tiles
__device__ __forceinline__ uint32_t a_off(int row, int ch) {
  return row * (BK * 2) + ((ch ^ ((row >> 1) & 3)) << 4);
}
__device__ __forceinline__ uint32_t b_off(int krow, int ch) {
  return krow * (BN * 2) + ((ch ^ (krow & 7)) << 4);
}

// the ring stage's three tiles: qh, hi, lo
__device__ __forceinline__ uint32_t stage_a(int slot) { return slot * STAGE; }
__device__ __forceinline__ uint32_t stage_b(int slot, int half) {
  return slot * STAGE + A_STAGE + half * B_STAGE;
}

// Ring stage `slot` <- depth step kt: qh columns [k0, k0 + BK) of rows
// [r0, r0 + BM), and rows [k0, k0 + BK) of hi and of lo, docs [n0, n0 + BN).
// Out-of-range rows, depths and docs are zero-filled.
__device__ __forceinline__ void load_stage(
    unsigned char* smem, uint32_t sbase, int slot, int kt,
    const uint16_t* __restrict__ qh, const uint16_t* __restrict__ hi,
    const uint16_t* __restrict__ lo, int B, int D, int Dp, long long N,
    int r0, long long n0, bool bvec) {
  const int k0 = kt * BK;
#pragma unroll
  for (int i = 0; i < (BM * BK / 8) / TC_THREADS; ++i) {
    const int c = threadIdx.x + i * TC_THREADS;
    const int row = c >> 2;
    const int ch = c & 3;
    const int r = r0 + row;
    const uint16_t* src =
        qh + static_cast<long long>(r < B ? r : B - 1) * Dp + k0 + ch * 8;
    cp_async16(sbase + stage_a(slot) + a_off(row, ch), src, r < B ? 16 : 0);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint16_t* mat = half == 0 ? hi : lo;
#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / TC_THREADS; ++i) {
      const int c = threadIdx.x + i * TC_THREADS;
      const int krow = c / (BN / 8);
      const int ch = c % (BN / 8);
      const int d = k0 + krow;
      const long long n = n0 + ch * 8;
      const uint32_t off = stage_b(slot, half) + b_off(krow, ch);
      if (bvec) {
        const bool ok = d < D && n < N;  // N % 8 == 0: a chunk is all in or out
        cp_async16(sbase + off, ok ? mat + static_cast<long long>(d) * N + n : mat,
                   ok ? 16 : 0);
      } else {
        uint16_t v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (d < D && n + e < N) ? mat[static_cast<long long>(d) * N + n + e]
                                      : static_cast<uint16_t>(0);
        uint4 w;
        w.x = v[0] | (static_cast<uint32_t>(v[1]) << 16);
        w.y = v[2] | (static_cast<uint32_t>(v[3]) << 16);
        w.z = v[4] | (static_cast<uint32_t>(v[5]) << 16);
        w.w = v[6] | (static_cast<uint32_t>(v[7]) << 16);
        *reinterpret_cast<uint4*>(smem + off) = w;
      }
    }
  }
}

// The live mask (one byte per lane, in the low byte first) and aux_doc of
// the four neighbouring docs nb .. nb + 3, read once for every row of a
// tile; docs past N read as dead.
__device__ __forceinline__ uint32_t docs4(const uint8_t* __restrict__ live,
                                          const float* __restrict__ aux_doc,
                                          long long nb, long long N,
                                          bool aligned, bool aux, float4* ad) {
  *ad = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (aligned && nb + 3 < N) {
    if (aux) *ad = *reinterpret_cast<const float4*>(aux_doc + nb);
    return *reinterpret_cast<const uint32_t*>(live + nb);
  }
  uint32_t lv = 0u;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (nb + e < N) {
      lv |= static_cast<uint32_t>(live[nb + e] != 0) << (8 * e);
      if (aux) a[e] = aux_doc[nb + e];
    }
  *ad = make_float4(a[0], a[1], a[2], a[3]);
  return lv;
}

template <int STAGES>
__global__ void __launch_bounds__(TC_THREADS, 1)
tiered_tc_kernel(const uint16_t* __restrict__ qh,
                 const uint16_t* __restrict__ hi,
                 const uint16_t* __restrict__ lo,
                 const uint8_t* __restrict__ live,
                 const float* __restrict__ aux_doc,
                 const float* __restrict__ aux_q, int B, int D, int Dp,
                 long long N, int tiles_per_span, int nspans, int k,
                 int transform, int count_positive,
                 unsigned long long* __restrict__ cand,
                 int* __restrict__ partial) {
  constexpr int RING = STAGES * STAGE;
  constexpr int UNION_BYTES = RING > TILE_BYTES ? RING : TILE_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* S = reinterpret_cast<float*>(smem);  // aliases the drained ring
  unsigned long long* top = reinterpret_cast<unsigned long long*>(smem + UNION_BYTES);
  unsigned long long* thr = top + BM * k;
  int* ntop = reinterpret_cast<int*>(thr + BM);
  int* rcnt = ntop + BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* wscr =
      reinterpret_cast<unsigned long long*>(rcnt + BM) + warp * WARP_FOLD_SCR;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int ntr = (B + BM - 1) / BM;
  const int rt = blockIdx.x % ntr;  // row tiles of one span are adjacent
  const int sp = blockIdx.x / ntr;
  const int r0 = rt * BM;
  const long long ndt = (N + BN - 1) / BN;
  const long long t0 = static_cast<long long>(sp) * tiles_per_span;
  const long long t1 = min(ndt, t0 + tiles_per_span);
  const int ktiles = Dp / BK;
  const bool bvec = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(hi) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(lo) & 15) == 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(live) & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(aux_doc) & 15) == 0;
  const int wm = warp >> 2;  // 64-row half of the tile
  const int wn = warp & 3;   // 64-doc quarter of the tile
  for (int i = threadIdx.x; i < BM; i += TC_THREADS) {
    thr[i] = 0ull;
    ntop[i] = 0;
    rcnt[i] = 0;
  }
  const bool aux = aux_doc != nullptr && reads_aux_doc(transform);

  for (long long t = t0; t < t1; ++t) {
    const long long n0 = t * BN;
    float acc[4][8][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) load_stage(smem, sbase, s, s, qh, hi, lo, B, D, Dp, N, r0, n0, bvec);
      cp_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_wait<STAGES - 2>();
      __syncthreads();  // stage kt landed; stage kt - 1 consumed by all
      const int nk = kt + STAGES - 1;
      if (nk < ktiles)
        load_stage(smem, sbase, nk % STAGES, nk, qh, hi, lo, B, D, Dp, N, r0, n0, bvec);
      cp_commit();
      const int slot = kt % STAGES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int row = wm * 64 + mi * 16 + (lane & 15);
          ldsm_x4(sbase + stage_a(slot) + a_off(row, kk * 2 + (lane >> 4)), a[mi]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // the hi tier, then the lo tier
          uint32_t b[8][2];
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            const int krow = kk * 16 + (lane & 15);
            const int ch = (wn * 64 + nj * 16) / 8 + (lane >> 4);
            uint32_t r[4];
            ldsm_x4_trans(sbase + stage_b(slot, half) + b_off(krow, ch), r);
            b[2 * nj][0] = r[0];
            b[2 * nj][1] = r[1];
            b[2 * nj + 1][0] = r[2];
            b[2 * nj + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
      }
    }
    cp_wait<0>();

    // the epilogue, in two halves of HN docs: accumulator fragments (row g /
    // g + 8, docs 2q, 2q + 1 of each m16 x n8 tile) -> score tile, then
    // each warp keys, counts and filters its rows
    const int g = lane >> 2;
    const int qd = lane & 3;
#pragma unroll
    for (int h = 0; h < BN / HN; ++h) {
      __syncthreads();  // the ring (or the previous half) free for the score tile
      if ((wn >> 1) == h) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int row = wm * 64 + mi * 16 + g;
            const int col = (wn & 1) * 64 + ni * 8 + 2 * qd;
            *reinterpret_cast<float2*>(S + row * SROW + col) =
                make_float2(acc[mi][ni][0], acc[mi][ni][1]);
            *reinterpret_cast<float2*>(S + (row + 8) * SROW + col) =
                make_float2(acc[mi][ni][2], acc[mi][ni][3]);
          }
      }
      __syncthreads();
      const long long nb = n0 + h * HN + 4 * lane;
      float4 ad;
      const uint32_t lv = docs4(live, aux_doc, nb, N, aligned, aux, &ad);
      // warp w owns rows w, w + WARPS, ... of the tile for the whole span
#pragma unroll 2
      for (int i = warp; i < BM; i += WARPS) {
        if (r0 + i >= B) break;  // uniform across the warp
        const float auxq = aux_q != nullptr ? aux_q[r0 + i] : 0.0f;
        const float4 d4 = *reinterpret_cast<const float4*>(S + i * SROW + 4 * lane);
        unsigned long long key[4];
        bool p[4];
        int np = 0;
        const unsigned counted = lanes4(d4, nb, N, transform, count_positive, lv, ad,
                                        auxq, thr[i], key, p, &np);
        int c = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c += __popc(__ballot_sync(0xffffffffu, (counted >> e) & 1u));
        if (lane == 0) rcnt[i] += c;
        if (__any_sync(0xffffffffu, np > 0))
          warp_fold(top + static_cast<long long>(i) * k, &thr[i], &ntop[i], wscr,
                    key[0], key[1], key[2], key[3],
                    p[0] | (p[1] << 1) | (p[2] << 2) | (p[3] << 3), k);
      }
    }
    __syncthreads();  // the score tile read before the next tile's loads
  }

  for (int i = warp; i < BM; i += WARPS) {
    if (r0 + i >= B) break;
    const long long slot = static_cast<long long>(r0 + i) * nspans + sp;
    for (int j = lane; j < k; j += 32)
      cand[slot * k + j] = j < ntop[i] ? top[static_cast<long long>(i) * k + j] : 0ull;
    if (lane == 0) partial[slot] = rcnt[i];
  }
}

__global__ void __launch_bounds__(SEL_THREADS)
tiered_merge_kernel(const unsigned long long* __restrict__ cand,
                    const int* __restrict__ partial, int nspans, int k,
                    float* __restrict__ out_v, int* __restrict__ out_i,
                    int* __restrict__ out_t) {
  select_merge_row(cand, partial, nspans, k, out_v, out_i, out_t);
}

// pass-1 geometry -> spans per row tile; *tps: doc tiles per span. One CTA
// fits an SM (its shared memory), so one wave: as many spans as leave every
// SM one CTA. Longer spans raise the row thresholds sooner, so fewer lanes
// are merged, and the spans' candidates are fewer to merge in pass 2.
int spans_for(int B, long long N, int* tps) {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ndt = (N + BN - 1) / BN;
  const int ntr = (B + BM - 1) / BM;
  long long want = sms / ntr;
  if (want > ndt) want = ndt;
  if (want < 1) want = 1;
  const long long per = (ndt + want - 1) / want;
  *tps = static_cast<int>(per);
  return static_cast<int>((ndt + per - 1) / per);
}

}  // namespace

extern "C" {

// the depth step: qh's columns are padded with zeros to a multiple of it
int tiered_candidates_depth() { return BK; }

// pass-1 spans per row, for the size of the cand/partial scratch
int tiered_candidates_spans(int B, long long N) {
  int tps;
  return spans_for(B, N, &tps);
}

// qh: [B, Dp] bf16 bit patterns (the query cut to bf16, zero past D; Dp a
// multiple of tiered_candidates_depth()); hi, lo: [D, N] bf16 bit patterns;
// aux_doc / aux_q may be nullptr, read as zeros. cand: [B, nspans, k] u64
// scratch; partial: [B, nspans] i32 scratch, nspans =
// tiered_candidates_spans(B, N). Returns cudaGetLastError() after the
// launches.
int tiered_candidates_launch(const uint16_t* qh, const uint16_t* hi,
                             const uint16_t* lo, const uint8_t* live,
                             const float* aux_doc, const float* aux_q, int B,
                             int D, int Dp, long long N, int k, int transform,
                             int count_positive, unsigned long long* cand,
                             int* partial, float* out_v, int* out_i,
                             int* out_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tps;
  const int nspans = spans_for(B, N, &tps);
  const int ntr = (B + BM - 1) / BM;
  const unsigned grid = static_cast<unsigned>(nspans) * ntr;
  // a three-stage ring where the row tile's top kb leaves room, else two
  cudaError_t err;
  if (smem_bytes(k, 3) <= SMEM_MAX) {
    const size_t smem = smem_bytes(k, 3);
    err = cudaFuncSetAttribute(tiered_tc_kernel<3>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tiered_tc_kernel<3><<<grid, TC_THREADS, smem, st>>>(
        qh, hi, lo, live, aux_doc, aux_q, B, D, Dp, N, tps, nspans, k, transform,
        count_positive, cand, partial);
  } else {
    const size_t smem = smem_bytes(k, 2);
    err = cudaFuncSetAttribute(tiered_tc_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tiered_tc_kernel<2><<<grid, TC_THREADS, smem, st>>>(
        qh, hi, lo, live, aux_doc, aux_q, B, D, Dp, N, tps, nspans, k, transform,
        count_positive, cand, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tiered_merge_kernel<<<B, SEL_THREADS, 0, st>>>(cand, partial, nspans, k,
                                                 out_v, out_i, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
