// scan_topk: fused scan + top-k + exact match count, for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticsearch_tpu/ops/kernels.py
// `_scan_topk_kernel` (launched by `_scan_topk_pallas`, public `scan_topk`).
// Per query row it computes
//
//   dots   = q[r] . mat_t[:, n]          (matmul mode; one fma per d)
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
//   pass 1  one block per (row, or tile of 64 rows in matmul mode; doc
//           span): computes the lane scores and keeps, per row, the span's
//           k best keys by a threshold filter (a lane is merged only if it
//           beats the k-th key kept so far), and the span's int32 match
//           count. The span count is chosen from the shape, so that B = 1
//           still fills the card;
//   pass 2  one block per row: the same filter over the spans' candidates,
//           and the integer sum of their counts.
// The top k of distinct keys is one set whatever order lanes arrive in, so
// the result does not depend on the filter's order or the atomics'.
//
// Streamed mode: one block of SEL_THREADS per (row, span) reads the row's
// scores with 16-byte loads (a scalar edge where a row is not 16-byte
// aligned), neighbouring threads on neighbouring addresses, and stages the
// lanes that beat the row's threshold in shared memory (`sel_push`,
// `sel_fold`). Memory bound: B*N*4 + N*5 bytes (scores, live, aux_doc when
// the transform reads it), 0.61 ms at B=512, N=1M on an H100 SXM
// (3.35 TB/s); live and aux_doc stay in L2.
//
// Matmul mode. Bound on an H100 SXM: 2*B*D*N operations on the CUDA cores
// at 67 TFLOP/s f32 (0.734 ms at B=64, D=384, N=1M; ~8 ms at the exact kNN
// arm's rerun, B ~ 700), against D*N*4*ceil(B/64) bytes of mat_t at
// 3.35 TB/s (0.46 ms at B <= 64): operation bound from B ~ 30. The design
// keeps the FMA pipe fed:
//   - one block per (tile of BM = 64 query rows, span of doc tiles of BN =
//     256 docs); the row tiles of one span are adjacent in launch order.
//     mat_t is read from HBM once per row tile: once at B <= 64, where the
//     old 8-row tile read it 8 times;
//   - 8 product warps run a cp.async ring of 3 shared-memory stages (2
//     where k leaves no room), each a BK = 32 deep slice of the query tile
//     (q transposed and zero-padded by the wrapper to [Dp, Bp], so a slice
//     is [BK][BM], rows contiguous) and of mat_t [BK][BN]; the ring runs on
//     across doc tiles;
//   - register blocking: product warp w owns rows 8w .. 8w + 7 of the
//     tile, lane l docs 4l .. 4l + 3 and 128 + 4l .. 128 + 4l + 3; per
//     depth step a thread reads 8 q values (two 16-byte broadcast loads)
//     and 8 mat_t values (two 16-byte loads, conflict-free) for 64 fma. A
//     warp whose rows are all past B skips the product. The depth loop is
//     unrolled 8 times, not 32 (fully unrolled it spills the instruction
//     cache: scripts/scan_probe.py);
//   - the selection is fused but runs in 4 warps of its own: at a tile's
//     end the product warps hand its 64 x 256 dots, with the tile's live
//     mask and aux_doc (which ride the ring with its last depth step), to
//     a shared-memory buffer and go on with the next tile, while the
//     selection warps (16 rows each) key them (`lanes4`), count them and
//     merge the lanes that beat each row's threshold (`warp_fold`). So the
//     selection's latencies overlap the product, and the selection reads
//     no global memory (a load issued behind the ring's copies waits for
//     them). Named barriers order the roles: the ring's among the product
//     warps, FULL (a tile handed over) and FREE (the buffer back). No
//     [B, N] score matrix is written.
//
// Arithmetic. Every dot is acc = __fmaf_rn(q[r, d], m[d, n], acc) for d =
// 0 .. D-1 from +0.0, one correctly rounded fma per (lane, d), in d order
// whatever B, the tiling or the span split (D is never split; zero-padded
// depth steps past D leave acc as it is, but for -0 -> +0, which the order
// key does not tell apart). The PyTorch twin (`_fma_dots` in
// ops/kernels.py) computes the same fma exactly in f64 (TwoSum and round to
// odd), so kernel and twin agree bit for bit. The file is built with
// --fmad=false (no other multiply-add is contracted: the transforms round
// each operation as the twin does) and without fast math, so no denormal
// is flushed. No tensor cores: TF32 is not f32.

#include "topk_select.cuh"

namespace {

constexpr int SPAN_BLOCKS = 264;   // streamed pass-1 blocks aimed at (2 per SM)
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

// ---------------------------------------------------------------------------
// matmul mode
// ---------------------------------------------------------------------------

constexpr int BM = 64;                   // query rows per tile
constexpr int BN = 256;                  // docs per tile
constexpr int HN = 128;                  // docs per selection half
constexpr int BK = 32;                   // depth per ring stage
constexpr int MM_WARPS = 8;              // the product's warps
constexpr int SEL_WARPS = 4;             // the selection's warps
constexpr int MATH_THREADS = MM_WARPS * 32;
constexpr int MM_THREADS = (MM_WARPS + SEL_WARPS) * 32;
constexpr int RPW = BM / MM_WARPS;       // rows per product warp (8)
constexpr int RPS = BM / SEL_WARPS;      // rows per selection warp (16)
constexpr int SMEM_MAX = 232448;         // a block's shared memory on sm_90
// named barriers (0 is __syncthreads'): the product warps' ring; the
// tile handed to the selection warps; the hand-off buffer free again
constexpr int BAR_RING = 1;
constexpr int BAR_FULL = 2;
constexpr int BAR_FREE = 3;
constexpr int Q_STAGE = BK * BM * 4;     // bytes: the query slice [BK][BM]
constexpr int M_STAGE = BK * BN * 4;     // bytes: the mat_t slice [BK][BN]
constexpr int L_STAGE = BN;              // bytes: the tile's live mask
constexpr int A_STAGE = BN * 4;          // bytes: the tile's aux_doc
constexpr int STAGE = Q_STAGE + M_STAGE + L_STAGE + A_STAGE;
constexpr int HANDOFF = BM * BN * 4 + L_STAGE + A_STAGE;  // a tile's dots and docs

// shared memory of one block: the ring, the hand-off buffer, each row's
// top k, threshold, count and aux_q, and the selection warps' scratch
size_t matmul_smem(int k, int stages) {
  return static_cast<size_t>(stages) * STAGE + HANDOFF + static_cast<size_t>(BM) * k * 8 +
         BM * 8 + BM * 4 * 3 + SEL_WARPS * WARP_FOLD_SCR * 8;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// Ring stage `slot` <- depth step k0 of doc tile n0: qt rows [k0, k0 + BK),
// columns [r0, r0 + BM) (zero-padded by the wrapper), and mat_t rows
// [k0, k0 + BK), docs [n0, n0 + BN), zero-filled past D and N. The tile's
// last depth step (`docs`) also brings its live mask and aux_doc (when the
// transform reads it), zero past N, so that the selection reads no global
// memory: a global load issued behind the ring's copies waits for them.
__device__ __forceinline__ void load_stage(unsigned char* smem, uint32_t sbase,
                                           int slot, const float* __restrict__ qt,
                                           const float* __restrict__ mat,
                                           const uint8_t* __restrict__ live,
                                           const float* __restrict__ aux_doc, int Bp,
                                           int D, long long N, int r0, int k0,
                                           long long n0, bool mvec, bool docs,
                                           bool dvec) {
  const uint32_t qoff = slot * STAGE;
  const uint32_t moff = qoff + Q_STAGE;
#pragma unroll
  for (int i = 0; i < (BK * BM / 4) / MATH_THREADS; ++i) {
    const int c = threadIdx.x + i * MATH_THREADS;
    const int row = c / (BM / 4);
    const int ch = c % (BM / 4);
    cp_async16(sbase + qoff + (row * BM + ch * 4) * 4,
               qt + static_cast<long long>(k0 + row) * Bp + r0 + ch * 4, 16);
  }
#pragma unroll
  for (int i = 0; i < (BK * BN / 4) / MATH_THREADS; ++i) {
    const int c = threadIdx.x + i * MATH_THREADS;
    const int krow = c / (BN / 4);
    const int ch = c % (BN / 4);
    const int d = k0 + krow;
    const long long n = n0 + ch * 4;
    const uint32_t off = moff + (krow * BN + ch * 4) * 4;
    if (mvec) {
      const bool ok = d < D && n < N;  // N % 4 == 0: a chunk is all in or out
      cp_async16(sbase + off, ok ? mat + static_cast<long long>(d) * N + n : mat,
                 ok ? 16 : 0);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (d < D && n + e < N) ? mat[static_cast<long long>(d) * N + n + e] : 0.0f;
      *reinterpret_cast<float4*>(smem + off) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (!docs) return;
  const uint32_t loff = moff + M_STAGE;
  const uint32_t aoff = loff + L_STAGE;
  const int t = threadIdx.x;
  if (t < L_STAGE / 16) {  // 16 live bytes per thread
    const long long n = n0 + 16 * t;
    if (dvec) {
      const long long left = N - n;
      const int bytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
      cp_async16(sbase + loff + 16 * t, bytes > 0 ? live + n : live, bytes);
    } else {
      for (int e = 0; e < 16; ++e)
        smem[loff + 16 * t + e] = n + e < N ? live[n + e] : 0;
    }
  } else if (aux_doc != nullptr && t < (L_STAGE + A_STAGE) / 16) {  // 4 floats
    const int u = t - L_STAGE / 16;
    const long long n = n0 + 4 * u;
    if (dvec) {
      const long long left = N - n;
      const int bytes = left >= 4 ? 16 : (left > 0 ? static_cast<int>(left) * 4 : 0);
      cp_async16(sbase + aoff + 16 * u, bytes > 0 ? aux_doc + n : aux_doc, bytes);
    } else {
      float* a = reinterpret_cast<float*>(smem + aoff) + 4 * u;
      for (int e = 0; e < 4; ++e) a[e] = n + e < N ? aux_doc[n + e] : 0.0f;
    }
  }
}

// Warps 0-7 run the product over the ring; at a tile's end they hand its
// dots (and the tile's live mask and aux_doc) to warps 8-11 through a
// shared-memory buffer and go on with the next tile, while warps 8-11 key,
// count and filter the handed tile's rows (16 each) against their running
// top k. So the selection's latencies overlap the product, and no product
// warp waits for a merge. Named barriers order the two: the product warps
// sync their ring among themselves; FULL hands a tile over, FREE hands the
// buffer back.
template <int STAGES>
__global__ void __launch_bounds__(MM_THREADS, 1)
scan_matmul_kernel(const float* __restrict__ qt, const float* __restrict__ mat,
                   const uint8_t* __restrict__ live,
                   const float* __restrict__ aux_doc,
                   const float* __restrict__ aux_q, int B, int D, long long N,
                   int tiles_per_span, int nspans, int k, int transform,
                   int count_positive, unsigned long long* __restrict__ cand,
                   int* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RING = STAGES * STAGE;
  float* hand = reinterpret_cast<float*>(smem + RING);  // [BM][BN] dots
  unsigned char* hlive = smem + RING + BM * BN * 4;     // [BN] live bytes
  float* haux = reinterpret_cast<float*>(hlive + L_STAGE);  // [BN] aux_doc
  unsigned long long* top = reinterpret_cast<unsigned long long*>(smem + RING + HANDOFF);
  unsigned long long* thr = top + BM * k;
  int* ntop = reinterpret_cast<int*>(thr + BM);
  int* rcnt = ntop + BM;
  float* auxq = reinterpret_cast<float*>(rcnt + BM);  // the tile's rows' aux_q
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int ntr = (B + BM - 1) / BM;
  const int Bp = ntr * BM;
  const int ktiles = (D + BK - 1) / BK;
  const int rt = blockIdx.x % ntr;  // row tiles of one span are adjacent
  const int sp = blockIdx.x / ntr;
  const int r0 = rt * BM;
  const long long ndt = (N + BN - 1) / BN;
  const long long t0 = static_cast<long long>(sp) * tiles_per_span;
  const long long t1 = min(ndt, t0 + tiles_per_span);
  const float* auxd = reads_aux_doc(transform) ? aux_doc : nullptr;
  for (int i = threadIdx.x; i < BM; i += MM_THREADS) {
    thr[i] = 0ull;
    ntop[i] = 0;
    rcnt[i] = 0;
    auxq[i] = (aux_q != nullptr && r0 + i < B) ? aux_q[r0 + i] : 0.0f;
  }
  __syncthreads();

  if (warp >= MM_WARPS) {
    // ---- the selection warps: rows w0 .. w0 + RPS - 1 of the tile
    const int w0 = (warp - MM_WARPS) * RPS;
    const int nrows = max(0, min(RPS, B - r0 - w0));
    unsigned long long* wscr = reinterpret_cast<unsigned long long*>(auxq + BM) +
                               (warp - MM_WARPS) * WARP_FOLD_SCR;
    bar_arrive(BAR_FREE, MM_THREADS);  // the buffer starts free
    for (long long t = t0; t < t1; ++t) {
      bar_sync(BAR_FULL, MM_THREADS);  // tile t handed over
      const long long n0 = t * BN;
      uint32_t lv[BN / HN];
      float4 ad[BN / HN];
      int nlive[BN / HN];  // live lanes of the half: the count of every row
#pragma unroll
      for (int h = 0; h < BN / HN; ++h) {
        lv[h] = *reinterpret_cast<const uint32_t*>(hlive + h * HN + 4 * lane);
        ad[h] = auxd != nullptr ? *reinterpret_cast<const float4*>(haux + h * HN + 4 * lane)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        nlive[h] = 0;  // (past N the staged mask is 0)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          nlive[h] += __popc(__ballot_sync(0xffffffffu, ((lv[h] >> (8 * e)) & 0xffu) != 0u));
      }
      for (int i = 0; i < nrows; ++i) {
        const int row = w0 + i;
#pragma unroll
        for (int h = 0; h < BN / HN; ++h) {
          const long long nb = n0 + h * HN + 4 * lane;
          const float4 d4 = *reinterpret_cast<const float4*>(hand + row * BN + h * HN + 4 * lane);
          unsigned long long key[4];
          bool p[4];
          int np = 0;
          const unsigned counted = lanes4(d4, nb, N, transform, count_positive, lv[h],
                                          ad[h], auxq[row], thr[row], key, p, &np);
          int c = nlive[h];
          if (count_positive) {
            c = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c += __popc(__ballot_sync(0xffffffffu, (counted >> e) & 1u));
          }
          if (lane == 0) rcnt[row] += c;
          if (__any_sync(0xffffffffu, np > 0))
            warp_fold(top + static_cast<long long>(row) * k, &thr[row], &ntop[row], wscr,
                      key[0], key[1], key[2], key[3],
                      p[0] | (p[1] << 1) | (p[2] << 2) | (p[3] << 3), k);
        }
      }
      if (t + 1 < t1) bar_arrive(BAR_FREE, MM_THREADS);  // (the last is never awaited)
    }
    for (int i = 0; i < nrows; ++i) {
      const int row = w0 + i;
      const long long slot = static_cast<long long>(r0 + row) * nspans + sp;
      for (int j = lane; j < k; j += 32)
        cand[slot * k + j] = j < ntop[row] ? top[static_cast<long long>(row) * k + j] : 0ull;
      if (lane == 0) partial[slot] = rcnt[row];
    }
    return;
  }

  // ---- the product warps: warp w owns rows 8w .. 8w + 7 of the tile
  const long long steps = (t1 - t0) * ktiles;
  const bool mvec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(mat) & 15) == 0;
  const bool dvec = (reinterpret_cast<uintptr_t>(live) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(auxd) & 15) == 0;
  const int w0 = warp * RPW;  // the warp's first row in the tile
  const bool active = r0 + w0 < B;  // uniform across the warp
  float acc[RPW][8];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      load_stage(smem, sbase, s, qt, mat, live, auxd, Bp, D, N, r0, (s % ktiles) * BK,
                 (t0 + s / ktiles) * BN, mvec, s % ktiles == ktiles - 1, dvec);
    cp_commit();
  }
  int kt = 0;  // depth step of the current doc tile
  for (long long s = 0; s < steps; ++s) {
    cp_wait<STAGES - 2>();
    bar_sync(BAR_RING, MATH_THREADS);  // stage s landed; stage s - 1 consumed by all
    const long long ns = s + STAGES - 1;
    if (ns < steps)
      load_stage(smem, sbase, static_cast<int>(ns % STAGES), qt, mat, live, auxd, Bp, D,
                 N, r0, static_cast<int>(ns % ktiles) * BK, (t0 + ns / ktiles) * BN, mvec,
                 ns % ktiles == ktiles - 1, dvec);
    cp_commit();
    const unsigned char* st = smem + static_cast<int>(s % STAGES) * STAGE;
    if (active) {
      const float* qs = reinterpret_cast<const float*>(st) + w0;
      const float* ms = reinterpret_cast<const float*>(st + Q_STAGE) + 4 * lane;
#pragma unroll 8
      for (int dd = 0; dd < BK; ++dd) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + dd * BM);
        const float4 qb = *reinterpret_cast<const float4*>(qs + dd * BM + 4);
        const float4 ma = *reinterpret_cast<const float4*>(ms + dd * BN);
        const float4 mb = *reinterpret_cast<const float4*>(ms + dd * BN + HN);
        const float qv[RPW] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float mv[8] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(qv[i], mv[j], acc[i][j]);
      }
    }
    if (++kt < ktiles) continue;
    // the tile's dots are complete: hand them over with the live mask and
    // aux_doc that this last stage brought (lane l: docs 4l .. 4l + 3 and
    // 128 + 4l .. 128 + 4l + 3 of each of the warp's rows)
    bar_sync(BAR_FREE, MM_THREADS);  // the previous tile's selection is done
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      *reinterpret_cast<float4*>(hand + (w0 + i) * BN + 4 * lane) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(hand + (w0 + i) * BN + HN + 4 * lane) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    if (threadIdx.x < (L_STAGE + A_STAGE) / 16)  // 16 bytes each
      reinterpret_cast<uint4*>(hlive)[threadIdx.x] =
          reinterpret_cast<const uint4*>(st + Q_STAGE + M_STAGE)[threadIdx.x];
    bar_arrive(BAR_FULL, MM_THREADS);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    kt = 0;
  }
  cp_wait<0>();
}

__global__ void __launch_bounds__(SEL_THREADS)
scan_merge_kernel(const unsigned long long* __restrict__ cand,
                  const int* __restrict__ partial, int nspans, int k,
                  float* __restrict__ out_v, int* __restrict__ out_i,
                  int* __restrict__ out_t) {
  select_merge_row(cand, partial, nspans, k, out_v, out_i, out_t);
}

// the streamed pass-1 geometry -> spans per row; *span_len: docs per span
int spans_for(int B, long long N, long long* span_len) {
  const long long units = (N + STEP - 1) / STEP;
  long long want = (SPAN_BLOCKS + B - 1) / B;
  if (want > units) want = units;
  if (want < 1) want = 1;
  long long per = (units + want - 1) / want;  // units per span
  if (per < 1) per = 1;
  *span_len = per * STEP;
  return static_cast<int>((units + per - 1) / per);
}

// the matmul pass-1 geometry -> spans per row tile; *tps: doc tiles per
// span. One block fills an SM (its shared memory), so one wave: as many
// spans as leave every SM one block. Longer spans raise the row thresholds
// sooner, so fewer lanes are merged.
int matmul_spans(int B, long long N, int* tps) {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long ndt = (N + BN - 1) / BN;
  const int ntr = (B + BM - 1) / BM;
  long long want = sms / ntr;
  if (want > ndt) want = ndt;
  if (want < 1) want = 1;
  long long per = (ndt + want - 1) / want;
  if (per < 1) per = 1;
  *tps = static_cast<int>(per);
  return static_cast<int>((ndt + per - 1) / per);
}

}  // namespace

extern "C" {

// matmul mode's query tile: q is passed transposed and zero-padded, as qt
// [ceil(D / depth) * depth, ceil(B / rows) * rows]
int scan_topk_depth() { return BK; }
int scan_topk_rows() { return BM; }

// pass-1 spans per row, for the size of the cand/partial scratch (N >= 1)
int scan_topk_spans(int B, long long N, int matmul) {
  if (matmul) {
    int tps;
    return matmul_spans(B, N, &tps);
  }
  long long len;
  return spans_for(B, N, &len);
}

// q == nullptr selects streamed mode (mat = scores [B, N]); otherwise q is
// qt (above) and mat = mat_t [D, N]. B, D, N >= 1. aux_doc / aux_q may be
// nullptr, read as zeros. cand: [B, nspans, k] u64 scratch; partial:
// [B, nspans] i32 scratch, with nspans = scan_topk_spans(B, N, q !=
// nullptr). Returns the first CUDA error of the launches, or 0.
int scan_topk_launch(const float* q, const float* mat, const uint8_t* live,
                     const float* aux_doc, const float* aux_q, int B, int D,
                     long long N, int k, int transform, int count_positive,
                     unsigned long long* cand, int* partial, float* out_v,
                     int* out_i, int* out_t, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int nspans;
  if (q == nullptr) {
    long long len;
    nspans = spans_for(B, N, &len);
    scan_streamed_kernel<<<nspans * B, SEL_THREADS, 0, st>>>(
        mat, live, aux_doc, aux_q, B, N, len, nspans, k, transform,
        count_positive, cand, partial);
  } else {
    int tps;
    nspans = matmul_spans(B, N, &tps);
    const unsigned grid = static_cast<unsigned>(nspans) * ((B + BM - 1) / BM);
    // a three-stage ring where the rows' top k leaves room, else two
    const int stages = matmul_smem(k, 3) <= SMEM_MAX ? 3 : 2;
    const size_t smem = matmul_smem(k, stages);
    auto kernel = stages == 3 ? scan_matmul_kernel<3> : scan_matmul_kernel<2>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, MM_THREADS, smem, st>>>(q, mat, live, aux_doc, aux_q, B, D, N, tps,
                                           nspans, k, transform, count_positive, cand,
                                           partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_merge_kernel<<<B, SEL_THREADS, 0, st>>>(cand, partial, nspans, k,
                                               out_v, out_i, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
