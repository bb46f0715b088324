// ann_gather_scan: batched IVF gather-scan of quantized cluster tiles +
// top-kb + exact candidate counts, for Hopper (sm_90a).
//
// Replaces the TPU kernel elasticsearch_tpu/ann/kernels.py `_ann_scan_kernel`
// (launched by `_ann_scan_pallas`, public `ann_gather_scan`): the scan behind
// approximate kNN. Per query b and probe p, c = probes[b, p]; for every slot
// l of cluster c's [L, D] tile:
//
//   int8:  dot = scale[c,l] * sum_d q[b,d]*codes[c,l,d] + offset[c,l] * sum_d q[b,d]
//   bf16:  dot = sum_d qh[b,d]*hi[c,l,d] + sum_d qh[b,d]*lo[c,l,d]
//          (qh: the query cut to bf16 by integer masking)
//   s      = transform(dot, auxd[c,l], auxq[b])
//   ok     = order[c,l] >= 0 && live_slots[c,l];   s = ok ? s : -inf
//   total  = #ok over every probed slot
//
// and returns the top kb lanes by (score desc, docid asc), kb <= 128, where
// the docid is order[c,l]. The scores are SELECTION scores: callers rescore
// the candidates in f32 (ann/search.py, query/nodes.py KnnNode).
//
// Design. The Pallas kernel walks a sequential (B, nprobe) grid, scalar-
// prefetches the probe ids to drive the tile DMA, and carries a running
// top-kb in VMEM. A batch probes few distinct tiles (bench.py C4: 1,024
// queries x 2 probes over ~7 tiles), so a design per (query, probe) reads
// each tile hundreds of times. Here the work is tile-major, in three
// launches:
//
//   1. ann_group_kernel (one block): a counting sort of the B*P (query,
//      probe) pairs by probed tile (histogram, prefix, a stable scatter by
//      one warp with __match_any_sync: deterministic), cut into groups of
//      up to G = 32 pairs of one tile.
//   2. ann_tile_scan_kernel<TIER>: a persistent grid walks the units
//      (span s, group g), s outer, so that the groups of one tile read the
//      same slots together and the tile comes from L2. A unit scores its
//      group's pairs over the span's chunks of S = 128 slots: each chunk's
//      rows are staged d-slice by d-slice through a two-stage cp.async ring
//      (16-byte copies; the slice of the pairs' query rows rides along),
//      and each thread holds a 4-pair x 4-slot register tile: 16
//      independent sums (32 for bf16) where a thread of a per-pair design
//      has one, and one int8-to-float conversion (a byte permute into
//      2^23 + c + 128 and one subtraction, exact) per slot and d shared by
//      its 4 pairs. Warp w owns pairs 4w .. 4w + 3 (for int8 it first sums
//      their query rows, d in order, from coalesced loads): it keys its slots
//      (transform, pad and live masks, `make_key`) and folds the keys that
//      beat a pair's kb-th key so far into the pair's top kb (`warp_fold`,
//      topk_select.cuh), with no block barrier. The unit writes each pair's
//      kb best keys and int32 count of the span.
//   3. ann_merge_kernel: per query, `select_merge_row` over its P x nspans
//      candidate lists, counts summed in integers.
//
// The scratch is sized on the host for up to SPAN_MAX spans per pair. The
// group kernel counts the groups on the card and picks the spans per pair
// so that groups x spans about fill the scan's resident blocks: fewer,
// longer spans let a pair's threshold rise further, so fewer keys are
// folded (at C4: ~70 groups, 4 spans of ~4,000 slots). At B = 1 a unit
// holds one pair and one warp works: the launches are short and the kernel
// stays latency-bound.
//
// Arithmetic. int8: a code times an f32 query value has up to 31 significant
// bits, so each product and each add rounds on its own (__fmul_rn,
// __fadd_rn; the library builds with --fmad=false too), summed d = 0 .. D-1
// from 0.0; sum_d q is the same sequential sum. bf16: hi/lo x qh products
// are exact in f32, so __fmaf_rn rounds as the twin's separate multiply and
// add do. The transform runs in the JAX package's order. The twin
// (`ann_gather_scan_reference`) spells out the same operations, so kernel
// and twin agree bit for bit. Pad slots carry id -1, so their keys are
// equal: equal keys give equal (value, id) rows, so the result is the same.
//
// Bound on an H100 SXM: chip_smoke.py counts each distinct probed tile
// once (D + 17 bytes per real slot for int8, 4D + 9 for bf16, 4 bytes per
// pad slot) and 2*D f32 operations per real slot of each (query, probe)
// (4*D for bf16) at 67 TFLOP/s: operation bound at C4. The int8 path
// issues a separate multiply and add per (slot, d), so its floor is about
// twice that bound.
//
// Occupancy (ptxas -v, sm_90a): ann_tile_scan_kernel 128 registers for
// both tiers, no spills; dynamic shared memory: the two-stage ring (int8
// 2 x 18,432 bytes, bf16 2 x 24,576), the tops (32 kb x 8 bytes), the
// warps' fold scratch (16 KB) and 896 bytes of pair state: 79,744 bytes
// (int8) or 92,032 (bf16) at kb = 100, 2 blocks (16 warps) per SM.
// ann_group_kernel 32 registers, 33,040 bytes; ann_merge_kernel 40
// registers, 33,952 bytes.

#include "topk_select.cuh"

namespace {

constexpr int TIER_INT8 = 0;
constexpr int TIER_BF16 = 1;
constexpr int G = 32;                 // pairs of a group
constexpr int S = 128;                // slots of a chunk
constexpr int SCAN_WARPS = 8;
constexpr int SCAN_THREADS = SCAN_WARPS * 32;
constexpr int PPW = G / SCAN_WARPS;   // pairs of a warp (4)
constexpr int SPL = S / 32;           // slots of a lane (4): lane, lane + 32, ...
constexpr int SPAN_MAX = 16;          // spans per pair
constexpr int GROUP_THREADS = 1024;
constexpr int ROW_BYTES = 64;         // bytes of a slot row per tier per stage
constexpr int ROW_STRIDE = 80;        // 5 x 16 B: 16-byte reads of rows lane,
                                      // lane + 1, ... hit distinct banks
constexpr unsigned FULL = 0xffffffffu;

template <int TIER>
struct Geo {
  static constexpr int ESIZE = TIER == TIER_INT8 ? 1 : 2;  // bytes per element
  static constexpr int DK = ROW_BYTES / ESIZE;             // d per stage
  static constexpr int NT = TIER == TIER_INT8 ? 1 : 2;     // tiers staged
  static constexpr int CODES = S * ROW_STRIDE;             // bytes per tier
  static constexpr int QBYTES = G * DK * 4;                // the pairs' q slice
  static constexpr int STAGE = NT * CODES + QBYTES;
};

// the most spans per pair at L slots (the scratch is sized for it)
inline int max_spans(int L) {
  const int nch = (L + S - 1) / S;
  return nch < SPAN_MAX ? nch : SPAN_MAX;
}
inline long long max_groups(long long BP, int C) {
  return (BP + G - 1) / G + (C < BP ? C : BP);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// exact int8 -> f32 of byte u of w (w already XORed with 0x80808080):
// the float 2^23 + (c + 128), minus 2^23 + 128
template <int U>
__device__ __forceinline__ float code_at(uint32_t w) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + U)), 8388736.0f);
}

// ---------------------------------------------------------------------------
// 1. the pairs grouped by tile
// ---------------------------------------------------------------------------

// groups: [max_groups] x (tile, first sorted position, pairs); cursor: [C]
// (used when the tiles are more than SMEM_TILES; shared memory otherwise);
// geo: the groups, the spans per pair and the chunks per span. The spans
// are as many as fill the scan's `slots` resident blocks with units
// (groups x spans), at most SPAN_MAX: a long span lets a pair's threshold
// rise further, so fewer keys are folded.
constexpr int SMEM_TILES = 8192;

__global__ void __launch_bounds__(GROUP_THREADS)
ann_group_kernel(const int* __restrict__ probes, int BP, int C, int L, int slots,
                 int* __restrict__ cursor_g, int* __restrict__ sorted,
                 int* __restrict__ groups, int* __restrict__ geo) {
  __shared__ int scur[SMEM_TILES];
  __shared__ int wsum[GROUP_THREADS / 32][2];
  __shared__ int carry[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* cursor = C <= SMEM_TILES ? scur : cursor_g;
  for (int c = tid; c < C; c += GROUP_THREADS) cursor[c] = 0;
  if (tid == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int i = tid; i < BP; i += GROUP_THREADS) atomicAdd(&cursor[probes[i]], 1);
  __syncthreads();
  // exclusive prefixes of the counts (pair positions) and of the groups
  for (int c0 = 0; c0 < C; c0 += GROUP_THREADS) {
    const int c = c0 + tid;
    const int n = c < C ? cursor[c] : 0;
    const int ng = (n + G - 1) / G;
    int in = n, ig = ng;
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(FULL, in, o);
      const int g = __shfl_up_sync(FULL, ig, o);
      if (lane >= o) {
        in += a;
        ig += g;
      }
    }
    if (lane == 31) {
      wsum[warp][0] = in;
      wsum[warp][1] = ig;
    }
    __syncthreads();
    int pn = carry[0], pg = carry[1];
    for (int w = 0; w < warp; ++w) {
      pn += wsum[w][0];
      pg += wsum[w][1];
    }
    const int start = pn + in - n;
    const int gstart = pg + ig - ng;
    if (c < C) {
      cursor[c] = start;
      for (int x = 0; x < ng; ++x) {
        groups[3 * (gstart + x)] = c;
        groups[3 * (gstart + x) + 1] = start + x * G;
        groups[3 * (gstart + x) + 2] = min(G, n - x * G);
      }
    }
    __syncthreads();  // every thread has read carry and wsum
    if (tid == GROUP_THREADS - 1) {
      carry[0] = start + n;
      carry[1] = gstart + ng;
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int ng = carry[1];
    const int nch = (L + S - 1) / S;
    int nsp = (slots + ng - 1) / ng;
    nsp = max(1, min(nsp, min(nch, SPAN_MAX)));
    const int per = (nch + nsp - 1) / nsp;
    geo[0] = ng;
    geo[1] = (nch + per - 1) / per;
    geo[2] = per;
  }
  // stable scatter, one warp: pairs in index order within each tile; the
  // probes of 8 rounds are loaded together
  constexpr int AHEAD = 8;
  if (warp == 0) {
    for (int i0 = 0; i0 < BP; i0 += 32 * AHEAD) {
      int tl[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int i = i0 + 32 * u + lane;
        tl[u] = i < BP ? probes[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int i = i0 + 32 * u + lane;
        const int tile = tl[u];
        const unsigned peers = __match_any_sync(FULL, tile);
        const int leader = __ffs(peers) - 1;
        const int rank = __popc(peers & ((1u << lane) - 1u));
        int pos = 0;
        if (tile >= 0 && lane == leader) {
          pos = cursor[tile];
          cursor[tile] = pos + __popc(peers);
        }
        pos = __shfl_sync(FULL, pos, leader);
        if (tile >= 0) sorted[pos + rank] = i;
        __syncwarp();
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the tile-major scan
// ---------------------------------------------------------------------------

template <int TIER>
struct ScanArgs {
  const float* q;
  const void* ta;
  const void* tb;
  const float* scale;
  const float* offset;
  const float* auxd;
  const float* auxq;
  const int* order;
  const uint8_t* live_slots;
  const int* sorted;
  const int* groups;
  const int* geo;  // groups, spans per pair, chunks per span
  int D, P, L, k, transform;
  unsigned long long* cand;
  int* partial;
};

// ring stage <- d-slice kt of the chunk's S slot rows (each tier) and of the
// pairs' query rows. Rows past L, pairs past npair and d past D read 0.
template <int TIER>
__device__ __forceinline__ void load_stage(unsigned char* stage, uint32_t sstage,
                                           const ScanArgs<TIER>& a, long long row0,
                                           int l0, int kt, const int* pq, int npair,
                                           bool vec) {
  using GE = Geo<TIER>;
  const int d0 = kt * GE::DK;
  const long long rowb = static_cast<long long>(a.D) * GE::ESIZE;  // bytes per slot row
  const int b0 = d0 * GE::ESIZE;
#pragma unroll
  for (int t = 0; t < GE::NT; ++t) {
    const unsigned char* src = static_cast<const unsigned char*>(t == 0 ? a.ta : a.tb);
    for (int c = threadIdx.x; c < S * (ROW_BYTES / 16); c += SCAN_THREADS) {
      const int r = c >> 2;
      const int ch = c & 3;
      const int off = b0 + ch * 16;
      const bool ok = l0 + r < a.L && off < rowb;
      const unsigned char* g = src + (row0 + l0 + r) * rowb + off;
      const int dst = t * GE::CODES + r * ROW_STRIDE + ch * 16;
      if (vec) {
        cp_async16(sstage + dst, ok ? g : src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) stage[dst + e] = ok && off + e < rowb ? g[e] : 0;
      }
    }
  }
  float* qs = reinterpret_cast<float*>(stage + GE::NT * GE::CODES);
  for (int c = threadIdx.x; c < G * GE::DK / 4; c += SCAN_THREADS) {
    const int j = c / (GE::DK / 4);
    const int dd = (c % (GE::DK / 4)) * 4;
    const bool ok = j < npair && d0 + dd < a.D;
    const float* g = a.q + static_cast<long long>(ok ? pq[j] : 0) * a.D + d0 + dd;
    if (vec) {
      cp_async16(sstage + GE::NT * GE::CODES + c * 16, ok ? g : a.q, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qs[j * GE::DK + dd + e] = ok && d0 + dd + e < a.D ? g[e] : 0.0f;
    }
  }
}

// the int8 dots of 16 d (dd .. dd + 15 of the stage, all below D when
// FULLD, else the first dn) for the warp's first NPR pairs (1, or all 4)
// x the lane's 4 slots
template <bool FULLD, int NPR>
__device__ __forceinline__ void dots_int8(const unsigned char* codes, const float* qs, int dd,
                                          int dn, int p0, float (&acc)[PPW][SPL]) {
  const int lane = threadIdx.x & 31;
  uint32_t w[SPL][4];
#pragma unroll
  for (int e = 0; e < SPL; ++e) {
    const uint4 v = *reinterpret_cast<const uint4*>(codes + (lane + 32 * e) * ROW_STRIDE + dd);
    w[e][0] = v.x ^ 0x80808080u;
    w[e][1] = v.y ^ 0x80808080u;
    w[e][2] = v.z ^ 0x80808080u;
    w[e][3] = v.w ^ 0x80808080u;
  }
#pragma unroll
  for (int u4 = 0; u4 < 4; ++u4) {
    float4 qv[NPR];
#pragma unroll
    for (int i = 0; i < NPR; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qs + (p0 + i) * Geo<TIER_INT8>::DK + dd + 4 * u4);
#pragma unroll
    for (int uu = 0; uu < 4; ++uu) {
      if (!FULLD && 4 * u4 + uu >= dn) return;
      float f[SPL];
#pragma unroll
      for (int e = 0; e < SPL; ++e) {
        const uint32_t x = w[e][u4];
        f[e] = uu == 0 ? code_at<0>(x) : uu == 1 ? code_at<1>(x) : uu == 2 ? code_at<2>(x)
                                                                          : code_at<3>(x);
      }
#pragma unroll
      for (int i = 0; i < NPR; ++i) {
        const float qd = uu == 0 ? qv[i].x : uu == 1 ? qv[i].y : uu == 2 ? qv[i].z : qv[i].w;
#pragma unroll
        for (int e = 0; e < SPL; ++e) acc[i][e] = __fadd_rn(acc[i][e], __fmul_rn(qd, f[e]));
      }
    }
  }
}

// the bf16 dots of 8 d (all below D when FULLD, else the first dn) for the
// warp's first NPR pairs
template <bool FULLD, int NPR>
__device__ __forceinline__ void dots_bf16(const unsigned char* hic, const unsigned char* loc,
                                          const float* qs, int dd, int dn, int p0,
                                          float (&ah)[PPW][SPL], float (&al)[PPW][SPL]) {
  const int lane = threadIdx.x & 31;
  uint4 h[SPL];
  uint4 l[SPL];
#pragma unroll
  for (int e = 0; e < SPL; ++e) {
    h[e] = *reinterpret_cast<const uint4*>(hic + (lane + 32 * e) * ROW_STRIDE + 2 * dd);
    l[e] = *reinterpret_cast<const uint4*>(loc + (lane + 32 * e) * ROW_STRIDE + 2 * dd);
  }
#pragma unroll
  for (int u4 = 0; u4 < 2; ++u4) {
    float4 qv[NPR];
#pragma unroll
    for (int i = 0; i < NPR; ++i)
      qv[i] = *reinterpret_cast<const float4*>(qs + (p0 + i) * Geo<TIER_BF16>::DK + dd + 4 * u4);
#pragma unroll
    for (int uu = 0; uu < 4; ++uu) {
      const int u = 4 * u4 + uu;
      if (!FULLD && u >= dn) return;
      float fh[SPL];
      float fl[SPL];
#pragma unroll
      for (int e = 0; e < SPL; ++e) {
        const uint32_t hw = u < 2 ? h[e].x : u < 4 ? h[e].y : u < 6 ? h[e].z : h[e].w;
        const uint32_t lw = u < 2 ? l[e].x : u < 4 ? l[e].y : u < 6 ? l[e].z : l[e].w;
        fh[e] = __uint_as_float((u & 1) ? (hw & 0xffff0000u) : (hw << 16));
        fl[e] = __uint_as_float((u & 1) ? (lw & 0xffff0000u) : (lw << 16));
      }
#pragma unroll
      for (int i = 0; i < NPR; ++i) {
        const float qd = uu == 0 ? qv[i].x : uu == 1 ? qv[i].y : uu == 2 ? qv[i].z : qv[i].w;
#pragma unroll
        for (int e = 0; e < SPL; ++e) {
          ah[i][e] = __fmaf_rn(qd, fh[e], ah[i][e]);
          al[i][e] = __fmaf_rn(qd, fl[e], al[i][e]);
        }
      }
    }
  }
}

template <int TIER>
__global__ void __launch_bounds__(SCAN_THREADS)
ann_tile_scan_kernel(const ScanArgs<TIER> a) {
  using GE = Geo<TIER>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* top = reinterpret_cast<unsigned long long*>(smem + 2 * GE::STAGE);
  unsigned long long* scr = top + G * a.k;
  unsigned long long* thr = scr + SCAN_WARPS * WARP_FOLD_SCR;
  int* ntop = reinterpret_cast<int*>(thr + G);
  int* pq = ntop + G;             // the group's query rows
  int* pid = pq + G;              // the group's pair ids (b * P + p)
  float* paq = reinterpret_cast<float*>(pid + G);  // auxq of each pair
  float* pqs = paq + G;           // sum_d q of each pair (int8)
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p0 = warp * PPW;
  const int ng = a.geo[0];
  const int nspans = a.geo[1];
  const int span_chunks = a.geo[2];
  const int nunits = ng * nspans;
  const int ktiles = (a.D + GE::DK - 1) / GE::DK;
  const int nch = (a.L + S - 1) / S;
  const bool aux = a.auxd != nullptr && reads_aux_doc(a.transform);
  bool vec = (static_cast<long long>(a.D) * GE::ESIZE) % 16 == 0 && a.D % 4 == 0 &&
             (reinterpret_cast<uintptr_t>(a.ta) & 15) == 0 &&
             (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;
  if (TIER == TIER_BF16) vec = vec && (reinterpret_cast<uintptr_t>(a.tb) & 15) == 0;

  for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
    const int sp = u / ng;  // spans outer: a tile's groups run side by side
    const int g = u % ng;
    const long long tile = a.groups[3 * g];
    const int first = a.groups[3 * g + 1];
    const int npair = a.groups[3 * g + 2];
    if (threadIdx.x < G) {
      const int j = threadIdx.x;
      const int id = j < npair ? a.sorted[first + j] : 0;
      const int b = id / a.P;
      pid[j] = id;
      pq[j] = b;
      paq[j] = a.auxq != nullptr ? a.auxq[b] : 0.0f;
      thr[j] = 0ull;
      ntop[j] = 0;
    }
    __syncthreads();
    const bool busy = p0 < npair;  // uniform across the warp
    const bool one = npair - p0 == 1;
    if (TIER == TIER_INT8 && busy) {
      // sum_d q of the warp's pairs, d = 0 .. D-1 from 0.0 (as the twin
      // sums it): 32 d per coalesced load, added in order by shuffles
      float qs_acc[PPW];
#pragma unroll
      for (int i = 0; i < PPW; ++i) qs_acc[i] = 0.0f;
      for (int d0 = 0; d0 < a.D; d0 += 32) {
        float v[PPW];
#pragma unroll
        for (int i = 0; i < PPW; ++i)
          v[i] = p0 + i < npair && d0 + lane < a.D
                     ? a.q[static_cast<long long>(pq[p0 + i]) * a.D + d0 + lane]
                     : 0.0f;
        const int dn = min(32, a.D - d0);
        for (int u = 0; u < dn; ++u)
#pragma unroll
          for (int i = 0; i < PPW; ++i)
            qs_acc[i] = __fadd_rn(qs_acc[i], __shfl_sync(FULL, v[i], u));
      }
      if (lane == 0)
#pragma unroll
        for (int i = 0; i < PPW; ++i) pqs[p0 + i] = qs_acc[i];
      __syncwarp();
    }
    int cnt[PPW];
#pragma unroll
    for (int i = 0; i < PPW; ++i) cnt[i] = 0;
    const int c0 = sp * span_chunks;
    const int c1 = min(nch, c0 + span_chunks);
    const long long row0 = tile * a.L;
    for (int ch = c0; ch < c1; ++ch) {
      const int l0 = ch * S;
      float acc[PPW][SPL];
      float acc2[PPW][SPL];
#pragma unroll
      for (int i = 0; i < PPW; ++i)
#pragma unroll
        for (int e = 0; e < SPL; ++e) acc[i][e] = acc2[i][e] = 0.0f;
      // a chunk of pad slots only (a tile's end) is keyed without its dots
      const int r = threadIdx.x;
      if (__syncthreads_or(r < S && l0 + r < a.L && a.order[row0 + l0 + r] >= 0)) {
        load_stage<TIER>(smem, sbase, a, row0, l0, 0, pq, npair, vec);
        cp_commit();
        for (int kt = 0; kt < ktiles; ++kt) {
          cp_wait_all();
          __syncthreads();  // stage kt landed; stage kt - 1 consumed by all
          if (kt + 1 < ktiles)
            load_stage<TIER>(smem + ((kt + 1) & 1) * GE::STAGE, sbase + ((kt + 1) & 1) * GE::STAGE,
                             a, row0, l0, kt + 1, pq, npair, vec);
          cp_commit();
          if (!busy) continue;
          const unsigned char* st = smem + (kt & 1) * GE::STAGE;
          const float* qs = reinterpret_cast<const float*>(st + GE::NT * GE::CODES);
          const int dn = min(GE::DK, a.D - kt * GE::DK);
          // a warp with one pair (B = 1, a tile's last pair) sums only its row
          if (TIER == TIER_INT8 && one) {
            int dd = 0;
            for (; dd + 16 <= dn; dd += 16) dots_int8<true, 1>(st, qs, dd, 16, p0, acc);
            if (dd < dn) dots_int8<false, 1>(st, qs, dd, dn - dd, p0, acc);
          } else if (TIER == TIER_INT8) {
            int dd = 0;
            for (; dd + 16 <= dn; dd += 16) dots_int8<true, PPW>(st, qs, dd, 16, p0, acc);
            if (dd < dn) dots_int8<false, PPW>(st, qs, dd, dn - dd, p0, acc);
          } else if (one) {
            int dd = 0;
            for (; dd + 8 <= dn; dd += 8)
              dots_bf16<true, 1>(st, st + GE::CODES, qs, dd, 8, p0, acc, acc2);
            if (dd < dn) dots_bf16<false, 1>(st, st + GE::CODES, qs, dd, dn - dd, p0, acc, acc2);
          } else {
            int dd = 0;
            for (; dd + 8 <= dn; dd += 8)
              dots_bf16<true, PPW>(st, st + GE::CODES, qs, dd, 8, p0, acc, acc2);
            if (dd < dn)
              dots_bf16<false, PPW>(st, st + GE::CODES, qs, dd, dn - dd, p0, acc, acc2);
          }
        }
        __syncthreads();  // the ring is free for the next chunk
      }
      if (!busy) continue;

      // key, count and fold the warp's pairs
      float scl[SPL], ofs[SPL], ad[SPL];
      int id[SPL];
      bool ok[SPL];
#pragma unroll
      for (int e = 0; e < SPL; ++e) {
        const int l = l0 + lane + 32 * e;
        const long long s = row0 + l;
        const bool in = l < a.L;
        id[e] = in ? a.order[s] : -1;
        ok[e] = in && id[e] >= 0 && a.live_slots[s] != 0;
        ad[e] = in && aux ? a.auxd[s] : 0.0f;
        scl[e] = in && TIER == TIER_INT8 ? a.scale[s] : 0.0f;
        ofs[e] = in && TIER == TIER_INT8 ? a.offset[s] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        const int j = p0 + i;
        if (j >= npair) break;  // uniform across the warp
        const unsigned long long th = thr[j];
        unsigned long long key[SPL];
        unsigned pass = 0u;
#pragma unroll
        for (int e = 0; e < SPL; ++e) {
          const int l = l0 + lane + 32 * e;
          float dot;
          if (TIER == TIER_INT8) {
            dot = __fadd_rn(__fmul_rn(scl[e], acc[i][e]), __fmul_rn(ofs[e], pqs[j]));
          } else {
            dot = __fadd_rn(acc[i][e], acc2[i][e]);
          }
          float v = apply_transform(dot, a.transform, ad[e], paq[j]);
          if (!ok[e]) v = neg_inf();  // pad slots and dead docs, before keying
          cnt[i] += ok[e];
          key[e] = l < a.L ? make_key(v, id[e]) : 0ull;
          pass |= static_cast<unsigned>(key[e] > th) << e;
        }
        if (__any_sync(FULL, pass != 0u))
          warp_fold(top + static_cast<long long>(j) * a.k, &thr[j], &ntop[j],
                    scr + warp * WARP_FOLD_SCR, key[0], key[1], key[2], key[3], pass, a.k);
      }
    }

    // the span's kb best keys and count of each of the warp's pairs
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      const int j = p0 + i;
      if (j >= npair) break;
      int c = cnt[i];
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
      const long long slot = static_cast<long long>(pid[j]) * nspans + sp;
      for (int x = lane; x < a.k; x += 32)
        a.cand[slot * a.k + x] = x < ntop[j] ? top[static_cast<long long>(j) * a.k + x] : 0ull;
      if (lane == 0) a.partial[slot] = c;
    }
    __syncthreads();  // the group's state is read before the next unit's
  }
}

// ---------------------------------------------------------------------------
// 3. per query: the P x nspans lists merged, the counts summed
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SEL_THREADS)
ann_merge_kernel(const unsigned long long* __restrict__ cand,
                 const int* __restrict__ partial, const int* __restrict__ geo, int P,
                 int k, float* __restrict__ out_v, int* __restrict__ out_i,
                 int* __restrict__ out_t) {
  select_merge_row(cand, partial, P * geo[1], k, out_v, out_i, out_t);
}

size_t scan_smem(int tier, int k) {
  const size_t stage = tier == TIER_INT8 ? Geo<TIER_INT8>::STAGE : Geo<TIER_BF16>::STAGE;
  return 2 * stage + static_cast<size_t>(G) * k * 8 + SCAN_WARPS * WARP_FOLD_SCR * 8 + G * 8 +
         G * 4 * 5;
}

// scratch layout, in 8-byte words: cand, partial, sorted, groups, cursor, geo
struct Scratch {
  long long cand, partial, sorted, groups, cursor, geo, words;
};

Scratch scratch_layout(long long B, int P, int C, int L, int k) {
  const long long BP = B * P;
  const long long nsp = max_spans(L);
  auto words32 = [](long long n) { return (n + 1) / 2; };
  Scratch s;
  s.cand = 0;
  s.partial = s.cand + BP * nsp * k;
  s.sorted = s.partial + words32(BP * nsp);
  s.groups = s.sorted + words32(BP);
  s.cursor = s.groups + words32(3 * max_groups(BP, C));
  s.geo = s.cursor + words32(C);
  s.words = s.geo + 2;
  return s;
}

// the scan's shared memory, set as its limit, and its resident blocks
template <int TIER>
int scan_setup(int k, size_t* smem, int* slots) {
  *smem = scan_smem(TIER, k);
  cudaError_t err = cudaFuncSetAttribute(ann_tile_scan_kernel<TIER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ann_tile_scan_kernel<TIER>,
                                                SCAN_THREADS, *smem);
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

}  // namespace

extern "C" {

// 8-byte words of the scratch buffer ann_gather_scan_launch needs, or -1
// when it exceeds an int
int ann_gather_scan_scratch(int B, int P, int C, int L, int k) {
  const long long w = scratch_layout(B, P, C, L, k).words;
  return w > 0x7fffffffll ? -1 : static_cast<int>(w);
}

// tier 0 (int8): q [B, D] f32, ta = codes [C, L, D] int8, tb unused,
// scale/offset [C, L] f32. tier 1 (bf16): q = qh [B, D] f32
// (bf16-representable), ta/tb = hi/lo [C, L, D] bf16 bit patterns,
// scale/offset unused. probes [B, P] i32 in [0, C); auxd [C, L] / auxq [B]
// f32 (may be nullptr, read as zeros); order [C, L] i32 (-1 pads);
// live_slots [C, L] u8. scratch: ann_gather_scan_scratch(B, P, C, L, k)
// 8-byte words. out_v, out_i [B, k], out_t [B]. Returns the first CUDA
// error of the launches, or 0.
int ann_gather_scan_launch(const float* q, const int* probes, const void* ta, const void* tb,
                           const float* scale, const float* offset,
                           const float* auxd, const float* auxq,
                           const int* order, const uint8_t* live_slots, int B,
                           int D, int P, int C, int L, int k, int tier,
                           int transform, unsigned long long* scratch,
                           float* out_v, int* out_i, int* out_t,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((tier != TIER_INT8 && tier != TIER_BF16) || k < 1 || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Scratch sl = scratch_layout(B, P, C, L, k);
  unsigned long long* cand = scratch + sl.cand;
  int* partial = reinterpret_cast<int*>(scratch + sl.partial);
  int* sorted = reinterpret_cast<int*>(scratch + sl.sorted);
  int* groups = reinterpret_cast<int*>(scratch + sl.groups);
  int* cursor = reinterpret_cast<int*>(scratch + sl.cursor);
  int* geo = reinterpret_cast<int*>(scratch + sl.geo);
  const long long BP = static_cast<long long>(B) * P;
  size_t smem;
  int slots;
  int rc = tier == TIER_INT8 ? scan_setup<TIER_INT8>(k, &smem, &slots)
                             : scan_setup<TIER_BF16>(k, &smem, &slots);
  if (rc != 0) return rc;
  ann_group_kernel<<<1, GROUP_THREADS, 0, st>>>(probes, static_cast<int>(BP), C, L, slots,
                                                cursor, sorted, groups, geo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: the resident blocks, or fewer when the units are
  const long long units = max_groups(BP, C) * max_spans(L);
  const unsigned grid = static_cast<unsigned>(units < slots ? units : slots);
  if (tier == TIER_INT8) {
    const ScanArgs<TIER_INT8> a{q, ta, tb, scale, offset, auxd, auxq, order, live_slots,
                                sorted, groups, geo, D, P, L, k, transform, cand,
                                partial};
    ann_tile_scan_kernel<TIER_INT8><<<grid, SCAN_THREADS, smem, st>>>(a);
  } else {
    const ScanArgs<TIER_BF16> a{q, ta, tb, scale, offset, auxd, auxq, order, live_slots,
                                sorted, groups, geo, D, P, L, k, transform, cand,
                                partial};
    ann_tile_scan_kernel<TIER_BF16><<<grid, SCAN_THREADS, smem, st>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ann_merge_kernel<<<B, SEL_THREADS, 0, st>>>(cand, partial, geo, P, k, out_v, out_i, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
