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
// top-kb in VMEM. Here the two passes of topk_select.cuh take its place:
// pass 1 is one block per (query, probe, chunk of CHUNK = 4,096 slots); the
// block reads its own probe id, stages the query in shared memory and walks
// its chunk in sub-batches of THREADS slots, one slot per thread. Each
// sub-batch's tile rows are staged through shared memory DT columns at a
// time, so that a warp reads whole 32-byte sectors of the tile and each
// thread then sums its own slot in d order. Then the block keys each slot on
// its docid (`make_key`, pad slots masked first), writes the chunk's kb best
// keys and its int32 count. Pass 2 is one block per query merging its
// P * ceil(L / CHUNK) candidate lists and summing the counts in integers.
// An L above CHUNK (a skewed partition) simply gives more chunks.
//
// Arithmetic. int8: a code times an f32 query value has up to 31 significant
// bits, so each product and each add rounds on its own (__fmul_rn,
// __fadd_rn; the library builds with --fmad=false too), summed d = 0 .. D-1
// from 0.0; sum_d q is the same sequential sum, taken by one thread of each
// block from the staged query. bf16: hi/lo x qh products are exact in f32, so __fmaf_rn rounds as
// the twin's separate multiply and add do. The transform runs in the JAX
// package's order. The twin (`ann_gather_scan_reference`) spells out the same
// operations, so kernel and twin agree bit for bit.
//
// Bound on an H100 SXM: bytes, by the JAX package's own count
// (monitoring/costmodel.py:215-240) at 3.35 TB/s, slots = B*P*L:
//   int8: slots*(D+8) + 12*slots + 4*B*D;  bf16: 4*D*slots + 12*slots + 4*B*D.
// At the C4 batch (B=1024, P=2, L~1536, D=384) that is ~1.27 GB (~0.38 ms)
// for int8 and ~4.8 GB (~1.4 ms) for bf16; the operations (2*D per slot) are
// far below the card's rate. That count charges every probed slot, pads and
// repeated tiles included. The least the work needs is lower: chip_smoke.py
// counts each distinct probed tile once, a pad slot by its 4-byte order
// entry alone, and 2*D operations per real slot of each (query, probe), and
// reports that bound with this one beside it. This simple kernel runs on
// CUDA cores with shared-memory bitonic selection, no wgmma or TMA yet.

#include <type_traits>

#include "topk_select.cuh"

namespace {

constexpr int TIER_INT8 = 0;
constexpr int TIER_BF16 = 1;
constexpr int ROW_PAD_BYTES = 4;  // keeps the staged rows off one bank

template <int TIER>
struct Staging {
  // tile element type, columns staged per step, row stride in elements
  using T = typename std::conditional<TIER == TIER_INT8, int8_t, uint16_t>::type;
  static constexpr int DT = TIER == TIER_INT8 ? 32 : 16;
  static constexpr int STRIDE = DT + ROW_PAD_BYTES / static_cast<int>(sizeof(T));
  static constexpr int BUF = THREADS * STRIDE;  // elements per staged buffer
};

__device__ __forceinline__ float bf16_bits_to_float(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

template <int TIER>
__global__ void __launch_bounds__(THREADS)
ann_scan_kernel(const float* __restrict__ q, const int* __restrict__ probes,
                const typename Staging<TIER>::T* __restrict__ ta,
                const typename Staging<TIER>::T* __restrict__ tb,
                const float* __restrict__ scale,
                const float* __restrict__ offset,
                const float* __restrict__ auxd, const float* __restrict__ auxq,
                const int* __restrict__ order,
                const uint8_t* __restrict__ live_slots, int D, int P, int L,
                int nch, int k, int transform,
                unsigned long long* __restrict__ cand,
                int* __restrict__ partial) {
  using S = Staging<TIER>;
  using T = typename S::T;
  extern __shared__ float qs[];  // [D] query, then the staged tile buffers
  __shared__ unsigned long long keys[CHUNK];
  __shared__ int scratch[THREADS / 32];
  __shared__ float qsum;
  T* bufa = reinterpret_cast<T*>(qs + ((D + 3) & ~3));
  T* bufb = bufa + S::BUF;

  const long long blk = blockIdx.x;  // (b * P + p) * nch + ch
  const int ch = static_cast<int>(blk % nch);
  const long long bp = blk / nch;
  const int p = static_cast<int>(bp % P);
  const long long b = bp / P;
  const long long c = probes[b * P + p];
  const long long tile0 = c * L;  // first slot row of the tile
  const int l0 = ch * CHUNK;
  const int tid = threadIdx.x;

  for (int d = tid; d < D; d += THREADS) qs[d] = q[b * D + d];
  if constexpr (TIER == TIER_INT8) {
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) acc = __fadd_rn(acc, qs[d]);
      qsum = acc;
    }  // read after the next __syncthreads
  }

  float dots[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    dots[e] = 0.0f;
    const int lb = l0 + e * THREADS;  // uniform across the block
    if (lb >= L) continue;
    const int rows = min(THREADS, L - lb);
    float acc_a = 0.0f;
    float acc_b = 0.0f;
    for (int d0 = 0; d0 < D; d0 += S::DT) {
      const int dn = min(S::DT, D - d0);
      __syncthreads();  // the previous step's rows (and qs) are consumed/ready
      for (int idx = tid; idx < THREADS * S::DT; idx += THREADS) {
        const int r = idx / S::DT;
        const int dd = idx % S::DT;
        if (r < rows && dd < dn) {
          const long long g = (tile0 + lb + r) * D + d0 + dd;
          bufa[r * S::STRIDE + dd] = ta[g];
          if constexpr (TIER == TIER_BF16) bufb[r * S::STRIDE + dd] = tb[g];
        }
      }
      __syncthreads();
      if (tid < rows) {
        const T* ra = bufa + tid * S::STRIDE;
        const T* rb = bufb + tid * S::STRIDE;
        for (int dd = 0; dd < dn; ++dd) {
          const float qv = qs[d0 + dd];
          if constexpr (TIER == TIER_INT8) {
            acc_a = __fadd_rn(acc_a, __fmul_rn(qv, static_cast<float>(ra[dd])));
          } else {
            acc_a = __fmaf_rn(qv, bf16_bits_to_float(static_cast<uint16_t>(ra[dd])), acc_a);
            acc_b = __fmaf_rn(qv, bf16_bits_to_float(static_cast<uint16_t>(rb[dd])), acc_b);
          }
        }
      }
    }
    if (tid < rows) {
      const long long s = tile0 + lb + tid;
      if constexpr (TIER == TIER_INT8) {
        dots[e] = __fadd_rn(__fmul_rn(scale[s], acc_a), __fmul_rn(offset[s], qsum));
      } else {
        dots[e] = __fadd_rn(acc_a, acc_b);
      }
    }
  }

  const float aq = auxq != nullptr ? auxq[b] : 0.0f;
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int lane = e * THREADS + tid;
    const int l = l0 + lane;
    if (l >= L) {
      keys[lane] = 0ull;  // below every real key
      continue;
    }
    const long long s = tile0 + l;
    const float ad = (auxd != nullptr && reads_aux_doc(transform)) ? auxd[s] : 0.0f;
    float sc = apply_transform(dots[e], transform, ad, aq);
    const int id = order[s];
    const bool ok = id >= 0 && live_slots[s] != 0;
    if (!ok) sc = neg_inf();  // pad slots and dead docs, before keying
    cnt += ok;
    keys[lane] = make_key(sc, id);
  }
  emit_chunk(keys, scratch, cnt, k, blk, cand, partial);
}

__global__ void __launch_bounds__(THREADS)
ann_merge_kernel(const unsigned long long* __restrict__ cand,
                 const int* __restrict__ partial, int nchunks, int k,
                 float* __restrict__ out_v, int* __restrict__ out_i,
                 int* __restrict__ out_t) {
  merge_row(cand, partial, nchunks, k, out_v, out_i, out_t);
}

template <int TIER>
int launch_scan(const float* q, const int* probes,
                const void* ta, const void* tb, const float* scale,
                const float* offset, const float* auxd, const float* auxq,
                const int* order, const uint8_t* live_slots, int B, int D,
                int P, int L, int k, int transform,
                unsigned long long* cand, int* partial, cudaStream_t st) {
  using S = Staging<TIER>;
  using T = typename S::T;
  const int nch = (L + CHUNK - 1) / CHUNK;
  const size_t dyn = sizeof(float) * ((D + 3) & ~3) +
                     sizeof(T) * S::BUF * (TIER == TIER_BF16 ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      ann_scan_kernel<TIER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * P * nch;
  ann_scan_kernel<TIER><<<static_cast<unsigned>(blocks), THREADS, dyn, st>>>(
      q, probes, static_cast<const T*>(ta), static_cast<const T*>(tb),
      scale, offset, auxd, auxq, order, live_slots, D, P, L, nch, k,
      transform, cand, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ann_gather_scan_chunk() { return CHUNK; }

// tier 0 (int8): q [B, D] f32, ta = codes [C, L, D] int8, tb unused,
// scale/offset [C, L] f32. tier 1 (bf16): q = qh [B, D] f32
// (bf16-representable), ta/tb = hi/lo [C, L, D] bf16 bit patterns,
// scale/offset unused. probes [B, P] i32 in [0, C); auxd
// [C, L] / auxq [B] f32 (may be nullptr, read as zeros); order [C, L] i32
// (-1 pads); live_slots [C, L] u8. cand: [B, P * nch, k] u64 scratch;
// partial: [B, P * nch] i32 scratch (nch = ceil(L / CHUNK)); out_v, out_i
// [B, k], out_t [B]. Returns the first CUDA error of the launches, or 0.
int ann_gather_scan_launch(const float* q, const int* probes, const void* ta, const void* tb,
                           const float* scale, const float* offset,
                           const float* auxd, const float* auxq,
                           const int* order, const uint8_t* live_slots, int B,
                           int D, int P, int L, int k, int tier,
                           int transform, unsigned long long* cand,
                           int* partial, float* out_v, int* out_i, int* out_t,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (tier == TIER_INT8) {
    rc = launch_scan<TIER_INT8>(q, probes, ta, tb, scale, offset, auxd,
                                auxq, order, live_slots, B, D, P, L, k,
                                transform, cand, partial, st);
  } else if (tier == TIER_BF16) {
    rc = launch_scan<TIER_BF16>(q, probes, ta, tb, scale, offset, auxd,
                                auxq, order, live_slots, B, D, P, L, k,
                                transform, cand, partial, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  const int nchunks = P * ((L + CHUNK - 1) / CHUNK);
  ann_merge_kernel<<<B, THREADS, 0, st>>>(cand, partial, nchunks, k, out_v,
                                          out_i, out_t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
