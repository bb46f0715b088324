"""Analytic per-kernel cost model: FLOPs and bytes moved per dispatch.

The JAX package's `monitoring/costmodel.py`, cut to the dispatches the
port times. Each dispatch site passes the shape fields it has in hand to
`telemetry.time_kernel`; `utilization` divides the FLOPs and bytes they
price by the measured wall time and the device's peak rates, and the
execution planner (`planner/`) prices an arm as its kernel's roofline-ideal
time over that kernel's measured efficiency.

Conventions (the reference's, kept letter for letter so one set of
observations prices the same on both packages):
  - a matmul [M,K]@[K,N] is 2*M*K*N FLOPs per pass (multiply+add);
  - selection/compare work counts 2 ops per scanned element;
  - bytes = operand reads + result writes at their storage dtypes, each
    operand counted once;
  - MFU is reported against the device's peak *bf16* matmul rate, whatever
    the compute dtype, so an f32 path can never look better than the bf16
    path it competes with.

`KERNEL_COSTS` keys are the literal `time_kernel(...)` names at the port's
dispatch sites (tests/test_torch_planner.py checks both ways). They are
cost-model keys, not names of implementations: `fused.pallas_scan` prices
the fused arm whatever kernel runs it. An entry of None marks a wrapper
span whose inner dispatches carry the accounting.
"""

from __future__ import annotations

import math

# ---------------------------------------------------------------------------
# device peak rates
# ---------------------------------------------------------------------------

# device name substring -> (peak bf16 matmul FLOP/s, peak HBM bytes/s),
# matched on torch.cuda.get_device_name; first match wins. NVIDIA's H100
# SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3 (at 700 W).
DEVICE_PEAKS: list[tuple[str, float, float]] = [
    ("H100", 989e12, 3.35e12),
]

# the CPU: a nominal 32-vCPU host. Utilization numbers on the CPU are
# illustrative only: the FLOPs and bytes stay exact, the denominator is
# nominal
CPU_PEAK_FLOPS = 3.2e12
CPU_PEAK_BW = 100e9

_default_type: str | None = None
_peaks_cache: dict[str, tuple[float, float, str]] = {}


def default_device_type() -> str:
    """"cuda" when the process sees a card, else "cpu": the device whose
    peaks price the planner's predictions."""
    global _default_type
    if _default_type is None:
        import torch

        _default_type = "cuda" if torch.cuda.is_available() else "cpu"
    return _default_type


def device_peaks(device=None) -> tuple[float, float, str]:
    """-> (peak_flops, peak_bytes_per_s, device_kind) of `device` (a torch
    device; None: the process's accelerator). A card is matched by its
    torch.cuda.get_device_name; the CPU, and a card kind the table does not
    name, get the nominal CPU peaks."""
    dtype = default_device_type() if device is None else device.type
    index = 0 if device is None or device.index is None else device.index
    key = f"{dtype}:{index}"
    out = _peaks_cache.get(key)
    if out is None:
        kind = "cpu"
        flops, bw = CPU_PEAK_FLOPS, CPU_PEAK_BW
        if dtype == "cuda":
            import torch

            kind = torch.cuda.get_device_name(index)
            for pat, f, b in DEVICE_PEAKS:
                if pat in kind:
                    flops, bw = f, b
                    break
        out = _peaks_cache[key] = (flops, bw, kind)
    return out


# ---------------------------------------------------------------------------
# primitive costs
# ---------------------------------------------------------------------------

def matmul_cost(m: int, k: int, n: int, *, passes: int = 1,
                a_bytes: int = 2, b_bytes: int = 2, out_bytes: int = 4) -> dict:
    """[M,K]@[K,N] done `passes` times (the split-bf16 tier runs 2 logical
    passes). Each pass re-reads both operands; the result is written once."""
    return {
        "flops": 2.0 * m * k * n * passes,
        "bytes": float(passes * (m * k * a_bytes + k * n * b_bytes) + m * n * out_bytes),
    }


def topk_scan_cost(q: int, n: int, *, score_bytes: int = 4) -> dict:
    """Streamed top-k over a [q, n] score field: one read of the scores, 2
    ops (compare + select) per element."""
    return {"flops": 2.0 * q * n, "bytes": float(q * n * score_bytes)}


def sparse_bm25_cost(rows: int, *, block: int = 128, lane_bytes: int = 12,
                     out_n: int = 0) -> dict:
    """Blocked-CSR BM25 over `rows` posting blocks: each lane is one (docid
    i32, tf f32, dl f32) read, ~6 FLOPs of BM25 and 1 of scatter-add.
    out_n > 0 adds the dense accumulator write."""
    lanes = rows * block
    return {"flops": 7.0 * lanes, "bytes": float(lanes * lane_bytes + out_n * 4)}


def impact_gather_cost(q_rows: int, *, block: int = 128, code_bytes: int = 2) -> dict:
    """Impact-tier gather and dequantization (`ops.kernels.impact_gather`):
    each lane reads (docid i32 + code) and writes (docid i32, score f32);
    1 FLOP per lane (the dequant multiply) + 1 op of bookkeeping. q_rows =
    the gathered block rows of the batch (Q·Ts·B)."""
    lanes = q_rows * block
    return {"flops": 2.0 * lanes, "bytes": float(lanes * (4 + code_bytes + 8))}


def impact_sum_cost(q: int, n: int, *, cands: int = 0) -> dict:
    """The impact arm's candidate tail (`fast_topk_from_candidates`): the
    [q, cands] sort (log2(cands) compare+select passes over 8-byte lanes)
    and the dense-tier selection scan over [q, n]."""
    parts = [topk_scan_cost(q, n)]
    if cands:
        passes = max(1.0, math.log2(max(cands, 2)))
        parts.append({"flops": 2.0 * q * cands * passes,
                      "bytes": float(q * cands * 8 * 3)})
    return _merge(*parts)


def knn_tiered_cost(b: int, d: int, n: int, *, kb: int = 128) -> dict:
    """TieredKnnScanner: 2 bf16 matmul passes over the split [D, N] corpus,
    then an f32 rescore of the [b, kb] survivors."""
    sel = matmul_cost(b, d, n, passes=2, a_bytes=2, b_bytes=2, out_bytes=0)
    resc_flops = 2.0 * b * kb * d
    resc_bytes = float(b * kb * d * 4 + b * kb * 8)
    return {"flops": sel["flops"] + resc_flops + 2.0 * b * n,
            "bytes": sel["bytes"] + resc_bytes}


def ann_gather_scan_cost(b: int, p: int, l: int, d: int, *, tier: str = "int8") -> dict:
    """The batched ANN gather-scan: every (query, probed cluster) pair reads
    its [L, D] tile at the tier's storage dtype (int8 codes + 8 B/slot scale
    and offset, or the split-bf16 pair at 4D B/slot) plus 12 B/slot of
    metadata; FLOPs: the matmul, the int8 affine correction or the second
    bf16 pass, and 2 ops/slot of selection."""
    slots = float(b * p * l)
    if tier == "int8":
        tile_bytes = slots * (d * 1 + 8)
        mm_flops = 2.0 * slots * d + 2.0 * slots
    else:
        tile_bytes = slots * (2 * d * 2)
        mm_flops = 2.0 * 2.0 * slots * d
    return {"flops": mm_flops + 2.0 * slots,
            "bytes": tile_bytes + slots * 12 + b * d * 4}


def ann_rescore_cost(b: int, kb: int, d: int) -> dict:
    """f32 rescore of ANN survivors: [b, kb, d] row gather, one einsum and
    the (score, id) writes."""
    return {"flops": 2.0 * b * kb * d, "bytes": float(b * kb * d * 4 + b * kb * 8)}


def knn_scan_cost(b: int, d: int, n: int) -> dict:
    """The f32 exact scan (the escalation arm): one f32 matmul over the
    corpus and the streamed selection."""
    mm = matmul_cost(b, d, n, passes=1, a_bytes=4, b_bytes=4, out_bytes=0)
    return {"flops": mm["flops"] + 2.0 * b * n, "bytes": mm["bytes"] + float(b * n * 4)}


# ---------------------------------------------------------------------------
# per-dispatch-site registry
# ---------------------------------------------------------------------------

# ---- the write path's build stages (`monitoring.refresh_profile.build_stage`)

def kmeans_build_cost(n: int, d: int, c: int, *, iters: int = 8) -> dict:
    """Lloyd k-means (ops/vector.kmeans_ivf): per iteration one [N,D]@[D,C]
    f32 distance matmul, a 2-ops/element argmax over [N,C], and the
    centroid scatter update reading the [N,D] corpus once more."""
    mm = matmul_cost(n, d, c, passes=iters, a_bytes=4, b_bytes=4,
                     out_bytes=0)
    return {
        "flops": mm["flops"] + 2.0 * n * c * iters + 2.0 * n * d * iters,
        "bytes": mm["bytes"] + float(iters * (n * 4 + c * d * 4)),
    }


def csr_assemble_build_cost(postings: int, *, n_docs: int = 0) -> dict:
    """Blocked-postings scatter (index/pack.py build): every posting is
    read from the flat CSR ((docid i32, tf f32) = 8 B) and written into
    its blocked lane ((docid, tf, dl) = 12 B); 2 ops/posting of index
    arithmetic; plus the per-doc norm gather."""
    return {
        "flops": 2.0 * postings,
        "bytes": float(postings * (8 + 12) + n_docs * 4),
    }


def norms_build_cost(n_docs: int, nfields: int) -> dict:
    """Smallfloat norm quantization (index/smallfloat.quantize_lengths):
    one i64 length read + one u8 norm write per (doc, field) lane, 2
    ops/lane for the quantize bucket search."""
    lanes = n_docs * max(nfields, 1)
    return {"flops": 2.0 * lanes, "bytes": float(lanes * (8 + 1))}


def impact_quantize_build_cost(rows: int, *, block: int = 128,
                               code_bytes: int = 2) -> dict:
    """Impact-code derivation over the blocked postings ([rows, BLOCK]
    lanes): tfn = tf/(tf + k_base + k_slope·dl) then scale+round+clip —
    ~6 FLOPs/lane; reads (tf f32, dl f32), writes one code. Identical
    model for the host derivation (pack.py, basis="host") and the
    on-device elementwise pass (index/device_build.impact_codes_device,
    basis="device") — the split between the two IS the attribution."""
    lanes = rows * block
    return {"flops": 6.0 * lanes, "bytes": float(lanes * (8 + code_bytes))}


def ann_tiles_build_cost(c: int, l: int, d: int) -> dict:
    """ANN tile packing (ann/index.build_ann): every [C, L] slot gathers
    its f32 vector row, scalar-quantizes it to int8 (~4 ops/element:
    min/max scan + affine + round) and writes codes + scale/offset/order
    metadata."""
    slots = float(c * l)
    return {
        "flops": 4.0 * slots * d,
        "bytes": slots * (d * 4 + d * 1 + 12),
    }


def device_put_build_cost(nbytes: float) -> dict:
    """Pack upload (query/executor.pack_to_device, stacked_to_device): a pure
    host→device transfer — zero FLOPs, judged on bandwidth only (the
    denominator is the HBM peak; PCIe/DMA peaks are below it, so the
    fraction is conservative)."""
    return {"flops": 0.0, "bytes": float(nbytes)}


def merge_build_cost(docs: int, *, nbytes: float = 0.0) -> dict:
    """Tier merge (engine._merge_tiers): a wrapper over a full rebuild —
    the inner stages carry the precise accounting; this entry keeps the
    merge-level roofline honest as one read of the old resident pack plus
    one write of its replacement, with 2 ops/doc of visibility
    bookkeeping."""
    return {"flops": 2.0 * docs, "bytes": float(2.0 * nbytes)}


def segment_merge_build_cost(docs: int, *, nbytes: float = 0.0) -> dict:
    """LSM tail-segment fold (engine._merge_tail_segments): a
    wrapper over the union rebuild of the tail segments ONLY — the
    inner build.* stages (csr_assemble, impact_quantize, device_put…)
    carry the precise accounting; same read-old + write-new convention
    as build.merge, scoped to the tail bytes instead of the base."""
    return {"flops": 2.0 * docs, "bytes": float(2.0 * nbytes)}


def analyze_build_cost(nbytes: int) -> dict:
    """Batch text analysis (analysis/batched.py): tokenization +
    term hashing over the burst's packed byte stream. Bytes-based
    convention — work scales with input
    CHARACTERS, not docs: ~16 ops/byte (char-class tests, case fold,
    two segmented polynomial hash lanes with their scan combines) and
    ~3× the input bytes of traffic (read the char tensor once, write
    the boundary masks and two u32 hash lanes amortized over scan
    tiles). The identical model prices the device kernel
    (basis="device") and the batched host pass (basis="host") — the
    split between the two IS the attribution, like build.impact_quantize."""
    nbytes = float(max(int(nbytes), 1))
    return {"flops": 16.0 * nbytes, "bytes": 3.0 * nbytes}


def _merge(*costs: dict) -> dict:
    return {"flops": sum(c["flops"] for c in costs), "bytes": sum(c["bytes"] for c in costs)}


def _fused_pallas_scan(fields: dict) -> dict | None:
    """The fused arm: the split-bf16 2-pass dense product (the tier read
    once as the stacked [2V, N] bf16 operand), the per-tile selection and
    the sparse scatter when posting rows ride along."""
    q, v, n = fields.get("queries"), fields.get("v"), fields.get("num_docs")
    if not (q and v and n):
        return None
    parts = [matmul_cost(q, v, n, passes=2, a_bytes=2, b_bytes=2, out_bytes=0),
             topk_scan_cost(q, n, score_bytes=0)]
    rows = fields.get("rows")
    if rows:
        parts.append(sparse_bm25_cost(int(rows)))
    return _merge(*parts)


def _batched_disjunction(fields: dict) -> dict | None:
    """The batched sparse path (`BatchTermSearcher.run` / `run_fast`):
    postings gather, BM25 and the per-query candidate selection."""
    q, n = fields.get("queries"), fields.get("num_docs")
    if not (q and n):
        return None
    rows = fields.get("rows", 0)
    parts = [topk_scan_cost(q, n)]
    if rows:
        parts.append(sparse_bm25_cost(int(rows), out_n=n))
    return _merge(*parts)


def _impact_gather(fields: dict) -> dict | None:
    rows = fields.get("rows")
    if not rows:
        return None
    return impact_gather_cost(int(rows), code_bytes=int(fields.get("code_bytes", 2)))


def _impact_sum(fields: dict) -> dict | None:
    q, n = fields.get("queries"), fields.get("num_docs")
    if not (q and n):
        return None
    return impact_sum_cost(q, n, cands=int(fields.get("cands", 0)))


def _impact_sharded(fields: dict) -> dict | None:
    """The code-block gather and dequantization per shard and the candidate
    tail; num_docs is the total scanned (S · n_max)."""
    q, n, rows = fields.get("queries"), fields.get("num_docs"), fields.get("rows")
    if not (q and n and rows):
        return None
    return _merge(impact_gather_cost(int(rows), code_bytes=int(fields.get("code_bytes", 2))),
                  topk_scan_cost(q, n))


def _knn_tiered(fields: dict) -> dict | None:
    b, d, n = fields.get("queries"), fields.get("dims"), fields.get("num_docs")
    if not (b and d and n):
        return None
    return knn_tiered_cost(b, d, n, kb=fields.get("kb", 128))


def _knn_scan(fields: dict) -> dict | None:
    b, d, n = fields.get("queries"), fields.get("dims"), fields.get("num_docs")
    if not (b and d and n):
        return None
    return knn_scan_cost(b, d, n)


def _ann_centroid_probe(fields: dict) -> dict | None:
    """[B, D] @ [D, C] f32 routing matmul and the per-centroid selection."""
    b, d, c = fields.get("queries"), fields.get("dims"), fields.get("nlist")
    if not (b and d and c):
        return None
    mm = matmul_cost(b, d, c, passes=1, a_bytes=4, b_bytes=4, out_bytes=0)
    return _merge(mm, {"flops": 2.0 * b * c, "bytes": float(b * c * 4)})


def _ann_gather_scan(fields: dict) -> dict | None:
    b, d = fields.get("queries"), fields.get("dims")
    p, l = fields.get("nprobe"), fields.get("tile")
    if not (b and d and p and l):
        return None
    return ann_gather_scan_cost(b, p, l, d, tier=fields.get("scan_tier", "int8"))


def _ann_rescore(fields: dict) -> dict | None:
    b, d, kb = fields.get("queries"), fields.get("dims"), fields.get("kb")
    if not (b and d and kb):
        return None
    return ann_rescore_cost(b, kb, d)


def _build_kmeans(fields: dict) -> dict | None:
    n, d, c = fields.get("n"), fields.get("dims"), fields.get("nlist")
    if not (n and d and c):
        return None
    return kmeans_build_cost(int(n), int(d), int(c),
                             iters=int(fields.get("iters", 8)))


def _build_csr_assemble(fields: dict) -> dict | None:
    p = fields.get("postings")
    if p is None:
        return None
    return csr_assemble_build_cost(int(p),
                                   n_docs=int(fields.get("num_docs", 0)))


def _build_norms(fields: dict) -> dict | None:
    n = fields.get("num_docs")
    if n is None:
        return None
    return norms_build_cost(int(n), int(fields.get("nfields", 1)))


def _build_impact_quantize(fields: dict) -> dict | None:
    rows = fields.get("rows")
    if rows is None:
        return None
    return impact_quantize_build_cost(
        int(rows), code_bytes=int(fields.get("code_bytes", 2)))


def _build_ann_tiles(fields: dict) -> dict | None:
    c, l, d = fields.get("nlist"), fields.get("tile"), fields.get("dims")
    if not (c and l and d):
        return None
    return ann_tiles_build_cost(int(c), int(l), int(d))


def _build_device_put(fields: dict) -> dict | None:
    nbytes = fields.get("nbytes")
    if nbytes is None:
        return None
    return device_put_build_cost(float(nbytes))


def _build_merge(fields: dict) -> dict | None:
    docs = fields.get("docs")
    if docs is None:
        return None
    return merge_build_cost(int(docs),
                            nbytes=float(fields.get("nbytes", 0.0)))


def _build_segment_merge(fields: dict) -> dict | None:
    docs = fields.get("docs")
    if docs is None:
        return None
    return segment_merge_build_cost(int(docs),
                                    nbytes=float(fields.get("nbytes", 0.0)))


def _build_analyze(fields: dict) -> dict | None:
    nbytes = fields.get("nbytes")
    if nbytes is None:
        return None
    return analyze_build_cost(int(nbytes))


def _esql_stats_exchange(fields: dict) -> dict | None:
    """STATS partials and their merge (esql/exchange.py): per row, the
    segment id and each used column's value and null bit in; per double
    column a stable sort of the R segment ids (comparator work ~ R log2 R)
    and one add, min and max per row; per long column a count, two half
    sums, a min and a max per row; then the [S, G] partials of each column
    out. The JAX package prices its one-hot matmul instead (R*G per view),
    which this program does not run."""
    s, r, g = fields.get("shards"), fields.get("rows"), fields.get("groups")
    if not (s and r and g):
        return None
    s, r, g = int(s), int(r), int(g)
    dc = int(fields.get("dbl_cols", 0))
    lc = int(fields.get("long_cols", 0))
    flops = r * (1.0 + 4.0 * dc + 5.0 * lc)
    if dc:
        flops += r * max(math.log2(max(r, 2)), 1.0)
    bytes_ = r * (8.0 + 9.0 * (dc + lc)) + s * g * 8.0 * (4.0 * dc + 5.0 * lc + 1.0)
    return {"flops": flops, "bytes": bytes_}


def _esql_topn_exchange(fields: dict) -> dict | None:
    """SORT|LIMIT top-n exchange (esql/topn.py): per-shard lexicographic
    sort over K encoded rank keys + the row index, then the re-sort of the
    S*n winners. Sort flops priced as comparator work ~ rows*log2(rows)
    per key lane; bytes move each [K+1] key lane once in and once out (the
    JAX package's pricing: the same sort work)."""
    s, r = fields.get("shards"), fields.get("rows")
    if not (s and r):
        return None
    s, r = int(s), int(r)
    k1 = int(fields.get("keys", 1)) + 1
    n = int(fields.get("n", 1)) or 1
    lg = max(math.log2(max(r, 2)), 1.0)
    lgm = max(math.log2(max(s * n, 2)), 1.0)
    flops = 2.0 * s * k1 * r * lg + 2.0 * k1 * (s * n) * lgm
    bytes_ = 2.0 * 8.0 * k1 * (s * r + s * n)
    return {"flops": flops, "bytes": bytes_}


# name -> cost fn (None = wrapper span; inner dispatches carry the cost)
KERNEL_COSTS: dict[str, object] = {
    "fused.pallas_scan": _fused_pallas_scan,
    "fused.msearch": None,  # wraps fused.pallas_scan (+ escalation)
    "batched.disjunction": _batched_disjunction,
    "batched.escalation": _batched_disjunction,
    "sparse.impact_gather": _impact_gather,
    "sparse.impact_sum": _impact_sum,
    "sharded.fused_pipeline": _fused_pallas_scan,
    "sharded.impact_disjunction": _impact_sharded,
    "sharded.exact_disjunction": _batched_disjunction,
    # the superpack lane: the exact arm's body over lane-indexed gathers
    # (num_docs = the size class's padded doc width)
    "superpack.tenant_gather": _batched_disjunction,
    "vector.knn_tiered": _knn_tiered,
    "vector.knn_scan": _knn_scan,
    "ann.centroid_probe": _ann_centroid_probe,
    "ann.gather_scan": _ann_gather_scan,
    "ann.rescore": _ann_rescore,
    # the write path's build stages, timed through refresh_profile.build_stage
    "build.kmeans": _build_kmeans,
    "build.impact_quantize": _build_impact_quantize,
    "build.csr_assemble": _build_csr_assemble,
    "build.norms": _build_norms,
    "build.ann_tiles": _build_ann_tiles,
    "build.device_put": _build_device_put,
    "build.merge": _build_merge,
    "build.segment_merge": _build_segment_merge,
    "build.analyze": _build_analyze,
    # the ES|QL exchanges (esql/exchange.py, esql/topn.py)
    "esql.stats_exchange": _esql_stats_exchange,
    "esql.topn_exchange": _esql_topn_exchange,
}


def kernel_cost(name: str, fields: dict) -> dict | None:
    """-> {"flops", "bytes"} of one dispatch, or None (unknown name, a
    wrapper entry, or shape fields missing)."""
    fn = KERNEL_COSTS.get(name)
    if fn is None:
        return None
    try:
        return fn(fields)
    except (TypeError, ValueError):  # a malformed field never fails a search
        return None


def utilization(name: str, fields: dict, seconds: float, device=None) -> dict | None:
    """-> {flops, bytes, mfu, bw_util} of one timed dispatch on `device`
    (None: the process's accelerator), or None."""
    cost = kernel_cost(name, fields)
    if cost is None:
        return None
    peak_f, peak_b, _kind = device_peaks(device)
    sec = max(seconds, 1e-9)
    return {
        "flops": cost["flops"],
        "bytes": cost["bytes"],
        "mfu": cost["flops"] / sec / peak_f,
        "bw_util": cost["bytes"] / sec / peak_b,
    }
