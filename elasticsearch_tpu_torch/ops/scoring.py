"""BM25 scoring over blocked-CSR postings, on torch tensors.

The counterpart of the JAX package's `ops/scoring.py` (reference behavior:
search/internal/ContextIndexSearcher.java — per-segment BulkScorer pulling
postings through BM25 into a top-k heap), run data-parallel:

    slice a term's postings blocks -> vectorized BM25 over [R, 128] lanes
    (or the impact tier's codes times one scale) -> index_add_ into a dense
    per-doc accumulator -> scan_topk

The dense accumulator has N+1 slots; slot N is a dead slot that absorbs all
padding lanes (padding docids == N), so no masking branch exists anywhere.
Within one term every docid is unique, so each add lands on 0.0 and the
scatter is exact and deterministic in any order.

BM25 (Lucene 9 BM25Similarity, ES's default at
server/.../index/similarity/SimilarityService.java:43-58):

    idf(t)  = ln(1 + (docCount - df + 0.5) / (df + 0.5))
    tfn     = tf / (tf + k1 * (1 - b + b * dl / avgdl))   [norms present]
    tfn     = tf / (tf + k1)                              [norms omitted]
    score   = boost * idf * tfn

The f32 operations run in the JAX package's order. `avgdl` is a 0-dim f32
tensor on the scoring device: a CUDA division by a host scalar would be a
multiplication by its reciprocal, not a division.
"""

from __future__ import annotations

import math

import torch

from .kernels import MAX_FUSED_K, _select_topk, scan_topk

DEAD_SLOT_PAD = 1  # dense accumulators are sized N + 1


def bm25_idf(doc_count: int, df: int) -> float:
    """Host-side idf; doc_count = docs with >= 1 term in the field."""
    if df <= 0:
        return 0.0
    return math.log(1.0 + (doc_count - df + 0.5) / (df + 0.5))


def term_score_blocks(
    post_docids: torch.Tensor,  # [num_blocks, BLOCK] int32
    post_tfs: torch.Tensor,  # [num_blocks, BLOCK] float32
    post_dls: torch.Tensor,  # [num_blocks, BLOCK] float32 (dl per posting)
    rows,  # this term's block rows: a slice (its contiguous rows) or an index tensor
    weight: float,  # boost * idf, an f32 value
    avgdl: torch.Tensor,  # 0-dim f32 on the scoring device
    num_docs: int,
    k1: float = 1.2,
    b: float = 0.75,
    has_norms: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score one term's postings blocks -> (scores[N+1] f32, match[N+1]
    bool). The doc length rides in the postings block, so BM25 is pure
    elementwise work over the term's rows."""
    dls = post_dls[rows] if has_norms else None
    return score_posting_arrays(
        post_docids[rows], post_tfs[rows], dls, weight, avgdl, num_docs,
        k1=k1, b=b, has_norms=has_norms,
    )


def score_posting_arrays(
    docids: torch.Tensor,  # [R, BLOCK] int32 (pad: num_docs)
    tfs: torch.Tensor,  # [R, BLOCK] float32 (pad: 0)
    dls: torch.Tensor | None,  # [R, BLOCK] float32 (None when has_norms=False)
    weight: float,
    avgdl: torch.Tensor,
    num_docs: int,
    k1: float = 1.2,
    b: float = 0.75,
    has_norms: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score explicit posting arrays (the tail of term_score_blocks)."""
    if has_norms:
        denom = tfs + k1 * (1.0 - b + b * dls / avgdl)
    else:
        denom = tfs + k1
    block_scores = weight * tfs / denom  # tf == 0 padding -> 0
    flat_ids = docids.reshape(-1)
    n1 = num_docs + DEAD_SLOT_PAD
    scores = torch.zeros(n1, dtype=torch.float32, device=tfs.device)
    scores.index_add_(0, flat_ids, block_scores.reshape(-1))
    match = torch.zeros(n1, dtype=torch.bool, device=tfs.device)
    match[flat_ids] = (tfs > 0).reshape(-1)
    return scores, match


def impact_term_scores(
    impact_codes: torch.Tensor,  # [num_blocks, BLOCK] uint16 | int8 codes
    post_docids: torch.Tensor,  # [num_blocks, BLOCK] int32 (pad: num_docs)
    rows,  # this term's block rows: a slice or an index tensor
    wscale: float,  # an f32 value: boost * idf * ubf / qmax
    num_docs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Impact-tier scoring of one term (the quantized BM25S tier): the
    term's code blocks and docids, each code times one per-term scale in
    one f32 multiply, scatter-added into the N+1 accumulator; padding lanes
    (code 0, docid num_docs) land in the dead slot. No tf, doc length,
    avgdl or division. -> (scores[N+1] f32, match[N+1] bool), as
    term_score_blocks returns them (tf > 0 postings carry code >= 1)."""
    codes = impact_codes[rows]
    if codes.dtype == torch.uint16:  # few uint16 ops exist on CUDA
        lanes = codes.view(torch.int16).to(torch.int32) & 0xFFFF
    else:
        lanes = codes.to(torch.int32)
    block_scores = wscale * lanes.to(torch.float32)
    flat_ids = post_docids[rows].reshape(-1)
    n1 = num_docs + DEAD_SLOT_PAD
    scores = torch.zeros(n1, dtype=torch.float32, device=codes.device)
    scores.index_add_(0, flat_ids, block_scores.reshape(-1))
    match = torch.zeros(n1, dtype=torch.bool, device=codes.device)
    match[flat_ids] = (lanes > 0).reshape(-1)
    return scores, match


def dense_term_scores(
    tfn_row: torch.Tensor,  # [N] f32 precomputed tf/(tf + K) of this term
    weight: float,  # boost * idf
    num_docs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score one dense-tier term: a pure elementwise scale, no gather and
    no scatter. tfn > 0 iff tf > 0, so the row doubles as the match set."""
    n1 = num_docs + DEAD_SLOT_PAD
    scores = torch.zeros(n1, dtype=torch.float32, device=tfn_row.device)
    scores[:num_docs] = weight * tfn_row
    match = torch.zeros(n1, dtype=torch.bool, device=tfn_row.device)
    match[:num_docs] = tfn_row > 0
    return scores, match


def segment_sum_pairwise(vals: torch.Tensor, seg: torch.Tensor, lengths: torch.Tensor,
                         longest: int | None = None) -> torch.Tensor:
    """[R] f64 values, their [R] segment ids in ascending order and the
    [nseg] segment lengths -> [nseg] f64 sums. Within each segment the
    values are added pairwise, by a tree fixed by the positions alone: at
    stride d, the value at position p (p a multiple of 2d) takes in the one
    at p + d. Each step is one elementwise add, so every device rounds the
    same sums in the same order. An empty segment sums to 0.0, and the sum
    ends with + 0.0 (a segment of -0.0 values sums to 0.0, as an
    accumulator started at 0.0 gives). `longest` (the largest length, when
    the caller has it on the host) saves a copy of lengths.max().

    Position p is a left node at stride d when both its lowest set bit (p =
    0: every stride) and the count of its segment's values from p on exceed
    d, so one precomputed minimum makes each pass three launches: the test,
    the partner values where it holds (0.0 elsewhere: only a zero's sign can
    change, and the final + 0.0 folds it) and an in-place add."""
    n = vals.shape[0]
    out = torch.zeros(lengths.shape[0], dtype=vals.dtype, device=vals.device)
    if n == 0:
        return out
    if longest is None:
        longest = int(lengths.max())
    starts = torch.cumsum(lengths, 0) - lengths
    pos = torch.arange(n, device=vals.device) - starts[seg]
    left = torch.minimum(torch.where(pos == 0, n, pos & -pos), lengths[seg] - pos)
    v = vals.clone()
    d = 1
    while d < longest:
        v[: n - d].add_(torch.where(left[: n - d] > d, v[d:], 0.0))
        d *= 2
    out = torch.where(lengths > 0, v[starts.clamp(max=n - 1)], out)
    return out + 0.0


def segment_sum_f32(tgt: torch.Tensor, vals: torch.Tensor, nseg: int) -> torch.Tensor:
    """Segmented float sum of `vals` into [nseg] f32 by segment `tgt` (in
    [0, nseg]; segment nseg is dropped) with no float atomics, by one
    summation order on every device: a stable sort by segment, each
    segment's values cast to f64 and added by the fixed pairwise tree of
    `segment_sum_pairwise` (one segment too), then rounded to f32 once. So
    the card and the CPU give the same bits. The tree adds
    ceil(log2(longest kept segment)) elementwise passes."""
    if nseg <= 0:
        return torch.zeros(0, dtype=torch.float32, device=vals.device)
    order = torch.sort(tgt, stable=True).indices
    lengths = torch.zeros(nseg + 1, dtype=torch.int64, device=tgt.device).index_add_(
        0, tgt, torch.ones_like(tgt))[:nseg]
    # the kept rows lead the sorted order; one copy brings both counts back
    keep, longest = torch.stack([lengths.sum(), lengths.max()]).tolist()
    order = order[:keep]
    sums = segment_sum_pairwise(vals[order].to(torch.float64), tgt[order], lengths, longest)
    return sums.to(torch.float32)


def top_k_with_total(
    scores: torch.Tensor,  # [N+1] f32
    match: torch.Tensor,  # [N+1] bool
    live: torch.Tensor,  # [N] bool
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global top-k by (score desc, docid asc) + exact total hit count
    (reference behavior: TopScoreDocCollector via
    search/query/QueryPhaseCollectorManager.java).

    For k <= MAX_FUSED_K the selection is the streamed `scan_topk`: the
    kernel on a CUDA tensor at every N, its PyTorch twin on a CPU tensor.
    Larger k select by a stable sort with the same order. The choice
    depends on k alone."""
    n = live.shape[0]
    ok = match[:n] & live
    if k <= MAX_FUSED_K:
        v, i, t = scan_topk(None, scores[:n][None, :], ok, k, count_positive=False)
        return v[0], i[0], t[0]
    total = ok.sum(dtype=torch.int32)
    masked = torch.where(ok, scores[:n], torch.tensor(float("-inf"), device=scores.device))
    top_v, top_i = _select_topk(masked[None, :], min(k, n))
    return top_v[0], top_i[0], total


def top_k_with_total_stacked(
    scores: torch.Tensor,  # [S, N+1] f32, one row per shard
    match: torch.Tensor,  # [S, N+1] bool
    live: torch.Tensor,  # [S, N] bool
    k: int,
):
    """The global top k over S shards of N (padded) lanes each, by (score
    desc, shard asc, docid asc), and the exact total over every shard.
    -> (scores [kg] f32, shards [kg] i32, docids [kg] i32, total 0-dim i32),
    kg = min(k, S·min(k, N)).

    The JAX package selects each shard's top min(k, N) on the vmap axis of
    its program and merges the rows by a top-k over their shard-major flat
    layout (`StackedSearcher._compiled`). Here the shard axis folds into the
    lane axis: lane s·N + d, so one streamed `scan_topk` over S·N lanes
    orders ties by (shard, docid), the merge's order, and returns the same
    finite hits in one launch per request."""
    S, n = live.shape
    kg = min(k, S * min(k, n))
    ok = (match[:, :n] & live).reshape(-1)
    flat = scores[:, :n].reshape(-1)
    if kg <= MAX_FUSED_K:
        v, i, t = scan_topk(None, flat[None, :], ok, kg, count_positive=False)
        v, i, total = v[0], i[0], t[0]
    else:
        total = ok.sum(dtype=torch.int32)
        masked = torch.where(ok, flat, torch.tensor(float("-inf"), device=flat.device))
        v, i = _select_topk(masked[None, :], kg)
        v, i = v[0], i[0]
    return v, torch.div(i, n, rounding_mode="floor"), torch.remainder(i, n), total
