"""The tenant-gather term disjunction of a superpack wave.

The counterpart of the JAX package's `tenancy/kernels.py` (a jitted XLA
program there, no Pallas kernel). One call scores a wave that mixes
queries from many small tenant indices sharing one stacked device layout:
every query row carries its tenant's lane id, and the posting gathers lead
with it (`post_docids[tid, rows]`). Past the gathers the body is the exact
arm's, `ops.batched.batch_term_disjunction`, op for op: the same f64 run
sums (`_run_sums`), the same dense top-k (`_dense_topk`, so the `scan_topk`
kernel on the card) and the same rank-key merge (`_merge`). So a tenant's
finite rows (scores, ids) and its total are byte-equal to what its own
index's exact arm gives on the same plan.

Why the rows stay equal:
  * `avgdl` is a per-query f32 operand; the per-index arm divides by its
    0-dim f32 avgdl, the same value in the same operation.
  * members carry no dense tier (superpack eligibility), so the dense part
    is the zero matrix the per-index arm also builds for a pack without
    one: its top k is all -inf with a positive count of 0 whatever the live
    mask, so one mask (any lane live) serves every row of the wave.
  * a lane's blocks past the tenant's own hold the class sentinel docid
    n_pad with tf 0, and the tenant's own pad slots its sentinel num_docs,
    dead in `live`: both sort after every real docid and leave the prefix
    sums of the real ones as they are.
"""

from __future__ import annotations

import torch

from ..ops.batched import NEG_INF, _dense_topk, _merge, _run_sums


def tenant_term_disjunction(dev: dict, k: int, sparse_rows: torch.Tensor,
                            sparse_weights: torch.Tensor, tids: torch.Tensor,
                            avgdl_q: torch.Tensor, num_docs: int, k1: float = 1.2,
                            b: float = 0.75, has_norms: bool = True):
    """dev: a size class's lane tensors (`post_docids`, `post_tfs`,
    `post_dls` [T, nb_pad, 128], `live` [T, n_pad]); sparse_rows [Q, Ts, B]
    lane-local block rows (0 = the reserved padding block); sparse_weights
    [Q, Ts] f32; tids [Q] lane ids; avgdl_q [Q] f32; num_docs = n_pad.
    -> (scores [Q, k], docids [Q, k] tenant-local, totals [Q] i32)."""
    n = num_docs
    Q = sparse_rows.shape[0]
    lane = tids.long()
    t3 = lane[:, None, None]
    rows = sparse_rows.long()
    docids = dev["post_docids"][t3, rows]  # [Q, Ts, B, 128]
    tfs = dev["post_tfs"][t3, rows]
    if has_norms:
        dls = dev["post_dls"][t3, rows]
        denom = tfs + k1 * (1.0 - b + b * dls / avgdl_q[:, None, None, None])
    else:
        denom = tfs + k1
    part = sparse_weights[:, :, None, None] * tfs / denom  # pad -> 0
    live = dev["live"][lane]  # [Q, n_pad]
    sd, run_sum, is_end = _run_sums(docids.reshape(Q, -1), part.reshape(Q, -1))
    at = sd.clamp(max=n - 1).long()
    valid_end = is_end & live.gather(1, at) & (sd < n)
    scores_d = torch.zeros((Q, n), dtype=torch.float32, device=sparse_rows.device)
    dg = scores_d.gather(1, at)
    cand = torch.where(valid_end, run_sum + dg, NEG_INF)
    dv, di, dense_count = _dense_topk(scores_d, live.any(dim=0), k)
    fv, fids = _merge(cand, sd, valid_end, dv, di, k)
    totals = dense_count + (valid_end & (dg <= 0) & (run_sum > 0)).sum(
        dim=1, dtype=torch.int32)
    return fv, fids, totals
