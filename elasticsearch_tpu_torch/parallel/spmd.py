"""The coordinator merge of per-shard top rows, on tensors.

The JAX package's `parallel/spmd.py` also builds meshes and partition rules
for a TPU slice; this package runs every shard on one device for now, so
only the merge is ported.
"""

from __future__ import annotations

import torch


def merge_topk_rows(v: torch.Tensor, i: torch.Tensor, t: torch.Tensor):
    """Per-shard top rows (v [S, Q, kk] f32, i [S, Q, kk] ids, t [S, Q]
    totals) -> (scores [Q, kk], shard [Q, kk] i32, doc [Q, kk], totals [Q]
    i64).

    Order (score desc, shard asc, doc asc): Lucene's TopDocs.merge, and
    byte for byte the JAX package's host lexsort `_merge_shard_rows`, which
    keys ties on the doc id, -inf lanes included. Three stable sorts over
    the shard-major flat rows apply the lexsort's keys from the last to the
    first (`torch.topk` orders ties arbitrarily)."""
    S, Q, kk = v.shape
    flat_v = v.permute(1, 0, 2).reshape(Q, S * kk)
    flat_i = i.permute(1, 0, 2).reshape(Q, S * kk)
    flat_s = torch.arange(S, dtype=torch.int32, device=v.device).repeat_interleave(kk)
    flat_s = flat_s[None, :].expand(Q, S * kk)
    order = torch.argsort(flat_i, dim=1, stable=True)
    order = order.gather(1, torch.argsort(flat_s.gather(1, order), dim=1, stable=True))
    order = order.gather(1, torch.argsort(flat_v.gather(1, order), dim=1, descending=True,
                                          stable=True))
    order = order[:, :kk]
    return (flat_v.gather(1, order), flat_s.gather(1, order), flat_i.gather(1, order),
            t.to(torch.int64).sum(dim=0))
