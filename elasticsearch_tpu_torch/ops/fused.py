"""The fused batched BM25 arm (the JAX package's `ops/fused.py`).

Only `rank_topk` is ported so far: the exact (score desc, docid asc) merge
the batched arms share. The fused tile-candidates kernel, its pipeline and
`FusedTermSearcher` are the next slice of the port.
"""

from __future__ import annotations

import torch


def rank_topk(values: torch.Tensor, ids: torch.Tensor, k: int):
    """(score desc, docid asc) exact order via one int64 rank-key top-k.
    values must be >= 0 or -inf: non-negative IEEE f32 bit patterns order
    like their values as int32, and -inf sorts below them all. Equal keys
    are equal (value, id) pairs, so the order among them is immaterial.
    -> (values [Q, k], ids [Q, k])."""
    score_bits = values.contiguous().view(torch.int32).to(torch.int64)
    rank = (score_bits << 32) + (0xFFFFFFFF - ids.to(torch.int64))
    _, sel = torch.topk(rank, k, dim=1)
    return values.gather(1, sel), ids.gather(1, sel)
