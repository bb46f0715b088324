"""`ops.scoring.segment_sum_f32`: one summation order on every device.

Every float sum of the port's aggregations and the exact term score of
`_search` go through `segment_sum_f32`: a stable sort by segment, the
values cast to f64 and added by a fixed pairwise tree (`segment_sum_pairwise`),
one rounding to f32. These tests build a segment whose f32 result depends
on the order of the f64 adds and show that the port always gives the
tree's result, one segment or many, and hold the function bit for bit to a
numpy model of the same tree. The card's half is in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.esql import exchange
from elasticsearch_tpu_torch.ops import scoring
from elasticsearch_tpu_torch.ops.scoring import segment_sum_f32, segment_sum_pairwise

# 1 + 2^-24 is the midpoint between two f32 neighbours. Added left to right
# in f64, each 2^-53 is a tie that rounds to even and vanishes, and the f32
# rounding of 1 + 2^-24 ties to 1.0. The tree adds the two 2^-53 first
# (exactly 2^-52), so the f64 sum lies above the midpoint and rounds up.
ORDER_DEPENDENT = np.array([1.0, 2.0 ** -24, 2.0 ** -53, 2.0 ** -53], np.float32)
SEQUENTIAL_F32 = np.float32(1.0)
PAIRWISE_F32 = np.float32(1.0 + 2.0 ** -23)


def _sequential_f64(vals) -> np.float32:
    acc = 0.0
    for v in np.asarray(vals, np.float64):
        acc += v
    return np.float32(acc)


def tree_model(tgt: np.ndarray, vals: np.ndarray, nseg: int) -> np.ndarray:
    """numpy model: per segment, the values in stable order, in f64, added
    pairwise (stride 1, 2, 4, ...: the value at position p, p a multiple of
    2d, takes in the one at p + d), + 0.0, rounded to f32."""
    order = np.argsort(tgt, kind="stable")
    st, sv = tgt[order], vals[order].astype(np.float64)
    out = np.zeros(nseg, np.float32)
    for s in range(nseg):
        v = sv[st == s].copy()
        d = 1
        while d < len(v):
            for p in range(0, len(v) - d, 2 * d):
                v[p] = v[p] + v[p + d]
            d *= 2
        out[s] = np.float32((v[0] if len(v) else 0.0) + 0.0)
    return out


def test_order_dependent_segment_takes_the_pairwise_tree():
    assert _sequential_f64(ORDER_DEPENDENT) == SEQUENTIAL_F32
    assert tree_model(np.zeros(4, np.int64), ORDER_DEPENDENT, 1)[0] == PAIRWISE_F32
    vals = torch.from_numpy(ORDER_DEPENDENT)
    # one segment: the branch that used to be one .sum()
    one = segment_sum_f32(torch.zeros(4, dtype=torch.int64), vals, 1)
    assert one.dtype == torch.float32 and one.numpy()[0] == PAIRWISE_F32
    # the same values as segment 2 of 4, interleaved with others and with
    # dropped lanes (segment nseg): the stable sort keeps their order
    tgt = torch.tensor([2, 4, 0, 2, 1, 4, 2, 3, 2], dtype=torch.int64)
    v = torch.tensor([1.0, 7.0, 0.5, 2.0 ** -24, 3.0, 9.0, 2.0 ** -53, 0.25, 2.0 ** -53],
                     dtype=torch.float32)
    out = segment_sum_f32(tgt, v, 4).numpy()
    assert out[2] == PAIRWISE_F32
    assert out.tolist() == [0.5, 3.0, float(PAIRWISE_F32), 0.25]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_sum_f32_equals_the_numpy_tree_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    # 300,000 mixed-sign values of wide magnitude in ~500 segments, some
    # empty, some lanes dropped (segment nseg)
    n, nseg = 300_000, 500
    vals = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)
    tgt = rng.integers(0, nseg + 1, n)
    tgt[tgt == 7] = nseg  # segment 7 stays empty
    got = segment_sum_f32(torch.from_numpy(tgt), torch.from_numpy(vals), nseg).numpy()
    want = tree_model(tgt, vals, nseg)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    assert got[7] == 0.0 and not np.signbit(got[7])
    # one segment: the same tree
    got1 = segment_sum_f32(torch.zeros(n, dtype=torch.int64), torch.from_numpy(vals), 1).numpy()
    assert got1.view(np.uint32)[0] == tree_model(np.zeros(n, np.int64), vals, 1).view(np.uint32)[0]


def test_negative_zero_segment_sums_to_positive_zero():
    out = segment_sum_f32(torch.zeros(3, dtype=torch.int64),
                          torch.tensor([-0.0, -0.0, -0.0]), 1)
    assert out.item() == 0.0 and not torch.signbit(out).item()
    assert segment_sum_f32(torch.zeros(0, dtype=torch.int64), torch.zeros(0), 0).shape == (0,)


def test_one_copy_of_the_tree_shared_with_esql():
    assert exchange.segment_sum_pairwise is scoring.segment_sum_pairwise
    vals = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -53, 2.0 ** -53, 5.0], dtype=torch.float64)
    seg = torch.tensor([0, 0, 0, 0, 1])
    lengths = torch.tensor([4, 1])
    out = segment_sum_pairwise(vals, seg, lengths)
    assert np.float32(out[0].item()) == PAIRWISE_F32 and out[1].item() == 5.0
