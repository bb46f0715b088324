"""The CUDA kernels against their PyTorch twins, on a card.

Every test here needs a CUDA card and the CUDA toolkit; without a card each
skips. The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: the suite's conftest.py configures JAX). Tolerance: the
kernel and its twin run the same f32 operations in the same order, so
values are equal, ids equal wherever the score is finite, totals equal.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import kernels
from elasticsearch_tpu_torch.ops.kernels import TRANSFORMS, scan_topk, scan_topk_reference


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("count_positive", [False, True])
@pytest.mark.parametrize("mode", ["streamed", "matmul"])
def test_scan_topk_kernel_matches_twin(mode, count_positive):
    dev = _cuda()
    rng = np.random.default_rng(7)
    B, D, N, k = (3, 0, 100_003, 25) if mode == "streamed" else (19, 40, 50_001, 10)
    live = torch.from_numpy(rng.random(N) > 0.1).to(dev)
    if mode == "streamed":
        q = None
        mat = torch.from_numpy(np.round(rng.normal(size=(B, N)), 2).astype(np.float32)).to(dev)
    else:
        q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dev)
        mat = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32)).to(dev)
    for transform in TRANSFORMS:
        aux_doc = torch.from_numpy(rng.random(N).astype(np.float32)).to(dev)
        aux_q = torch.from_numpy(rng.random(B).astype(np.float32)).to(dev)
        before = kernels.launch_counts["scan_topk"]
        got = scan_topk(q, mat, live, k, transform=transform, aux_doc=aux_doc,
                        aux_q=aux_q, count_positive=count_positive)
        assert kernels.launch_counts["scan_topk"] == before + 1
        want = scan_topk_reference(q, mat, live, k, transform=transform, aux_doc=aux_doc,
                                   aux_q=aux_q, count_positive=count_positive)
        torch.cuda.synchronize()
        gv, gi, gt = [x.cpu().numpy() for x in got]
        wv, wi, wt = [x.cpu().numpy() for x in want]
        np.testing.assert_array_equal(gv, wv)
        finite = np.isfinite(wv)
        np.testing.assert_array_equal(gi[finite], wi[finite])
        np.testing.assert_array_equal(gt, wt)


@pytest.mark.gpu
def test_scan_topk_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    scores = torch.zeros((1, 1000), device=dev)
    live = torch.ones(1000, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        scan_topk(None, scores, live, 129)
    with pytest.raises(ValueError, match="live must be bool"):
        scan_topk(None, scores, live.float(), 10)
    with pytest.raises(ValueError, match="contiguous"):
        scan_topk(None, torch.zeros((1, 2000), device=dev)[:, ::2], live, 10)
