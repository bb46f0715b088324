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
from elasticsearch_tpu_torch.ops.fused import (
    TILE_N,
    _key_bits,
    fused_tile_candidates,
    fused_tile_candidates_reference,
)
from elasticsearch_tpu_torch.ops.kernels import (
    TRANSFORMS,
    impact_gather,
    impact_gather_reference,
    scan_topk,
    scan_topk_reference,
    split_bf16,
    tiered_candidates,
    tiered_candidates_reference,
)


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


@pytest.mark.gpu
@pytest.mark.parametrize("count_positive", [False, True])
def test_tiered_candidates_kernel_matches_twin(count_positive):
    dev = _cuda()
    rng = np.random.default_rng(11)
    B, D, N, kb = 19, 40, 50_001, 64
    q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dev)
    mat = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32)).to(dev)
    if count_positive:
        mat = mat.abs()
    hi, lo = split_bf16(mat)
    hc, lc = split_bf16(mat.cpu())
    assert torch.equal(hi.cpu().view(torch.int16), hc.view(torch.int16))
    assert torch.equal(lo.cpu().view(torch.int16), lc.view(torch.int16))
    live = torch.from_numpy(rng.random(N) > 0.1).to(dev)
    for transform in TRANSFORMS:
        aux_doc = torch.from_numpy(rng.random(N).astype(np.float32)).to(dev)
        aux_q = torch.from_numpy(rng.random(B).astype(np.float32)).to(dev)
        before = kernels.launch_counts["tiered_candidates"]
        got = tiered_candidates(q, hi, lo, live, kb, transform=transform, aux_doc=aux_doc,
                                aux_q=aux_q, count_positive=count_positive)
        assert kernels.launch_counts["tiered_candidates"] == before + 1
        want = tiered_candidates_reference(q, hi, lo, live, kb, transform=transform,
                                           aux_doc=aux_doc, aux_q=aux_q,
                                           count_positive=count_positive)
        torch.cuda.synchronize()
        gv, gi, gt = [x.cpu().numpy() for x in got]
        wv, wi, wt = [x.cpu().numpy() for x in want]
        np.testing.assert_array_equal(gv, wv)
        finite = np.isfinite(wv)
        np.testing.assert_array_equal(gi[finite], wi[finite])
        np.testing.assert_array_equal(gt, wt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint16", "int8"])
def test_impact_gather_kernel_matches_twin(dtype):
    dev = _cuda()
    rng = np.random.default_rng(5)
    nb, Q, R, n_docs = 1000, 37, 13, 90_000
    codes = rng.integers(0, 65536 if dtype == "uint16" else 128, (nb, 128)).astype(dtype)
    docids = rng.integers(0, n_docs, (nb, 128)).astype(np.int32)
    rows = rng.integers(0, nb, (Q, R)).astype(np.int32)
    w = rng.random((Q, R)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (codes, docids, rows, w)]
    before = kernels.launch_counts["impact_gather"]
    got = impact_gather(*args)
    assert kernels.launch_counts["impact_gather"] == before + 1
    want = impact_gather_reference(*args)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.gpu
def test_new_kernels_reject_what_they_do_not_take():
    dev = _cuda()
    q = torch.zeros((2, 8), device=dev)
    hi = torch.zeros((8, 1000), dtype=torch.bfloat16, device=dev)
    live = torch.ones(1000, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        tiered_candidates(q, hi, hi, live, 129)
    with pytest.raises(ValueError, match="mat_lo"):
        tiered_candidates(q, hi, hi.float(), live, 10)
    codes = torch.zeros((4, 128), dtype=torch.int32, device=dev)
    rows = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="uint16 or int8"):
        impact_gather(codes, codes, rows, torch.zeros((2, 3), device=dev))


def _fused_inputs(rng, dev, Qc=37, N=12 * TILE_N + 40, V=40, Td=4):
    """Split-bf16 tier, distinct ascending dense rows with bf16-cut weights
    (some 0), and sorted window entries with duplicate (query, doc) keys;
    tile 1 has only 3 live lanes; the tail tile holds 40 docs."""
    hi, lo = split_bf16(torch.from_numpy(
        (rng.random((V, N)) * (rng.random((V, N)) < 0.2)).astype(np.float32)).to(dev))
    live = rng.random(N) > 0.1
    live[TILE_N: 2 * TILE_N] = False
    live[TILE_N + np.array([5, 900, 4000])] = True
    drows = np.sort(np.stack([rng.choice(V, Td, replace=False) for _ in range(Qc)]), axis=1)
    dwh = rng.uniform(0.5, 8, (Qc, Td)).astype(np.float32)
    dwh[rng.random((Qc, Td)) < 0.3] = 0.0
    dwh = (dwh.view(np.int32) & -65536).view(np.float32)
    n_pad = -(-N // TILE_N) * TILE_N
    _, db, _ = _key_bits(n_pad, 1, Qc)
    q = rng.integers(0, Qc, 20_000)
    doc = rng.integers(0, N, 20_000)
    dup = rng.random(20_000) < 0.3  # second and third entries of a (query, doc)
    q = np.concatenate([q, q[dup], q[dup][::2]])
    doc = np.concatenate([doc, doc[dup], doc[dup][::2]])
    keys = ((q << db) | doc).astype(np.int32)
    order = np.argsort(keys, kind="stable")
    keys = np.concatenate([keys[order], np.full(300, 2**31 - 1, np.int32)])
    vals = rng.uniform(0, 3, keys.shape[0]).astype(np.float32)
    bounds = ((np.arange(Qc)[:, None] << db) | (np.arange(n_pad // TILE_N + 1) * TILE_N)[None, :])
    ptr = np.searchsorted(keys, bounds.reshape(-1)).astype(np.int32).reshape(Qc, -1)
    host = [torch.from_numpy(a).to(dev) for a in (live, drows.astype(np.int32), dwh, keys,
                                                   vals, ptr)]
    return (hi, lo, *host), db


@pytest.mark.gpu
@pytest.mark.parametrize("t", [7, 65])
def test_fused_tile_candidates_kernel_matches_twin(t):
    dev = _cuda()
    args, db = _fused_inputs(np.random.default_rng(13), dev)
    before = kernels.launch_counts["fused_tile_candidates"]
    got = fused_tile_candidates(*args, t=t, db=db)
    assert kernels.launch_counts["fused_tile_candidates"] == before + 1
    want = fused_tile_candidates_reference(*args, t=t, db=db)
    torch.cuda.synchronize()
    gv, gi, gt, gl = [x.cpu().numpy() for x in got]
    wv, wi, wt, wl = [x.cpu().numpy() for x in want]
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gt, wt)
    assert not gl.any() and not wl.any()
    tiles = gv.reshape(gv.shape[0], -1, t)
    assert np.isfinite(tiles[:, 1]).sum(1).max() <= 3  # the nearly dead tile
    # slots past the last doc: (-inf, -1) once t exceeds the tail's 40 lanes
    assert (gi.reshape(tiles.shape)[:, -1] == -1).any() == (t > 40)


@pytest.mark.gpu
def test_fused_tile_candidates_rejects_what_it_does_not_take():
    dev = _cuda()
    (hi, lo, live, drows, dwh, keys, vals, ptr), db = _fused_inputs(
        np.random.default_rng(3), dev, Qc=4, N=9000, V=8)
    with pytest.raises(ValueError, match="drows has dtype"):
        fused_tile_candidates(hi, lo, live, drows.long(), dwh, keys, vals, ptr, t=7, db=db)
    with pytest.raises(ValueError, match="ptr has shape"):
        fused_tile_candidates(hi, lo, live, drows, dwh, keys, vals, ptr[:, :-1], t=7, db=db)
    with pytest.raises(ValueError, match="keys is on cpu"):
        fused_tile_candidates(hi, lo, live, drows, dwh, keys.cpu(), vals, ptr, t=7, db=db)
    with pytest.raises(ValueError, match="out of range"):
        fused_tile_candidates(hi, lo, live, drows, dwh, keys, vals, ptr, t=0, db=db)
