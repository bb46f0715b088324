"""The CUDA kernels against their PyTorch twins, on a card.

Every test here needs a CUDA card and the CUDA toolkit; without a card each
skips. The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: the suite's conftest.py configures JAX). Tolerance: the
kernel and its twin run the same f32 operations in the same order, so
values are equal, ids equal wherever the score is finite, totals equal.
The one exception is tiered_candidates, whose tensor-core product adds in
its own order: it is held to `check_tiered_selection` (the f32 summation
bound of its 2D terms, doubled for the tensor cores' truncation).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ann.kernels import (
    _ann_gather_scan_cuda,
    _prepare,
    ann_gather_scan,
    ann_gather_scan_reference,
)
from elasticsearch_tpu_torch.ops import kernels
from elasticsearch_tpu_torch.ops.fused import (
    TILE_N,
    _fused_tile_candidates_cuda,
    _key_bits,
    fused_route,
    fused_tile_candidates,
    fused_tile_candidates_reference,
)
from elasticsearch_tpu_torch.ops.kernels import (
    TRANSFORMS,
    check_tiered_selection,
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


def _edge_rows(rng, B, N, ties):
    """Streamed scores [B, N] for the selection's edge cases: row 0 has 5
    positive lanes (fewer than k finite under count_positive), row 1 none
    (all -inf under count_positive), row 2 equal scores on both sides of
    every 2,048-lane boundary (spans are multiples of it), the rest random."""
    s = np.round(rng.normal(size=(B, N)), 2).astype(np.float32)
    s[0] = -np.abs(s[0])
    s[0, rng.choice(N, 5, replace=False)] = 0.5
    s[1] = -np.abs(s[1])
    s[2] = rng.uniform(0, 0.9, N)
    s[2, ties[ties < N]] = 1.0
    return s


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 128])
@pytest.mark.parametrize("count_positive", [False, True])
@pytest.mark.parametrize("mode", ["streamed", "matmul"])
def test_scan_topk_kernel_selection_edges(mode, count_positive, k):
    """Rows with fewer than k finite lanes, all -inf rows, ties across span
    boundaries and N ragged past one: still equal to the twin."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    if mode == "streamed":
        B, N = 5, 300_007
        b = np.arange(2048, N, 2048)
        q = None
        mat = torch.from_numpy(_edge_rows(rng, B, N, np.concatenate([b - 1, b]))).to(dev)
    else:
        # row 0 all zero: every dot 0 (all -inf under count_positive, ties
        # otherwise); columns repeated across every 4,096-doc chunk boundary
        B, D, N = 9, 16, 37 * 4096 + 5
        qn = rng.normal(size=(B, D)).astype(np.float32)
        qn[0] = 0.0
        m = rng.normal(size=(D, N)).astype(np.float32)
        b = np.arange(4096, N, 4096)
        m[:, b] = m[:, b - 1]
        q, mat = torch.from_numpy(qn).to(dev), torch.from_numpy(m).to(dev)
    live = torch.from_numpy(rng.random(N) > 0.1).to(dev)
    got = scan_topk(q, mat, live, k, count_positive=count_positive)
    want = scan_topk_reference(q, mat, live, k, aux_doc=torch.zeros(N, device=dev),
                               aux_q=torch.zeros(B, device=dev), count_positive=count_positive)
    torch.cuda.synchronize()
    gv, gi, gt = [x.cpu().numpy() for x in got]
    wv, wi, wt = [x.cpu().numpy() for x in want]
    np.testing.assert_array_equal(gv, wv)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(gi[finite], wi[finite])
    np.testing.assert_array_equal(gt, wt)
    if count_positive:  # the all -inf row, and the short row
        assert not finite[1 if mode == "streamed" else 0].any()
        assert mode == "matmul" or 0 < finite[0].sum() <= 5


# (B, D, N, k) of the matmul route: row tiles of 64 (B = 1, 63, 64, 65,
# 130), depth steps of 32 (D = 100 ragged), doc tiles of 256 (N ragged; N
# odd takes the scalar mat_t path), k at 1, 10 and the largest
MATMUL_SHAPES = {"b1": (1, 384, 100_003, 10), "b63_k128": (63, 100, 65_536, 128),
                 "b64_d896_k1": (64, 896, 50_000, 1), "b65": (65, 384, 70_001, 10),
                 "b130_k128": (130, 100, 160 * 256 + 17, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(MATMUL_SHAPES))
def test_scan_topk_matmul_route_matches_twin(shape):
    """The matmul route (64-row tiles, fma in d order, fused selection)
    equal to its twin on every transform, count_positive on and off, with
    dead lanes and with columns repeated across every doc-tile boundary
    (ties at the selection's edges)."""
    dev = _cuda()
    B, D, N, k = MATMUL_SHAPES[shape]
    rng = np.random.default_rng(11)
    qn = rng.normal(size=(B, D)).astype(np.float32)
    m = rng.normal(size=(D, N)).astype(np.float32)
    b = np.arange(256, N, 256)
    m[:, b] = m[:, b - 1]
    q, mat = torch.from_numpy(qn).to(dev), torch.from_numpy(m).to(dev)
    live = torch.from_numpy(rng.random(N) > 0.1).to(dev)
    sq, qsq = (mat * mat).sum(0), (q * q).sum(1)
    aux = {"cosine": (1.0 / torch.sqrt(sq), 1.0 / torch.sqrt(qsq)), "l2_norm": (sq, qsq)}
    for transform in TRANSFORMS:
        aux_doc, aux_q = aux.get(transform, (torch.zeros(N, device=dev),
                                             torch.zeros(B, device=dev)))
        for cp in (False, True):
            before = kernels.launch_counts["scan_topk"]
            got = scan_topk(q, mat, live, k, transform=transform, aux_doc=aux_doc,
                            aux_q=aux_q, count_positive=cp)
            assert kernels.launch_counts["scan_topk"] == before + 1
            want = scan_topk_reference(q, mat, live, k, transform=transform,
                                       aux_doc=aux_doc, aux_q=aux_q, count_positive=cp)
            torch.cuda.synchronize()
            gv, gi, gt = [x.cpu().numpy() for x in got]
            wv, wi, wt = [x.cpu().numpy() for x in want]
            np.testing.assert_array_equal(gv, wv, err_msg=f"{transform} {cp}")
            finite = np.isfinite(wv)
            np.testing.assert_array_equal(gi[finite], wi[finite], err_msg=f"{transform} {cp}")
            np.testing.assert_array_equal(gt, wt, err_msg=f"{transform} {cp}")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["streamed", "matmul"])
def test_scan_topk_empty_tier_launches_nothing(mode):
    """Zero docs (an empty tier) or zero rows: the route is chosen by shape
    before any launch; no hits, totals 0, nothing raised."""
    dev = _cuda()
    live = torch.zeros(0, dtype=torch.bool, device=dev)
    before = kernels.launch_counts["scan_topk"]
    for B in (3, 0):
        if mode == "streamed":
            q, mat = None, torch.zeros((B, 0), device=dev)
        else:
            q, mat = torch.zeros((B, 384), device=dev), torch.zeros((384, 0), device=dev)
        v, i, t = scan_topk(q, mat, live, 10, transform="cosine")
        assert v.shape == (B, 0) and i.shape == (B, 0) and v.device.type == "cuda"
        assert t.tolist() == [0] * B
    if mode == "matmul":  # zero rows over docs
        v, i, t = scan_topk(torch.zeros((0, 8), device=dev), torch.ones((8, 100), device=dev),
                            torch.ones(100, dtype=torch.bool, device=dev), 10)
        assert v.shape == (0, 0) and t.shape == (0,)
    assert kernels.launch_counts["scan_topk"] == before


# (B, D, N, kb): N odd takes the scalar B-operand path; kb=128 the 2-stage ring
TIERED_SHAPES = {"base": (19, 40, 50_001, 64), "b37_ragged_d": (37, 100, 100_000, 64),
                 "ragged_n": (130, 64, 100_003, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(TIERED_SHAPES))
@pytest.mark.parametrize("count_positive", [False, True])
def test_tiered_candidates_kernel_matches_twin(count_positive, shape):
    dev = _cuda()
    rng = np.random.default_rng(11)
    B, D, N, kb = TIERED_SHAPES[shape]
    q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dev)
    mat = torch.from_numpy(rng.normal(size=(D, N)).astype(np.float32)).to(dev)
    if count_positive:
        # BM25 semantics: every product >= 0, so the sign of a sum, and the
        # positive count, does not depend on the summation order
        q, mat = q.abs(), mat.abs()
    hi, lo = split_bf16(mat)
    hc, lc = split_bf16(mat.cpu())
    assert torch.equal(hi.cpu().view(torch.int16), hc.view(torch.int16))
    assert torch.equal(lo.cpu().view(torch.int16), lc.view(torch.int16))
    live = torch.from_numpy(rng.random(N) > 0.1).to(dev)
    for transform in TRANSFORMS:
        aux_doc = torch.from_numpy(rng.random(N).astype(np.float32)).to(dev)
        aux_q = torch.from_numpy(rng.random(B).astype(np.float32)).to(dev)
        kw = {"transform": transform, "aux_doc": aux_doc, "aux_q": aux_q,
              "count_positive": count_positive}
        before = kernels.launch_counts["tiered_candidates"]
        got = tiered_candidates(q, hi, lo, live, kb, **kw)
        assert kernels.launch_counts["tiered_candidates"] == before + 1
        want = tiered_candidates_reference(q, hi, lo, live, kb, **kw)
        torch.cuda.synchronize()
        assert check_tiered_selection(got, want, q, hi, lo, live, **kw)[0] <= 1.0


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
@pytest.mark.parametrize("t", [1, 5, 7, 16, 65, 128, 129, 200])
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


def _fused_edge_inputs(rng, dev, Qc=45, N=9 * TILE_N + 1000, V=12, Td=4):
    """The selection's edge rows and tiles: rows 0-4 without a dense weight,
    rows 5-9 without a window entry, rows 10-14 with neither; tile 2 all
    dead; tile 4 with 3 live docs (fewer positive lanes than t); the tail
    tile of 1,000 docs; duplicate (query, doc) entries; and scores tied
    across docids (tier values and window values from a few levels)."""
    lv = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    tier = lv[rng.integers(0, 4, (V, N))] * (rng.random((V, N)) < 0.3)
    hi, lo = split_bf16(torch.from_numpy(tier.astype(np.float32)).to(dev))
    live = rng.random(N) > 0.1
    live[2 * TILE_N: 3 * TILE_N] = False
    live[4 * TILE_N: 5 * TILE_N] = False
    live[4 * TILE_N + np.array([7, 8, 3000])] = True
    drows = np.sort(np.stack([rng.choice(V, Td, replace=False) for _ in range(Qc)]), axis=1)
    dwh = np.array([1.0, 2.0, 0.5], np.float32)[rng.integers(0, 3, (Qc, Td))]
    dwh[rng.random((Qc, Td)) < 0.25] = 0.0
    dwh[0:5] = 0.0
    dwh[10:15] = 0.0
    n_pad = -(-N // TILE_N) * TILE_N
    _, db, _ = _key_bits(n_pad, 1, Qc)
    q = rng.integers(0, Qc, 30_000)
    q = q[(q < 5) | (q >= 15)]
    doc = rng.integers(0, N, q.shape[0])
    dup = rng.random(q.shape[0]) < 0.3
    q = np.concatenate([q, q[dup]])
    doc = np.concatenate([doc, doc[dup]])
    keys = ((q << db) | doc).astype(np.int32)
    keys = np.concatenate([np.sort(keys, kind="stable"), np.full(100, 2**31 - 1, np.int32)])
    vals = np.array([0.5, 1.0, 1.5], np.float32)[rng.integers(0, 3, keys.shape[0])]
    bounds = ((np.arange(Qc)[:, None] << db) | (np.arange(n_pad // TILE_N + 1) * TILE_N)[None, :])
    ptr = np.searchsorted(keys, bounds.reshape(-1)).astype(np.int32).reshape(Qc, -1)
    host = [torch.from_numpy(a).to(dev) for a in (live, drows.astype(np.int32), dwh, keys,
                                                   vals, ptr)]
    return (hi, lo, *host), db


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 5, 7, 16, 65])
@pytest.mark.parametrize("route", ["select", "sort"])
def test_fused_tile_candidates_edge_rows_match_twin(route, t):
    """Both routes == the twin on rows without weights or windows, dead and
    nearly dead tiles, the tail tile, duplicate entries and tied scores."""
    dev = _cuda()
    args, db = _fused_edge_inputs(np.random.default_rng(23), dev)
    got = _fused_tile_candidates_cuda(*args, t, db, route=route)
    want = fused_tile_candidates_reference(*args, t=t, db=db)
    torch.cuda.synchronize()
    gv, gi, gt, _ = [x.cpu().numpy() for x in got]
    wv, wi, wt, _ = [x.cpu().numpy() for x in want]
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gt, wt)
    tiles = gv.reshape(gv.shape[0], -1, t)
    assert not np.isfinite(tiles[10:15]).any() and (gt[10:15] == 0).all()
    assert not np.isfinite(tiles[:, 2]).any()  # the dead tile
    assert np.isfinite(tiles[:, 4]).sum(1).max() <= 3
    assert fused_route(t) == "select"


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


def _ann_inputs(rng, dev, C, L, D, B, P):
    """Random tiles with pad slots, dead docs and exactly tied slots (slots
    5-8 repeat slots 1-4 of every tile under other docids)."""
    vals = rng.normal(size=(C, L, D)).astype(np.float32)
    codes = rng.integers(-127, 128, (C, L, D)).astype(np.int8)
    scale = (rng.random((C, L)) * 0.05).astype(np.float32)
    offset = (rng.normal(size=(C, L)) * 0.1).astype(np.float32)
    for a in (vals, codes, scale, offset):
        a[:, 5:9] = a[:, 1:5]
    order = rng.permutation(C * L).astype(np.int32).reshape(C, L)
    order[np.arange(L)[None, :] >= rng.integers(L - L // 4, L + 1, (C, 1))] = -1
    hi, lo = split_bf16(torch.from_numpy(vals).to(dev))
    ann = {"order": torch.from_numpy(order).to(dev), "codes": torch.from_numpy(codes).to(dev),
           "scale": torch.from_numpy(scale).to(dev), "offset": torch.from_numpy(offset).to(dev),
           "hi": hi, "lo": lo, "sq": torch.from_numpy((vals * vals).sum(-1)).to(dev)}
    live = torch.from_numpy((rng.random((C, L)) > 0.1).astype(np.uint8)).to(dev)
    q = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dev)
    probes = torch.from_numpy(np.stack([rng.permutation(C)[:P] for _ in range(B)])
                              .astype(np.int32)).to(dev)
    return q, probes, ann, live


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["int8", "bf16"])
@pytest.mark.parametrize("shape", ["batch", "search", "long_tile"])
def test_ann_gather_scan_kernel_matches_twin(tier, shape):
    dev = _cuda()
    C, L, D, B, P = {"batch": (40, 640, 96, 64, 3), "search": (30, 512, 384, 1, 2),
                     "long_tile": (5, 4096 + 384, 48, 6, 3)}[shape]
    q, probes, ann, live = _ann_inputs(np.random.default_rng(17), dev, C, L, D, B, P)
    for transform in TRANSFORMS:
        for kb in (1, 100, 128):
            before = kernels.launch_counts["ann_gather_scan"]
            got = ann_gather_scan(q, probes, ann, live, kb, tier=tier, similarity=transform)
            assert kernels.launch_counts["ann_gather_scan"] == before + 1
            want = ann_gather_scan_reference(q, probes, ann, live, kb, tier=tier,
                                             similarity=transform)
            torch.cuda.synchronize()
            gv, gi, gt = [x.cpu().numpy() for x in got]
            wv, wi, wt = [x.cpu().numpy() for x in want]
            np.testing.assert_array_equal(gv, wv)
            finite = np.isfinite(wv)
            np.testing.assert_array_equal(gi[finite], wi[finite])
            np.testing.assert_array_equal(gt, wt)


def _grouped_probes(rng, case, C, B, P):
    """Probes for the tile-major grouping's edge cases."""
    if case == "one_tile":  # every query probes tile 3 first: the largest group
        rest = [rng.permutation(np.delete(np.arange(C), 3))[: P - 1] for _ in range(B)]
        return np.stack([np.concatenate([[3], r]) for r in rest]).astype(np.int32)
    return np.stack([rng.permutation(C)[:P] for _ in range(B)]).astype(np.int32)


# (C, L, D, B, P): B=1; B not a multiple of the 32-pair group; L > 4,096 and
# not a multiple of the 128-slot chunk; D not a multiple of 16 (the staged
# rows' plain path)
GROUPED = {"one_tile": (8, 300, 64, 77, 2), "b1": (9, 1792, 384, 1, 2),
           "ragged_b": (3, 256, 32, 45, 3), "long_ragged_tile": (4, 4096 + 200, 48, 5, 2),
           "ragged_d": (5, 200, 38, 33, 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["int8", "bf16"])
@pytest.mark.parametrize("case", list(GROUPED) + ["dead_tile"])
def test_ann_gather_scan_grouping_edges_match_twin(case, tier):
    """The tile-major kernel == its twin where its grouping is stressed,
    for kb in {1, 100, 128} and every transform; `dead_tile`: a probed
    tile with no live slot."""
    dev = _cuda()
    rng = np.random.default_rng(29)
    C, L, D, B, P = GROUPED.get(case, (6, 640, 32, 40, 2))
    q, probes, ann, live = _ann_inputs(rng, dev, C, L, D, B, P)
    probes = torch.from_numpy(_grouped_probes(rng, case, C, B, P)).to(dev)
    if case == "dead_tile":
        live[int(probes[0, 0])] = 0
    for transform in TRANSFORMS:
        for kb in (1, 100, 128):
            before = kernels.launch_counts["ann_gather_scan"]
            got = ann_gather_scan(q, probes, ann, live, kb, tier=tier, similarity=transform)
            assert kernels.launch_counts["ann_gather_scan"] == before + 1
            want = ann_gather_scan_reference(q, probes, ann, live, kb, tier=tier,
                                             similarity=transform)
            torch.cuda.synchronize()
            gv, gi, gt = [x.cpu().numpy() for x in got]
            wv, wi, wt = [x.cpu().numpy() for x in want]
            np.testing.assert_array_equal(gv, wv, err_msg=f"{case} {transform} kb={kb}")
            finite = np.isfinite(wv)
            np.testing.assert_array_equal(gi[finite], wi[finite])
            np.testing.assert_array_equal(gt, wt)


@pytest.mark.gpu
def test_ann_gather_scan_rejects_what_it_does_not_take():
    dev = _cuda()
    q, probes, ann, live = _ann_inputs(np.random.default_rng(2), dev, 6, 256, 16, 4, 2)
    with pytest.raises(ValueError, match="live_slots has dtype"):
        ann_gather_scan(q, probes, ann, live.bool(), 10)
    with pytest.raises(ValueError, match="probes has dtype"):
        ann_gather_scan(q, probes.long(), ann, live, 10)
    with pytest.raises(ValueError, match="codes has dtype"):
        ann_gather_scan(q, probes, {**ann, "codes": ann["codes"].to(torch.int16)}, live, 10)
    with pytest.raises(ValueError, match="is on cpu"):
        ann_gather_scan(q, probes.cpu(), ann, live, 10)
    # the public route sends kb > 128 to the composition; the kernel's own
    # wrapper refuses it
    q_in, auxd, auxq = _prepare(q, ann, "int8", "cosine")
    with pytest.raises(ValueError, match="exceeds"):
        _ann_gather_scan_cuda(q_in, probes, ann, live, auxd, auxq, 129, "int8", "cosine")


def _same_rows(a, b, what):
    """(scores, shards, ids, totals) rows of the card and the host: totals
    equal, finite lanes alike, scores within 1e-6 relative, (shard, id)
    equal up to fp-ties (1e-5 relative)."""
    av, ash, ai, at = (np.asarray(x) for x in a)
    bv, bsh, bi, bt = (np.asarray(x) for x in b)
    assert np.array_equal(at, bt), what
    fin = np.isfinite(bv)
    assert np.array_equal(np.isfinite(av), fin), what
    np.testing.assert_allclose(av[fin], bv[fin], rtol=1e-6, atol=0, err_msg=what)
    swapped = fin & ((ash != bsh) | (ai != bi))
    assert (np.abs(av[swapped] - bv[swapped]) <= 1e-5 * np.maximum(np.abs(bv[swapped]), 1.0)).all()


@pytest.mark.gpu
def test_sharded_search_and_msearch_on_card_match_cpu():
    """A 3-shard stacked pack on the card against the same pack on the host:
    the derived dense tier and impact codes byte-equal; `_search` with one
    scan_topk launch per request; `_msearch` at k=10 (the fused arm, one
    fused_tile_candidates launch per shard and chunk) and k=25 (the impact
    arm, one impact_gather launch per shard and chunk)."""
    dev = _cuda()
    from elasticsearch_tpu_torch.corpus import (
        MAPPINGS, corpus_docs, make_corpus, sample_queries, traffic)
    from elasticsearch_tpu_torch.index.mappings import Mappings
    from elasticsearch_tpu_torch.parallel import StackedSearcher, build_stacked_pack, msearch_sharded

    rng = np.random.default_rng(17)
    lens, tok, nums = make_corpus(rng, 13000, vocab=400, mean_len=12)
    docs = [(str(i), d) for i, d in enumerate(corpus_docs(lens, tok, nums, vocab=400))]
    sp = build_stacked_pack(docs, Mappings(MAPPINGS), 3, dense_min_df=64)
    card, cpu = StackedSearcher(sp, device=dev), StackedSearcher(sp, device="cpu")
    assert sp.n_max >= 4096 and sp.dense_v > 0
    assert torch.equal(card.dev["dense_tfn"].cpu(), cpu.dev["dense_tfn"])
    assert torch.equal(card.dev["impact_codes"].view(torch.int16).cpu(),
                       cpu.dev["impact_codes"].view(torch.int16))
    for q in traffic(rng, lens, tok, 10, 5, 5):
        for size, from_ in ((10, 0), (20, 5)):
            before = kernels.launch_counts["scan_topk"]
            a = card.search(q, size=size, from_=from_)
            assert kernels.launch_counts["scan_topk"] == before + 1
            b = cpu.search(q, size=size, from_=from_)
            _same_rows((a.scores, a.doc_shards, a.doc_ids, [a.total]),
                       (b.scores, b.doc_shards, b.doc_ids, [b.total]), str(q))
    qs = sample_queries(rng, lens, tok, 600)
    for k, name, launches in ((10, "fused_tile_candidates", 3 * 2), (25, "impact_gather", 3)):
        before = kernels.launch_counts[name]
        a = msearch_sharded(card, "body", qs, k)
        assert kernels.launch_counts[name] - before == launches, name
        assert card.last_stats["queries"] == {"fused" if k == 10 else "impact": len(qs)}
        _same_rows(a, msearch_sharded(cpu, "body", qs, k), f"msearch k={k}")


@pytest.mark.gpu
def test_rest_search_and_coalesced_msearch_on_card_match_cpu():
    """The REST app on the card against the same requests on the host:
    `_search` (one scan_topk launch each) and an `_msearch` of 64 term
    disjunctions with serving on at k=10 (fused_tile_candidates) and k=25
    (impact_gather): statuses and totals equal, scores within 1e-6
    relative, ids up to fp-ties."""
    dev = _cuda()
    import json

    from elasticsearch_tpu_torch.corpus import (
        MAPPINGS, corpus_docs, make_corpus, sample_queries, traffic)
    from elasticsearch_tpu_torch.rest import make_app

    rng = np.random.default_rng(19)
    lens, tok, nums = make_corpus(rng, 6000, vocab=400, mean_len=12)
    lines = []
    for i, d in enumerate(corpus_docs(lens, tok, nums, vocab=400)):
        lines += [json.dumps({"index": {"_id": str(i)}}), json.dumps(d)]
    bulk = ("\n".join(lines) + "\n").encode()
    apps = [make_app(device=dev), make_app(device="cpu")]
    try:
        for app in apps:
            assert app.handle("PUT", "/c", {}, {}, json.dumps({"mappings": MAPPINGS}).encode())[0] == 200
            assert app.handle("POST", "/c/_bulk", {"refresh": "true"}, {}, bulk)[0] == 200

        def both(method, path, body):
            return [json.loads(app.handle(method, path, {}, {}, body)[2]) for app in apps]

        def same(a, b, what):
            assert a["hits"]["total"] == b["hits"]["total"], what
            ah, bh = a["hits"]["hits"], b["hits"]["hits"]
            assert len(ah) == len(bh), what
            for x, y in zip(ah, bh):
                assert abs(x["_score"] - y["_score"]) <= 1e-6 * abs(y["_score"]), what
                assert x["_id"] == y["_id"] or abs(x["_score"] - y["_score"]) <= 1e-5 * abs(
                    y["_score"]), what

        for q in traffic(rng, lens, tok, 6, 3, 3):
            before = kernels.launch_counts["scan_topk"]
            a, b = both("POST", "/c/_search", json.dumps({"query": q, "size": 10}).encode())
            assert kernels.launch_counts["scan_topk"] == before + 1
            same(a, b, str(q))
        for app in apps:
            app.handle("PUT", "/_cluster/settings", {}, {},
                       b'{"transient": {"serving.enabled": true}}')
        qs = sample_queries(rng, lens, tok, 64)
        for size, name in ((10, "fused_tile_candidates"), (25, "impact_gather")):
            body = "".join(json.dumps({"index": "c"}) + "\n" + json.dumps(
                {"query": {"match": {"body": " ".join(t for t, _ in q)}}, "size": size}) + "\n"
                for q in qs).encode()
            before = kernels.launch_counts[name]
            a, b = both("POST", "/_msearch", body)
            assert kernels.launch_counts[name] > before, name
            for j, (x, y) in enumerate(zip(a["responses"], b["responses"])):
                assert x["status"] == y["status"] == 200
                same(x, y, f"msearch size={size} [{j}]")
    finally:
        for app in apps:
            app.close()


@pytest.mark.gpu
def test_tiered_index_on_card_matches_cpu():
    """A one-shard index with updates, deletes and three tail segments on
    the card against the same writes on the host: the base's re-derived
    dense tier and impact codes byte-equal; each tiered `_search` one
    scan_topk launch per tier, totals equal, scores within 1e-6 relative,
    ids up to fp-ties; `count` equal to the tiered total."""
    dev = _cuda()
    from elasticsearch_tpu_torch import EsIndex
    from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, make_corpus, traffic

    rng = np.random.default_rng(23)
    lens, tok, nums = make_corpus(rng, 9000, vocab=400, mean_len=12)
    docs = corpus_docs(lens, tok, nums, vocab=400)
    card, cpu = EsIndex("t", MAPPINGS, device=dev), EsIndex("t", MAPPINGS, device="cpu")
    for idx in (card, cpu):
        for i, d in enumerate(docs[:8000]):
            idx.index_doc(str(i), d)
        idx.refresh()
        for r in range(3):
            for j in range(8000 + 100 * r, 8100 + 100 * r):
                idx.index_doc(str(j), docs[j])
            for j in range(r, 300, 7):
                idx.index_doc(str(j), docs[8900 - j])
            for j in range(1000 + r, 1400, 11):
                idx.delete_doc(str(j))
            idx.refresh()
        assert idx.last_refresh_kind == "incremental" and len(idx._tails) == 3
    assert torch.equal(card._searcher.dev["dense_tfn"].cpu(), cpu._searcher.dev["dense_tfn"])
    assert torch.equal(card._searcher.dev["impact_codes"].view(torch.int16).cpu(),
                       cpu._searcher.dev["impact_codes"].view(torch.int16))
    for q in traffic(rng, lens, tok, 10, 5, 5):
        for size, from_ in ((10, 0), (20, 5)):
            before = kernels.launch_counts["scan_topk"]
            a = card.search(q, size=size, from_=from_)["hits"]
            assert kernels.launch_counts["scan_topk"] == before + 4
            b = cpu.search(q, size=size, from_=from_)["hits"]
            assert a["total"] == b["total"] and len(a["hits"]) == len(b["hits"]), q
            for x, y in zip(a["hits"], b["hits"]):
                assert abs(x["_score"] - y["_score"]) <= 1e-6 * abs(y["_score"]), q
                assert x["_id"] == y["_id"] or abs(x["_score"] - y["_score"]) <= 1e-5 * abs(
                    y["_score"]), q
        assert card.count(q) == cpu.count(q)


def _cpu_twin_index(idx):
    """The index's tiers searched with device="cpu" on the same packs (the
    base under its statistics override, each segment as it is), behind the
    same EsIndex logic: kNN searches on both run the same algorithm."""
    import copy
    import dataclasses

    from elasticsearch_tpu_torch.parallel.sharded import StackedSearcher
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    cpu = copy.copy(idx)
    cpu.device = torch.device("cpu")
    if isinstance(idx._searcher, StackedSearcher):
        cpu._searcher = StackedSearcher(idx._searcher.sp, device="cpu")
    else:
        cpu._searcher = ShardSearcher(idx._searcher.pack, device="cpu", mappings=idx.mappings)
        cpu._searcher.set_stats_override(idx._searcher.stats_override)
    cpu._tails = [dataclasses.replace(seg, searcher=StackedSearcher(seg.searcher.sp,
                                                                    device="cpu"))
                  for seg in idx._tails]
    return cpu


def _knn_rows_match(a, b, what):
    a, b = a["hits"], b["hits"]
    assert a["total"] == b["total"] and len(a["hits"]) == len(b["hits"]), what
    for x, y in zip(a["hits"], b["hits"]):
        assert abs(x["_score"] - y["_score"]) <= 1e-6 * abs(y["_score"]), what
        assert x["_id"] == y["_id"] or abs(x["_score"] - y["_score"]) <= 1e-5 * abs(
            y["_score"]), what


def _vector_docs(rng, n, dims=32, ncl=12):
    centers = rng.normal(size=(ncl, dims)).astype(np.float32) * 4.0
    vecs = centers[rng.integers(0, ncl, n)] + rng.normal(size=(n, dims)).astype(np.float32)
    return vecs, [{"vec": [float(x) for x in v], "n": i, "body": f"w{i % 13} w{i % 7}"}
                  for i, v in enumerate(vecs)]


_VEC_MAPPING = {"properties": {
    "vec": {"type": "dense_vector", "dims": 32, "similarity": "cosine",
            "index_options": {"type": "int8_hnsw"}},
    "n": {"type": "long"}, "body": {"type": "text"}}}


@pytest.mark.gpu
def test_sharded_knn_on_card_matches_cpu():
    """A 4-shard kNN index on the card: each unfiltered kNN `_search` one
    ann_gather_scan launch per shard; answers (and hybrid answers) equal
    the same stacked pack searched with device="cpu": totals equal, scores
    within 1e-6 relative, ids up to fp-ties."""
    dev = _cuda()
    from elasticsearch_tpu_torch import EsIndex

    rng = np.random.default_rng(31)
    vecs, docs = _vector_docs(rng, 4800)
    card = EsIndex("k", _VEC_MAPPING, settings={"number_of_shards": 4}, device=dev)
    for i, d in enumerate(docs):
        card.index_doc(f"d{i}", d)
    card.refresh()
    assert card.searcher.sp.vectors["vec"].ann is not None
    cpu = _cpu_twin_index(card)
    for j in range(24):
        body = {"field": "vec", "query_vector": [float(x) for x in vecs[j * 97] + 0.1],
                "k": 10, "num_candidates": 50}
        before = kernels.launch_counts["ann_gather_scan"]
        got = card.search(knn=body)
        assert kernels.launch_counts["ann_gather_scan"] == before + 4
        _knn_rows_match(got, cpu.search(knn=body), j)
        q = {"match": {"body": f"w{j % 13}"}}
        _knn_rows_match(card.search(q, knn=body, size=20), cpu.search(q, knn=body, size=20),
                        ("hybrid", j))


@pytest.mark.gpu
def test_tiered_knn_on_card_matches_cpu():
    """A one-shard kNN index with updates, deletes and new docs in three
    tail segments (each with its own small IVF index) on the card: one
    ann_gather_scan launch per tier per kNN `_search`, the tiers not
    merged, answers equal the same tiers searched with device="cpu"."""
    dev = _cuda()
    from elasticsearch_tpu_torch import EsIndex

    rng = np.random.default_rng(37)
    vecs, docs = _vector_docs(rng, 5000)
    card = EsIndex("k", _VEC_MAPPING, device=dev)
    for i, d in enumerate(docs[:4000]):
        card.index_doc(f"d{i}", d)
    card.refresh()
    for r in range(3):
        for j in range(4000 + 300 * r, 4000 + 300 * r + 60):
            card.index_doc(f"d{j - 4000}", docs[j])  # updates with new vectors
            card.index_doc(f"n{j}", docs[j + 150])
        for j in range(r, 200, 9):
            card.delete_doc(f"d{j + 1000}")
        card.refresh()
    assert card.last_refresh_kind == "incremental" and len(card._tails) == 3
    assert all(seg.searcher.sp.vectors["vec"].ann is not None for seg in card._tails)
    tails = list(card._tails)
    cpu = _cpu_twin_index(card)
    for j in range(24):
        body = {"field": "vec", "query_vector": [float(x) for x in vecs[j * 199] + 0.1],
                "k": 10, "num_candidates": 50}
        before = kernels.launch_counts["ann_gather_scan"]
        got = card.search(knn=body, size=5, from_=j % 3)
        assert kernels.launch_counts["ann_gather_scan"] == before + 4
        _knn_rows_match(got, cpu.search(knn=body, size=5, from_=j % 3), j)
    assert card._tails == tails


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sync", "host_copy", "device_window"])
def test_time_kernel_window_covers_the_card_work(mode):
    """A timing window on a CUDA tensor covers the card's work: around a
    spin kernel of known length, a time_kernel window closed by its own
    synchronization or by a device-to-host copy, and a device_window read
    after a later copy, are no shorter than the spin's CUDA-event time."""
    from elasticsearch_tpu_torch.telemetry import (collect_profile_events, device_window,
                                                   time_kernel)

    dev = _cuda()
    x = torch.ones(4, device=dev)
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fields = {"queries": 1, "k": 1, "num_docs": 4}
    with collect_profile_events() as events:
        if mode == "device_window":
            window = device_window("batched.disjunction", dev, **fields)
            with window:
                start.record()
                torch.cuda._sleep(50_000_000)
                end.record()
            (x + 1).cpu()
            window.close()
        else:
            with time_kernel("batched.disjunction", dev, sync=mode == "sync", **fields):
                start.record()
                torch.cuda._sleep(50_000_000)
                end.record()
                y = x + 1
                if mode == "host_copy":
                    y = y.cpu()
    torch.cuda.synchronize(dev)
    spin_ms = start.elapsed_time(end)
    assert spin_ms > 1.0
    assert events[0]["kernel"] == "batched.disjunction" and events[0]["ms"] >= spin_ms


@pytest.mark.gpu
def test_bf16_product_has_f32_output():
    """The fast arm's bf16 dense product: bf16 operands, f32 output, within
    the f32 summation bound of the exact products."""
    from elasticsearch_tpu_torch.ops.batched import bf16_product

    dev = _cuda()
    rng = np.random.default_rng(12)
    W = torch.from_numpy(rng.uniform(0, 3, (64, 896)).astype(np.float32)).to(dev)
    tier = torch.from_numpy(rng.uniform(0, 1, (896, 50_000)).astype(np.float32)).to(dev)
    dense_bf16 = tier.to(torch.bfloat16)
    out = bf16_product(W, dense_bf16)
    assert out.dtype == torch.float32 and out.shape == (64, 50_000)
    exact = W.to(torch.bfloat16).double() @ dense_bf16.double()
    bound = 896 * 2.0**-23 * exact.abs()
    assert ((out.double() - exact).abs() <= bound).all()
    # not rounded to bf16: the output carries more than bf16's 8 bits
    assert (out != out.to(torch.bfloat16).float()).any()


# ---- aggregations: the segmented reductions and whole requests on the card --


@pytest.mark.gpu
@pytest.mark.parametrize("nseg", [1, 151, 5000])
def test_agg_segment_sums_on_card_equal_cpu(nseg):
    """The float segment sum (f64, no float atomics), counts and min/max on
    the card `==` the same call on the CPU."""
    from elasticsearch_tpu_torch.aggs.nodes import _seg_scatter

    dev = _cuda()
    rng = np.random.default_rng(3)
    n = 1 << 20
    seg = torch.from_numpy(rng.integers(0, nseg, n))
    valid = torch.from_numpy(rng.random(n) < 0.7)
    vals = torch.from_numpy((rng.random(n) * 1e5).astype(np.float32))
    for values, init, op in ((vals, 0.0, "add"), (torch.ones(n, dtype=torch.int32), 0, "add"),
                             (vals, np.inf, "min"), (vals, -np.inf, "max")):
        want = _seg_scatter(seg, nseg, valid, values, init, op)
        got = _seg_scatter(seg.to(dev), nseg, valid.to(dev), values.to(dev), init, op).cpu()
        assert got.dtype == want.dtype and torch.equal(got, want), op


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 1])
def test_agg_exact_long_sum_on_card_equal_cpu(n):
    """The exact long sum's halves (hi/lo split below 2^20 rows, the int64
    sum above) `==` the CPU's, and rebuild numpy's int64 sums."""
    from elasticsearch_tpu_torch.aggs.nodes import _seg_sum_long_exact

    dev = _cuda()
    rng = np.random.default_rng(4)
    v = rng.integers(-(2**40), 2**40, n)
    seg = rng.integers(0, 30, n)
    ok = rng.random(n) < 0.9
    args = (torch.from_numpy(seg), 30, torch.from_numpy(ok), torch.from_numpy(v))
    want = _seg_sum_long_exact(*args)
    got = [x.cpu() for x in _seg_sum_long_exact(*(a.to(dev) if isinstance(a, torch.Tensor)
                                                  else a for a in args))]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for s in range(30):
        total = (int(got[0][s]) << 32) + int(got[1][s])
        assert total == int(v[(seg == s) & ok].sum())


def _agg_index(device):
    from elasticsearch_tpu_torch import EsIndex
    from elasticsearch_tpu_torch.corpus import C3_MAPPINGS, c3_corpus

    idx = EsIndex("c3", C3_MAPPINGS, settings={"number_of_shards": 2}, device=device)
    for i, d in c3_corpus(np.random.default_rng(5), 20_000):
        idx.index_doc(i, d)
    idx.refresh()
    return idx


_AGGS = {"by_status": {"terms": {"field": "status"}, "aggs": {
    "over_time": {"date_histogram": {"field": "@timestamp", "calendar_interval": "day"}},
    "bytes": {"sum": {"field": "size"}}, "avg": {"avg": {"field": "size"}},
    "st": {"stats": {"field": "size"}}}},
    "ip": {"cardinality": {"field": "clientip"}}, "p": {"percentiles": {"field": "size"}},
    "h": {"histogram": {"field": "size", "interval": 777}}}


@pytest.mark.gpu
def test_agg_request_runs_byte_equal_and_wave_rows_equal_solo():
    """Two runs of one agg request on the card are byte-equal, a serving
    wave's rows equal the solo search byte for byte, and the card's answer
    equals the CPU's (counts, keys, int sums equal; floats within 1e-6)."""
    import json

    from elasticsearch_tpu_torch.aggs.check import agg_mismatches

    idx = _agg_index(_cuda())
    a = idx.search({"range": {"size": {"gte": 500}}}, size=3, aggs=_AGGS)
    b = idx.search({"range": {"size": {"gte": 500}}}, size=3, aggs=_AGGS)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    rows = idx.search_wave([dict(query={"range": {"size": {"gte": 500}}}, size=3, aggs=_AGGS)] * 4)
    for r in rows:
        assert json.dumps(r, sort_keys=True) == json.dumps(a, sort_keys=True)
    cpu = _agg_index("cpu")
    want = cpu.search({"range": {"size": {"gte": 500}}}, size=3, aggs=_AGGS)
    assert not agg_mismatches(a["aggregations"], want["aggregations"])


def _text_index(device, shards: int = 1):
    """A seeded text index: Zipf `body` words, a keyword `tag` and a long
    `n` (missing on some docs), a double `p` of -0.0, +0.0 and others."""
    from elasticsearch_tpu_torch import EsIndex

    rng = np.random.default_rng(17)
    probs = 1.0 / np.arange(1, 301)
    probs /= probs.sum()
    idx = EsIndex("t", {"properties": {"body": {"type": "text"}, "tag": {"type": "keyword"},
                                       "n": {"type": "long"}, "p": {"type": "double"}}},
                  settings={"number_of_shards": shards}, device=device)
    for i in range(20_000):
        src = {"body": " ".join(f"w{w}" for w in rng.choice(300, size=int(rng.integers(3, 30)),
                                                            p=probs))}
        if i % 7:
            src["tag"] = f"k{int(rng.integers(0, 40)):02d}"
        if i % 9:
            src["n"] = int(rng.integers(0, 500))
        if i % 5:
            src["p"] = [-0.0, 0.0, 1.5, -2.25][int(rng.integers(0, 4))]
        idx.index_doc(f"d{i}", src)
    idx.refresh()
    return idx


_DSL_REQUESTS = [
    dict(query={"match_phrase": {"body": "w0 w1"}}, size=20),
    dict(query={"match_phrase": {"body": "w2 w0 w1"}}, size=20),
    dict(query={"match_phrase_prefix": {"body": "w0 w1"}}, size=20),
    dict(query={"fuzzy": {"body": {"value": "w12", "fuzziness": 1}}}, size=20),
    dict(query={"fuzzy": {"body": {"value": "w123", "fuzziness": 2}}}, size=20),
    dict(query={"wildcard": {"body": "w1?"}}, size=20),
    dict(query={"match": {"body": "w3 w4"}}, collapse={"field": "tag"}, size=20),
    dict(query={"match_phrase": {"body": "w0 w1"}}, collapse={"field": "n"}, size=20),
    dict(query={"match": {"body": "w3 w4"}}, size=20, rescore={
        "window_size": 100, "query": {"rescore_query": {"match_phrase": {"body": "w3 w4"}}}}),
    dict(query={"match": {"body": "w5"}}, sort=[{"p": "desc"}, {"n": "asc"}], size=50),
    dict(query=None, sort=[{"p": {"order": "asc", "missing": "_first"}},
                           {"tag": {"order": "desc", "missing": "_last"}}], size=80,
         search_after=[None, "k10"]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_text_dsl_on_card_equals_cpu(shards):
    """Phrase, fuzzy, collapse, rescore and sorted pages (±0.0 and missing
    keys among them) on the card equal the device="cpu" run byte for byte,
    and two runs on the card are byte-equal (no float atomics)."""
    import json

    card, cpu = _text_index(_cuda(), shards), _text_index("cpu", shards)
    for r in _DSL_REQUESTS:
        a = json.dumps(card.search(**r), sort_keys=True)
        assert a == json.dumps(card.search(**r), sort_keys=True), r
        assert a == json.dumps(cpu.search(**r), sort_keys=True), r


# ---------------------------------------------------------------------------
# the device build (index/device_build.py): the card's route above its floors
# ---------------------------------------------------------------------------

def _build_corpus(n_docs: int):
    from elasticsearch_tpu_torch.corpus import corpus_docs, make_corpus

    rng = np.random.default_rng(16)
    lens, tok, nums = make_corpus(rng, n_docs, vocab=5000, mean_len=30)
    docs = corpus_docs(lens, tok, nums, vocab=5000)
    for i, d in enumerate(docs):
        d["tag"] = f"k{i % 23}"
    docs[3]["body"] = "Café don't rock'n'roll O'Neil " + docs[3]["body"]
    docs[5]["body"] = [docs[5]["body"], "", "second value t1 t2"]
    docs[7]["body"] = "y" * 300 + " " + docs[7]["body"]
    return docs


def _pack_arrays(pack) -> dict:
    def h(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    out = {k: h(getattr(pack, k)) for k in (
        "post_docids", "post_tfs", "post_dls", "term_block_start", "term_df", "block_max_tf",
        "block_min_len", "dense_tfn", "impact_codes", "impact_ubf", "pos_keys",
        "term_pos_start", "term_pos_count")}
    for f, n in pack.norms.items():
        out[f"norms.{f}"] = n
    for f, col in pack.docvalues.items():
        out[f"dv.{f}"] = col.values
    return out


@pytest.mark.gpu
def test_device_analysis_on_card_equals_cpu_tensors():
    from elasticsearch_tpu_torch.analysis import StandardAnalyzer
    from elasticsearch_tpu_torch.analysis.batched import BatchedAnalyzer

    dev = _cuda()
    values = [d["body"] if isinstance(d["body"], str) else d["body"][0]
              for d in _build_corpus(20_000)]
    ba = BatchedAnalyzer(StandardAnalyzer())
    card = ba.analyze_values(values, mode="device", device=dev)
    cpu = ba.analyze_values(values, mode="device", device="cpu")
    host = ba.analyze_values(values, mode="batched")
    assert card.basis == "device" and card.term_ids.device.type == "cuda"
    assert list(card.term_strings()) == list(cpu.term_strings()) == list(host.terms)
    for name in ("value_idx", "pos_pre", "last_pos", "counts"):
        assert np.array_equal(getattr(card, name).cpu().numpy(), getattr(cpu, name).cpu().numpy())


@pytest.mark.gpu
def test_device_built_pack_on_card_equals_host_pack():
    from elasticsearch_tpu_torch.index.mappings import Mappings
    from elasticsearch_tpu_torch.index.pack import PackBuilder
    from elasticsearch_tpu_torch.monitoring.refresh_profile import collect_build_stages

    dev = _cuda()
    docs = _build_corpus(20_000)
    mapping = {"properties": {"body": {"type": "text"}, "n": {"type": "long"},
                              "tag": {"type": "keyword"}}}

    def build(device):
        m = Mappings(mapping)
        b = PackBuilder(m, device=device)
        b.add_documents_batch([m.parse_document(d) for d in docs],
                              doc_ids=[str(i) for i in range(len(docs))])
        with collect_build_stages() as c:
            return b.build(dense_min_df=200), c

    card, c = build(dev)
    host, _ = build("cpu")
    assert set(c.bases.values()) == {"device"}
    assert isinstance(card.dense_tfn, torch.Tensor) and card.dense_tfn.device.type == "cuda"
    got, want = _pack_arrays(card), _pack_arrays(host)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert card.term_dict == host.term_dict and card.field_stats == host.field_stats


@pytest.mark.gpu
def test_card_built_tier_stays_one_copy_after_an_incremental_refresh():
    """A 20,000-doc base whose dense tier the card built: an incremental
    refresh's statistics override rewrites that tier in place, so the card
    holds one tier (the pack's and the searcher's), not a second beside it."""
    from elasticsearch_tpu_torch import EsIndex

    dev = _cuda()
    docs = _build_corpus(20_500)
    mapping = {"properties": {"body": {"type": "text"}, "n": {"type": "long"},
                              "tag": {"type": "keyword"}}}
    idx = EsIndex("t", mapping, device=dev)
    for i, d in enumerate(docs[:20_000]):
        idx.index_doc(str(i), d)
    idx.refresh()
    tier = idx._searcher.pack.dense_tfn
    assert isinstance(tier, torch.Tensor) and tier.device.type == "cuda"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    for j in range(20_000, 20_500):
        idx.index_doc(str(j), docs[j])
    idx.refresh()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(dev) - before
    assert idx.last_refresh_kind == "incremental" and idx._searcher.stats_override is not None
    assert idx._searcher.dev["dense_tfn"] is tier is idx._searcher.pack.dense_tfn
    seg = sum(t.nbytes for t in idx._tails)
    assert grown < seg + tier.nbytes // 2, (grown, seg, tier.nbytes)


def _esql_table(n: int, seed: int):
    """An ES|QL table with every exchange key type and nulls: a double, a
    long (past 2^53 in places), a keyword, a boolean."""
    from elasticsearch_tpu_torch.esql.engine import Column, Table

    rng = np.random.default_rng(seed)
    kw = np.array([f"k{int(x)}" for x in rng.integers(0, 500, n)], object)
    kw_null = rng.random(n) < 0.05
    kw[kw_null] = None
    lv = rng.integers(-1000, 1000, n).astype(np.int64)
    lv[::97] = rng.integers(-(1 << 40), 1 << 40, len(lv[::97])) * 4096
    return Table({"d": Column(rng.standard_normal(n) * 1e3, rng.random(n) < 0.05, "double"),
                  "l": Column(lv, rng.random(n) < 0.05, "long"),
                  "k": Column(kw, kw_null, "keyword"),
                  "b": Column(rng.random(n) < 0.5, rng.random(n) < 0.05, "boolean")}, n)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 4])
def test_esql_exchanges_on_card_equal_cpu(shards):
    """The sharded SORT | LIMIT and STATS programs on the card select the
    same rows and give the same counts, longs, extrema and doubles as on
    CPU tensors: the double sums add by the same pairwise tree on both."""
    from elasticsearch_tpu_torch.esql.exchange import stats_exchange
    from elasticsearch_tpu_torch.esql.topn import topn_exchange

    dev = _cuda()
    n = 300_000
    t = _esql_table(n, shards)
    shard_of = np.random.default_rng(5).integers(0, shards, n).astype(np.int32)
    for payload in ([("d", True, None)], [("l", False, None), ("k", True, None)],
                    [("k", False, True), ("b", True, None), ("d", False, None)]):
        for limit in (10, 1000):
            card = topn_exchange(t, shard_of, payload, limit, dev)
            cpu = topn_exchange(t, shard_of, payload, limit, "cpu")
            assert np.array_equal(card, cpu), (payload, limit)
    aggs = [("n", ("call", "count", [("star",)]))] + [
        (f"{fn}_{c}", ("call", fn, [("col", c)]))
        for c in ("d", "l") for fn in ("count", "sum", "avg", "min", "max")]
    for by in ([], ["k"], ["b", "k"]):
        card = stats_exchange(t, shard_of, aggs, by, dev)
        cpu = stats_exchange(t, shard_of, aggs, by, "cpu")
        assert card.nrows == cpu.nrows and list(card.columns) == list(cpu.columns)
        for name, want in cpu.columns.items():
            got = card.columns[name]
            assert got.type == want.type and np.array_equal(got.null, want.null), name
            assert np.array_equal(got.values, want.values), name


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_esql_request_on_card_equals_cpu(shards):
    """bench.py C10's queries through `esql_query` on a card engine and a
    device="cpu" engine of the same docs: the same columns and values
    (doubles within 1e-12 relative) and the same operators."""
    from elasticsearch_tpu_torch import Engine
    from elasticsearch_tpu_torch.corpus import C3_MAPPINGS, c3_corpus
    from elasticsearch_tpu_torch.esql import esql_query

    dev = _cuda()
    docs = c3_corpus(np.random.default_rng(2), 20_000)
    engines = [Engine(device=dev), Engine(device="cpu")]
    for e in engines:
        idx = e.create_index("c3", C3_MAPPINGS, {"number_of_shards": shards})
        for i, d in docs:
            idx.index_doc(i, d)
        idx.refresh()
    try:
        for q in ('FROM c3 | WHERE size >= 50000 | STATS c = COUNT(*), b = SUM(size) BY status '
                  '| SORT status',
                  'FROM c3 | SORT size DESC | LIMIT 10 | KEEP clientip, size',
                  'FROM c3 | WHERE status == "404" | SORT size DESC | LIMIT 10 '
                  '| KEEP clientip, size',
                  'FROM c3 | EVAL kb = size / 1024 | STATS m = MAX(kb), a = AVG(kb)',
                  'FROM c3 | STATS c = COUNT(*), b = SUM(size) BY clientip '
                  '| SORT c DESC, clientip | LIMIT 10'):
            card, cpu = (esql_query(e, {"query": q, "profile": True}) for e in engines)
            assert card["columns"] == cpu["columns"], q
            assert len(card["values"]) == len(cpu["values"]) > 0, q
            for rg, rw in zip(card["values"], cpu["values"]):
                for g, w in zip(rg, rw):
                    if isinstance(w, float):
                        assert type(g) is float and abs(g - w) <= 1e-12 * abs(w), (q, g, w)
                    else:
                        assert type(g) is type(w) and g == w, (q, g, w)
            assert [o["operator"] for o in card["profile"]["drivers"][0]["operators"]] == \
                [o["operator"] for o in cpu["profile"]["drivers"][0]["operators"]], q
    finally:
        for e in engines:
            e.close()


# ---- one summation order, tenancy and scripts (the card against the CPU) ----

@pytest.mark.gpu
def test_segment_sum_f32_on_card_equals_cpu():
    """`segment_sum_f32` adds by one pairwise tree on every device: the
    order-dependent segment (1, 2^-24, 2^-53, 2^-53) rounds to 1 + 2^-23 on
    both, and 300,000 mixed-sign doubles in ~500 segments give the same
    bits."""
    import torch

    from elasticsearch_tpu_torch.ops.scoring import segment_sum_f32

    dev = _cuda()
    od = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -53, 2.0 ** -53], dtype=torch.float32)
    z = torch.zeros(4, dtype=torch.int64)
    card = segment_sum_f32(z.to(dev), od.to(dev), 1).cpu()
    assert card.item() == np.float32(1.0 + 2.0 ** -23) == segment_sum_f32(z, od, 1).item()
    rng = np.random.default_rng(3)
    n, nseg = 300_000, 500
    vals = torch.from_numpy((rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n))
                            .astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, nseg + 1, n))
    for k in (nseg, 1):
        t = tgt if k > 1 else torch.zeros_like(tgt)
        got = segment_sum_f32(t.to(dev), vals.to(dev), k).cpu().numpy()
        want = segment_sum_f32(t, vals, k).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), k


def _tenant_engines(dev, n_tenants=12):
    from elasticsearch_tpu_torch import Engine

    engines = [Engine(device=dev), Engine(device="cpu")]
    names = []
    for t in range(n_tenants):
        trng = np.random.default_rng(10_000 + t)
        vocab = 40 if t % 2 else 20
        docs = [(str(j), {"body": " ".join(f"w{int(x)}" for x in trng.integers(0, vocab, 6))})
                for j in range(24)]
        name = f"tenant{t:04d}"
        for e in engines:
            e.settings.update({"persistent": {"superpack.enabled": True}})
            idx = e.create_index(name, {"properties": {"body": {"type": "text"}}})
            for i, d in docs:
                idx.index_doc(i, d)
            idx.refresh()
            assert e.superpacks.adopt(idx)
        names.append(name)
    return engines, names


@pytest.mark.gpu
def test_superpack_rows_on_card_equal_exact_arm_and_cpu():
    """A wave mixing two size classes on the card: each tenant's rows are
    byte-equal (finite lanes, totals) to its per-index exact arm on the
    card and to a device="cpu" engine's superpack; `scan_topk` launched."""
    from elasticsearch_tpu_torch.ops.batched import BatchTermSearcher, fetch

    dev = _cuda()
    (card, cpu), names = _tenant_engines(dev)
    queries = [[("w3", 1.0), ("w7", 1.0)], [("w1", 1.0)], [("w2", 1.0), ("w39", 2.0)]]
    try:
        assert len(card.superpacks.packs) == 2
        kernels.reset_launch_counts()
        rows = {n: card.superpacks.msearch(n, "body", queries, 10) for n in names}
        assert kernels.launch_counts["scan_topk"] == len(names)
        for n in names:
            v, _s, i, t = rows[n]
            ss = card.indices[n]._searcher
            bts = BatchTermSearcher(ss)
            ev, ei, et = fetch([bts.run("body", bts.plan("body", queries, 10))])[0]
            cv, _cs, ci, ct = cpu.superpacks.msearch(n, "body", queries, 10)
            for want_v, want_i, want_t in ((ev, ei, et), (cv, ci, ct)):
                assert np.array_equal(t, want_t), n
                for q in range(len(queries)):
                    k = int(np.isfinite(want_v[q]).sum())
                    assert int(np.isfinite(v[q]).sum()) == k
                    assert np.array_equal(v[q][:k].view(np.uint32), want_v[q][:k].view(np.uint32))
                    assert np.array_equal(i[q][:k], want_i[q][:k])
        ents = [{"index": names[j % len(names)],
                 "kwargs": {"query": {"match": {"body": f"w{j % 20} w{(j * 7) % 20}"}},
                            "size": 10}} for j in range(40)]
        outs = []
        for e in (card, cpu):
            es = [{"index": x["index"], "kwargs": dict(x["kwargs"])} for x in ents]
            assert all(e.superpacks.wave_claim(x) for x in es)
            job = e.superpacks.search_wave_begin(es)
            e.superpacks.search_wave_fetch(job)
            outs.append(e.superpacks.search_wave_finish(job))
        assert outs[0] == outs[1]
    finally:
        card.close()
        cpu.close()


def _script_pair(dev, shards):
    from elasticsearch_tpu_torch import Engine

    rng = np.random.default_rng(shards)
    engines = [Engine(device=dev), Engine(device="cpu")]
    idxs = []
    for e in engines:
        idx = e.create_index("s", {"properties": {"body": {"type": "text"},
                                                  "n": {"type": "long"},
                                                  "p": {"type": "double"}}},
                             {"number_of_shards": shards})
        idxs.append(idx)
    for i in range(5000):
        src = {"body": " ".join(f"w{int(x)}" for x in rng.zipf(1.3, 8) % 50),
               "n": int(rng.integers(0, 100))}
        if i % 3:
            src["p"] = float(rng.standard_normal())
        for idx in idxs:
            idx.index_doc(str(i), src)
    for idx in idxs:
        idx.refresh()
    return engines, idxs


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_function_and_script_score_on_card_equal_cpu(shards):
    """function_score (field_value_factor, a decay, a filtered weight,
    random_score) and script_score searches on the card: the same hits and
    scores (`==`) as a device="cpu" engine on the same docs."""
    dev = _cuda()
    (card, cpu), (ci, pi) = _script_pair(dev, shards)
    bodies = [
        {"script_score": {"query": {"match": {"body": "w1 w3"}},
                          "script": "_score * 2 + doc['n'].value / 10"}},
        {"function_score": {"query": {"match": {"body": "w2 w4"}}, "functions": [
            {"field_value_factor": {"field": "n", "factor": 0.5, "modifier": "log1p"}},
            {"gauss": {"n": {"origin": 50, "scale": 20}}},
            {"filter": {"range": {"n": {"gte": 70}}}, "weight": 3.0},
            {"random_score": {"seed": 9}}], "score_mode": "sum"}},
        {"bool": {"must": [{"match": {"body": "w1"}}],
                  "filter": [{"script": {"script": "doc['p'].value > 0"}}]}},
    ]
    try:
        for q in bodies:
            kernels.reset_launch_counts()
            got = ci.search(q, size=10)
            assert kernels.launch_counts["scan_topk"] >= 1
            assert got == pi.search(q, size=10), q
        rm = {"r": {"type": "long", "script": "emit(doc['n'].value % 7)"}}
        got = ci.search({"range": {"r": {"gte": 3}}}, size=5, runtime_mappings=rm,
                        aggs={"t": {"terms": {"field": "r"}}}, sort=[{"r": "desc"}])
        assert got == pi.search({"range": {"r": {"gte": 3}}}, size=5, runtime_mappings=rm,
                                aggs={"t": {"terms": {"field": "r"}}}, sort=[{"r": "desc"}])
    finally:
        card.close()
        cpu.close()


# ---- slice 18: the other field types and query kinds on the card ---------

def _hits_close(got: dict, want: dict, what, rtol: float = 1e-6, boundary=frozenset()):
    """Totals equal and hit rows equal, scores within rtol; a doc in
    `boundary` (a point within float32 noise of a radius) may be on either
    side."""
    g = {h["_id"]: h["_score"] for h in got["hits"]["hits"]}
    w = {h["_id"]: h["_score"] for h in want["hits"]["hits"]}
    if boundary:
        assert set(g) - set(boundary) == set(w) - set(boundary), what
        return
    assert got["hits"]["total"] == want["hits"]["total"], what
    assert list(g) == list(w) or sorted(g) == sorted(w), what
    for k, s in w.items():
        assert s is None or abs(g[k] - s) <= rtol * abs(s), (what, k, g[k], s)


def _slice18_engines(dev, name, mapping, docs, shards, settings=None):
    from elasticsearch_tpu_torch import Engine

    engines = [Engine(device=dev), Engine(device="cpu")]
    idxs = []
    for e in engines:
        idx = e.create_index(name, mapping, {"number_of_shards": shards, **(settings or {})})
        for i, d in docs:
            idx.index_doc(i, d)
        idx.refresh()
        idxs.append(idx)
    return engines, idxs


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_geo_kinds_on_card_equal_cpu(shards):
    """geo_distance, geo_bounding_box (one across the dateline), the
    rank_feature functions, terms_set, distance_feature on a geo_point and
    the geo aggs on the card against a device="cpu" engine of the same docs:
    match sets equal but for counted boundary docs, scores within 1e-6
    relative, geo_bounds and tile counts equal, the centroid equal (the
    same pairwise f64 sums on both)."""
    from elasticsearch_tpu_torch.corpus import GEONAMES_MAPPINGS, geonames_corpus
    from elasticsearch_tpu_torch.query.geo import parse_distance_meters
    from geo_edges import boundary_docs, tile_boundary_docs

    dev = _cuda()
    docs, lat, lon = geonames_corpus(np.random.default_rng(18), 30_000)
    (card, cpu), (ci, pi) = _slice18_engines(dev, "geo", GEONAMES_MAPPINGS, docs, shards)
    lat32, lon32 = lat.astype(np.float32).astype(np.float64), lon.astype(np.float32).astype(np.float64)
    try:
        edge_total = 0
        for j in range(12):
            la, lo = float(lat[j * 97]), float(lon[j * 97])
            dist = ("1km", "10km", "100km")[j % 3]
            q = {"geo_distance": {"distance": dist, "location": {"lat": la, "lon": lo}}}
            kernels.reset_launch_counts()
            ci.search(q, size=10)
            assert kernels.launch_counts["scan_topk"] == 1
            got = ci.search(q, size=10_000)
            edge = {str(i) for i in np.flatnonzero(boundary_docs(
                lat32, lon32, la, lo, parse_distance_meters(dist)))}
            edge_total += len(edge)
            _hits_close(got, pi.search(q, size=10_000), q, boundary=edge)
        assert edge_total <= 3
        bodies = [
            {"geo_bounding_box": {"location": {"top": 40, "bottom": -10, "left": 160, "right": -150}}},
            {"geo_bounding_box": {"location": {"top_left": "50,0", "bottom_right": "40,20"}}},
            {"rank_feature": {"field": "pop_rank"}},
            {"rank_feature": {"field": "pop_rank", "log": {"scaling_factor": 2}}},
            {"rank_feature": {"field": "pop_rank", "sigmoid": {"pivot": 100, "exponent": 0.6}}},
            {"rank_feature": {"field": "pop_rank", "linear": {}}},
            {"terms_set": {"codes": {"terms": ["k1", "k2", "k3"],
                                     "minimum_should_match_field": "required_matches"}}},
            {"bool": {"must": [{"match": {"name": "t1 t2"}}], "should": [
                {"distance_feature": {"field": "location", "origin": "10,10", "pivot": "500km"}}]}},
        ]
        for q in bodies:
            _hits_close(ci.search(q, size=20), pi.search(q, size=20), q)
        aggs = {"t": {"geotile_grid": {"field": "location", "precision": 6},
                      "aggs": {"c": {"geo_centroid": {"field": "location"}}}},  # edge docs may move
                "b": {"filter": {"term": {"feature_class": "P"}},
                      "aggs": {"bb": {"geo_bounds": {"field": "location"}}}}}
        got, want = ci.search(None, size=0, aggs=aggs), pi.search(None, size=0, aggs=aggs)
        assert got["aggregations"]["b"] == want["aggregations"]["b"]
        gt = {b["key"]: b for b in got["aggregations"]["t"]["buckets"]}
        wt = {b["key"]: b for b in want["aggregations"]["t"]["buckets"]}
        moved = sum(max(0, gt.get(k, {"doc_count": 0})["doc_count"]
                        - wt.get(k, {"doc_count": 0})["doc_count"]) for k in set(gt) | set(wt))
        assert moved <= int(tile_boundary_docs(lat32, lon32, 6).sum())  # counted edge points
        for k, b in wt.items():  # a tile no point left or entered: the same centroid
            if moved == 0:
                assert gt[k] == b
    finally:
        card.close()
        cpu.close()


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_types_extra_and_matchers_on_card_equal_cpu(shards):
    """ip terms, CIDR and ranges, date_nanos ranges and sorts, more_like_this,
    combined_fields, pinned, wrapper, intervals, nested and percolate on the
    card: the responses of a device="cpu" engine of the same docs."""
    import base64
    import json

    from elasticsearch_tpu_torch.corpus import (C3_TYPED_MAPPINGS, PERCOLATOR_MAPPINGS,
                                                QA_MAPPINGS, c3_corpus, c3_typed_docs,
                                                percolator_queries, qa_corpus)

    dev = _cuda()
    rng = np.random.default_rng(5)
    c3 = c3_typed_docs(c3_corpus(rng, 20_000), rng)
    qa = qa_corpus(rng, 3_000)
    texts = [(f"t{i}", {"body": " ".join(f"t{int(x)}" for x in rng.integers(0, 300, size=12)),
                        "tag": f"g{i % 20}"}) for i in range(4_000)]
    perc = percolator_queries(rng, 300, vocab=300)
    made = [_slice18_engines(dev, "c3", C3_TYPED_MAPPINGS, c3, shards),
            _slice18_engines(dev, "qa", QA_MAPPINGS, qa, shards),
            _slice18_engines(dev, "tx", PERCOLATOR_MAPPINGS, texts + perc, shards)]
    try:
        (c3c, c3p), (qac, qap), (txc, txp) = (m[1] for m in made)
        checks = [
            (c3c, c3p, {"term": {"clientip": "10.1.2.3"}}, {}),
            (c3c, c3p, {"term": {"clientip": "10.12.0.0/16"}}, {}),
            (c3c, c3p, {"range": {"clientip": {"gte": "10.100.0.0", "lt": "10.101.0.0"}}}, {}),
            (c3c, c3p, {"range": {"@timestamp": {"gt": "2015-01-05T00:00:00.000000500Z",
                                                 "lt": "2015-01-05T06:00:00Z"}}}, {}),
            (c3c, c3p, {"match_all": {}}, {"sort": [{"clientip": "asc"}, {"@timestamp": "desc"}]}),
            (c3c, c3p, {"match_all": {}}, {"sort": [{"@timestamp": "desc"}],
                                           "search_after": [1_421_000_000_000_000_000]}),
            (qac, qap, {"nested": {"path": "answers", "query": {"bool": {"must": [
                {"range": {"answers.score": {"gte": 5}}},
                {"range": {"answers.date": {"gte": "2012-01-01"}}}]}}}}, {}),
            (txc, txp, {"more_like_this": {"fields": ["body"], "like": texts[3][1]["body"],
                                           "min_term_freq": 1, "min_doc_freq": 2}}, {}),
            (txc, txp, {"more_like_this": {"like": [{"_id": "t7"}], "min_term_freq": 1}}, {}),
            (txc, txp, {"combined_fields": {"query": "t1 t2", "fields": ["body"]}}, {}),
            (txc, txp, {"pinned": {"ids": ["t9", "t4"], "organic": {"match": {"body": "t5"}}}}, {}),
            (txc, txp, {"wrapper": {"query": base64.b64encode(json.dumps(
                {"match": {"body": "t8"}}).encode()).decode()}}, {}),
            (txc, txp, {"intervals": {"body": {"match": {"query": "t1 t2", "max_gaps": 3,
                                                         "ordered": True}}}}, {}),
            (txc, txp, {"percolate": {"field": "query", "documents": [
                {"body": texts[1][1]["body"], "tag": "g3"}]}}, {}),
        ]
        for c, p, q, kw in checks:
            kernels.reset_launch_counts()
            got = c.search(q, size=25, **kw)
            assert kernels.launch_counts["scan_topk"] >= 1 or "sort" in kw, q
            want = p.search(q, size=25, **kw)
            if "sort" in kw:
                assert got["hits"] == want["hits"], q
            else:
                _hits_close(got, want, q)
    finally:
        for (engines, _i) in made:
            for e in engines:
                e.close()


@pytest.mark.gpu
def test_routed_8_shard_build_and_mlt_by_id_on_card_equal_cpu():
    """8 shards of 24,000 docs built by a card engine (the routed card build,
    each stage above its floor) and by a device="cpu" engine: every shard's
    pack byte for byte, each shard's `doc_sources` equal, and more_like_this
    by `_id` (the like docs' sources from their shards, the terms over the
    global df) answering as the cpu engine does."""
    dev = _cuda()
    docs = [(str(i), d) for i, d in enumerate(_build_corpus(24_000))]
    mapping = {"properties": {"body": {"type": "text"}, "n": {"type": "long"},
                              "tag": {"type": "keyword"}}}
    engines, (card, cpu) = _slice18_engines(dev, "mlt8", mapping, docs, 8)
    try:
        gs, ws = card.searcher.sp.shards, cpu.searcher.sp.shards
        assert len(gs) == len(ws) == 8
        (prof,) = engines[0].refresh_recorder.profiles()["profiles"]
        assert prof["basis"].get("flat_csr") == "device", prof["basis"]
        for k, (g, w) in enumerate(zip(gs, ws)):
            got, want = _pack_arrays(g), _pack_arrays(w)
            assert set(got) == set(want), k
            for name in want:
                if want[name] is None:
                    assert got[name] is None, (k, name)
                    continue
                assert got[name].dtype == want[name].dtype, (k, name)
                assert got[name].tobytes() == want[name].tobytes(), (k, name)
            assert g.term_dict == w.term_dict and g.doc_sources == w.doc_sources, k
        ids = np.random.default_rng(19).integers(0, len(docs), size=20).tolist()
        for j in range(0, 20, 2):
            q = {"more_like_this": {"like": [{"_id": str(ids[j])}, {"_id": str(ids[j + 1])}],
                                    "min_term_freq": 1, "min_doc_freq": 5}}
            kernels.reset_launch_counts()
            got = card.search(q, size=10)
            assert kernels.launch_counts["scan_topk"] >= 1, q
            want = cpu.search(q, size=10)
            assert want["hits"]["total"]["value"] > 0, q
            _hits_close(got, want, q)
    finally:
        for e in engines:
            e.close()


@pytest.mark.gpu
def test_custom_analyzer_refresh_on_card_equals_host_route():
    """A card engine's refresh of english and synonym_graph + edge_ngram
    fields (the host route, by analyzer type) and a standard field (the
    card's route) gives the packs of a device="cpu" engine, and the same
    match / match_phrase answers."""
    from elasticsearch_tpu_torch import Engine

    dev = _cuda()
    rng = np.random.default_rng(3)
    settings = {"analysis": {"filter": {
        "sg": {"type": "synonym_graph", "synonyms": ["t1, t2", "t3 => t30"]},
        "eg": {"type": "edge_ngram", "min_gram": 2, "max_gram": 4}},
        "analyzer": {"custom": {"tokenizer": "standard", "filter": ["lowercase", "sg", "eg"]}}}}
    mapping = {"properties": {"en": {"type": "text", "analyzer": "english"},
                              "cu": {"type": "text", "analyzer": "custom"},
                              "st": {"type": "text"}}}
    docs = []
    for i in range(40_000):
        t = " ".join(f"t{int(x)}" for x in rng.integers(0, 500, size=10))
        docs.append((str(i), {"en": t + " running", "cu": t, "st": t}))
    engines, (ci, pi) = _slice18_engines(dev, "an", mapping, docs, 1, settings)
    try:
        a, b = ci.searcher.pack, pi.searcher.pack
        assert a.term_dict == b.term_dict
        for name in ("post_docids", "post_tfs", "pos_keys", "term_pos_start", "impact_codes"):
            assert np.asarray(getattr(a, name)).tobytes() == np.asarray(getattr(b, name)).tobytes()
        for q in ({"match": {"cu": "t2"}}, {"match_phrase": {"cu": "t1 t5"}},
                  {"match": {"en": "run"}}, {"match_phrase": {"st": "t4 t9"}}):
            _hits_close(ci.search(q, size=20), pi.search(q, size=20), q)
    finally:
        for e in engines:
            e.close()


# ---- the fetch sub-phases, suggesters and profile (the card against the CPU) ----

def _rest(app, method, path, body=None):
    import json

    status, _h, raw = app.handle(method, path, {}, {}, b"" if body is None else
                                 json.dumps(body).encode())
    assert status == 200, raw
    return json.loads(raw)


def _strip_timings(tree):
    if isinstance(tree, list):
        return [_strip_timings(x) for x in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: (_strip_timings(v) if k != "breakdown" else
                {bk: bv for bk, bv in v.items() if bk.endswith("_count")})
            for k, v in tree.items() if k not in ("time_in_nanos", "rewrite_time", "device",
                                                  "phases")}


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_profile_device_section_counts_every_scan_topk_launch(shards):
    """A profiled bool of 4 match clauses on a card index: the `device`
    section holds one `scan_topk` event per launch the request made (the
    search's own and 2 per profiled node), on every shard's section; the
    tree (timings left out), the highlighted hits and a term suggestion
    equal a device="cpu" engine's."""
    from elasticsearch_tpu_torch import Engine
    from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, make_corpus
    from elasticsearch_tpu_torch.rest import make_app

    dev = _cuda()
    lens, tok, nums = make_corpus(np.random.default_rng(3), 20_000, vocab=2_000, mean_len=12)
    docs = [(str(i), d) for i, d in enumerate(corpus_docs(lens, tok, nums, vocab=2_000))]
    apps = [make_app(Engine(device=dev)), make_app(Engine(device="cpu"))]
    try:
        for app in apps:
            idx = app.engine.create_index("p", MAPPINGS, {"number_of_shards": shards})
            for i, d in docs:
                idx.index_doc(i, d)
            idx.refresh()
        words = docs[7][1]["body"].split()[:4]
        body = {"query": {"bool": {"should": [{"match": {"body": w}} for w in words]}},
                "profile": True, "size": 10,
                "highlight": {"fields": {"body": {"fragment_size": 100,
                                                  "number_of_fragments": 3}}},
                "suggest": {"t": {"text": words[0][:-1] + "q", "term": {"field": "body"}}}}
        before = kernels.launch_counts["scan_topk"]
        card = _rest(apps[0], "POST", "/p/_search", body)
        torch.cuda.synchronize()
        launched = kernels.launch_counts["scan_topk"] - before
        cpu = _rest(apps[1], "POST", "/p/_search", body)

        def count(tree):
            return 1 + sum(count(c) for c in tree.get("children", ()))

        tree = card["profile"]["shards"][0]["searches"][0]["query"][0]
        assert launched == 1 + 2 * count(tree) == 11
        assert len(card["profile"]["shards"]) == shards
        for entry in card["profile"]["shards"]:
            names = [k["name"] for k in entry["device"]["kernels"]]
            assert names == ["scan_topk"] * launched
        assert _strip_timings(card["profile"]) == _strip_timings(cpu["profile"])
        assert card["suggest"] == cpu["suggest"]
        assert [(h["_id"], h.get("highlight")) for h in card["hits"]["hits"]] == \
            [(h["_id"], h.get("highlight")) for h in cpu["hits"]["hits"]]
        assert all(h.get("highlight") for h in card["hits"]["hits"])
    finally:
        for app in apps:
            app.close()


@pytest.mark.gpu
def test_completion_index_built_on_card_equals_cpu():
    """A completion index of 40,000 geonames place names weighted by
    population, refreshed on the card's build route and with
    device="cpu": the packs' completion lists are equal, and so are 40
    prefix suggestions of 1-4 characters (10 with skip_duplicates), on 1
    shard and on 4."""
    from elasticsearch_tpu_torch import Engine
    from elasticsearch_tpu_torch.corpus import geonames_corpus

    dev = _cuda()
    docs, _lat, _lon = geonames_corpus(np.random.default_rng(4), 40_000)
    mapping = {"properties": {"name": {"type": "text"}, "population": {"type": "long"},
                              "suggest": {"type": "completion"}}}
    src = [(i, {"name": d["name"], "population": d["population"],
                "suggest": {"input": d["name"], "weight": d["population"]}}) for i, d in docs]
    prefixes = [docs[j][1]["name"][:1 + j % 4] for j in range(0, 4000, 100)]
    engines = [Engine(device=dev), Engine(device="cpu")]
    try:
        answers, lists = [], []
        for e in engines:
            for shards in (1, 4):
                idx = e.create_index(f"g{shards}", mapping, {"number_of_shards": shards})
                for i, d in src:
                    idx.index_doc(i, d)
                idx.refresh()
                if e.device.type == "cuda":
                    prof = e.refresh_recorder.profiles(1)["profiles"][-1]
                    assert "device" in prof["basis"].values(), prof["basis"]
                searcher = idx.searcher
                lists.append(searcher.pack.completion if shards == 1 else searcher.sp.completion)
                answers.append([e.suggest_multi(f"g{shards}", {"c": {
                    "prefix": p, "completion": {"field": "suggest", "size": 5,
                                                "skip_duplicates": j % 4 == 0}}})
                    for j, p in enumerate(prefixes)])
        assert lists[0] == lists[2] and lists[1] == lists[3]
        assert len(lists[0]["suggest"]) == 40_000
        assert answers[0] == answers[2] and answers[1] == answers[3]
        assert [[o["text"] for o in a["c"][0]["options"]] for a in answers[0]] == \
            [[o["text"] for o in a["c"][0]["options"]] for a in answers[1]]
    finally:
        for e in engines:
            e.close()


def _log_engine(device, shards: int):
    """Six daily log indices of 400 docs each (Kibana Discover's layout over
    a `logs-*` pattern) on `device`."""
    from elasticsearch_tpu_torch import Engine

    rng = np.random.default_rng(20)
    words = [f"w{i}" for i in range(30)]
    e = Engine(device=device)
    mapping = {"properties": {"@timestamp": {"type": "date"}, "body": {"type": "text"},
                              "n": {"type": "long"}}}
    for day in range(6):
        idx = e.create_index(f"logs-{day}", mapping, {"number_of_shards": shards})
        for i in range(400):
            idx.index_doc(f"{day}-{i}", {
                "@timestamp": 1_704_067_200_000 + day * 86_400_000 + int(rng.integers(0, 86_400_000)),
                "body": " ".join(rng.choice(words, int(rng.integers(2, 9)))),
                "n": int(rng.integers(0, 1000))})
        idx.refresh()
    return e


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_multi_index_search_with_skipped_indices_on_card_equals_cpu(shards):
    """`_search` over six daily indices on the card and with device="cpu":
    a "last day" range skips five indices (can_match), which launch no
    scan_topk; the answers, sorted pages included, are `==` but for scores
    within 1e-6 relative."""
    dev = _cuda()
    engines = [_log_engine(dev, shards), _log_engine("cpu", shards)]
    try:
        day = 86_400_000
        last = {"range": {"@timestamp": {"gte": 1_704_067_200_000 + 5 * day}}}
        reqs = [{"query": {"bool": {"must": [{"match": {"body": "w1 w2"}}], "filter": [last]}}},
                {"query": {"match": {"body": "w3"}}, "size": 20},
                {"query": {"match": {"body": "w4 w5"}}, "sort": [{"@timestamp": "desc"}],
                 "size": 50}]
        out = []
        for e in engines:
            rows = []
            for r in reqs:
                kernels.reset_launch_counts()
                res = e.search_multi("logs-*", **r)
                rows.append((res, kernels.launch_counts["scan_topk"]))
            out.append(rows)
        (card, cpu) = out
        assert card[0][0]["skipped_shards"] == cpu[0][0]["skipped_shards"] == 5 * shards
        assert card[0][1] == 1  # one index searched, one selection
        assert card[1][1] == 6 and card[1][0]["skipped_shards"] == 0
        for (a, _), (b, _) in zip(card, cpu):
            assert a["hits"]["total"] == b["hits"]["total"]
            assert [h["_id"] for h in a["hits"]["hits"]] == [h["_id"] for h in b["hits"]["hits"]]
            assert [h.get("sort") for h in a["hits"]["hits"]] == \
                [h.get("sort") for h in b["hits"]["hits"]]
            for g, w in zip(a["hits"]["hits"], b["hits"]["hits"]):
                if w["_score"] is not None:
                    assert abs(g["_score"] - w["_score"]) <= 1e-6 * abs(w["_score"])
    finally:
        for e in engines:
            e.close()


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 3])
def test_explain_per_clause_scores_on_card_equal_cpu(shards):
    """`_explain` of a bool of three clauses on the card: the total and each
    clause's exact BM25 score `==` the device="cpu" run's; 1 + 3
    scan_topk launches per explanation (one per scored clause)."""
    dev = _cuda()
    engines = [_log_engine(dev, shards), _log_engine("cpu", shards)]
    try:
        q = {"bool": {"must": [{"match": {"body": "w1"}}],
                      "should": [{"match": {"body": "w2"}}, {"match": {"body": "w7 w8"}}]}}
        got = []
        for e in engines:
            idx = e.get_index("logs-2")
            rows = []
            for i in range(0, 400, 40):
                kernels.reset_launch_counts()
                rows.append((idx.explain(f"2-{i}", q), kernels.launch_counts["scan_topk"]))
            got.append(rows)
        assert [r[0] for r in got[0]] == [r[0] for r in got[1]]
        for ex, n in got[0]:
            if ex["matched"]:
                assert n == 1 + len(q["bool"]["must"]) + len(q["bool"]["should"])
        assert any(ex["matched"] for ex, _ in got[0])
    finally:
        for e in engines:
            e.close()
