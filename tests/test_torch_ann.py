"""The port's ANN index and gather-scan against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:

- `scalar_quantize_int8`, the tile packing and the split-bf16 tiers run the
  same element-wise f32 operations on both sides: byte-equal.
- Per-slot squared norms: numpy's pairwise sum against torch's: 1e-6
  relative.
- k-means: both sides run f32 matmuls summed in different orders, so an
  assignment may differ only where the reference's top-two logit gap is
  within 1e-4 relative; centroids within 1e-5 relative.
- `ann_gather_scan_reference` (the kernel's twin) against the JAX XLA arm
  and the Pallas kernel in interpret mode: the reference sums each dot in
  einsum/MXU order, the twin sequentially, so values agree within 1e-5
  relative + 1e-5 absolute, and ids are equal on finite lanes except where
  values tie within that tolerance. The interpret-mode kernel orders exact
  ties by docid as the port does, so there ids are equal on every exact tie.
- AnnSearcher / TieredKnnScanner: rescored f32 scores; the port's batched
  product and XLA's einsum sum in different orders: 1e-6 relative, except
  l2_norm, where |d|^2 - 2 q.d + |q|^2 cancels: there the allowance is 64
  ulp of |d|^2 + |q|^2 carried through 1/(1 + l2) (`_l2_tol`). Ids equal up
  to fp-ties (1e-5 relative), totals equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ann import AnnSearcher as RefAnnSearcher
from elasticsearch_tpu.ann import build_ann as ref_build_ann
from elasticsearch_tpu.ann import kernels as ref_kernels
from elasticsearch_tpu.ann.index import ann_to_device as ref_ann_to_device
from elasticsearch_tpu.ann.quantize import dequantize_int8 as ref_dequantize
from elasticsearch_tpu.ann.quantize import quantization_error_bound as ref_error_bound
from elasticsearch_tpu.ann.quantize import scalar_quantize_int8 as ref_quantize
from elasticsearch_tpu.index.device_build import ann_tiles_device
from elasticsearch_tpu.ops.vector import TieredKnnScanner as RefTieredKnnScanner
from elasticsearch_tpu.ops.vector import kmeans_ivf as ref_kmeans
from elasticsearch_tpu_torch.ann import AnnSearcher, ann_to_device, build_ann
from elasticsearch_tpu_torch.ann.index import ann_tiles
from elasticsearch_tpu_torch.ann.kernels import ann_gather_scan, ann_gather_scan_reference
from elasticsearch_tpu_torch.ann.quantize import (
    dequantize_int8,
    quantization_error_bound,
    scalar_quantize_int8,
)
from elasticsearch_tpu_torch.corpus import vector_corpus
from elasticsearch_tpu_torch.ops.kernels import split_bf16
from elasticsearch_tpu_torch.ops.vector import TieredKnnScanner, kmeans_ivf

SIMS = ("cosine", "dot_product", "l2_norm", "max_inner_product")
TRANSFORMS = ("identity",) + SIMS
F32_EPS = 2.0 ** -24


@pytest.fixture(scope="module")
def clustered():
    vecs, near = vector_corpus(np.random.default_rng(3), 3000, 32, 20, 12)
    return vecs, near


@pytest.mark.parametrize("case", ["normal", "constant_rows", "wide_range"])
def test_scalar_quantize_int8_byte_equal(case):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(300, 48)).astype(np.float32)
    if case == "constant_rows":
        v[::3] = 2.5  # scale 0, exact offset
        v[1::7] = 0.0
    elif case == "wide_range":
        v *= np.float32(1e4) ** rng.uniform(-1, 1, (300, 1)).astype(np.float32)
    got, want = scalar_quantize_int8(v), ref_quantize(v)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert dequantize_int8(*got).tobytes() == ref_dequantize(*want).tobytes()
    q = rng.normal(size=48).astype(np.float32)
    assert quantization_error_bound(got[1], q) == ref_error_bound(want[1], q)


def _assign(vecs, nlist):
    return ref_kmeans(vecs, nlist)[1]


@pytest.mark.parametrize("with_absent", [False, True])
def test_tile_packing_byte_equal(clustered, with_absent):
    """ann_tiles against the reference's ann_tiles_device and its host loop
    (build_ann with the device build off), on the reference's assignment."""
    vecs = clustered[0]
    present = np.arange(len(vecs))
    if with_absent:
        present = present[np.random.default_rng(2).random(len(vecs)) > 0.2]
    assign = _assign(vecs[present], 20)
    C = 20
    L = ((np.bincount(assign, minlength=C).max() + 127) // 128) * 128
    got = ann_tiles(vecs, present, assign, C, L, device="cpu")
    want = ann_tiles_device(vecs, present.astype(np.int32), assign, C, L)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


def test_tile_packing_matches_host_loop(clustered, monkeypatch):
    vecs = clustered[0]
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "0")
    ref = ref_build_ann(vecs, np.ones(len(vecs), bool), 20)
    assign = _assign(vecs, 20)
    got = ann_tiles(vecs, np.arange(len(vecs)), assign, ref["nlist"], ref["tile"], device="cpu")
    for g, name in zip(got, ("order", "codes", "scale", "offset")):
        assert g.tobytes() == np.asarray(ref[name]).tobytes(), name


def test_ann_to_device_matches_reference(clustered):
    vecs = clustered[0]
    ann = ref_build_ann(vecs, np.ones(len(vecs), bool), 20)
    want = ref_ann_to_device(ann, vecs, jnp.asarray)
    got = ann_to_device(ann, vecs, "cpu")
    for name in ("hi", "lo"):
        w = np.asarray(want[name]).view(np.uint16)
        assert np.array_equal(got[name].view(torch.int16).numpy().view(np.uint16), w), name
    np.testing.assert_allclose(got["sq"].numpy(), np.asarray(want["sq"]), rtol=1e-6, atol=0)
    for name in ("centroids", "order", "codes", "scale", "offset"):
        assert got[name].numpy().tobytes() == np.asarray(want[name]).tobytes(), name


def test_kmeans_matches_reference(clustered):
    vecs = clustered[0]
    rc, ra = ref_kmeans(vecs, 20)
    pc, pa = kmeans_ivf(vecs, 20, device="cpu")
    np.testing.assert_allclose(pc, rc, rtol=1e-5, atol=1e-5 * np.abs(rc).max())
    logits = vecs @ rc.T - 0.5 * (rc * rc).sum(1)[None, :]
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4 * np.abs(top2[:, 1])
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(pa[clear], ra[clear])
    # the port's build runs this k-means: a second build gives the same bytes
    a, b = (build_ann(vecs, np.ones(len(vecs), bool), 20, device="cpu") for _ in range(2))
    for key in ("centroids", "order", "codes", "scale", "offset"):
        assert a[key].tobytes() == b[key].tobytes(), key


def _tiles(rng, C, L, D):
    """Random tiles: ~1/4 pad slots at the tile ends, dead docs, and slots
    5-8 of every tile repeating slots 1-4 (exact ties, other docids)."""
    vals = rng.normal(size=(C, L, D)).astype(np.float32)
    codes = rng.integers(-127, 128, (C, L, D)).astype(np.int8)
    scale = (rng.random((C, L)) * 0.05).astype(np.float32)
    offset = (rng.normal(size=(C, L)) * 0.1).astype(np.float32)
    for a in (vals, codes, scale, offset):
        a[:, 5:9] = a[:, 1:5]
    order = rng.permutation(C * L).astype(np.int32).reshape(C, L)
    order[np.arange(L)[None, :] >= rng.integers(L - L // 4, L + 1, (C, 1))] = -1
    hi, lo = split_bf16(torch.from_numpy(vals))
    live = (order >= 0) & (rng.random((C, L)) > 0.1)
    port = {"order": torch.from_numpy(order), "codes": torch.from_numpy(codes),
            "scale": torch.from_numpy(scale), "offset": torch.from_numpy(offset),
            "hi": hi, "lo": lo, "sq": torch.from_numpy((vals * vals).sum(-1))}
    ref = {k: jnp.asarray(v.numpy()) for k, v in port.items() if k not in ("hi", "lo")}
    ref["hi"] = jnp.asarray(hi.view(torch.int16).numpy()).view(jnp.bfloat16)
    ref["lo"] = jnp.asarray(lo.view(torch.int16).numpy()).view(jnp.bfloat16)
    ref["sq"] = jnp.asarray(port["sq"].numpy())
    return port, ref, live


def _check_against(got, want, what, exact_ties=False):
    gv, gi, gt = [np.asarray(x) for x in got]
    wv, wi, wt = [np.asarray(x) for x in want]
    np.testing.assert_array_equal(gt, wt, err_msg=what)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin, err_msg=what)
    tol = 1e-5 + 1e-5 * np.abs(wv[fin])
    assert (np.abs(gv[fin] - wv[fin]) <= tol).all(), what
    for b in range(wv.shape[0]):
        for j in np.flatnonzero(fin[b] & (gi[b] != wi[b])):
            if exact_ties:  # ids may differ only among values that are not equal bits
                assert gv[b, j] != wv[b, j] or wv[b, j] not in np.delete(wv[b], j), what
            # the port's id sits in a tie class of the reference's row, or in
            # the tie class at the row's end (ties beyond kb are not shown)
            near = np.abs(wv[b] - wv[b, j]) <= 1e-5 + 1e-5 * abs(wv[b, j])
            assert near.sum() >= 2 or abs(wv[b, j] - wv[b, -1]) <= 2e-5 * max(1, abs(wv[b, j])), what


@pytest.mark.parametrize("tier", ["int8", "bf16"])
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_twin_matches_xla_arm(tier, transform):
    rng = np.random.default_rng(11)
    for C, L, P, kb in ((12, 128, 1, 1), (12, 128, 3, 10), (6, 512, 1, 128), (6, 512, 3, 10)):
        port, ref, live = _tiles(rng, C, L, 32)
        B = 6
        q = rng.normal(size=(B, 32)).astype(np.float32)
        probes = np.stack([rng.permutation(C)[:P] for _ in range(B)]).astype(np.int32)
        got = ann_gather_scan_reference(torch.from_numpy(q), torch.from_numpy(probes), port,
                                        torch.from_numpy(live.astype(np.uint8)), kb,
                                        tier=tier, similarity=transform)
        # the public wrapper takes the twin on the CPU
        via = ann_gather_scan(torch.from_numpy(q), torch.from_numpy(probes), port,
                              torch.from_numpy(live.astype(np.uint8)), kb,
                              tier=tier, similarity=transform)
        for g, v in zip(got, via):
            assert torch.equal(g, v)
        want = ref_kernels.ann_gather_scan(jnp.asarray(q), jnp.asarray(probes), ref,
                                           jnp.asarray(live), kb, tier=tier,
                                           similarity=transform)
        _check_against(got, want, f"{tier} {transform} C={C} L={L} P={P} kb={kb}")


@pytest.mark.parametrize("tier,transform", [("int8", "cosine"), ("bf16", "max_inner_product")])
def test_twin_matches_pallas_interpret(tier, transform):
    rng = np.random.default_rng(5)
    port, ref, live = _tiles(rng, 8, 128, 32)
    B, P = 4, 3
    q = rng.normal(size=(B, 32)).astype(np.float32)
    probes = np.stack([rng.permutation(8)[:P] for _ in range(B)]).astype(np.int32)
    for kb in (10, 128):
        got = ann_gather_scan_reference(torch.from_numpy(q), torch.from_numpy(probes), port,
                                        torch.from_numpy(live.astype(np.uint8)), kb,
                                        tier=tier, similarity=transform)
        want = ref_kernels.ann_gather_scan(jnp.asarray(q), jnp.asarray(probes), ref,
                                           jnp.asarray(live), kb, tier=tier,
                                           similarity=transform, interpret=True)
        _check_against(got, want, f"interpret {tier} {transform} kb={kb}", exact_ties=True)


def test_wide_kb_takes_the_composition(clustered):
    """kb > 128 routes to the XLA arm's composition on every device."""
    rng = np.random.default_rng(9)
    port, ref, live = _tiles(rng, 6, 256, 32)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    probes = np.stack([rng.permutation(6)[:2] for _ in range(3)]).astype(np.int32)
    for tier in ("int8", "bf16"):
        got = ann_gather_scan(torch.from_numpy(q), torch.from_numpy(probes), port,
                              torch.from_numpy(live.astype(np.uint8)), 300, tier=tier,
                              similarity="cosine")
        want = ref_kernels.ann_gather_scan(jnp.asarray(q), jnp.asarray(probes), ref,
                                           jnp.asarray(live), 300, tier=tier,
                                           similarity="cosine")
        assert got[0].shape == (3, 300)
        _check_against(got, want, f"kb=300 {tier}")


def _l2_tol(scores, dsq, qsq):
    """|d s| for an l2 error of 64 ulp of |d|^2 + |q|^2: s = 1/(1 + l2)
    moves by s^2 per unit of l2."""
    return scores ** 2 * 64 * F32_EPS * (dsq + qsq) + 1e-6 * np.abs(scores)


def _rows_agree(gv, gi, wv, wi, sim, vecs, q):
    """Scores within 1e-6 relative (l2_norm: `_l2_tol`), ids up to fp-ties."""
    fin = np.isfinite(wv)
    assert np.array_equal(np.isfinite(gv), fin)
    for b in range(wv.shape[0]):
        f = fin[b]
        if sim == "l2_norm":
            tol = _l2_tol(wv[b][f], (vecs[wi[b][f]] ** 2).sum(1), (q[b] ** 2).sum())
        else:
            tol = 1e-6 * np.abs(wv[b][f])
        assert (np.abs(gv[b][f] - wv[b][f]) <= tol).all(), (sim, b)
        for j in np.flatnonzero(f & (gi[b] != wi[b])):
            assert abs(gv[b, j] - wv[b, j]) <= 1e-5 * max(abs(wv[b, j]), 1.0)


@pytest.fixture(scope="module")
def ann_index(clustered):
    vecs = clustered[0]
    built = 2900  # rows past built_n form the exact tail
    ann = ref_build_ann(vecs[:built], np.ones(built, bool), 20)
    ann["built_n"] = built
    return ann


@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("tier", ["int8", "bf16"])
def test_ann_searcher_matches_reference(clustered, ann_index, sim, tier):
    vecs, near = clustered
    sq = (vecs * vecs).sum(1)
    live = np.random.default_rng(4).random(len(vecs)) > 0.05
    ref = RefAnnSearcher(ann_index, vecs, sq, sim, tier=tier)
    port = AnnSearcher(ann_index, vecs, sq, sim, tier=tier, device="cpu")
    calls = [dict(), dict(nprobe=3), dict(num_candidates=60)]
    for kw in calls:
        gv, gi, gt = port.search(near, 10, **kw)
        wv, wi, wt = ref.search(near, 10, **kw)
        np.testing.assert_array_equal(gt, wt)
        _rows_agree(gv, gi, wv, wi, sim, vecs, near)
    # deletes through set_live
    ref.set_live(jnp.asarray(live))
    port.set_live(live)
    gv, gi, gt = port.search(near, 10)
    wv, wi, wt = ref.search(near, 10)
    np.testing.assert_array_equal(gt, wt)
    assert live[gi[np.isfinite(gv)]].all()
    _rows_agree(gv, gi, wv, wi, sim, vecs, near)
    # every partition probed: the exact top 10 of the live docs
    gv, gi, _ = port.search(near, 10, nprobe=ann_index["nlist"])
    from elasticsearch_tpu_torch.ops.vector import knn_scores

    for b, q in enumerate(near):
        s = knn_scores(torch.from_numpy(vecs), torch.from_numpy(sq), torch.from_numpy(q),
                       sim).numpy()
        s = np.where(live, s, -np.inf)
        top = np.lexsort((np.arange(len(s)), -s))[:10]
        _rows_agree(gv[b:b + 1], gi[b:b + 1], s[top][None], top[None], sim, vecs, near[b:b + 1])


@pytest.mark.parametrize("sim", ["cosine", "l2_norm"])
def test_tiered_knn_scanner_matches_reference(sim):
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(2000, 24)).astype(np.float32)
    sq = (vecs * vecs).sum(1)
    live = rng.random(2000) > 0.05
    q = rng.normal(size=(16, 24)).astype(np.float32)
    # kb = k + 1 leaves little slack: the margin test flags and escalates
    for kb, k in ((5, 4), (None, 10)):
        ref = RefTieredKnnScanner(vecs, sq, sim, live=live, kb=kb)
        port = TieredKnnScanner(vecs, sq, sim, live=live, kb=kb, device="cpu")
        gv, gi, gt, gok = port.search(q, k)
        wv, wi, wt, wok = ref.search(q, k)
        np.testing.assert_array_equal(gt, wt)
        _rows_agree(gv, gi, wv, wi, sim, vecs, q)
        if kb == 5:
            assert not gok.all() and not wok.all()


def test_tiered_knn_scanner_promotes_to_ann(clustered, ann_index):
    vecs, near = clustered
    sq = (vecs * vecs).sum(1)
    port = TieredKnnScanner(vecs, sq, "cosine", ann=ann_index, device="cpu")
    ref = RefTieredKnnScanner(vecs, sq, "cosine", ann=ann_index)
    gv, gi, gt, gok = port.search(near, 10)
    wv, wi, wt, wok = ref.search(near, 10)
    assert gok.all() and wok.all()
    np.testing.assert_array_equal(gt, wt)
    _rows_agree(gv, gi, wv, wi, "cosine", vecs, near)
