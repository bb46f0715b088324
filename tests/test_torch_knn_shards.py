"""kNN on indices of several shards, and the hybrid `knn` + `query` search,
of the port against the JAX package's.

The same seeded documents (clustered 16-dim vectors from bench.py C4's
generator, a text `body` of Zipf words, a keyword `tag` and a long `n`) go
into the reference's `StackedSearcher(mesh=None)` / `Engine(None)` indices
and the port's `device="cpu"` ones, routed by murmur3 at S in {1, 4}, with
the ANN index on the int8 tier (`int8_hnsw`, `ivf`) and exact. Each side
builds its own k-means partitions; the stacking itself is held byte for
byte by carrying the reference's shard packs across and stacking them in
the port (`convert.stacked_pack_from_reference`).

The reference scores the text part of a hybrid search from its impact
tier (ES_TPU_IMPACT=force), as the port does.

Tolerances: totals equal; scores within 1e-6 relative (l2_norm: 64 ulp of
|d|^2 + |q|^2 carried through 1/(1 + l2), its cancellation); ids equal
except where the two scores agree within 1e-5 relative (fp-ties).
"""

import numpy as np
import pytest

from elasticsearch_tpu.engine.engine import Engine as RefEngine
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.parallel import sharded as ref_sharded
from elasticsearch_tpu.parallel import stacked as ref_stacked
from elasticsearch_tpu_torch.convert import stacked_pack_from_reference
from elasticsearch_tpu_torch.corpus import vector_corpus
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.parallel import sharded, stacked

D, NCL = 16, 10
F32_EPS = 2.0 ** -24
WORDS = [f"w{i}" for i in range(30)]
CONFIGS = {
    "int8_hnsw_cosine": ({"type": "int8_hnsw"}, "cosine"),
    "ivf_l2_norm": ({"type": "ivf", "nlist": 8}, "l2_norm"),
    "exact_cosine": (None, "cosine"),
}


@pytest.fixture(autouse=True)
def _cold_planners_and_impact(monkeypatch):
    """Both planners start each test cold; the reference's text part
    scores from its impact tier, as the port's does."""
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


def _mapping(opts, sim):
    vec = {"type": "dense_vector", "dims": D, "similarity": sim}
    if opts is not None:
        vec["index_options"] = opts
    return {"properties": {"vec": vec, "body": {"type": "text"}, "tag": {"type": "keyword"},
                           "n": {"type": "long"}}}


def _docs(n: int, seed: int = 21):
    vecs, near = vector_corpus(np.random.default_rng(seed), n, D, NCL, 12)
    rng = np.random.default_rng(seed + 1)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    docs = [(f"d{i}", {"vec": [float(x) for x in v],
                       "body": " ".join(rng.choice(WORDS, size=5, p=p / p.sum())),
                       "tag": f"t{i % 4}", "n": i})
            for i, v in enumerate(vecs)]
    return vecs, near, docs


def _l2_tol(scores, sq):
    return np.abs(scores) ** 2 * 64 * F32_EPS * sq + 1e-6 * np.abs(scores)


def _same_hits(got, want, what, l2_sq=None):
    """Totals equal, scores within 1e-6 relative (or the l2 allowance for
    `l2_sq` = the largest |d|^2 + |q|^2), ids equal up to fp-ties."""
    gh, wh = got["hits"], want["hits"]
    assert gh.get("total") == wh.get("total"), what
    assert len(gh["hits"]) == len(wh["hits"]), what
    gs = np.array([h["_score"] for h in gh["hits"]])
    ws = np.array([h["_score"] for h in wh["hits"]])
    tol = _l2_tol(ws, l2_sq) if l2_sq is not None else 1e-6 * np.abs(ws)
    assert (np.abs(gs - ws) <= tol).all(), (what, gs, ws)
    for g, w in zip(gh["hits"], wh["hits"]):
        if g["_id"] != w["_id"]:
            assert abs(g["_score"] - w["_score"]) <= max(1e-5 * abs(w["_score"]),
                                                         float(np.max(tol, initial=0))), what
        else:
            assert g["_source"] == w["_source"], what


_BUILT: dict = {}


def _pair(name: str, S: int, n: int = 1600):
    """(reference index, port index, vectors, near queries), built once."""
    key = (name, S, n)
    if key not in _BUILT:
        opts, sim = CONFIGS[name]
        vecs, near, docs = _docs(n)
        m = _mapping(opts, sim)
        ref = RefEngine(None).create_index("v", m, {"number_of_shards": S,
                                                    "refresh_interval": "-1"})
        port = Engine(device="cpu").create_index("v", m, {"number_of_shards": S,
                                                          "refresh_interval": "-1"})
        for doc_id, d in docs:
            ref.index_doc(doc_id, d)
            port.index_doc(doc_id, d)
        ref.refresh()
        port.refresh()
        _BUILT[key] = (ref, port, vecs, near)
    return _BUILT[key]


def _l2_sq(name, vecs, near):
    if CONFIGS[name][1] != "l2_norm":
        return None
    return float((vecs ** 2).sum(1).max() + (near ** 2).sum(1).max())


def _bodies(near, nlist=None):
    q = [[float(x) for x in v] for v in near]
    base = {"field": "vec", "k": 5, "num_candidates": 20}
    out = [({**base, "query_vector": q[i]}, 10, 0) for i in range(6)]
    out += [
        ({**base, "query_vector": q[6], "filter": {"term": {"tag": "t1"}}}, 10, 0),
        ({**base, "query_vector": q[7], "filter": {"range": {"n": {"lt": 30}}}}, 10, 0),
        ([{**base, "query_vector": q[8], "k": 3}, {**base, "query_vector": q[9], "k": 4}], 10, 0),
        ({**base, "query_vector": q[10], "boost": 2.0}, 3, 2),
        ({**base, "query_vector": q[11]}, 10, 4),
    ]
    if nlist is not None:
        out += [({**b, "nprobe": nlist} if isinstance(b, dict) else b, size, from_)
                for b, size, from_ in out[:6]]
    return out


@pytest.mark.parametrize("name", ["int8_hnsw_cosine", "ivf_l2_norm"])
def test_stacked_vectors_and_ann_byte_equal(name):
    """The port stacks the reference's own shard packs into the bytes of
    the reference's stacked vectors and stacked ANN (pad centroids 1e6,
    pad order -1, pad codes/scale/offset 0, the widest (C, L)); the port's
    own build of the same docs has equal assignments, so equal tiles."""
    opts, sim = CONFIGS[name]
    _, _, docs = _docs(1600)
    rsp = ref_stacked.build_stacked_pack(docs, RefMappings(_mapping(opts, sim)), 4)
    psp = stacked.build_stacked_pack(docs, Mappings(_mapping(opts, sim)), 4, device="cpu")
    rvc = rsp.vectors["vec"]
    cp = stacked_pack_from_reference(rsp, _mapping(opts, sim))  # raises unless byte-equal
    shapes = {s.vectors["vec"].ann["order"].shape for s in rsp.shards}
    assert len(shapes) > 1, "the shards should differ in (C, L) so that padding shows"
    for vc in (cp.vectors["vec"], psp.vectors["vec"]):
        assert vc.values.tobytes() == np.asarray(rvc.values).tobytes()
        assert vc.has_value.tobytes() == np.asarray(rvc.has_value).tobytes()
        assert (vc.similarity, vc.dims, vc.ann_quant) == (rvc.similarity, rvc.dims,
                                                          rvc.ann_quant)
        for key in ("order", "codes", "scale", "offset", "nlist", "tile", "built_n"):
            assert np.asarray(vc.ann[key]).tobytes() == np.asarray(rvc.ann[key]).tobytes(), key
    np.testing.assert_allclose(psp.vectors["vec"].ann["centroids"], rvc.ann["centroids"],
                               rtol=1e-5, atol=1e-5)
    C, L = rvc.ann["nlist"], rvc.ann["tile"]
    assert psp.nbytes() > 4 * C * L * D * 5  # the int8 tiles and the bf16 pair
    # a shard that differs from the source's stack is refused
    bad = {"shards": rsp.shards, "global_df": rsp.global_df, "field_stats": rsp.field_stats,
           "dense_dict": rsp.dense_dict,
           "vectors": {"vec": {"values": rvc.values, "has_value": rvc.has_value,
                               "ann": {**rvc.ann, "tile": L + 128}}}}
    with pytest.raises(ValueError, match="tile"):
        stacked_pack_from_reference(bad, _mapping(opts, sim))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_knn_matches_reference(name):
    """4 shards: kNN `_search` (filters, two sections, pages, boost; and at
    nprobe = nlist on the ANN configs) equal to the reference's."""
    ref, port, vecs, near = _pair(name, 4)
    sp = port.searcher.sp
    ann = sp.vectors["vec"].ann
    assert (ann is not None) == (CONFIGS[name][0] is not None)
    n_hits = 0
    for body, size, from_ in _bodies(near, ann["nlist"] if ann else None):
        want = ref.search(knn=body, size=size, from_=from_)
        got = port.search(knn=body, size=size, from_=from_)
        _same_hits(got, want, (name, body if isinstance(body, list) else body.get("nprobe")),
                   _l2_sq(name, vecs, near))
        n_hits += len(got["hits"]["hits"])
    assert n_hits > 45


def test_converted_stack_searches_as_the_reference():
    """The reference's own shard packs carried across answer its
    StackedSearcher's kNN rows, so parity does not rest on the k-means."""
    _, near, docs = _docs(1600)
    m = _mapping(*CONFIGS["int8_hnsw_cosine"])
    rsp = ref_stacked.build_stacked_pack(docs, RefMappings(m), 4)
    rs = ref_sharded.StackedSearcher(rsp, mesh=None)
    ps = sharded.StackedSearcher(stacked_pack_from_reference(rsp, m), device="cpu")
    for body, size, from_ in _bodies(near, rsp.vectors["vec"].ann["nlist"]):
        if isinstance(body, list):
            continue
        want = rs.search({"knn": body}, size=size, from_=from_)
        got = ps.search({"knn": body}, size=size, from_=from_)
        assert got.total == want.total
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6)
        same = (got.doc_shards == want.doc_shards) & (got.doc_ids == want.doc_ids)
        assert (same | np.isclose(got.scores, want.scores, rtol=1e-5)).all()


@pytest.mark.parametrize("S", [1, 4])
def test_hybrid_matches_reference(S):
    """`knn` with `query`: each section's global top k joins the query as
    a pinned should clause; scores equal the reference's, and each hit's
    score minus its text-only score is 0 or its knn score."""
    ref, port, vecs, near = _pair("int8_hnsw_cosine", S)
    q = [[float(x) for x in v] for v in near]
    texts = [{"match": {"body": "w1 w4"}}, {"match": {"body": "w2"}},
             {"bool": {"must": [{"match": {"body": "w0"}}],
                       "filter": [{"range": {"n": {"lt": 800}}}]}}, {"match_all": {}}]
    n_boosted = 0
    for j, text in enumerate(texts):
        knn = {"field": "vec", "query_vector": q[j], "k": 4, "num_candidates": 20}
        for size, from_ in ((10, 0), (5, 3), (40, 0)):
            want = ref.search(query=text, knn=knn, size=size, from_=from_)
            got = port.search(query=text, knn=knn, size=size, from_=from_)
            _same_hits(got, want, (S, text, size))
        both = port.search(query=text, knn=[knn, {**knn, "query_vector": q[j + 4], "k": 2}],
                           size=40)
        _same_hits(both, ref.search(query=text, knn=[knn, {**knn, "query_vector": q[j + 4],
                                                           "k": 2}], size=40), (S, text, "2"))
        hyb = port.search(query=text, knn=knn, size=2000)["hits"]["hits"]
        text_only = {h["_id"]: h["_score"] for h in port.search(query=text, size=2000)
                     ["hits"]["hits"]}
        knn_only = {h["_id"]: h["_score"] for h in port.search(knn=knn)["hits"]["hits"]}
        for h in hyb:
            extra = h["_score"] - text_only.get(h["_id"], 0.0)
            if h["_id"] in knn_only:
                n_boosted += 1
                assert abs(extra - knn_only[h["_id"]]) <= 1e-5 * h["_score"]
            else:
                assert abs(extra) <= 1e-6 * h["_score"]
    assert n_boosted >= 4 * len(texts)


def test_knn_plans_once_per_request_on_shards():
    """On 4 shards the execution planner sees one nprobe decision and one
    tier event per kNN request, and every shard takes the same plan."""
    from elasticsearch_tpu_torch.planner import execution_planner
    from elasticsearch_tpu_torch.query.dsl import parse_knn
    from elasticsearch_tpu_torch.telemetry import collect_profile_events

    _, port, _, near = _pair("int8_hnsw_cosine", 4)
    ss = port.searcher
    vc = ss.sp.vectors["vec"]
    pl = execution_planner()
    fields = {"queries": 1, "dims": D, "tile": vc.ann["tile"], "nprobe": 2,
              "scan_tier": vc.ann_quant}
    pl.observe("ann.gather_scan", fields, 1e-3, {"mfu": 0.5})
    pl.configure(knn_target_ms=60_000.0)  # advise nprobe = nlist
    body = {"field": "vec", "query_vector": [float(x) for x in near[0]], "k": 5,
            "num_candidates": 20}
    before = pl.stats()["knobs"]["nprobe_adjustments"]
    with collect_profile_events() as events:
        node = parse_knn(body, port.mappings)
        res = ss.search(node, size=5)
    assert pl.stats()["knobs"]["nprobe_adjustments"] - before == 1
    tiers = [e for e in events if e.get("kind") == "tier"]
    assert len(tiers) == 1 and tiers[0]["nprobe"] == vc.ann["nlist"]
    assert node._ann[0] == vc.ann["nlist"]
    # the advised full probe equals an explicit nprobe = nlist
    pl.configure(knn_target_ms=0.0)
    full = ss.search(parse_knn({**body, "nprobe": vc.ann["nlist"]}, port.mappings), size=5)
    assert (res.doc_ids == full.doc_ids).all() and (res.scores == full.scores).all()


# ---- the reference's own cases ---------------------------------------------


def test_sharded_equals_single():
    """tests/test_vector.py:75: 8 shards of 120 exact cosine vectors give
    the top 10 of the exact scores, as on one shard."""
    vecs, _ = vector_corpus(np.random.default_rng(2), 120, D, 4)
    m = {"properties": {"v": {"type": "dense_vector", "dims": D, "similarity": "cosine"}}}
    docs = [(f"d{i}", {"v": [float(x) for x in row]}) for i, row in enumerate(vecs)]
    q = vector_corpus(np.random.default_rng(7), 1, D, 1)[0][0]
    body = {"knn": {"field": "v", "query_vector": q.tolist(), "k": 10, "num_candidates": 10}}
    r8 = sharded.StackedSearcher(stacked.build_stacked_pack(docs, Mappings(m), 8),
                                 device="cpu").search(body, size=10)
    rs = ref_sharded.StackedSearcher(ref_stacked.build_stacked_pack(docs, RefMappings(m), 8),
                                     mesh=None).search(body, size=10)
    expected = vecs @ q / np.linalg.norm(vecs, axis=1) / np.linalg.norm(q)
    np.testing.assert_allclose(np.sort(r8.scores)[::-1],
                               np.sort((1 + expected) / 2)[::-1][:10], rtol=1e-5)
    np.testing.assert_allclose(r8.scores, rs.scores, rtol=1e-6)
    assert r8.total == rs.total  # each shard matches its own top num_candidates


def test_query_union_through_engine():
    """tests/test_vector.py:90: knn alone, then query + knn where doc 3
    matches both and ranks first."""
    m = {"properties": {"text": {"type": "text"},
                        "emb": {"type": "dense_vector", "dims": 4, "similarity": "dot_product"}}}
    for S in (1, 2):
        ref = RefEngine(None).create_index("kb", m, {"refresh_interval": "-1",
                                                     "number_of_shards": S})
        port = Engine(device="cpu").create_index("kb", m, {"refresh_interval": "-1",
                                                           "number_of_shards": S})
        for idx in (ref, port):
            idx.index_doc("1", {"text": "apple pie recipe", "emb": [1, 0, 0, 0]})
            idx.index_doc("2", {"text": "banana bread", "emb": [0, 1, 0, 0]})
            idx.index_doc("3", {"text": "apple tart", "emb": [0, 0, 1, 0]})
            idx.refresh()
        res = port.search(knn={"field": "emb", "query_vector": [1, 0, 0, 0], "k": 1})
        assert [h["_id"] for h in res["hits"]["hits"]] == ["1"]
        kw = dict(query={"match": {"text": "apple"}},
                  knn={"field": "emb", "query_vector": [0, 0, 1, 0], "k": 1})
        res = port.search(**kw)
        ids = [h["_id"] for h in res["hits"]["hits"]]
        assert ids[0] == "3" and set(ids) == {"1", "3"}
        _same_hits(res, ref.search(**kw), S)


def test_k_caps_hits_on_several_shards():
    """tests/test_vector.py:151: knn alone on 2 shards caps the hits and
    the total at k."""
    m = {"properties": {"v": {"type": "dense_vector", "dims": 2, "similarity": "l2_norm"}}}
    idx = Engine(device="cpu").create_index("caps", m, {"number_of_shards": 2,
                                                        "refresh_interval": "-1"})
    for i in range(10):
        idx.index_doc(f"d{i}", {"v": [float(i), 0.0]})
    idx.refresh()
    assert len(idx.searcher.sp.shards) == 2 and all(p.num_docs for p in idx.searcher.sp.shards)
    res = idx.search(knn={"field": "v", "query_vector": [0.0, 0.0], "k": 2})
    assert len(res["hits"]["hits"]) == 2
    assert res["hits"]["total"]["value"] == 2
    assert [h["_id"] for h in res["hits"]["hits"]] == ["d0", "d1"]


def test_hybrid_global_k_across_four_shards():
    """tests/test_vector.py:196: only the single global nearest doc gets a
    knn contribution, not each shard's nearest."""
    m = {"properties": {"text": {"type": "text"},
                        "v": {"type": "dense_vector", "dims": 2, "similarity": "l2_norm"}}}
    idx = Engine(device="cpu").create_index("hyb", m, {"number_of_shards": 4,
                                                       "refresh_interval": "-1"})
    for i in range(12):
        idx.index_doc(f"d{i}", {"text": "common token", "v": [float(i), 0.0]})
    idx.refresh()
    res = idx.search(query={"match": {"text": "common"}},
                     knn={"field": "v", "query_vector": [0.0, 0.0], "k": 1}, size=12)
    assert res["hits"]["total"]["value"] == 12
    hits = {h["_id"]: h["_score"] for h in res["hits"]["hits"]}
    base = {h["_id"]: h["_score"]
            for h in idx.search(query={"match": {"text": "common"}}, size=12)["hits"]["hits"]}
    assert [i for i in hits if hits[i] - base[i] > 1e-6] == ["d0"]


def test_shard_without_vectors_keeps_the_similarity():
    """tests/test_vector.py:230: 3 docs on 8 shards, most shards without a
    vector: the l2_norm scores of every doc, as the reference gives them."""
    vecs = [[3.0, 0.0], [0.0, 4.0], [1.0, 1.0]]
    m = {"properties": {"v": {"type": "dense_vector", "dims": 2, "similarity": "l2_norm"},
                        "k": {"type": "keyword"}}}
    docs = [(f"d{i}", {"v": v, "k": "x"}) for i, v in enumerate(vecs)]
    sp = stacked.build_stacked_pack(docs, Mappings(m), 8)
    assert sum(1 for p in sp.shards if p.vectors) < 8
    body = {"knn": {"field": "v", "query_vector": [3.0, 0.0], "k": 3}}
    got = sharded.StackedSearcher(sp, device="cpu").search(body, size=3)
    want = ref_sharded.StackedSearcher(ref_stacked.build_stacked_pack(docs, RefMappings(m), 8),
                                       mesh=None).search(body, size=3)
    exp = 1.0 / (1.0 + ((np.array(vecs) - [3.0, 0.0]) ** 2).sum(1))
    np.testing.assert_allclose(got.scores, np.sort(exp)[::-1], rtol=1e-5)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert (list(got.doc_shards), list(got.doc_ids)) == (list(want.doc_shards),
                                                         list(want.doc_ids))
