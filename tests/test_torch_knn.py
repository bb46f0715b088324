"""kNN `_search` of the port's EsIndex against the JAX package's.

The same seeded documents (clustered 16-dim vectors from bench.py C4's
generator, a keyword `tag` and a long `n`) go into the reference
`EsIndex(..., data_dir=None)` and the port's `EsIndex(device="cpu")`, with
the mapping of tests/test_ann.py: ANN on the int8 tier (`ivf`, `int8_hnsw`),
on the bf16 tier (`hnsw`) and exact (no `index_options`), every similarity.
Each side builds its own k-means partitions; the same requests are then
held against the reference with the reference pack carried across by
`convert.pack_from_reference` too, so parity does not rest on the k-means.

Tolerances: totals equal; scores within 1e-6 relative (each side sums the
f32 dots in its own order), except l2_norm, where |d|^2 - 2 q.d + |q|^2
cancels: 64 ulp of |d|^2 + |q|^2 carried through 1/(1 + l2); ids equal
except where the two scores agree within 1e-5 relative (fp-ties).
"""

import numpy as np
import pytest

from elasticsearch_tpu.engine.engine import EsIndex as RefEsIndex
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu_torch import EsIndex
from elasticsearch_tpu_torch.convert import pack_from_reference
from elasticsearch_tpu_torch.corpus import vector_corpus
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.query.executor import ShardSearcher
from elasticsearch_tpu_torch.utils.errors import (
    IllegalArgumentError,
    MapperParsingError,
    QueryParsingError,
)

N_DOCS, DIMS, NCL = 400, 16, 10
F32_EPS = 2.0 ** -24
CONFIGS = {
    "ivf_int8_l2_norm": ({"type": "ivf", "nlist": 10}, "l2_norm"),
    "ivf_bf16_cosine": ({"type": "ivf", "nlist": 10, "quantization": "bf16"}, "cosine"),
    "int8_hnsw_max_inner_product": ({"type": "int8_hnsw"}, "max_inner_product"),
    "hnsw_dot_product": ({"type": "hnsw"}, "dot_product"),
    "exact_cosine": (None, "cosine"),
    "exact_l2_norm": (None, "l2_norm"),
}
THRESHOLD = {"cosine": 0.99, "dot_product": 0.99, "l2_norm": 3.0, "max_inner_product": 200.0}


@pytest.fixture(autouse=True)
def _cold_planners():
    """Both packages' execution planners start each test cold: a planner
    warmed by an earlier test could route a batch to another arm."""
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


def _mapping(opts, sim):
    vec = {"type": "dense_vector", "dims": DIMS, "similarity": sim}
    if opts is not None:
        vec["index_options"] = opts
    return {"properties": {"vec": vec, "tag": {"type": "keyword"}, "n": {"type": "long"}}}


def _data(sim):
    vecs, near = vector_corpus(np.random.default_rng(21), N_DOCS, DIMS, NCL, 8)
    if sim == "dot_product":  # unit vectors, as dot_product asks
        vecs = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        near = near / np.linalg.norm(near, axis=1, keepdims=True)
    docs = [{"vec": [float(x) for x in v], "tag": f"t{i % 4}", "n": i} for i, v in enumerate(vecs)]
    return vecs, near, docs


_BUILT = {}


def _indexes(name):
    """(reference index, port index, vectors, near queries, docs), built once."""
    if name not in _BUILT:
        opts, sim = CONFIGS[name]
        vecs, near, docs = _data(sim)
        m = _mapping(opts, sim)
        ref = RefEsIndex("v", RefMappings(m), {}, None)
        port = EsIndex("v", m, device="cpu")
        for i, d in enumerate(docs):
            ref.index_doc(str(i), d)
            port.index_doc(str(i), d)
        ref.refresh()
        port.refresh()
        _BUILT[name] = (ref, port, vecs, near, docs)
    return _BUILT[name]


def _bodies(sim, near, qs):
    q = [[float(x) for x in v] for v in qs]
    base = {"field": "vec", "k": 5, "num_candidates": 20}
    out = []
    for i in range(len(q)):
        out.append(({**base, "query_vector": q[i]}, 10, 0))
    out += [
        ({**base, "query_vector": q[0], "filter": {"term": {"tag": "t1"}}}, 10, 0),
        ({**base, "query_vector": q[1], "filter": [{"range": {"n": {"lt": 300}}},
                                                   {"term": {"tag": "t2"}}]}, 10, 0),
        ({**base, "query_vector": q[2], "similarity": THRESHOLD[sim]}, 10, 0),
        # 15 docs pass: the oversampled ANN candidates starve, the exact rerun fills k
        ({**base, "query_vector": q[3], "filter": {"range": {"n": {"lt": 15}}}}, 10, 0),
        ([{**base, "query_vector": q[4], "k": 3}, {**base, "query_vector": q[5], "k": 4}], 10, 0),
        ({**base, "query_vector": q[6], "boost": 2.0, "nprobe": 3}, 10, 0),
        ({**base, "query_vector": q[7], "num_candidates": 50}, 3, 2),
        ({**base, "query_vector": q[0]}, 10, 4),
        ({**base, "query_vector": q[1]}, 10, 7),
    ]
    return out


def _l2_tol(scores, dsq, qsq):
    return scores ** 2 * 64 * F32_EPS * (dsq + qsq) + 1e-6 * np.abs(scores)


def _assert_hits(got, want, sim, vecs, qvecs, what):
    gh, wh = got["hits"], want["hits"]
    assert gh["total"] == wh["total"], what
    assert len(gh["hits"]) == len(wh["hits"]), what
    gs = np.array([h["_score"] for h in gh["hits"]])
    ws = np.array([h["_score"] for h in wh["hits"]])
    if sim == "l2_norm":
        ids = [int(h["_id"]) for h in wh["hits"]]
        tol = _l2_tol(ws, (vecs[ids] ** 2).sum(1), min((q ** 2).sum() for q in qvecs))
        tol = np.maximum(tol, _l2_tol(ws, (vecs[ids] ** 2).sum(1),
                                      max((q ** 2).sum() for q in qvecs)))
    else:
        tol = 1e-6 * np.abs(ws)
    assert (np.abs(gs - ws) <= tol).all(), (what, gs, ws)
    for g, w in zip(gh["hits"], wh["hits"]):
        if g["_id"] != w["_id"]:
            assert abs(g["_score"] - w["_score"]) <= 1e-5 * max(abs(w["_score"]), 1.0), what
    if wh["max_score"] is None:
        assert gh["max_score"] is None
    else:
        w = wh["max_score"]
        tol = (_l2_tol(w, (vecs ** 2).sum(1).max(), max((q ** 2).sum() for q in qvecs))
               if sim == "l2_norm" else 1e-6 * abs(w))
        assert abs(gh["max_score"] - w) <= tol, what


def _qvecs(body):
    return [np.asarray(b["query_vector"], np.float32)
            for b in (body if isinstance(body, list) else [body])]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_knn_search_matches_reference(name):
    ref, port, vecs, near, _ = _indexes(name)
    opts, sim = CONFIGS[name]
    vc = port.searcher.pack.vectors["vec"]
    assert (vc.ann is not None) == (opts is not None)
    if opts is not None:
        assert vc.ann_quant == ("bf16" if opts.get("quantization") == "bf16"
                                or opts["type"] == "hnsw" else "int8")
    n_hits = 0
    for body, size, from_ in _bodies(sim, near, near):
        want = ref.search(knn=body, size=size, from_=from_)
        got = port.search(knn=body, size=size, from_=from_)
        _assert_hits(got, want, sim, vecs, _qvecs(body), (name, size, from_, body))
        n_hits += len(got["hits"]["hits"])
    assert n_hits > 50
    # the knn query kind: no k clamp on size or total
    body = {"field": "vec", "query_vector": [float(x) for x in near[2]], "k": 5,
            "num_candidates": 12}
    _assert_hits(port.search(query={"knn": body}, size=20),
                 ref.search(query={"knn": body}, size=20), sim, vecs, _qvecs(body), "query")


def test_index_setting_nprobe_applies():
    ref, port, vecs, near, _ = _indexes("ivf_int8_l2_norm")
    body = {"field": "vec", "query_vector": [float(x) for x in near[3]], "k": 5,
            "num_candidates": 20}
    port.settings["knn.nprobe"] = 1
    try:
        got = port.search(knn=body)
    finally:
        del port.settings["knn.nprobe"]
    want = ref.search(knn={**body, "nprobe": 1})
    _assert_hits(got, want, "l2_norm", vecs, _qvecs(body), "knn.nprobe")


@pytest.mark.parametrize("name", ["ivf_int8_l2_norm", "hnsw_dot_product"])
def test_converted_reference_pack_searches_the_same(name):
    """The reference's own partitions, carried across by convert, answer as
    the reference does."""
    ref, _, vecs, near, docs = _indexes(name)
    opts, sim = CONFIGS[name]
    m = RefMappings(_mapping(opts, sim))
    b = RefPackBuilder(m)
    b.add_documents_batch([m.parse_document(d) for d in docs],
                          doc_ids=[str(i) for i in range(len(docs))])
    ref_pack = b.build()
    pack = pack_from_reference(ref_pack)
    rvc, pvc = ref_pack.vectors["vec"], pack.vectors["vec"]
    for key in ("centroids", "order", "codes", "scale", "offset"):
        assert pvc.ann[key].tobytes() == np.asarray(rvc.ann[key]).tobytes(), key
    assert pvc.values.tobytes() == rvc.values.tobytes()
    port = EsIndex("v", _mapping(opts, sim), device="cpu")
    port._searcher = ShardSearcher(pack, device="cpu", mappings=port.mappings)
    port._hits_src = [(str(i), d) for i, d in enumerate(docs)]
    for body, size, from_ in _bodies(sim, near, near):
        want = ref.search(knn=body, size=size, from_=from_)
        got = port.search(knn=body, size=size, from_=from_)
        _assert_hits(got, want, sim, vecs, _qvecs(body), (name, "converted", body))


def test_pack_vectors_match_reference():
    _, port, _, _, docs = _indexes("exact_cosine")
    m = RefMappings(_mapping(None, "cosine"))
    b = RefPackBuilder(m)
    b.add_documents_batch([m.parse_document(d) for d in docs[:50] + [{"tag": "x"}]])
    ref = b.build().vectors["vec"]
    pm = Mappings(_mapping(None, "cosine"))
    from elasticsearch_tpu_torch.index.pack import PackBuilder

    pb = PackBuilder(pm)
    pb.add_documents_batch([pm.parse_document(d) for d in docs[:50] + [{"tag": "x"}]])
    pack = pb.build(device="cpu")
    got = pack.vectors["vec"]
    assert got.values.tobytes() == ref.values.tobytes()
    assert got.has_value.tobytes() == ref.has_value.tobytes()
    assert (got.similarity, got.dims, got.ann, got.ann_quant) == (
        ref.similarity, ref.dims, ref.ann, ref.ann_quant)
    assert pack.nbytes() > 51 * DIMS * 4


@pytest.mark.parametrize("opts,quant", [
    ({"type": "hnsw"}, "bf16"), ({"type": "int8_hnsw"}, "int8"),
    ({"type": "int4_hnsw", "nlist": 7}, "int8"), ({"type": "ivf", "quantization": "bf16"}, "bf16"),
    ({"type": "flat"}, None),
])
def test_index_options_map_as_reference(opts, quant):
    m = {"properties": {"v": {"type": "dense_vector", "dims": 4, "index_options": opts}}}
    ft, rft = Mappings(m).fields["v"], RefMappings(m).fields["v"]
    assert (ft.ann_nlist, ft.ann_quant if quant else None) == (
        rft.ann_nlist, rft.ann_quant if quant else None)
    assert ft.ann_quant == (quant or "int8")


@pytest.mark.parametrize("mapping,match", [
    ({"v": {"type": "dense_vector"}}, "requires \\[dims\\]"),
    ({"v": {"type": "dense_vector", "dims": 4,
            "index_options": {"type": "ivf", "quantization": "fp8"}}}, "int8\\|bf16"),
])
def test_mapping_errors_match_reference(mapping, match):
    m = {"properties": mapping}
    with pytest.raises(MapperParsingError, match=match) as ours:
        Mappings(m)
    with pytest.raises(Exception) as theirs:
        RefMappings(m)
    assert str(ours.value) == str(theirs.value)


def test_knn_errors():
    _, port, _, near, _ = _indexes("ivf_int8_l2_norm")
    q = [float(x) for x in near[0]]
    with pytest.raises(IllegalArgumentError, match="has 3 dims, field \\[vec\\] has 16"):
        port.search(knn={"field": "vec", "query_vector": [1.0, 2.0, 3.0], "k": 2})
    with pytest.raises(QueryParsingError, match="num_candidates >= k"):
        port.search(knn={"field": "vec", "query_vector": q, "k": 5, "num_candidates": 3})
    with pytest.raises(QueryParsingError, match="requires \\[field\\]"):
        port.search(knn={"query_vector": q})
    # knn with a query (once refused): the reference's hybrid answer
    ref = _indexes("ivf_int8_l2_norm")[0]
    knn = {"field": "vec", "query_vector": q, "k": 2}
    hyb = port.search(query={"match_all": {}}, knn=knn, size=5)
    _assert_hits(hyb, ref.search(query={"match_all": {}}, knn=knn, size=5), "l2_norm",
                 _indexes("ivf_int8_l2_norm")[2], [np.asarray(q, np.float32)], "hybrid")
    assert hyb["hits"]["total"]["value"] == N_DOCS
    # a knn body in msearch (once refused) answers as search does
    out = port.msearch([{"knn": knn}])
    assert out["responses"][0].pop("status") == 200
    assert out["responses"][0] == port.search(knn=knn)
    with pytest.raises(MapperParsingError, match="has 2 dims, mapping says 16"):
        port.index_doc("bad", {"vec": [1.0, 2.0]})
    with pytest.raises(MapperParsingError, match="expects numbers"):
        port.index_doc("bad", {"vec": ["a"] * 16})
    assert "bad" not in port._docs


def test_entry_points_take_the_card_by_default():
    import torch

    from elasticsearch_tpu_torch.ann import AnnSearcher

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    vecs, _ = vector_corpus(np.random.default_rng(0), 200, 8, 4)
    from elasticsearch_tpu_torch.ann import build_ann

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ann(vecs, np.ones(200, bool), 4)
    ann = build_ann(vecs, np.ones(200, bool), 4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnnSearcher(ann, vecs, (vecs * vecs).sum(1), "cosine")
