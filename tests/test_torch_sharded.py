"""Multi-shard indices: the port's `parallel/` and sharded `EsIndex` against
the JAX package's on the same documents.

Both packages build their stacked packs from the same seeded documents (a
Zipf vocabulary of 300 terms with a keyword, a long and a float field),
routed by murmur3 of the ids, at S in {1, 3, 4}; the fused arm gets its own
corpus of 9,000 docs on 2 shards (its shards need >= 4,096 docs). The
reference runs with `mesh=None` (its single-device vmap route).

Tolerances:
  - routing, global statistics, dense keys, stacked arrays, docvalues and
    impact codes are byte-equal;
  - the device-derived dense tier within 2 ulps: the same f32 operations,
    but XLA on the CPU contracts the tf + k1·y of the denominator into an
    FMA and divides within 1 ulp; the port rounds each operation;
  - the merge is byte-equal to `_merge_shard_rows`, ties across shards and
    -inf tails included;
  - rows of `_search` and of the msearch arms: totals equal, scores within
    1e-6 relative, (shard, id) equal up to fp-ties (1e-5 relative).
"""


import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster import routing as ref_routing
from elasticsearch_tpu.engine.engine import EsIndex as RefEsIndex
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.parallel import sharded as ref_sharded
from elasticsearch_tpu.parallel import stacked as ref_stacked
from elasticsearch_tpu_torch import EsIndex
from elasticsearch_tpu_torch.cluster import routing
from elasticsearch_tpu_torch.convert import stacked_pack_from_reference
from elasticsearch_tpu_torch.corpus import (
    c5_corpus, c5_shard_docs, corpus_docs, doc_texts, make_corpus, sample_queries, traffic)
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.parallel import sharded, stacked
from elasticsearch_tpu_torch.parallel.spmd import merge_topk_rows
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.query.executor import ShardSearcher
from elasticsearch_tpu_torch.query.nodes import BoolNode, ConstantScoreNode, TermNode, mark_exact
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"},
                          "tag": {"type": "keyword"}, "price": {"type": "float"}}}
TAGS = ["red", "green", "blue", "grün", "青", "紅色", "x-1"]
N_DOCS, VOCAB = 2400, 300
SHARDS = (1, 3, 4)


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


def _impact(mp, mode):
    mp.setenv("ES_TPU_IMPACT", mode)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(41)
    lens, tok, nums = make_corpus(rng, N_DOCS, vocab=VOCAB, mean_len=12)
    docs = []
    for i, d in enumerate(corpus_docs(lens, tok, nums, vocab=VOCAB)):
        d = dict(d, tag=TAGS[int(rng.integers(0, len(TAGS)))],
                 price=float(np.round(rng.random() * 100, 2)))
        docs.append((f"doc-{i}" if i % 3 else f"文書{i}", d))
    return rng, lens, tok, docs


_STACKS: dict = {}


@pytest.fixture(scope="module")
def stacks(corpus):
    """S -> (reference searcher, port searcher), built at first use."""
    _, _, _, docs = corpus

    def get(S):
        if S not in _STACKS:
            mp = pytest.MonkeyPatch()
            _impact(mp, "0")
            try:
                rsp = ref_stacked.build_stacked_pack(docs, RefMappings(MAPPING), S)
                rs = ref_sharded.StackedSearcher(rsp, mesh=None)
            finally:
                mp.undo()
            psp = stacked.build_stacked_pack(docs, Mappings(MAPPING), S)
            _STACKS[S] = (rs, sharded.StackedSearcher(psp, device="cpu"))
        return _STACKS[S]

    yield get
    _STACKS.clear()


def test_routing_byte_equal():
    ids = ([f"doc-{i}" for i in range(300)] + [str(i) for i in range(300)]
           + ["", "a", "ab", "abc", "abcd", "abcde", "é", "ünïcödé", "文書", "日本語のID",
              "😀", "mixed-Ω-文-😀", "x" * 257])
    for S in (1, 2, 3, 4, 5, 8, 16, 1024, 1500):
        assert routing.default_routing_num_shards(S) == ref_routing.default_routing_num_shards(S)
        for d in ids:
            assert routing.shard_for_id(d, S) == ref_routing.shard_for_id(d, S), (d, S)
    for d in ids:
        b = d.encode("utf-16-le")
        assert routing.murmur3_32(b) == ref_routing.murmur3_32(b)
        assert routing.murmur3_32(b, 7) == ref_routing.murmur3_32(b, 7)
    assert routing.shard_for_id("abc", 4, 64) == ref_routing.shard_for_id("abc", 4, 64)
    with pytest.raises(ValueError):
        routing.shard_for_id("abc", 3, 64)
    docs = [(d, {"i": i}) for i, d in enumerate(ids)]
    for S in (1, 3, 4):
        assert stacked.route_docs(docs, S) == ref_stacked.route_docs(docs, S)


@pytest.mark.parametrize("S", [1, 2, 3, 8, 5, 1024, 1500])
def test_batch_routing_equals_reference(S):
    """`shards_for_ids` (each UTF-16 length hashed as one numpy array) places
    every id where the reference's per-id murmur3 does."""
    rng = np.random.default_rng(S)
    alphabet = list("ab0-Ω文é") + ["😀"]
    ids = ([str(i) for i in range(3000)] + ["", "x" * 257, "😀", "mixed-Ω-文-😀"]
           + ["".join(rng.choice(alphabet, int(rng.integers(0, 24)))) for _ in range(500)])
    got = routing.shards_for_ids(ids, S)
    assert got.dtype == np.int64
    assert got.tolist() == [ref_routing.shard_for_id(d, S) for d in ids]


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("S", SHARDS)
def test_stacked_pack_byte_equal(stacks, S):
    rs, ps = stacks(S)
    r, p = rs.sp, ps.sp
    assert (p.S, p.n_max, p.nb_max) == (r.S, r.n_max, r.nb_max)
    assert p.field_stats == r.field_stats and p.global_df == r.global_df
    assert p.dense_dict == r.dense_dict and p.dense_fields == r.dense_fields and p.dense_v > 0
    _equal(p.dense_tf, r.dense_tf, "dense_tf")
    for name in ("post_docids", "post_tfs", "post_dls", "live", "impact_row_scale_inv",
                 "impact_row_field"):
        _equal(getattr(p, name), getattr(r, name), name)
    assert p.impact_meta == r.impact_meta and p.impact_fields == r.impact_fields
    for name in ("norms", "text_present"):
        assert getattr(p, name).keys() == getattr(r, name).keys()
        for f in getattr(p, name):
            _equal(getattr(p, name)[f], getattr(r, name)[f], f"{name}[{f}]")
    assert p.global_docvalues.keys() == r.global_docvalues.keys() == {"_id", "n", "tag", "price"}
    for f, col in p.global_docvalues.items():
        rc = r.global_docvalues[f]
        assert col.kind == rc.kind and col.ord_terms == rc.ord_terms, f
        _equal(col.values, rc.values, f"docvalues[{f}]")
        _equal(col.has_value, rc.has_value, f"has_value[{f}]")
    # the device-derived tiers
    codes = ps.dev["impact_codes"].view(torch.int16).numpy().view(np.uint16)
    _equal(codes, np.asarray(rs.dev["impact_codes"]), "impact_codes")
    got, want = ps.dev["dense_tfn"].numpy(), np.asarray(rs.dev["dense_tfn"])
    assert got.shape == want.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 2 and (got >= 0).all()
    # a reference stack carried across equals the one built here
    cp = stacked_pack_from_reference(r, MAPPING)
    for name in ("post_docids", "post_tfs", "post_dls", "live", "impact_row_scale_inv"):
        _equal(getattr(cp, name), getattr(p, name), f"converted {name}")
    assert cp.dense_dict == p.dense_dict and cp.global_df == p.global_df
    _equal(cp.dense_tf, p.dense_tf, "converted dense_tf")


def _ref_rows(rng, S, Q, kk, n_max):
    """Per-shard rows as the partials give them: (score desc, id asc) over
    finite lanes, scores from a small set so ties cross shards, then -inf
    lanes whose ids follow no order."""
    v = np.full((S, Q, kk), -np.inf, np.float32)
    i = rng.integers(0, n_max, size=(S, Q, kk)).astype(np.int32)
    t = rng.integers(0, 50, size=(S, Q)).astype(np.int32)
    levels = np.array([3.5, 2.25, 2.25000024, 1.0, 0.5], np.float32)
    for s in range(S):
        for q in range(Q):
            m = int(rng.integers(0, kk + 1))
            vals = np.sort(rng.choice(levels, size=m))[::-1]
            ids = rng.choice(n_max, size=m, replace=False).astype(np.int32)
            order = np.lexsort((ids, -vals))
            v[s, q, :m] = vals[order]
            i[s, q, :m] = ids[order]
    return v, i, t


@pytest.mark.parametrize("S,Q,kk", [(1, 5, 4), (3, 17, 10), (4, 9, 1), (8, 33, 25)])
def test_merge_byte_equal(S, Q, kk):
    rng = np.random.default_rng(S * 100 + kk)
    v, i, t = _ref_rows(rng, S, Q, kk, 40)
    want = ref_sharded._merge_shard_rows(v, i, t)
    got = merge_topk_rows(*(torch.from_numpy(x) for x in (v, i, t)))
    for name, g, w in zip(("scores", "shards", "ids", "totals"), got, want):
        _equal(g.numpy(), w.astype(g.numpy().dtype) if name == "totals" else w, name)


def _rows_close(got, want, what, rtol=1e-6):
    """(scores [Q, k], shard, id, totals) rows: totals equal, finite lanes
    alike, scores within rtol, (shard, id) equal up to fp-ties."""
    gv, gs, gi, gt = (np.asarray(x) for x in got)
    wv, ws, wi, wt = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gt, wt, err_msg=what)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin, err_msg=what)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=rtol, atol=0, err_msg=what)
    swapped = fin & ((gs != ws) | (gi != wi))
    gap = np.abs(gv[swapped] - wv[swapped])
    assert (gap <= 1e-5 * np.maximum(np.abs(wv[swapped]), 1.0)).all(), what


def _requests(rng, lens, tok):
    qs = traffic(rng, lens, tok, 6, 3, 3)
    qs += [
        {"term": {"tag": "grün"}}, {"terms": {"tag": ["red", "青", "none"]}},
        {"term": {"n": 5}}, {"range": {"price": {"gte": 20.5, "lt": 60}}},
        {"bool": {"must": {"match": {"body": "t1 t7"}}, "filter": {"term": {"tag": "blue"}}}},
        {"match": {"body": "zzz"}}, None,
    ]
    return [(q, 10, 0) for q in qs] + [(qs[0], 0, 0), (qs[1], 20, 5), (qs[2], 10, N_DOCS)]


@pytest.mark.parametrize("S", [3, 4, 8])
def test_search_matches_reference(stacks, corpus, monkeypatch, S):
    """`_search` on S shards: the port's impact tier (resident on every
    shard) against the reference's under ES_TPU_IMPACT=force."""
    rng, lens, tok, _ = corpus
    _impact(monkeypatch, "force")
    rs, ps = stacks(S)
    reqs = _requests(np.random.default_rng(S), lens, tok)
    if S != 3:
        reqs = reqs[:6]
    for q, size, from_ in reqs:
        a = rs.search(q, size=size, from_=from_)
        b = ps.search(q, size=size, from_=from_)
        assert b.total == a.total and (b.max_score is None) == (a.max_score is None), q
        _rows_close((b.scores[None], b.doc_shards[None], b.doc_ids[None], [b.total]),
                    (a.scores[None], a.doc_shards[None], a.doc_ids[None], [a.total]), str(q))


def _term_nodes(node):
    if isinstance(node, TermNode):
        return [node]
    if isinstance(node, BoolNode):
        return [t for grp in (node.must, node.filter, node.should, node.must_not)
                for c in grp for t in _term_nodes(c)]
    if isinstance(node, ConstantScoreNode):
        return _term_nodes(node.child)
    return []


def _tie_class(q, mappings, packs) -> float:
    """The impact tier's quantization tie class of query q: 2 · Σ boost·idf
    · ubf / QMAX over its impact-served terms, each term's largest ubf over
    `packs` (the first plans it: global statistics), + 1e-7."""
    bound = 0.0
    for t in _term_nodes(parse_query(q, mappings)):
        params = t.prepare(packs[0])
        if params[0] != "impact":
            continue
        key = (t.fld, t.term)
        ubf = max((float(p.impact_ubf[p.term_dict[key]]) for p in packs[1:]
                   if key in p.term_dict), default=0.0)
        bound += params[2] * ubf / packs[1].impact_meta["qmax"]
    return 2 * bound + 1e-7


def _rows_in_tie_class(got, want, tie, what):
    """Hit rows of two score functions: totals equal, scores within the tie
    class (and 1e-6 relative), ids swapped only within it."""
    assert got["total"] == want["total"], what
    gs = np.array([h["_score"] for h in got["hits"]])
    ws = np.array([h["_score"] for h in want["hits"]])
    assert gs.shape == ws.shape, what
    gap = np.abs(gs - ws)
    assert (gap <= tie + 1e-6 * np.abs(ws)).all(), (what, gap.max(), tie)
    for g, w, d in zip(got["hits"], want["hits"], gap):
        assert g["_id"] == w["_id"] or d <= tie, what


def test_impact_search_on_8_shards_holds_exact_bm25(stacks, corpus, monkeypatch):
    """On 8 shards the impact rows hold the reference's exact BM25 rows
    (ES_TPU_IMPACT=0) within the tie class, and `mark_exact` plans equal
    them up to fp-ties."""
    from elasticsearch_tpu.cache import request_cache

    rng, lens, tok, _ = corpus
    rs, ps = stacks(8)
    _impact(monkeypatch, "0")
    request_cache().invalidate_searcher(rs.cache_token)
    m = Mappings(MAPPING)
    impact_terms = 0
    for q, size, from_ in _requests(np.random.default_rng(8), lens, tok):
        a = rs.search(q, size=size, from_=from_)
        want = {"total": a.total, "hits": [{"_score": float(v), "_id": (int(s), int(d))}
                                           for v, s, d in zip(a.scores, a.doc_shards, a.doc_ids)]}
        b = ps.search(q, size=size, from_=from_)
        got = {"total": b.total, "hits": [{"_score": float(v), "_id": (int(s), int(d))}
                                          for v, s, d in zip(b.scores, b.doc_shards, b.doc_ids)]}
        tie = _tie_class(q, m, [ps._views[0], *ps.sp.shards])
        impact_terms += tie > 1e-7
        _rows_in_tie_class(got, want, tie, str(q))
        e = ps.search(mark_exact(parse_query(q, m)), size=size, from_=from_)
        _rows_close((e.scores[None], e.doc_shards[None], e.doc_ids[None], [e.total]),
                    (a.scores[None], a.doc_shards[None], a.doc_ids[None], [a.total]), str(q))
    assert impact_terms >= 8


def _queries(corpus, n=24):
    rng, lens, tok, _ = corpus
    return sample_queries(np.random.default_rng(9), lens, tok, n) + [
        [], [("zzz", 1.0)], [("t1", 2.0), (f"t{VOCAB - 1}", 0.5)], [("t3", 1.0), ("t3", 0.5)]]


@pytest.mark.parametrize("k", [10, 25])
def test_exact_partials_match_reference(stacks, corpus, monkeypatch, k):
    _impact(monkeypatch, "0")
    rs, ps = stacks(3)
    qs = _queries(corpus)
    wv, wi, wt = ref_sharded._msearch_exact_partials(rs, "body", qs, k)
    gv, gi, gt = (x.numpy() for x in sharded._msearch_exact_partials(ps, "body", qs, k))
    np.testing.assert_array_equal(gt, wt)
    for s in range(3):
        _rows_close((gv[s], np.zeros_like(gi[s]), gi[s], gt[s]),
                    (wv[s], np.zeros_like(wi[s]), wi[s], wt[s]), f"shard {s}")
    _rows_close(sharded._msearch_sharded_exact(ps, "body", qs, k),
                ref_sharded._msearch_sharded_exact(rs, "body", qs, k), "merged")


def test_stacked_plans_byte_equal(stacks, corpus, monkeypatch):
    _impact(monkeypatch, "force")
    rs, ps = stacks(4)
    qs = _queries(corpus)
    want = ref_sharded._msearch_stack_plans(rs, "body", qs, 10, impact=True)
    got = sharded._msearch_stack_plans(ps, "body", qs, 10, impact=True)
    for key in ("W", "rows", "ws", "iws"):
        _equal(got[key], want[key], key)
    assert got["kk"] == want["kk"] and got["avgdl"] == want["avgdl"]


@pytest.mark.parametrize("k", [10, 25])
def test_impact_partials_match_reference(stacks, corpus, monkeypatch, k):
    _impact(monkeypatch, "force")
    rs, ps = stacks(4)
    qs = _queries(corpus)
    want = ref_sharded._msearch_impact_partials(rs, "body", qs, k)
    got = sharded._msearch_impact_partials(ps, "body", qs, k)
    assert want is not None and got is not None
    _rows_close(sharded._merged(*got), ref_sharded._merge_shard_rows(*want), f"impact k={k}")
    ps.last_stats = {}
    sharded.msearch_sharded(ps, "body", qs, k)
    assert ps.last_stats["queries"] == {"impact": len(qs)}


def test_fused_partials_match_reference(monkeypatch):
    monkeypatch.setenv("ES_TPU_FUSED", "force")
    monkeypatch.setenv("ES_TPU_FUSED_TILE", "4096")
    _impact(monkeypatch, "0")
    rng = np.random.default_rng(5)
    lens, tok, nums = make_corpus(rng, 9000, vocab=400, mean_len=12)
    docs = [(str(i), d) for i, d in enumerate(corpus_docs(lens, tok, nums, vocab=400))]
    rs = ref_sharded.StackedSearcher(
        ref_stacked.build_stacked_pack(docs, RefMappings(MAPPING), 2, dense_min_df=64), mesh=None)
    ps = sharded.StackedSearcher(
        stacked.build_stacked_pack(docs, Mappings(MAPPING), 2, dense_min_df=64), device="cpu")
    qs = sample_queries(rng, lens, tok, 24) + [[], [("zzz", 1.0)], [("t399", 1.0), ("t1", 2.0)]]
    fs = ps.fused_msearch()
    assert fs.usable(10) and not fs.usable(17) and ps.sp.n_max >= 4096
    got = sharded._merged(*fs.msearch_partials("body", qs, 10))
    want = ref_sharded._merge_shard_rows(
        *ref_sharded._fused_sharded_for(rs).msearch_partials("body", qs, 10))
    _rows_close(got, want, "fused partials")
    _rows_close(got, ref_sharded._msearch_sharded_exact(rs, "body", qs, 10), "fused vs exact")
    ps.last_stats = {}
    sharded.msearch_sharded(ps, "body", qs, 10)
    assert ps.last_stats["queries"] == {"fused": len(qs)} and ps.last_stats["chunks"] == 2
    # a flagged query's rows are the exact partials' on every shard
    real = sharded.F._fused_pipeline

    def flag_first(*a, **kw):
        v, i, t, fl = real(*a, **kw)
        fl = fl.clone()
        fl[0] = True
        return v, i, t, fl

    monkeypatch.setattr(sharded.F, "_fused_pipeline", flag_first)
    ps.last_stats = {}
    esc = sharded._merged(*fs.msearch_partials("body", qs, 10))
    assert ps.last_stats["escalated"] == 1
    _rows_close(esc, got, "escalated")


def test_esindex_matches_reference(corpus, monkeypatch):
    rng, lens, tok, docs = corpus
    docs = docs[:900]
    ref = RefEsIndex("corpus", RefMappings(MAPPING), {"number_of_shards": 3}, None)
    port = EsIndex("corpus", MAPPING, settings={"number_of_shards": 3}, device="cpu")
    for doc_id, src in docs:
        ref.index_doc(doc_id, src)
        port.index_doc(doc_id, src)
    _impact(monkeypatch, "force")
    ref.refresh()
    port.refresh()
    assert [len(x) for x in port.shard_docs] == [len(x) for x in ref.shard_docs]
    assert [[d for d, _ in x] for x in port.shard_docs] == [[d for d, _ in x] for x in ref.shard_docs]

    def same(a, b, what):
        assert a["total"] == b["total"], what
        _rows_close(([h["_score"] for h in a["hits"]], [0] * len(a["hits"]),
                     [h["_id"] for h in a["hits"]], [0]),
                    ([h["_score"] for h in b["hits"]], [0] * len(b["hits"]),
                     [h["_id"] for h in b["hits"]], [0]), what)

    reqs = _requests(np.random.default_rng(2), lens, tok)[:8]
    for q, size, from_ in reqs:
        same(port.search(q, size=size, from_=from_)["hits"],
             ref.search(q, size=size, from_=from_)["hits"], str(q))
    bodies = [{"query": {"match": {"body": " ".join(t for t, _ in q)}}}
              for q in sample_queries(np.random.default_rng(3), lens, tok, 12)]
    bodies += [dict(b, size=20, **{"from": 5}) for b in bodies[:6]]
    _impact(monkeypatch, "force")
    want = ref.search_wave([{"query": b["query"], "size": b.get("size", 10),
                             "from_": b.get("from", 0)} for b in bodies])
    got = port.msearch(bodies)["responses"]
    for b, g, w in zip(bodies, got, want):
        assert g["status"] == 200
        same(g["hits"], w["hits"], str(b))
    # knn on a field the mappings lack matches nothing, on both
    same(port.search(knn={"field": "v", "query_vector": [1.0], "k": 1})["hits"],
         ref.search(knn={"field": "v", "query_vector": [1.0], "k": 1})["hits"], "knn")


def test_sharded_index_matches_one_shard(corpus):
    """3 shards with global statistics answer as 1 shard: _search and
    msearch rows within the impact tier's quantization tie class (each
    shard quantizes with its own per-term bound), and `mark_exact` _search
    rows by _id up to fp-ties."""
    rng, lens, tok, docs = corpus
    one = EsIndex("c", MAPPING, device="cpu")
    three = EsIndex("c", MAPPING, settings={"number_of_shards": 3}, device="cpu")
    for doc_id, src in docs:
        one.index_doc(doc_id, src)
        three.index_doc(doc_id, src)
    one.refresh()
    three.refresh()
    ss = three.searcher
    for q, size, from_ in _requests(np.random.default_rng(4), lens, tok):
        a = one.search(q, size=size, from_=from_)["hits"]
        b = three.search(q, size=size, from_=from_)["hits"]
        tie = _tie_class(q, one.mappings, [one.searcher.pack, one.searcher.pack, *ss.sp.shards])
        _rows_in_tie_class(b, a, tie, str(q))
        ea = one.searcher.search(mark_exact(parse_query(q, one.mappings)), size, from_)
        eb = ss.search(mark_exact(parse_query(q, one.mappings)), size, from_)
        ids_a = [one.shard_docs[0][d][0] for d in ea.doc_ids]
        ids_b = [three.shard_docs[s][d][0] for s, d in zip(eb.doc_shards, eb.doc_ids)]
        assert ea.total == eb.total, q
        _rows_close((eb.scores[None], np.zeros((1, len(ids_b))), np.array([ids_b]), [eb.total]),
                    (ea.scores[None], np.zeros((1, len(ids_a))), np.array([ids_a]), [ea.total]),
                    str(q))
    bodies = [{"query": {"match": {"body": " ".join(t for t, _ in q)}}}
              for q in sample_queries(np.random.default_rng(6), lens, tok, 20)]
    pack1 = one.searcher.pack
    sp = three.searcher.sp
    doc_count = pack1.field_stats["body"]["doc_count"]
    for b, x, y in zip(bodies, one.msearch(bodies)["responses"],
                       three.msearch(bodies)["responses"]):
        assert x["hits"]["total"] == y["hits"]["total"]
        bound = 0.0
        for t in dict.fromkeys(b["query"]["match"]["body"].split()):
            _, _, df = pack1.term_blocks("body", t)
            if df and pack1.dense_row_of("body", t) is None:
                ubfs = [float(p.impact_ubf[p.term_dict[("body", t)]]) for p in sp.shards
                        if ("body", t) in p.term_dict]
                ubfs.append(float(pack1.impact_ubf[pack1.term_dict[("body", t)]]))
                bound += np.log(1 + (doc_count - df + 0.5) / (df + 0.5)) * max(ubfs) / 65535
        gs = np.array([h["_score"] for h in y["hits"]["hits"]])
        ws = np.array([h["_score"] for h in x["hits"]["hits"]])
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=2 * bound + 1e-7)


def test_one_shard_stacked_matches_shard_searcher(corpus):
    rng, lens, tok, docs = corpus
    m = Mappings(MAPPING)
    b = PackBuilder(m)
    b.add_documents_batch([m.parse_document(s) for _, s in docs], doc_ids=[d for d, _ in docs])
    single = ShardSearcher(b.build(), device="cpu", mappings=m)
    one = sharded.StackedSearcher(stacked.build_stacked_pack(docs, Mappings(MAPPING), 1),
                                  device="cpu")
    for q, size, from_ in _requests(np.random.default_rng(8), lens, tok):
        a = single.search(q, size=size, from_=from_)
        r = one.search(q, size=size, from_=from_)
        assert not r.doc_shards.any()
        _rows_close((r.scores[None], r.doc_shards[None], r.doc_ids[None], [r.total]),
                    (a.scores[None], np.zeros((1, len(a.doc_ids)), np.int32),
                     a.doc_ids[None], [a.total]), str(q))


def test_number_of_shards_below_one_raises():
    for bad in (0, -2):
        with pytest.raises(IllegalArgumentError, match="number_of_shards"):
            EsIndex("x", MAPPING, settings={"number_of_shards": bad}, device="cpu")


def test_vectors_on_more_than_one_shard_raise():
    """Vectors on 2 shards (once refused) stack and answer kNN as the
    reference's 2-shard index: totals, scores and ids equal."""
    mapping = {"properties": {"v": {"type": "dense_vector", "dims": 2}}}
    idx = EsIndex("x", mapping, settings={"number_of_shards": 2}, device="cpu")
    ref = RefEsIndex("x", RefMappings(mapping), {"number_of_shards": 2}, None)
    for i in range(4):
        idx.index_doc(str(i), {"v": [1.0, float(i)]})
        ref.index_doc(str(i), {"v": [1.0, float(i)]})
    idx.refresh()
    ref.refresh()
    assert idx.searcher.sp.vectors["v"].values.shape == (2, idx.searcher.sp.n_max, 2)
    for q, k in (([1.0, 0.5], 3), ([0.0, 1.0], 4), ([2.0, -1.0], 1)):
        got = idx.search(knn={"field": "v", "query_vector": q, "k": k})["hits"]
        want = ref.search(knn={"field": "v", "query_vector": q, "k": k})["hits"]
        assert got["total"] == want["total"]
        assert [h["_id"] for h in got["hits"]] == [h["_id"] for h in want["hits"]]
        np.testing.assert_allclose([h["_score"] for h in got["hits"]],
                                   [h["_score"] for h in want["hits"]], rtol=1e-6)


def test_parallel_build_equals_serial(corpus):
    """Shards analyzed on a worker thread beside the previous shard's build
    are the bytes of a serial build, one shard after another."""
    _, _, _, docs = corpus
    routed = stacked.route_docs(docs[:600], 2)
    m = Mappings(MAPPING)
    a = stacked.StackedPack([stacked._ingest_shard(d, m, False).build(dense_min_df=1 << 62)
                             for d in routed], m)
    b = stacked.build_stacked_pack_routed(routed, Mappings(MAPPING))
    for name in ("post_docids", "post_tfs", "post_dls", "live", "impact_row_scale_inv"):
        _equal(getattr(b, name), getattr(a, name), name)
    assert a.global_df == b.global_df and a.dense_dict == b.dense_dict


def test_c5_corpus_is_bench_stream():
    """C5's corpus continues bench.py's stream: the same generator calls in
    the same order, docs split by range."""
    lens, tok, rng = c5_corpus(n_per_shard=500, shards=3)
    want = np.random.default_rng(4242)
    zipf = 1.0 / np.arange(1, 100_001)
    zipf /= zipf.sum()
    wl = want.poisson(40, size=1500).clip(4, None)
    wt = want.choice(100_000, size=int(wl.sum()), p=zipf)
    _equal(lens, wl, "lens")
    _equal(tok, wt, "tok")
    assert sample_queries(rng, lens, tok, 5) == sample_queries(want, wl, wt, 5)
    docs = c5_shard_docs(lens, tok, 1, 500)
    start = int(lens[:500].sum())
    assert docs[0] == ("500", {"body": " ".join(f"t{t}" for t in tok[start: start + lens[500]])})
    texts = doc_texts(lens, tok, step=7)
    words, pos = [], 0
    for ln in lens.tolist():
        words.append(" ".join(f"t{t}" for t in tok[pos: pos + ln]))
        pos += ln
    assert texts == words


def test_plan_fused_shards_byte_equal(stacks, corpus):
    """The shared-pass planner gives each shard's view the plan that
    plan_fused gives it, array for array."""
    from elasticsearch_tpu_torch.ops import fused

    _, ps = stacks(4)
    qs = _queries(corpus, 60) + [[("t2", 1.0), ("zzz", 1.0), ("t2", 3.0)]]
    for chunk in (qs, qs[:1], [[]]):
        got = sharded.plan_fused_shards(ps.sp, "body", chunk, 10)
        for s, plan in enumerate(got):
            want = fused.plan_fused(ps.sp.shard_view(s), "body", chunk, 10, qc=len(chunk))
            for name in ("rows", "row_q", "row_w", "row_t", "dense_rows", "dense_w"):
                _equal(getattr(plan, name), getattr(want, name), f"shard {s} {name}")
            assert (plan.k, plan.ts) == (want.k, want.ts)
