"""Field-sorted search, search_after, collapse and rescore: the port's
`EsIndex.search(sort=, search_after=, collapse=, rescore=)` against the JAX
package's `_search_inner`, on one shard, on three shards and on a base
with tail segments (which both merge first), and over the REST app.

The fixed documents are those of the reference's `tests/test_sort.py` and
`tests/test_collapse_rescore.py`; the seeded corpus is
`torch_parity.text_docs` (a double field holding -0.0 and +0.0, and
missing values). Sorted hits: the `sort` arrays equal the reference's, ids
equal up to full-key ties (the reference's `lax.sort` documents no order
among them; the port orders them by (shard, docid)). Scored hits:
`torch_parity.same_hits` (scores within 1e-6 relative, ids up to
fp-ties). The reference scores from its impact tier (ES_TPU_IMPACT=force).
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.query.sort import SortPlan, parse_sort, sort_key_i64, sorted_top
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
from torch_parity import MAPPING, Pair, pages_of, same_hits, sorted_ties_hold, text_docs

SORT_MAPPING = {"properties": {"body": {"type": "text"}, "tag": {"type": "keyword"},
                               "n": {"type": "long"}, "price": {"type": "double"},
                               "ts": {"type": "date"}}}
SORT_DOCS = [
    ("a", {"body": "x common", "tag": "beta", "n": 5, "price": 1.5, "ts": "2024-03-01"}),
    ("b", {"body": "x common", "tag": "alpha", "n": 2, "price": 9.0, "ts": "2024-01-01"}),
    ("c", {"body": "x common", "tag": "gamma", "n": 9, "price": 4.0, "ts": "2024-02-01"}),
    ("d", {"body": "x common", "tag": "alpha", "n": 2, "price": 2.5}),
    ("e", {"body": "x common", "n": 7, "price": 0.5, "ts": "2024-04-01"}),
]
SORT_CASES = [
    dict(query={"match_all": {}}, sort=[{"n": "asc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"n": "desc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"price": "desc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"ts": "asc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"tag": "asc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"tag": "desc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"n": "asc"}, {"price": "desc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"ts": {"order": "asc", "missing": "_first"}}], size=10),
    dict(query={"match_all": {}}, sort=[{"price": {"order": "asc", "missing": 3}}], size=10),
    dict(query={"range": {"n": {"gte": 5}}}, sort=[{"n": "asc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"n": "asc"}], size=2, search_after=[2]),
    dict(query={"match_all": {}}, sort=[{"tag": "asc"}], size=3, search_after=["alphz"]),
    dict(query={"match_all": {}}, sort=[{"n": "asc"}, {"price": "asc"}], size=2,
         search_after=[2, 2.5]),
    dict(query={"match": {"body": "common"}}, sort=[{"_score": "desc"}, {"n": "asc"}], size=10),
    dict(query={"match_all": {}}, sort=["_doc"], size=3),
    dict(query={"match_all": {}}, sort=[{"missing_field": "asc"}, {"n": "desc"}], size=10),
    dict(query={"match_all": {}}, sort=[{"n": "desc"}], size=2,
         aggs={"mx": {"max": {"field": "n"}}, "t": {"terms": {"field": "tag"}}}),
    dict(query={"match_all": {}}, sort=[{"n": "asc"}], size=2, from_=2, track_total_hits=False),
]


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


@pytest.fixture(scope="module", params=[1, 3], ids=["1shard", "3shards"])
def fixed(request):
    p = Pair(SORT_MAPPING, {"number_of_shards": request.param})
    p.index(SORT_DOCS)
    p.refresh()
    yield p
    p.close()


@pytest.mark.parametrize("case", SORT_CASES, ids=[f"case{i}" for i in range(len(SORT_CASES))])
def test_sort_cases_match_reference(fixed, case):
    got, want = fixed.search(**case)
    same_hits(got, want, str(case))
    sorted_ties_hold(got, want)
    for h in got["hits"]["hits"]:
        assert h["_score"] is None and "sort" in h
    assert got["hits"]["max_score"] is None


def test_expected_orders(fixed):
    def ids(**kw):
        return [h["_id"] for h in fixed.port.search(**kw)["hits"]["hits"]]

    # ties by (shard, docid): b before d wherever they land
    assert ids(query={"match_all": {}}, sort=[{"n": "asc"}, {"price": "desc"}]) == \
        ["b", "d", "a", "e", "c"]
    assert ids(query={"match_all": {}}, sort=[{"ts": "asc"}]) == ["b", "c", "a", "e", "d"]
    seen, cursor = [], None
    for _ in range(6):
        r = fixed.port.search({"match_all": {}}, sort=[{"n": "asc"}, {"price": "asc"}], size=1,
                              search_after=cursor)["hits"]["hits"]
        if not r:
            break
        seen.append(r[0]["_id"])
        cursor = r[0]["sort"]
    assert seen == ["d", "b", "a", "e", "c"]


@pytest.mark.parametrize("kw, match", [
    (dict(sort=[{"body": "asc"}]), "Text fields are not optimised"),
    (dict(search_after=[1]), "search_after requires an explicit sort"),
    (dict(sort=[{"n": "asc"}], knn={"field": "v", "query_vector": [1.0], "k": 1}),
     "knn with field sort"),
    (dict(sort=[{"n": "asc"}], collapse={"field": "tag"}), "collapse/rescore with field sort"),
    (dict(sort=[{"n": "asc"}], rescore={"query": {"rescore_query": {"match_all": {}}}}),
     "collapse/rescore with field sort"),
    (dict(collapse={"field": "tag"}, rescore={"query": {"rescore_query": {"match_all": {}}}}),
     "cannot use \\[collapse\\] in conjunction with \\[rescore\\]"),
    (dict(collapse={}), "no \\[field\\] specified for collapse"),
    (dict(rescore={"query": {}}), "rescore requires \\[rescore_query\\]"),
    (dict(rescore={"query": {"rescore_query": {"match_all": {}}, "score_mode": "sum"}}),
     "unsupported rescore score_mode"),
    (dict(sort=[{"n": "asc"}], search_after=[1, 2]), "search_after has 2 values"),
    (dict(sort=[{"n": "sideways"}]), "unknown sort order"),
], ids=["text", "after_no_sort", "knn", "collapse", "rescore", "collapse_rescore",
        "collapse_field", "rescore_query", "score_mode", "after_len", "order"])
def test_refusals_match_reference(fixed, kw, match):
    with pytest.raises(Exception, match=match) as want:
        fixed.ref.search(query={"match_all": {}}, **kw)
    with pytest.raises(Exception, match=match) as got:
        fixed.port.search({"match_all": {}}, **kw)
    assert got.value.status == 400
    assert type(got.value).__name__ == type(want.value).__name__


@pytest.fixture(scope="module", params=[1, 3], ids=["1shard", "3shards"])
def corpus(request):
    p = Pair(MAPPING, {"number_of_shards": request.param})
    p.index(text_docs(21, 500))
    p.refresh()
    yield p
    p.close()


CORPUS_SORTS = [
    [{"p": "desc"}, {"n": "asc"}],
    [{"p": {"order": "asc", "missing": "_first"}}],
    [{"tag": "desc"}, {"p": "asc"}],
    [{"n": "asc"}, {"tag": {"order": "asc", "missing": "_first"}}],
    ["_score", {"n": "desc"}],
]


@pytest.mark.parametrize("sort", CORPUS_SORTS, ids=[f"sort{i}" for i in range(len(CORPUS_SORTS))])
def test_corpus_pages_match_reference(corpus, sort):
    """Ten pages by search_after equal the reference's pages and, joined,
    the pages that one long page gives (`pages_of`: a page skips the rest
    of its cursor's full-key tie)."""
    q = {"match": {"body": "w1 w2 w3"}}
    pages, cursor = [], None
    for _ in range(10):
        # the reference cannot page past a missing key, and a `_score` cursor
        # may sit an ulp away from the reference's own
        if cursor is None or (None not in cursor and "_score" not in sort):
            got, want = corpus.search(query=q, sort=sort, size=7, search_after=cursor)
            same_hits(got, want, f"page {sort}")
            sorted_ties_hold(got, want)
        else:
            got = corpus.port.search(q, sort=sort, size=7, search_after=cursor)
        pages += got["hits"]["hits"]
        if not got["hits"]["hits"]:
            break
        cursor = got["hits"]["hits"][-1]["sort"]
    one = corpus.port.search(q, sort=sort, size=1000)["hits"]["hits"]  # every match
    assert [(h["_id"], h["sort"]) for h in pages_of(one, 7, 10)] == \
        [(h["_id"], h["sort"]) for h in pages]


def test_aggs_beside_sort_equal_unsorted(corpus):
    aggs = {"t": {"terms": {"field": "tag", "size": 20}}, "s": {"sum": {"field": "n"}}}
    q = {"range": {"n": {"lt": 40}}}
    got, want = corpus.search(query=q, sort=[{"n": "desc"}], size=5, aggs=aggs)
    same_hits(got, want, "aggs beside sort")
    assert got["aggregations"] == corpus.port.search(q, size=0, aggs=aggs)["aggregations"]


def test_zero_sign_key_order():
    """-0.0 and +0.0 sort as equal keys, ties by docid, as `lax.sort` orders
    them on the CPU (the encoding gives the card's radix sort the same
    order); hit values keep their sign; search_after compares by IEEE."""
    keys = torch.tensor([0.0, -0.0, 1.0, -1.0, 0.0, -0.0, -3.5, 2.0e300], dtype=torch.float64)
    enc = sort_key_i64(keys)
    assert enc[0] == enc[1] == enc[4] == enc[5]
    assert [int(i) for i in torch.argsort(enc, stable=True)] == [6, 3, 0, 1, 4, 5, 2, 7]
    lanes, (ks,) = sorted_top([keys], torch.ones(8, dtype=torch.bool), 8)
    assert lanes.tolist() == [6, 3, 0, 1, 4, 5, 2, 7]
    assert [str(x) for x in ks.tolist()[2:6]] == ["0.0", "-0.0", "0.0", "-0.0"]
    p = Pair({"properties": {"p": {"type": "double"}}})
    try:
        p.index([("z1", {"p": 0.0}), ("z2", {"p": -0.0}), ("z3", {"p": 0.0}),
                  ("z4", {"p": -0.0}), ("z5", {"p": 1.0})])
        p.refresh()
        for order in ("asc", "desc"):
            got, want = p.search(query=None, sort=[{"p": order}], size=5)
            assert [h["_id"] for h in got["hits"]["hits"]] == [h["_id"] for h in want["hits"]["hits"]]
            assert [str(h["sort"][0]) for h in got["hits"]["hits"]] == \
                [str(h["sort"][0]) for h in want["hits"]["hits"]]
        got, want = p.search(query=None, sort=[{"p": "asc"}], size=5, search_after=[0.0])
        assert [h["_id"] for h in got["hits"]["hits"]] == ["z5"] == \
            [h["_id"] for h in want["hits"]["hits"]]
    finally:
        p.close()


def test_sort_plan_after_keys_between_ordinals():
    m = Mappings(SORT_MAPPING)
    p = Pair(SORT_MAPPING)
    try:
        p.index(SORT_DOCS)
        p.refresh()
        plan = SortPlan(parse_sort([{"tag": "desc"}]), p.port.searcher.pack, m)
        assert plan.after_keys(["alpha"], None) == (0,)
        assert plan.after_keys(["alphz"], None) == (-1,)  # odd: between alpha and beta
    finally:
        p.close()


COLLAPSE_MAPPING = {"properties": {"title": {"type": "text"}, "brand": {"type": "keyword"},
                                   "rank": {"type": "integer"}}}
COLLAPSE_DOCS = [
    ("1", {"title": "red shoe sale", "brand": "acme", "rank": 5}),
    ("2", {"title": "red shoe", "brand": "acme", "rank": 1}),
    ("3", {"title": "red boot shoe shoe", "brand": "bolt", "rank": 9}),
    ("4", {"title": "blue shoe", "brand": "bolt", "rank": 2}),
    ("5", {"title": "red sandal", "brand": "core", "rank": 7}),
    ("6", {"title": "green shoe", "rank": 3}),
]


@pytest.fixture(scope="module", params=[1, 2], ids=["1shard", "2shards"])
def shoes(request):
    p = Pair(COLLAPSE_MAPPING, {"number_of_shards": request.param})
    p.index(COLLAPSE_DOCS)
    p.refresh()
    yield p
    p.close()


@pytest.mark.parametrize("field", ["brand", "rank", "missing"])
def test_collapse_matches_reference(shoes, field):
    got = shoes.check("collapse", query={"match": {"title": "shoe"}},
                      collapse={"field": field}, size=10)
    keys = [h["fields"][field][0] for h in got["hits"]["hits"]]
    assert len(keys) == len(set(map(repr, keys)))  # one hit per group
    if field == "brand":
        assert None in keys  # the null group: docs without a brand


def test_collapse_with_aggs_counts_every_match(shoes):
    got = shoes.check("collapse aggs", query={"match": {"title": "shoe"}},
                      collapse={"field": "brand"}, size=2, from_=1,
                      aggs={"b": {"terms": {"field": "brand"}}})
    assert sum(b["doc_count"] for b in got["aggregations"]["b"]["buckets"]) == 4


@pytest.mark.parametrize("mode", ["total", "multiply", "avg", "max", "min"])
def test_rescore_modes_match_reference(shoes, mode):
    rescore = {"window_size": 3, "query": {"rescore_query": {"match_phrase": {"title": "red shoe"}},
                                           "query_weight": 0.7, "rescore_query_weight": 2.0,
                                           "score_mode": mode}}
    shoes.check("rescore", query={"match": {"title": "shoe red"}}, rescore=rescore, size=4)
    shoes.check("rescore list", query={"match": {"title": "shoe"}},
                rescore=[rescore, {"window_size": 2, "query": {
                    "rescore_query": {"match": {"title": "boot"}}}}], size=5, from_=1)


@pytest.mark.parametrize("shards", [1, 3])
def test_corpus_collapse_and_rescore_match_reference(corpus, shards):
    for q in ({"match": {"body": "w1 w4"}}, {"match_phrase": {"body": "w0 w1"}}):
        for fld in ("tag", "n", "p"):
            corpus.check("collapse", query=q, collapse={"field": fld}, size=12)
    rs = {"window_size": 40, "query": {"rescore_query": {"match_phrase": {"body": "w0 w1"}},
                                       "score_mode": "total"}}
    corpus.check("rescore", query={"match": {"body": "w0 w1 w2"}}, rescore=rs, size=15)


def test_sort_collapse_rescore_merge_the_tiers():
    docs = text_docs(22, 600)
    p = Pair(MAPPING)
    try:
        p.index(docs[:450])
        p.refresh()
        p.index(docs[450:])
        p.refresh()
        assert len(p.port._tails) == 1
        got, want = p.search(query={"match": {"body": "w2"}}, sort=[{"n": "desc"}], size=9)
        same_hits(got, want, "tiers sort")
        sorted_ties_hold(got, want)
        assert len(p.port._tails) == 0
        p.index([("d1", {"body": "w2 w3", "tag": "k01", "n": 3})])
        p.refresh()
        assert len(p.port._tails) == 1
        p.check("tiers collapse", query={"match": {"body": "w2"}}, collapse={"field": "tag"})
        assert len(p.port._tails) == 0
    finally:
        p.close()


def test_msearch_and_wave_run_sorted_bodies_solo(corpus):
    body = {"query": {"match": {"body": "w1"}}, "sort": [{"n": "asc"}], "size": 4}
    out = corpus.port.msearch([body, {"query": {"match": {"body": "w1"}}, "size": 4},
                               {**body, "track_total_hits": False}])["responses"]
    solo = corpus.port.search(body["query"], sort=body["sort"], size=4)
    assert {k: v for k, v in out[0].items() if k != "status"} == solo
    assert "total" not in out[2]["hits"]
    wave = corpus.port.search_wave([dict(query=body["query"], sort=body["sort"], size=4),
                                    dict(query={"match_phrase": {"body": "w0 w1"}}, size=3,
                                         collapse={"field": "tag"})])
    assert wave[0] == solo
    assert wave[1] == corpus.port.search({"match_phrase": {"body": "w0 w1"}}, size=3,
                                         collapse={"field": "tag"})


def test_rest_search_takes_sort_and_phrase(corpus):
    app = make_app(corpus.port_engine)
    body = {"query": {"match": {"body": "w1"}}, "sort": [{"n": "desc"}, {"tag": "asc"}],
            "size": 3, "search_after": [40, "k03"]}
    status, _, raw = app.handle("POST", "/idx/_search", {}, {}, json.dumps(body).encode())
    res = json.loads(raw)
    assert status == 200
    direct = corpus.port.search(body["query"], sort=body["sort"], size=3,
                                search_after=body["search_after"])
    assert res["hits"] == direct["hits"]
    body = {"query": {"match_phrase": {"body": "w0 w1"}}, "collapse": {"field": "tag"},
            "rescore": None}
    status, _, raw = app.handle("POST", "/idx/_search", {}, {}, json.dumps(body).encode())
    res = json.loads(raw)
    assert status == 200
    assert res["hits"] == corpus.port.search(body["query"], collapse=body["collapse"])["hits"]
    status, _, raw = app.handle("POST", "/idx/_search", {}, {},
                                json.dumps({"search_after": [1]}).encode())
    res = json.loads(raw)
    assert status == 400 and res["error"]["type"] == "illegal_argument_exception"


@pytest.mark.parametrize("shards", [1, 3])
def test_two_pass_terms_beside_a_sort_runs_single_pass(monkeypatch, shards):
    """TWO_PASS_MIN_V lowered in both packages: a terms agg with a sub-agg
    that would take the two-pass scheme runs its single pass beside a field
    sort (reference `executor.py:573-579`), in both packages alike."""
    from elasticsearch_tpu.aggs import nodes as ref_nodes
    from elasticsearch_tpu_torch.aggs import nodes

    monkeypatch.setattr(ref_nodes, "TWO_PASS_MIN_V", 8)
    monkeypatch.setattr(nodes, "TWO_PASS_MIN_V", 8)
    p = Pair(MAPPING, {"number_of_shards": shards})
    try:
        p.index(text_docs(23, 300))
        p.refresh()
        aggs = {"by_n": {"terms": {"field": "n", "size": 5}, "aggs": {"s": {"sum": {"field": "p"}}}}}
        got, want = p.search(query={"match": {"body": "w1"}}, sort=[{"n": "asc"}], size=4,
                             aggs=aggs)
        same_hits(got, want, "two-pass beside sort")
        assert len(got["aggregations"]["by_n"]["buckets"]) == 5
    finally:
        p.close()
