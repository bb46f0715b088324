"""The host matchers of the port, which feed an id set to the device:
`intervals`, `nested` (with the `nested` type) and `percolate` (with the
`percolator` type), against the JAX package on the same numpy-seeded docs.

Mirrors tests/test_intervals.py:27-76, tests/test_geo_nested.py's nested
cases and tests/test_percolate_rankeval.py::test_percolate_matches_stored_queries,
then seeded bodies beyond them (ordered and unordered windows with
max_gaps 0-3, any_of / all_of, nested ranges and bools over 1-5 objects,
stored match / term / bool queries), on 1 and 3 shards, on a tiered index
and over REST.

Tolerances: these kinds score a constant boost, so match sets and totals
are `==`; inside a bool, scores within 1e-6 relative and ids up to
fp-ties at 1e-5 (`torch_parity.same_hits`). On several shards the
reference's stacked route pads each shard's id set to a common width with
docid 0 (ROADMAP queue C: doc 0 of a shard matches), so there the port is
held to the reference's one-shard index of the same docs.

A percolated stored query that fails to parse is no match, as in the
reference; any other exception (a launch failure) propagates (the
reference's matcher catches every exception).
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu_torch.query import nodes as port_nodes
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.utils.errors import QueryParsingError
from torch_parity import Pair, same_hits


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()


def _ids(out) -> set:
    return {h["_id"] for h in out["hits"]["hits"]}


# ---------------------------------------------------------------------------
# intervals (tests/test_intervals.py:27-76)
# ---------------------------------------------------------------------------

IV_DOCS = [("1", {"t": "the quick brown fox jumps"}), ("2", {"t": "brown dog and a quick cat"}),
           ("3", {"t": "quick as a very very very brown thing"}), ("4", {"t": "unrelated words here"})]
IV_BODIES = [
    ({"match": {"query": "quick brown", "ordered": True, "max_gaps": 0}}, {"1"}),
    ({"match": {"query": "quick brown", "ordered": True, "max_gaps": 5}}, {"1", "3"}),
    ({"match": {"query": "quick brown", "max_gaps": 3}}, {"1", "2"}),
    ({"match": {"query": "quick brown"}}, {"1", "2", "3"}),
    ({"any_of": {"intervals": [{"match": {"query": "fox"}}, {"match": {"query": "cat"}}]}},
     {"1", "2"}),
    ({"all_of": {"intervals": [{"match": {"query": "quick"}}, {"match": {"query": "brown"}}]}},
     {"1", "2", "3"}),
]


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("rule,want", IV_BODIES, ids=[json.dumps(r) for r, _ in IV_BODIES])
def test_reference_intervals(rule, want, shards):
    p = Pair({"properties": {"t": {"type": "text"}}}, {"number_of_shards": shards})
    try:
        p.index(IV_DOCS)
        p.refresh()
        q = {"intervals": {"t": rule}}
        got, ref = p.search(query=q, size=10)
        assert _ids(got) == want
        if shards == 1:
            same_hits(got, ref, json.dumps(q))
    finally:
        p.close()


def text_docs(seed: int, n: int, vocab: int = 30) -> list:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [(f"x{i}", {"t": " ".join(f"w{w}" for w in rng.choice(vocab, size=int(rng.integers(3, 16)),
                                                                 p=p)),
                       "n": int(rng.integers(0, 100))}) for i in range(n)]


def _interval_rules() -> list:
    rules = []
    for gaps in (0, 1, 2, 3):
        rules.append({"match": {"query": "w1 w2", "ordered": True, "max_gaps": gaps}})
        rules.append({"match": {"query": "w3 w0 w5", "max_gaps": gaps}})
    rules += [{"match": {"query": "w4 w4", "ordered": True}},
              {"match": {"query": "w0"}},
              {"any_of": {"intervals": [{"match": {"query": "w7 w8", "max_gaps": 2}},
                                        {"match": {"query": "w9 w1", "ordered": True}}]}},
              {"all_of": {"intervals": [{"match": {"query": "w0 w1", "max_gaps": 1}},
                                        {"match": {"query": "w2"}}]}},
              {"match": {"query": "nothing here"}}]
    return rules


@pytest.fixture(params=[1, 3], ids=["1shard", "3shards"], scope="module")
def texts(request):
    docs = text_docs(request.param, 500)
    p = Pair({"properties": {"t": {"type": "text"}, "n": {"type": "long"}}},
             {"number_of_shards": request.param})
    p.index(docs)
    p.refresh()
    one = None
    if request.param > 1:
        one = Pair({"properties": {"t": {"type": "text"}, "n": {"type": "long"}}})
        one.index(docs)
        one.refresh()
    yield p, one, docs
    p.close()
    if one is not None:
        one.close()


def test_seeded_intervals(texts):
    p, one, docs = texts
    for rule in _interval_rules():
        q = {"intervals": {"t": rule}}
        got = p.port.search(q, size=len(docs))
        if one is None:
            same_hits(got, p.ref.search(query=q, size=len(docs)), json.dumps(q))
        else:
            want = one.ref.search(query=q, size=len(docs))
            assert _ids(got) == _ids(want) and got["hits"]["total"] == want["hits"]["total"], q
        comp = {"bool": {"must": [q], "filter": [{"range": {"n": {"lt": 50}}}],
                         "should": [{"match": {"t": "w2"}}]}}
        gc = p.port.search(comp, size=40)
        if one is None:
            same_hits(gc, p.ref.search(query=comp, size=40), json.dumps(comp))
        else:
            assert _ids(p.port.search(comp, size=len(docs))) == \
                _ids(one.ref.search(query=comp, size=len(docs)))


# ---------------------------------------------------------------------------
# nested (tests/test_geo_nested.py:70-137)
# ---------------------------------------------------------------------------

USERS = {"properties": {"group": {"type": "keyword"}, "user": {"type": "nested", "properties": {
    "first": {"type": "keyword"}, "last": {"type": "keyword"}, "age": {"type": "integer"}}}}}


@pytest.fixture(params=[1, 3], ids=["1shard", "3shards"], scope="module")
def users(request):
    p = Pair(USERS, {"number_of_shards": request.param})
    p.index([("1", {"group": "fans", "user": [{"first": "John", "last": "Smith", "age": 30},
                                               {"first": "Alice", "last": "White", "age": 40}]}),
             ("2", {"group": "fans", "user": [{"first": "John", "last": "White", "age": 20}]})])
    p.refresh()
    yield p
    p.close()


NESTED_REFERENCE = [
    ({"nested": {"path": "user", "query": {"bool": {"must": [
        {"term": {"user.first": {"value": "John"}}}, {"term": {"user.last": {"value": "Smith"}}}]}}}},
     {"1"}),
    ({"bool": {"must": [{"term": {"user.first": "John"}}, {"term": {"user.last": "White"}}]}},
     {"1", "2"}),
    ({"nested": {"path": "user", "query": {"bool": {"must": [
        {"term": {"user.first": {"value": "John"}}}, {"range": {"user.age": {"gte": 25}}}]}}}},
     {"1"}),
    ({"bool": {"must": [{"nested": {"path": "user", "query": {"bool": {"must": [
        {"term": {"user.first": {"value": "John"}}}, {"range": {"user.age": {"gte": 25}}}]}}}},
        {"term": {"group": "fans"}}]}}, {"1"}),
]


@pytest.mark.parametrize("q,want", NESTED_REFERENCE, ids=[json.dumps(q) for q, _ in NESTED_REFERENCE])
def test_reference_nested(users, q, want):
    got, ref = users.search(query=q, size=10)
    assert _ids(got) == _ids(ref) == want


def test_nested_unknown_path_rejected(users):
    with pytest.raises(QueryParsingError):
        users.port.search({"nested": {"path": "nope", "query": {"match_all": {}}}})


QA = {"properties": {"title": {"type": "text"}, "tag": {"type": "keyword"},
                     "answers": {"type": "nested", "properties": {
                         "user": {"type": "keyword"}, "date": {"type": "date"},
                         "score": {"type": "integer"}, "body": {"type": "text"}}}}}


def qa_docs(seed: int, n: int) -> list:
    """StackOverflow-shaped questions with 1-5 nested answers each."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        answers = [{"user": f"u{int(rng.integers(0, 40))}",
                    "date": f"2015-{int(rng.integers(1, 13)):02d}-{int(rng.integers(1, 28)):02d}",
                    "score": int(rng.integers(-3, 30)),
                    "body": " ".join(f"w{int(w)}" for w in rng.integers(0, 20, size=4))}
                   for _ in range(int(rng.integers(1, 6)))]
        docs.append((f"q{i}", {"title": f"w{i % 9} w{int(rng.integers(0, 20))}",
                               "tag": f"t{i % 5}", "answers": answers}))
    return docs


def _nested_bodies() -> list:
    return [
        {"nested": {"path": "answers", "query": {"bool": {"must": [
            {"term": {"answers.user": "u3"}}, {"range": {"answers.score": {"gte": 10}}}]}}}},
        {"nested": {"path": "answers", "query": {"range": {
            "answers.date": {"gte": "2015-06-01", "lt": "2015-07-01"}}}}},
        {"nested": {"path": "answers", "query": {"bool": {
            "should": [{"term": {"answers.user": "u1"}}, {"term": {"answers.user": "u2"}}],
            "must_not": [{"range": {"answers.score": {"lt": 0}}}]}}, "boost": 2.0}},
        {"nested": {"path": "answers", "query": {"bool": {"filter": [
            {"match": {"answers.body": "w4 w5"}}, {"exists": {"field": "answers.date"}}],
            "must": [{"terms": {"answers.user": ["u7", "u8", "u9"]}}]}}}},
        {"bool": {"must": [{"match": {"title": "w3"}}], "filter": [
            {"nested": {"path": "answers", "query": {"range": {"answers.score": {"gt": 20}}}}}]}},
    ]


@pytest.fixture(params=[1, 3], ids=["1shard", "3shards"], scope="module")
def qa(request):
    docs = qa_docs(request.param, 400)
    p = Pair(QA, {"number_of_shards": request.param})
    p.index(docs)
    p.refresh()
    one = None
    if request.param > 1:
        one = Pair(QA)
        one.index(docs)
        one.refresh()
    yield p, one, docs
    p.close()
    if one is not None:
        one.close()


def test_seeded_nested(qa):
    p, one, docs = qa
    for q in _nested_bodies():
        got = p.port.search(q, size=len(docs))
        if one is None:
            same_hits(got, p.ref.search(query=q, size=len(docs)), json.dumps(q))
        else:
            want = one.ref.search(query=q, size=len(docs))
            assert _ids(got) == _ids(want) and got["hits"]["total"] == want["hits"]["total"], q
    # an oracle for the first body: some answer by u3 scoring >= 10
    want = {i for i, s in docs if any(a["user"] == "u3" and a["score"] >= 10 for a in s["answers"])}
    assert _ids(p.port.search(_nested_bodies()[0], size=len(docs))) == want


# ---------------------------------------------------------------------------
# percolate (tests/test_percolate_rankeval.py:12-47)
# ---------------------------------------------------------------------------

ALERTS = {"properties": {"query": {"type": "percolator"}, "msg": {"type": "text"},
                         "level": {"type": "keyword"}}}
STORED = [("q1", {"query": {"match": {"msg": "error"}}}),
          ("q2", {"query": {"bool": {"must": [{"match": {"msg": "disk"}},
                                              {"term": {"level": "FATAL"}}]}}}),
          ("q3", {"query": {"range": {"code": {"gte": 500}}}})]
PERCOLATE_REFERENCE = [
    ({"percolate": {"field": "query", "document": {"msg": "disk error", "level": "WARN"}}}, {"q1"}),
    ({"percolate": {"field": "query", "document": {"msg": "disk full", "level": "FATAL"}}}, {"q2"}),
    ({"percolate": {"field": "query", "document": {"code": 503}}}, {"q3"}),
    ({"percolate": {"field": "query", "documents": [{"msg": "all good"}, {"msg": "error here"}]}},
     {"q1"}),
    ({"bool": {"must": [{"percolate": {"field": "query", "document": {"msg": "error"}}},
                        {"ids": {"values": ["q2", "q3"]}}]}}, set()),
]


@pytest.mark.parametrize("shards", [1, 3])
def test_percolate_matches_stored_queries(shards):
    p = Pair(ALERTS, {"number_of_shards": shards})
    try:
        p.index(STORED)
        p.refresh()
        for q, want in PERCOLATE_REFERENCE:
            got, ref = p.search(query=q, size=10)
            assert _ids(got) == want, q
            if shards == 1:
                same_hits(got, ref, json.dumps(q))
    finally:
        p.close()


def test_percolate_query_errors_are_no_match_but_launch_errors_propagate(monkeypatch):
    p = Pair(ALERTS)
    try:
        p.index(STORED + [("bad", {"query": {"no_such_kind": {}}}),
                          ("bad2", {"query": {"term": {}}})])
        p.refresh()
        q = {"percolate": {"field": "query", "document": {"msg": "error"}}}
        got, ref = p.search(query=q, size=10)
        assert _ids(got) == _ids(ref) == {"q1"}

        def boom(self, dev, params, ctx):
            raise RuntimeError("CUDA error: unspecified launch failure")

        monkeypatch.setattr(port_nodes.TermNode, "device_eval", boom)
        with pytest.raises(RuntimeError, match="launch failure"):
            p.port.search(q, size=10)
    finally:
        p.close()


def perc_docs(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        kind = i % 3
        w = [f"w{int(x)}" for x in rng.integers(0, 25, size=2)]
        if kind == 0:
            q = {"match": {"msg": " ".join(w)}}
        elif kind == 1:
            q = {"term": {"level": f"L{int(rng.integers(0, 4))}"}}
        else:
            q = {"bool": {"must": [{"match": {"msg": w[0]}}],
                          "must_not": [{"term": {"level": "L0"}}]}}
        docs.append((f"p{i}", {"query": q, "msg": "stored", "level": f"L{i % 4}"}))
    return docs


def test_seeded_percolate_on_shards_and_tiers():
    docs = perc_docs(4, 90)
    rng = np.random.default_rng(8)
    requests = []
    for _ in range(3):  # each new request costs the reference ~4 s of compiles
        ds = [{"msg": " ".join(f"w{int(x)}" for x in rng.integers(0, 25, size=5)),
               "level": f"L{int(rng.integers(0, 4))}"} for _ in range(int(rng.integers(1, 5)))]
        requests.append({"percolate": {"field": "query", "documents": ds}})
    one = Pair(ALERTS)
    three = Pair(ALERTS, {"number_of_shards": 3})
    tiered = Pair(ALERTS)
    try:
        for pr in (one, three):
            pr.index(docs)
            pr.refresh()
        tiered.index(docs[:60])
        tiered.refresh()
        tiered.index(docs[60:75])
        tiered.refresh()
        tiered.index(docs[75:])
        tiered.refresh()
        for q in requests:
            want = one.ref.search(query=q, size=len(docs))
            same_hits(one.port.search(q, size=len(docs)), want, json.dumps(q))
            got3 = three.port.search(q, size=len(docs))
            assert _ids(got3) == _ids(want) and got3["hits"]["total"] == want["hits"]["total"]
            same_hits(tiered.port.search(q, size=20), tiered.ref.search(query=q, size=20),
                      json.dumps(q))
    finally:
        for pr in (one, three, tiered):
            pr.close()


def test_matchers_on_a_tiered_index():
    """Nested and intervals on base + tail segments: not tier-safe, so the
    tiers merge first, as the reference's do."""
    docs = qa_docs(12, 500)
    p = Pair(QA)
    try:
        p.index(docs[:350])
        p.refresh()
        p.index(docs[350:430])
        p.refresh()
        p.index(docs[430:] + [("q5", {"title": "moved w3", "answers": [{"user": "u3", "score": 25}]})])
        p.refresh()
        for q in _nested_bodies() + [{"intervals": {"title": {"match": {"query": "w3 w1"}}}}]:
            p.check(json.dumps(q), query=q, size=30)
    finally:
        p.close()


def test_matchers_over_rest():
    docs = qa_docs(6, 150)
    app = make_app(device="cpu")
    try:
        assert app.handle("PUT", "/qa", {}, {}, json.dumps({"mappings": QA}).encode())[0] == 200
        nd = "".join(json.dumps({"index": {"_index": "qa", "_id": i}}) + "\n" + json.dumps(s) + "\n"
                     for i, s in docs).encode()
        assert app.handle("POST", "/_bulk", {"refresh": "true"}, {}, nd)[0] == 200
        idx = app.engine.get_index("qa")
        for q in _nested_bodies()[:2] + [{"intervals": {"title": {"match": {"query": "w2 w5"}}}}]:
            st, _h, out = app.handle("POST", "/qa/_search", {}, {},
                                     json.dumps({"query": q, "size": 50}).encode())
            assert st == 200
            same_hits(json.loads(out), idx.search(q, size=50), json.dumps(q))
        assert app.handle("PUT", "/al", {}, {}, json.dumps({"mappings": ALERTS}).encode())[0] == 200
        for i, s in STORED:
            assert app.handle("PUT", f"/al/_doc/{i}", {"refresh": "true"}, {},
                              json.dumps(s).encode())[0] in (200, 201)
        st, _h, out = app.handle("POST", "/al/_search", {}, {}, json.dumps(
            {"query": PERCOLATE_REFERENCE[0][0]}).encode())
        assert st == 200 and _ids(json.loads(out)) == {"q1"}
    finally:
        app.close()
