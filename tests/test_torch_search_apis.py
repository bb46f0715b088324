"""The port's search-side APIs against the JAX package's: `_explain`
(`EsIndex.explain`), `_field_caps` (`Engine.field_caps`), `_mget`
(`Engine.mget`), and `engine/admin.py`'s `_analyze`, `_validate/query` and
`_termvectors`, with their REST routes (`_mtermvectors` too).

The reference's tests/test_search_surface.py mget, field_caps and explain
cases, and the analyze / validate / termvectors part of
tests/test_admin_apis.py::test_admin_apis, run through both packages. Then
seeded indices on 1 and 3 shards, on a fresh base and after a tiered
refresh (new docs, updates, deletes): `_explain` of matching and
non-matching docs under match, term, bool (each must and should clause
scored alone) and range queries; term vectors with `term_statistics` (df
over every tier); `_mget` with every `_source` form; field caps over
indices whose field types differ; analyze with each analyzer and field;
validation of good and bad queries, with and without `explain`.

Tolerances: explanation values within 1e-6 relative (each is an exact
BM25 score, `mark_exact`, where XLA on the CPU may contract a multiply-add),
descriptions and matched flags `==`; everything else `==`.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.engine import Engine as RefEngine
from elasticsearch_tpu.engine import admin as ref_admin
from elasticsearch_tpu.utils.errors import ElasticsearchTpuError as RefError
from elasticsearch_tpu_torch.engine import Engine, admin
from elasticsearch_tpu_torch.utils.errors import DocumentMissingError, ElasticsearchTpuError
from torch_parity import MAPPING, close, rest_both, text_docs


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")


def _surface(cls, kw):
    e = cls(None, **kw) if cls is RefEngine else cls(**kw)
    idx = e.create_index("docs", {"properties": {
        "body": {"type": "text"}, "n": {"type": "long"}, "tag": {"type": "keyword"}}})
    for i in range(25):
        idx.index_doc(f"d{i}", {"body": f"word{'x' if i % 2 else 'y'} common", "n": i,
                                "tag": f"t{i % 3}"})
    idx.refresh()
    return e


@pytest.fixture
def engines():
    port, ref = _surface(Engine, {"device": "cpu"}), _surface(RefEngine, {})
    yield port, ref
    port.close()
    ref.close()


def _same_explanation(got: dict, want: dict) -> None:
    assert got["_id"] == want["_id"] and got["matched"] == want["matched"]
    ge, we = got["explanation"], want["explanation"]
    assert ge["description"] == we["description"]
    assert close(ge["value"], we["value"], 1e-6), (ge, we)
    assert [d["description"] for d in ge["details"]] == [d["description"] for d in we["details"]]
    for a, b in zip(ge["details"], we["details"]):
        assert close(a["value"], b["value"], 1e-6), (a, b)


class TestMget:
    def test_mget_mixed(self, engines):
        port, ref = engines
        items = [("docs", "d1"), ("docs", "nope"), ("ghost", "d1")]
        docs = port.mget(items)
        assert docs == ref.mget(items)
        assert docs[0]["found"] is True and docs[0]["_source"]["n"] == 1
        assert docs[1]["found"] is False
        assert docs[2]["error"]["type"] == "index_not_found_exception"


class TestFieldCaps:
    def test_union_across_indices(self, engines):
        for e in engines:
            e.create_index("docs2", {"properties": {
                "n": {"type": "double"}, "extra": {"type": "keyword"}}}).refresh()
        port, ref = engines
        res = port.field_caps("docs,docs2", "*")
        assert res == ref.field_caps("docs,docs2", "*")
        assert set(res["indices"]) == {"docs", "docs2"}
        assert set(res["fields"]["n"]) == {"long", "double"}
        assert res["fields"]["n"]["long"]["indices"] == ["docs"]
        assert res["fields"]["body"]["text"]["aggregatable"] is False
        assert res["fields"]["tag"]["keyword"]["aggregatable"] is True

    def test_field_filter(self, engines):
        port, ref = engines
        res = port.field_caps("docs", "n,ta*")
        assert set(res["fields"]) == {"n", "tag"} and res == ref.field_caps("docs", "n,ta*")


class TestExplain:
    def test_explain_matching(self, engines):
        port, ref = engines
        r = port.get_index("docs").explain("d1", {"match": {"body": "wordx"}})
        assert r["matched"] is True and r["explanation"]["value"] > 0
        _same_explanation(r, ref.get_index("docs").explain("d1", {"match": {"body": "wordx"}}))
        res = port.get_index("docs").search(query={"match": {"body": "wordx"}}, size=25)
        by_id = {h["_id"]: h["_score"] for h in res["hits"]["hits"]}
        assert r["explanation"]["value"] == pytest.approx(by_id["d1"], rel=1e-5)

    def test_explain_non_matching(self, engines):
        port, ref = engines
        r = port.get_index("docs").explain("d2", {"match": {"body": "wordx"}})
        assert r["matched"] is False
        assert r == ref.get_index("docs").explain("d2", {"match": {"body": "wordx"}})

    def test_explain_missing_doc(self, engines):
        with pytest.raises(DocumentMissingError):
            engines[0].get_index("docs").explain("nope", {"match_all": {}})

    def test_explain_bool_details(self, engines):
        port, ref = engines
        q = {"bool": {"must": [{"match": {"body": "wordx"}}],
                      "should": [{"match": {"body": "common"}}]}}
        r = port.get_index("docs").explain("d1", q)
        assert r["matched"] is True
        assert len(r["explanation"]["details"]) == 2
        total = sum(d["value"] for d in r["explanation"]["details"])
        assert r["explanation"]["value"] == pytest.approx(total, rel=1e-5)
        _same_explanation(r, ref.get_index("docs").explain("d1", q))


def test_admin_apis(tmp_path):
    """The analyze, validate and termvectors part of the reference's
    tests/test_admin_apis.py::test_admin_apis, through both apps."""
    nd = "".join(json.dumps({"index": {"_index": "logs", "_id": str(i)}}) + "\n"
                 + json.dumps({"msg": f"error in module {i}",
                               "level": "ERROR" if i % 2 else "INFO"}) + "\n" for i in range(6))
    seq = [
        ("put", "PUT", "/logs", {"mappings": {"properties": {
            "msg": {"type": "text"}, "level": {"type": "keyword"}}}}, {}),
        ("bulk", "POST", "/_bulk", nd, {}),
        ("refresh", "POST", "/logs/_refresh", None, {}),
        ("analyze", "POST", "/_analyze", {"analyzer": "standard",
                                          "text": "Hello, World's TPUs!"}, {}),
        ("analyze_field", "POST", "/logs/_analyze", {"field": "msg", "text": "A B"}, {}),
        ("validate", "POST", "/logs/_validate/query", {"query": {"match": {"msg": "error"}}},
         {"explain": "true"}),
        ("invalid", "POST", "/logs/_validate/query", {"query": {"no_such_query": {}}}, {}),
        ("tv", "GET", "/logs/_termvectors/1", None, {"term_statistics": "true"}),
    ]
    port, ref = rest_both(seq, tmp_path)
    toks = port["analyze"][1]["tokens"]
    assert [t["token"] for t in toks] == ["hello", "world's", "tpus"]
    assert toks[0]["start_offset"] == 0 and toks[0]["position"] == 0
    assert [t["token"] for t in port["analyze_field"][1]["tokens"]] == ["a", "b"]
    body = port["validate"][1]
    assert body["valid"] and body["explanations"][0]["valid"]
    assert port["invalid"][1]["valid"] is False
    tv = port["tv"][1]
    assert tv["found"] and "msg" in tv["term_vectors"]
    assert tv["term_vectors"]["msg"]["terms"]["error"]["term_freq"] == 1
    for name in ("analyze", "analyze_field", "validate", "tv"):
        assert port[name] == ref[name], name
    assert {k: v for k, v in port["invalid"][1].items() if k != "error"} == \
        {k: v for k, v in ref["invalid"][1].items() if k != "error"}


# ---------------------------------------------------------------------------
# seeded indices, 1 and 3 shards, fresh and tiered
# ---------------------------------------------------------------------------

class Both:
    def __init__(self, shards: int, tiered: bool, seed: int):
        self.ref, self.port = RefEngine(None), Engine(device="cpu")
        rng = np.random.default_rng(seed)
        docs = text_docs(seed, 120)
        for e in (self.ref, self.port):
            idx = e.create_index("s", MAPPING, {"number_of_shards": shards})
            for i, d in docs:
                idx.index_doc(i, d)
            idx.refresh()
        self.ids = [i for i, _ in docs]
        if tiered:
            more = text_docs(seed + 1, 30)
            more = [(i if k % 2 else f"{i}-n", d) for k, (i, d) in enumerate(more)]
            self.gone = sorted({f"d{int(x)}" for x in rng.integers(30, 120, 8)})
            for e in (self.ref, self.port):
                idx = e.get_index("s")
                for i, d in more:
                    idx.index_doc(i, d)
                for i in self.gone:
                    idx.delete_doc(i)
                idx.refresh()
            assert self.port.get_index("s")._tails
            self.ids += [i for i, _ in more]
        else:
            self.gone = []

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.mark.parametrize("tiered", [False, True], ids=["fresh", "tiered"])
@pytest.mark.parametrize("shards", [1, 3])
def test_explain_matches_reference(shards, tiered):
    b = Both(shards, tiered, seed=shards + 4 * tiered)
    try:
        rng = np.random.default_rng(shards * 7 + tiered)
        matched = 0
        for j in range(12):
            doc = str(rng.choice([i for i in b.ids if i not in b.gone]))
            w = [f"w{int(x)}" for x in rng.integers(0, 20, 3)]
            q = [{"match": {"body": " ".join(w[:2])}},
                 {"bool": {"must": [{"match": {"body": w[0]}}],
                           "should": [{"match": {"body": w[1]}}, {"term": {"tag": "k03"}}],
                           "filter": [{"range": {"n": {"gte": 5}}}]}},
                 {"term": {"body": w[2]}},
                 {"bool": {"should": [{"match": {"title": w[0]}}, {"match": {"body": w[1]}}]}},
                 ][j % 4]
            got = b.port.get_index("s").explain(doc, q)
            _same_explanation(got, b.ref.get_index("s").explain(doc, q))
            matched += got["matched"]
        assert 0 < matched < 12
        for e in (b.port, b.ref):
            with pytest.raises((ElasticsearchTpuError, RefError)):
                e.get_index("s").explain("never-written", {"match_all": {}})
        if b.gone:
            with pytest.raises(DocumentMissingError):
                b.port.get_index("s").explain(b.gone[0], {"match_all": {}})
    finally:
        b.close()


@pytest.mark.parametrize("tiered", [False, True], ids=["fresh", "tiered"])
@pytest.mark.parametrize("shards", [1, 3])
def test_termvectors_with_term_statistics_match_reference(shards, tiered):
    b = Both(shards, tiered, seed=20 + shards + tiered)
    try:
        rng = np.random.default_rng(shards + 2 * tiered)
        for doc in list(rng.choice(b.ids, 8)) + (b.gone[:1] or ["absent"]):
            for body, fields in (({"term_statistics": True}, None),
                                 ({"fields": ["title"], "term_statistics": True}, None),
                                 (None, "body"), ({}, None)):
                got = admin.termvectors(b.port, "s", str(doc), body, fields)
                want = ref_admin.termvectors(b.ref, "s", str(doc), body, fields)
                assert got == want, (doc, body, fields)
        # df counts every tier: the tiers merged first, in both packages
        assert not b.port.get_index("s")._tails
    finally:
        b.close()


def test_analyze_and_validate_match_reference():
    ports, refs = Engine(device="cpu"), RefEngine(None)
    try:
        settings = {"analysis": {"analyzer": {"mine": {
            "type": "custom", "tokenizer": "whitespace", "filter": ["lowercase"]}}}}
        mapping = {"properties": {"t": {"type": "text", "analyzer": "english"},
                                  "c": {"type": "text", "analyzer": "mine"},
                                  "k": {"type": "keyword"}, "n": {"type": "long"}}}
        for e in (ports, refs):
            e.create_index("a", mapping, settings)
        texts = ["The Quick-Brown FOXES jumped!", ["two values", "Running runners"], "",
                 "email@example.com 3.14 don't"]
        for text in texts:
            for body in ({"text": text}, {"text": text, "analyzer": "whitespace"},
                         {"text": text, "analyzer": "english"},
                         {"text": text, "analyzer": "keyword"},
                         {"text": text, "field": "t"}, {"text": text, "field": "c"},
                         {"text": text, "field": "k"}, {"text": text, "field": "nope"}):
                for index in ("a", None):
                    assert admin.analyze(ports, index, dict(body)) == \
                        ref_admin.analyze(refs, index, dict(body)), (index, body)
        for e, mod, err in ((ports, admin, ElasticsearchTpuError), (refs, ref_admin, RefError)):
            with pytest.raises(err):
                mod.analyze(e, None, {"analyzer": "standard"})
            with pytest.raises(err):
                mod.analyze(e, None, {"text": "x", "analyzer": "no_such_analyzer"})
        queries = [{"match": {"t": "fox"}}, {"term": {"k": "x"}}, {"range": {"n": {"gte": 3}}},
                   {"bool": {"must": [{"match": {"c": "a b"}}],
                             "must_not": [{"term": {"k": "z"}}]}},
                   None, {"range": {"n": {"gte": "abc"}}}, {"bool": {"must": "x"}},
                   {"no_such_query": {}}]
        for q in queries:
            for explain in (False, True):
                for expr in ("a", None, "*"):
                    got = admin.validate_query(ports, expr, {"query": q}, explain)
                    want = ref_admin.validate_query(refs, expr, {"query": q}, explain)
                    assert got["valid"] == want["valid"], q
                    if got["valid"]:
                        assert got == want, q
                    elif explain:
                        assert [x["valid"] for x in got["explanations"]] == \
                            [x["valid"] for x in want["explanations"]]
    finally:
        ports.close()
        refs.close()


def test_rest_search_apis_match_reference(tmp_path):
    docs = text_docs(9, 30)
    nd = "".join(json.dumps({"index": {"_index": ix, "_id": i}}) + "\n" + json.dumps(d) + "\n"
                 for ix in ("r1", "r2") for i, d in docs)
    r2 = {"properties": {**MAPPING["properties"], "n": {"type": "double"},
                         "extra": {"type": "keyword"}}}
    seq = [
        ("put1", "PUT", "/r1", {"mappings": MAPPING}, {}),
        ("put2", "PUT", "/r2", {"mappings": r2}, {}),
        ("bulk", "POST", "/_bulk", nd, {"refresh": "true"}),
        ("mget_docs", "POST", "/_mget", {"docs": [
            {"_index": "r1", "_id": "d1"}, {"_index": "r2", "_id": "d2", "_source": ["n"]},
            {"_index": "r2", "_id": "zz"}, {"_index": "nope", "_id": "d1"},
            {"_index": "r1", "_id": "d3", "_source": False}]}, {}),
        ("mget_ids", "POST", "/r1/_mget", {"ids": ["d4", "d5", "x"]}, {}),
        ("mget_includes", "POST", "/r1/_mget", {"ids": ["d4", "d6"]},
         {"_source_includes": "n,tag"}),
        ("mget_excludes", "GET", "/r1/_mget", {"ids": ["d4"]}, {"_source_excludes": "body"}),
        ("mget_source", "POST", "/r1/_mget", {"docs": [{"_id": "d4"}, {"_id": "d7",
                                                                     "_source": True}]},
         {"_source": "title"}),
        ("mget_no_index", "POST", "/_mget", {"docs": [{"_id": "d1"}]}, {}),
        ("mget_ids_no_index", "POST", "/_mget", {"ids": ["d1"]}, {}),
        ("mget_bad", "POST", "/_mget", {"x": 1}, {}),
        ("caps", "GET", "/_field_caps", None, {"fields": "*"}),
        ("caps_idx", "POST", "/r1,r2/_field_caps", {"fields": ["n", "ex*"]}, {}),
        ("explain", "POST", "/r1/_explain/d3", {"query": {"bool": {
            "must": [{"match": {"body": "w1"}}], "should": [{"match": {"body": "w2"}}]}}}, {}),
        ("explain_q", "GET", "/r1/_explain/d3", None, {"q": "body:w1"}),
        ("explain_none", "POST", "/r1/_explain/d3", {}, {}),
        ("explain_missing", "POST", "/r1/_explain/zz", {"query": {"match_all": {}}}, {}),
        ("mtv", "POST", "/r1/_mtermvectors", {"ids": ["d1", "d2", "zz"]}, {}),
        ("mtv_docs", "POST", "/_mtermvectors", {"docs": [
            {"_index": "r2", "_id": "d1", "term_statistics": True},
            {"_id": "d1"}, {"_index": "nope", "_id": "d1"}]}, {}),
        ("tv_fields", "GET", "/r1/_termvectors/d5", None, {"fields": "title"}),
        ("analyze_get", "GET", "/_analyze", None, {"text": "Foo Bar", "analyzer": "whitespace"}),
        ("analyze_field", "GET", "/r1/_analyze", None, {"text": "Foo Bar", "field": "body"}),
        ("validate_all", "POST", "/_validate/query", {"query": {"match": {"body": "w1"}}}, {}),
    ]
    port, ref = rest_both(seq, tmp_path)
    for name in port:
        assert port[name][0] == ref[name][0], (name, port[name], ref[name])
        if name.startswith(("put", "bulk")):
            continue
        if name.startswith("explain") and port[name][0] == 200:
            _same_explanation(port[name][1], ref[name][1])
        else:
            assert port[name] == ref[name], name
    assert port["caps"][1]["fields"]["n"]["double"]["indices"] == ["r2"]
