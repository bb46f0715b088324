"""Multi-term expansions and the other new query kinds: the port's `prefix`,
`wildcard`, `regexp`, `fuzzy`, `ids`, keyword `range`, `dis_max`,
`multi_match` (best_fields, most_fields, bool_prefix) and
`match_bool_prefix` against the JAX package's, on one shard, on three
shards and on a base with tail segments.

The fixed documents are those of the reference's `tests/test_multiterm.py`
(prefix, wildcard and regexp on text and keyword fields, fuzzy edit
distances, transpositions, prefix_length, AUTO:low,high); the seeded
corpus is `torch_parity.text_docs`. The reference scores from its impact
tier (ES_TPU_IMPACT=force), as the port does. A fuzzy query sums its
expanded terms per doc in f64, rounded once (the reference adds in f32 in
lane order): tolerances of `torch_parity.same_hits` (scores within 1e-6
relative, ids up to fp-ties, totals equal).
"""

import json

import pytest
import torch

from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.query.nodes import MAX_CLAUSE_COUNT, ExpandedTermsNode
from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuError, IllegalArgumentError,
                                                  QueryParsingError)
from torch_parity import MAPPING, Pair, text_docs

FIXED_MAPPING = {"properties": {"body": {"type": "text"}, "tag": {"type": "keyword"}}}
FIXED_DOCS = [
    {"body": "apple pie baking", "tag": "food-dessert"},
    {"body": "application server", "tag": "tech-infra"},
    {"body": "apply for a job", "tag": "work"},
    {"body": "banana bread", "tag": "food-bread"},
    {"body": "grape jelly", "tag": "food-spread"},
]
FIXED_CASES = [
    {"prefix": {"body": "appl"}},
    {"prefix": {"tag": {"value": "food", "boost": 2.5}}},
    {"prefix": {"tag": "tech"}},
    {"prefix": {"body": {"value": "APP", "case_insensitive": True}}},
    {"wildcard": {"tag": "food-*d"}},
    {"wildcard": {"body": "appl?"}},
    {"wildcard": {"tag": {"value": "FOOD-*", "case_insensitive": True}}},
    {"wildcard": {"tag": {"wildcard": "food-*"}}},
    {"regexp": {"tag": "food-(bread|spread)"}},
    {"fuzzy": {"body": "aple"}},
    {"fuzzy": {"body": {"value": "aple", "fuzziness": 2}}},
    {"fuzzy": {"body": {"value": "appel", "fuzziness": 1}}},
    {"fuzzy": {"body": {"value": "appel", "fuzziness": 1, "transpositions": False}}},
    {"fuzzy": {"body": {"value": "bpple", "fuzziness": 1, "prefix_length": 1}}},
    {"fuzzy": {"body": {"value": "aple", "fuzziness": "AUTO:6,8"}}},
    {"bool": {"must": [{"match": {"body": "bread"}}], "filter": [{"prefix": {"tag": "food"}}]}},
    {"ids": {"values": ["1", "3", "missing"]}},
    {"range": {"tag": {"gte": "food-bread", "lt": "tech"}}},
    {"range": {"tag": {"gt": "food-bread"}}},
    {"range": {"tag": {"lte": "food-spread"}}},
    {"match_bool_prefix": {"body": "banana bre"}},
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
    p = Pair(FIXED_MAPPING, {"number_of_shards": request.param})
    p.index([(str(i), d) for i, d in enumerate(FIXED_DOCS)])
    p.refresh()
    yield p
    p.close()


@pytest.mark.parametrize("q", FIXED_CASES,
                         ids=[f"{list(q)[0]}{i}" for i, q in enumerate(FIXED_CASES)])
def test_fixed_cases_match_reference(fixed, q):
    fixed.check("fixed", query=q, size=10)


def test_expected_counts(fixed):
    def total(q):
        return fixed.port.search(q, size=10)["hits"]["total"]["value"]

    assert total({"prefix": {"body": "appl"}}) == 3
    assert total({"wildcard": {"body": "appl?"}}) == 2  # apple, apply
    assert total({"fuzzy": {"body": {"value": "appel", "fuzziness": 1}}}) == 1
    assert total({"fuzzy": {"body": {"value": "appel", "fuzziness": 1,
                                     "transpositions": False}}}) == 0
    assert total({"ids": {"values": ["1", "3", "missing"]}}) == 2


def test_bad_patterns_are_refused(fixed):
    with pytest.raises(QueryParsingError):
        fixed.port.search({"regexp": {"tag": "food-("}})
    with pytest.raises(QueryParsingError):
        fixed.port.search({"fuzzy": {"body": {"value": "aple", "fuzziness": "AUTO:x,y"}}})


def _corpus_queries():
    return [
        {"prefix": {"body": "w1"}},
        {"wildcard": {"body": "w1?"}},
        {"regexp": {"body": "w[2-4][0-9]"}},
        {"fuzzy": {"body": {"value": "w12", "fuzziness": 1}}},
        {"fuzzy": {"body": {"value": "w40", "fuzziness": "AUTO", "max_expansions": 3}}},
        {"ids": {"values": ["d3", "d10", "d99", "d400"]}},
        {"range": {"tag": {"gte": "k03", "lt": "k07"}}},
        {"dis_max": {"queries": [{"match": {"body": "w1 w2"}}, {"match": {"title": "w1"}}],
                     "tie_breaker": 0.3}},
        {"multi_match": {"query": "w1 w3", "fields": ["body", "title^2"]}},
        {"multi_match": {"query": "w1 w3", "fields": ["body", "title"], "type": "most_fields"}},
        {"multi_match": {"query": "w1 w1", "fields": ["body", "title"], "type": "bool_prefix"}},
        {"match_bool_prefix": {"body": "w2 w1"}},
        {"bool": {"should": [{"prefix": {"title": "w2"}}, {"fuzzy": {"body": "w33"}}],
                  "must_not": [{"range": {"tag": {"lt": "k02"}}}]}},
    ]


@pytest.mark.parametrize("shards", [1, 3])
def test_corpus_kinds_match_reference(shards):
    p = Pair(MAPPING, {"number_of_shards": shards})
    try:
        p.index(text_docs(11, 600))
        p.refresh()
        for q in _corpus_queries():
            p.check(f"{shards} shards", query=q, size=12)
            p.check(f"{shards} shards page 2", query=q, size=6, from_=6)
    finally:
        p.close()


def test_kinds_on_tiers_match_reference():
    """Base + two tail segments: prefix, wildcard, regexp, fuzzy and
    dis_max run on each tier under the combined statistics; ids and the
    keyword range resolve against each tier's own dictionary."""
    docs = text_docs(12, 700)
    p = Pair(MAPPING)
    try:
        p.index(docs[:500])
        p.refresh()
        p.index(docs[500:600])
        p.refresh()
        p.index(docs[600:] + [("d5", {"body": "w1 w12 w13", "tag": "k05"})])
        p.refresh()
        assert len(p.port._tails) == 2
        for q in _corpus_queries():
            p.check("tiers", query=q, size=10)
        assert len(p.port._tails) == 2  # every kind above is tier-safe
    finally:
        p.close()


def test_max_clause_count_refusal():
    """An expansion past MAX_CLAUSE_COUNT terms is the reference's 400."""
    docs = [(str(i), {"body": f"z{i}"}) for i in range(MAX_CLAUSE_COUNT + 5)]
    p = Pair(FIXED_MAPPING)
    try:
        p.index(docs)
        p.refresh()
        with pytest.raises(IllegalArgumentError, match="max_clause_count") as ei:
            p.port.search({"prefix": {"body": "z"}})
        assert ei.value.status == 400
        with pytest.raises(Exception, match="max_clause_count"):
            p.ref.search(query={"prefix": {"body": "z"}})
        p.check("under the cap", query={"prefix": {"body": "z40"}}, size=5)
    finally:
        p.close()


def test_fuzzy_sum_is_deterministic():
    """A scored fuzzy query sums its lanes per doc with no float atomics:
    two runs give the same bits, and each doc's score is the f64 sum of its
    expanded terms' BM25 rounded once."""
    p = Pair(MAPPING)
    try:
        p.index(text_docs(13, 300))
        p.refresh()
        s = p.port.searcher
        node = parse_query({"fuzzy": {"body": {"value": "w15", "fuzziness": 1}}}, Mappings(MAPPING))
        assert isinstance(node, ExpandedTermsNode) and node.scored
        a = node.device_eval(s.dev, node.prepare(s.view), s.ctx)
        b = node.device_eval(s.dev, node.prepare(s.view), s.ctx)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert int(a[1].sum()) > 0 and not bool(a[1][-1])  # the dead slot never matches
    finally:
        p.close()


@pytest.mark.parametrize("kind", ["terms_set", "geo_bounding_box", "intervals", "nested",
                                  "more_like_this", "geo_distance", "percolate", "wrapper"])
def test_unported_kinds_still_answer_not_yet_ported(kind):
    """These kinds are ported (tests/test_torch_geo.py, test_torch_extra.py,
    test_torch_matchers.py): an empty body is the kind's own 400, not "not
    yet ported"; a kind neither package registers still answers "not yet
    ported"."""
    with pytest.raises(ElasticsearchTpuError) as ei:
        parse_query({kind: {}}, Mappings(MAPPING))
    assert ei.value.status == 400 and "not yet ported" not in str(ei.value)
    with pytest.raises(QueryParsingError, match="not yet ported") as ei:
        parse_query({f"span_{kind}": {}}, Mappings(MAPPING))
    assert ei.value.status == 400


@pytest.mark.parametrize("q", [
    {"prefix": {"body": "w1"}}, {"wildcard": {"body": "w1?"}}, {"wildcard": {"body": "*1"}},
    {"regexp": {"body": "w1[0-9]"}}, {"regexp": {"body": "w1?3"}}, {"regexp": {"body": "w1{0,1}2"}},
    {"regexp": {"body": "w1|w2"}}, {"regexp": {"body": "w[1-3]+"}},
    {"fuzzy": {"body": {"value": "w12", "fuzziness": 1, "prefix_length": 2}}},
    {"wildcard": {"body": {"value": "W1*", "case_insensitive": True}}},
], ids=lambda q: json.dumps(q))
def test_literal_prefix_walk_expands_as_the_full_walk(q):
    """The walk over the dictionary's literal-prefix run finds the terms
    the full walk finds."""
    p = Pair(MAPPING)
    try:
        p.index(text_docs(14, 200))
        p.refresh()
        pack = p.port.searcher.pack
        node = parse_query(q, Mappings(MAPPING))
        full = ExpandedTermsNode(**{**node.__dict__, "literal_prefix": ""})
        a, b = node.prepare(pack), full.prepare(pack)
        assert a[0].tolist() == b[0].tolist() and a[1].tolist() == b[1].tolist()
    finally:
        p.close()
