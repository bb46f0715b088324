"""query_string and simple_query_string: the port's Lucene-syntax parsers
against the JAX package's, as DSL (the same desugared query objects) and as
searches (the same hits), on one shard and on three.

The index is that of the reference's `tests/test_runtime_querystring.py`
(title, body, integer price and qty, keyword tag). Query strings cover
bare terms, AND / OR / NOT, +/-, fields, quoted phrases, ranges, `>=`,
wildcards, fuzzy `~`, `_exists_`, groups and boosts. The reference scores
from its impact tier (ES_TPU_IMPACT=force), as the port does; tolerances
of `torch_parity.same_hits`.
"""

import pytest

from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.query.querystring import parse_query_string as ref_qs
from elasticsearch_tpu.query.querystring import parse_simple_query_string as ref_sqs
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.query.querystring import (parse_query_string,
                                                      parse_simple_query_string)
from elasticsearch_tpu_torch.utils.errors import QueryParsingError
from torch_parity import Pair

MAPPING = {"properties": {"title": {"type": "text"}, "body": {"type": "text"},
                          "price": {"type": "integer"}, "qty": {"type": "integer"},
                          "tag": {"type": "keyword"}}}
ROWS = [
    ("1", {"title": "red widget", "body": "a fine red widget", "price": 10, "qty": 3, "tag": "a"}),
    ("2", {"title": "blue widget", "body": "blue and shiny", "price": 20, "qty": 5, "tag": "b"}),
    ("3", {"title": "red gadget", "body": "gadget of red color", "price": 30, "qty": 2, "tag": "a"}),
    ("4", {"title": "green thing", "body": "just a thing", "price": 40, "qty": 1, "tag": "c"}),
    ("5", {"title": "red red thing", "body": "fine widget of blue color", "price": 25, "tag": "b"}),
]
QS = [
    ("red widget", {}), ("red AND widget", {}), ("title:red", {}), ("red -gadget", {}),
    ('"red widget"', {}), ("price:[20 TO 30]", {}), ("price:{20 TO 30]", {}),
    ("price:>=30", {}), ("price:<25", {}), ("wid*", {}), ("_exists_:tag", {}),
    ("(red OR blue) AND widget", {}), ("widgte~", {}), ("widgte~1", {}),
    ("title:red^2 body:blue", {}), ("NOT red", {}), ("+red +thing", {}),
    ("red widget", {"default_operator": "and"}), ("red", {"fields": ["title"]}),
    ("red widget", {"fields": ["title^3", "body"]}), ('"fine widget"', {"fields": ["body"]}),
    ("tag:a OR tag:c", {}), ("title:(red OR green)", {}), ("title:", {}),
    ("red gadget", {"default_field": "body", "boost": 2}),
]
SQS = [
    ("red widget", {}), ("red +widget", {}), ('"red widget"', {}), ("wid*", {}),
    ("red -thing", {}), ("blue | green", {}), ("red widget", {"default_operator": "and"}),
    ("red", {"fields": ["body"]}), ('"blue color"', {"fields": ["body"]}),
    ("((((", {}), ('"unclosed', {}), ("", {}),
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


def _ids(cases):
    return [f"{i}:{q}" for i, (q, _kw) in enumerate(cases)]


@pytest.mark.parametrize("q, kw", QS, ids=_ids(QS))
def test_query_string_desugars_as_reference(q, kw):
    body = {"query": q, **kw}
    try:
        want = ref_qs(body, RefMappings(MAPPING))
    except Exception as ex:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(QueryParsingError, match=str(ex)[:20].replace("[", "\\[")):
            parse_query_string(body, Mappings(MAPPING))
        return
    assert parse_query_string(body, Mappings(MAPPING)) == want


@pytest.mark.parametrize("q, kw", SQS, ids=_ids(SQS))
def test_simple_query_string_desugars_as_reference(q, kw):
    body = {"query": q, **kw}
    assert parse_simple_query_string(body, Mappings(MAPPING)) == \
        ref_sqs(body, RefMappings(MAPPING))


@pytest.fixture(scope="module", params=[1, 3], ids=["1shard", "3shards"])
def pair(request):
    p = Pair(MAPPING, {"number_of_shards": request.param})
    p.index(ROWS)
    p.refresh()
    yield p
    p.close()


# the strings both parsers refuse (a field prefix without a value)
_REFUSED = ("title:", "title:(red OR green)")
_SEARCHED = [c for c in QS if c[0] not in _REFUSED]


@pytest.mark.parametrize("q, kw", _SEARCHED, ids=_ids(_SEARCHED))
def test_query_string_searches_match_reference(pair, q, kw):
    pair.check("query_string", query={"query_string": {"query": q, **kw}}, size=10)


@pytest.mark.parametrize("q, kw", SQS, ids=_ids(SQS))
def test_simple_query_string_searches_match_reference(pair, q, kw):
    pair.check("simple_query_string", query={"simple_query_string": {"query": q, **kw}},
               size=10)


def test_expected_answers(pair):
    def ids(q):
        got = pair.port.search({"query_string": {"query": q}}, size=10)
        return {h["_id"] for h in got["hits"]["hits"]}

    assert ids("red AND widget") == {"1", "5"}
    assert ids('"red widget"') == {"1"}
    assert ids("price:[20 TO 30]") == {"2", "3", "5"}
    assert ids("(red OR blue) AND widget") == {"1", "2", "5"}
    assert ids("widgte~") == {"1", "2", "5"}


def test_malformed_query_string_is_a_400(pair):
    for q in ("(unclosed AND paren", *_REFUSED):
        with pytest.raises(QueryParsingError) as ei:
            pair.port.search({"query_string": {"query": q}})
        assert ei.value.status == 400
    with pytest.raises(QueryParsingError):
        pair.port.search({"query_string": {"fields": ["title"]}})
