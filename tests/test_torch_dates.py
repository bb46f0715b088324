"""The `date` and `boolean` field types: the port's mappings, parsing,
formatting, packing and queries against the JAX package's.

Date parsing (`parse_date_to_millis`, `parse_date_with_formats`) and
formatting (`format_date_millis`) are compared value for value on the
reference's own inputs (`index/mappings.py:64-175`: year and year-month
prefixes, offsets with and without a colon, a space for the T, epoch
millis as a number and as a string, java patterns with ||-alternatives);
`range` / `term` / `terms` on date and boolean fields return the same hits
(ids, equal totals); an unknown type answers the reference's 400 (date_nanos
is ported: tests/test_torch_types.py; completion: tests/test_torch_suggest.py).
"""

import numpy as np
import pytest

from elasticsearch_tpu.engine.engine import Engine as RefEngine
from elasticsearch_tpu.index import mappings as ref_mappings
from elasticsearch_tpu.utils import errors as ref_errors
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.index import mappings
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuError, MapperParsingError

DATE_INPUTS = [
    "2015-01-01", "2015-01-01T12:30:00Z", "2015-01-01T12:30:00.123Z", "2015-01-01 12:30",
    "2015-01-01T12:30:00+0100", "2015-01-01T12:30:00-05:30", "2015", "2015-07",
    "1999-12-31T23:59:59.999", "1420070400000", "-86400000", 1420070400000, 0, -1, 12.7,
    "1969-07-20T20:17:40Z", "2262-04-11",
]
FORMATS = [
    ("yyyy/MM/dd HH:mm:ss||yyyy/MM/dd||epoch_millis", ["2015/01/02 10:11:12", "2015/01/02",
                                                      "1420070400000", 1420070400000]),
    ("epoch_second", [1420070400, "1420070400"]),
    ("dd-MM-yyyy", ["02-01-2015"]),
    ("strict_date_optional_time||epoch_millis", ["2015-01-02T03:04:05Z", 5]),
    ("yyyy-MM-dd'T'HH", ["2015-01-02T03"]),
    ("yyyyMMddHHmmssSSS", ["20150102030405123"]),
]


@pytest.mark.parametrize("value", DATE_INPUTS, ids=str)
def test_parse_date_to_millis_matches_reference(value):
    assert mappings.parse_date_to_millis(value) == ref_mappings.parse_date_to_millis(value)


@pytest.mark.parametrize("value", ["not a date", "2015-13-45", True, None, "15-1-1"], ids=str)
def test_bad_dates_raise_as_the_reference(value):
    with pytest.raises(Exception) as ref_ex:
        ref_mappings.parse_date_to_millis(value)
    with pytest.raises(MapperParsingError) as ex:
        mappings.parse_date_to_millis(value)
    assert type(ref_ex.value).__name__ == type(ex.value).__name__


@pytest.mark.parametrize("fmt,values", FORMATS, ids=[f for f, _ in FORMATS])
def test_parse_date_with_formats_matches_reference(fmt, values):
    for v in values:
        try:
            want = ref_mappings.parse_date_with_formats(v, fmt)
        except Exception as ex:  # noqa: BLE001 - the port must fail the same way
            with pytest.raises(MapperParsingError) as got:
                mappings.parse_date_with_formats(v, fmt)
            assert type(ex).__name__ == type(got.value).__name__
            continue
        assert mappings.parse_date_with_formats(v, fmt) == want, (fmt, v)


@pytest.mark.parametrize("fmt", [None, "epoch_millis", "epoch_second", "yyyy/MM/dd HH:mm:ss",
                                 "yyyy-MM-dd'T'HH:mm:ss.SSS", "strict_date_optional_time",
                                 "dd-MM-yyyy||epoch_millis"])
def test_format_date_millis_matches_reference(fmt):
    rng = np.random.default_rng(2)
    for ms in [0, 1420070400123, -86400001, *rng.integers(-2**40, 2**42, 20).tolist()]:
        assert mappings.format_date_millis(ms, fmt) == ref_mappings.format_date_millis(ms, fmt)


def test_dynamic_mapping_detects_dates_and_booleans():
    m, r = Mappings(), ref_mappings.Mappings()
    doc = {"when": "2015-01-01T00:00:00Z", "day": "2015-02-03", "flag": True,
           "text": "2015 was a year", "n": 3}
    assert m.parse_document(doc) == r.parse_document(doc)
    assert {f: ft.type for f, ft in m.fields.items()} == \
        {f: ft.type for f, ft in r.fields.items()}
    assert m.fields["when"].type == "date" and m.fields["flag"].type == "boolean"
    assert m.to_dict() == r.to_dict()


def test_date_nanos_and_unported_types_answer_400():
    """date_nanos, geo_point, ip and completion are ported
    (tests/test_torch_types.py, tests/test_torch_suggest.py); a type that
    neither package knows answers the reference's 400, at mapping and at
    index creation."""
    for t in ("date_nanos", "geo_point", "ip", "completion"):
        assert Mappings({"properties": {"x": {"type": t}}}).fields["x"].type == t
    with pytest.raises(MapperParsingError) as ex:
        Mappings({"properties": {"x": {"type": "no_such_type"}}})
    with pytest.raises(ref_errors.MapperParsingError) as ref_ex:
        ref_mappings.Mappings({"properties": {"x": {"type": "no_such_type"}}})
    assert ex.value.status == 400 and str(ex.value) == str(ref_ex.value)
    engine = Engine(device="cpu")
    with pytest.raises(ElasticsearchTpuError) as ex:
        engine.create_index("sugg", {"properties": {"t": {"type": "no_such_type"}}})
    assert ex.value.status == 400
    assert engine.create_index("sugg", {"properties": {"t": {"type": "completion"}}})
    idx = engine.create_index("nanos", {"properties": {"t": {"type": "date_nanos"}}})
    idx.index_doc("a", {"t": "2024-01-02T03:04:05.123456789Z"})
    idx.refresh()
    assert idx.search({"range": {"t": {"gt": "2024-01-02T03:04:05.123456788Z"}}})[
        "hits"]["total"]["value"] == 1


def test_bad_boolean_and_date_values_fail_the_document():
    m = Mappings({"properties": {"b": {"type": "boolean"}, "d": {"type": "date"}}})
    with pytest.raises(MapperParsingError):
        m.parse_document({"b": "yes"})
    with pytest.raises(MapperParsingError):
        m.parse_document({"d": "tomorrow"})
    assert m.parse_document({"b": "false", "d": "2015"}) == {
        "b": [False], "d": [1420070400000]}


MAPPING = {"properties": {"ts": {"type": "date"}, "day": {"type": "date", "format": "yyyy/MM/dd"},
                          "ok": {"type": "boolean"}, "n": {"type": "long"}}}


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(9)
    ref_e, port_e = RefEngine(None), Engine(device="cpu")
    ref = ref_e.create_index("d", MAPPING, {"number_of_shards": 2})
    port = port_e.create_index("d", MAPPING, {"number_of_shards": 2})
    for i in range(600):
        ms = 1_420_070_400_000 + int(rng.integers(0, 60 * 86_400_000))
        d = {"ts": ms if i % 2 else mappings.format_date_millis(ms, None),
             "day": f"2015/{int(rng.integers(1, 13)):02d}/{int(rng.integers(1, 29)):02d}",
             "ok": bool(rng.integers(2)) if i % 5 else ["true", "false"][i % 2],
             "n": i}
        ref.index_doc(f"d{i}", d)
        port.index_doc(f"d{i}", d)
    ref.refresh()
    port.refresh()
    yield ref, port
    ref_e.close()
    port_e.close()


QUERIES = [
    {"range": {"ts": {"gte": "2015-01-10", "lt": "2015-02-01T12:00:00Z"}}},
    {"range": {"ts": {"gt": 1_420_070_400_000 + 86_400_000 * 30}}},
    {"range": {"day": {"gte": "2015/03/01", "lte": "2015/06/30"}}},
    {"term": {"ok": True}},
    {"term": {"ok": "false"}},
    {"terms": {"ok": [True]}},
    {"term": {"day": "2015/05/05"}},
    {"terms": {"ts": ["2015-01-01T00:00:00Z", 1_420_070_400_000]}},
    {"match": {"ok": "true"}},
    {"bool": {"filter": [{"term": {"ok": False}}, {"range": {"ts": {"lt": "2015-01-20"}}}]}},
]


@pytest.mark.parametrize("q", QUERIES, ids=[str(i) for i in range(len(QUERIES))])
def test_date_and_boolean_queries_match_reference(pair, q):
    ref, port = pair
    want = ref.search(query=q, size=700)
    got = port.search(q, size=700)
    assert got["hits"]["total"] == want["hits"]["total"]
    assert sorted(h["_id"] for h in got["hits"]["hits"]) == \
        sorted(h["_id"] for h in want["hits"]["hits"])


def test_date_and_boolean_docvalues_and_aggs_match_reference(pair):
    ref, port = pair
    aggs = {"ok": {"terms": {"field": "ok"}},
            "days": {"date_histogram": {"field": "day", "calendar_interval": "month"}},
            "span": {"stats": {"field": "ts"}}, "first": {"min": {"field": "ts"}}}
    from elasticsearch_tpu_torch.aggs.check import agg_mismatches

    want = ref.search(query=None, size=0, aggs=aggs)["aggregations"]
    got = port.search(None, size=0, aggs=aggs)["aggregations"]
    assert not agg_mismatches(got, want)
    assert sorted(b["key"] for b in got["ok"]["buckets"]) == [0, 1]
