"""Aggregations on one shard: the port's `EsIndex(device="cpu").search(aggs=...)`
against the JAX package's `Engine(None)` index on the same documents.

The corpus (numpy-seeded, 2,500 docs) has every column kind the aggs read:
a text body, a 5-value keyword `status`, a multi-valued keyword `tag` (1-3
values, missing on some docs), a `long` `n` with negatives and missing
values, a `long` `big` above 2^53 in both signs, positive `float`s `f` and
`w`, a `date` `ts` (epoch millis and ISO strings) and a `boolean` `b`.

Tolerances (`aggs.check.agg_mismatches`): counts, keys, exact long sums and
cardinalities equal; every float within 1e-6 relative. The float columns
are positive, so a segment's |sum| is its Σ|v| and the relative bound is
the bound relative to the segment's Σ|v|; percentiles (f32 interpolation on
the port's one shard against the reference's f64 `np.percentile` over its
sorted partial) and the variance family (sum of squares less the squared
mean) come within it too.
"""

import copy

import numpy as np
import pytest

from elasticsearch_tpu.aggs import nodes as ref_nodes
from elasticsearch_tpu.engine.engine import Engine as RefEngine
from elasticsearch_tpu_torch.aggs import nodes
from elasticsearch_tpu_torch.aggs.check import agg_mismatches
from elasticsearch_tpu_torch.corpus import C3_AGGS, C3_MAPPINGS, c3_corpus
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuError

MAPPING = {"properties": {
    "body": {"type": "text"}, "status": {"type": "keyword"}, "tag": {"type": "keyword"},
    "n": {"type": "long"}, "big": {"type": "long"}, "f": {"type": "float"},
    "w": {"type": "float"}, "ts": {"type": "date"}, "b": {"type": "boolean"},
}}
N_DOCS = 2500
T0 = 1_600_000_000_000


def agg_docs(seed: int = 7, n: int = N_DOCS) -> list[tuple[str, dict]]:
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "eps"]
    docs = []
    for i in range(n):
        d = {"body": " ".join(rng.choice(words, int(rng.integers(1, 4)))),
             "status": str(rng.choice(["200", "200", "200", "404", "500", "301", "304"])),
             "n": int(rng.integers(-500, 500)),
             "big": int(rng.integers(2**53, 2**60)) * (1 if rng.random() < 0.7 else -1),
             "f": float(np.round(rng.random() * 1000, 2)),
             "w": float(np.round(rng.random() * 5 + 0.5, 1)),
             "b": bool(rng.integers(2))}
        ts = T0 + int(rng.integers(0, 120 * 86_400_000))
        d["ts"] = ts if i % 3 else _iso(ts)
        k = int(rng.integers(0, 4))
        if k:
            d["tag"] = [str(x) for x in rng.choice(list("pqrstuvw"), k)]
        if rng.random() < 0.1:
            del d["n"]
        if rng.random() < 0.05:
            del d["f"]
        docs.append((f"d{i}", d))
    return docs


def _iso(ms: int) -> str:
    import datetime as dt

    t = dt.datetime.fromtimestamp(ms / 1000, tz=dt.timezone.utc)
    return t.strftime("%Y-%m-%dT%H:%M:%S.") + f"{t.microsecond // 1000:03d}Z"


class Pair:
    """The same documents in both packages' indices."""

    def __init__(self, docs, mapping=MAPPING, shards: int = 1):
        self.ref_engine, self.port_engine = RefEngine(None), Engine(device="cpu")
        settings = {"number_of_shards": shards}
        self.ref = self.ref_engine.create_index("idx", mapping, dict(settings))
        self.port = self.port_engine.create_index("idx", mapping, dict(settings))
        for i, d in docs:
            self.ref.index_doc(i, d)
            self.port.index_doc(i, d)
        self.ref.refresh()
        self.port.refresh()

    def close(self):
        self.ref_engine.close()
        self.port_engine.close()

    def check(self, aggs, query=None, size=0, atol=0.0, **kw):
        want = self.ref.search(query=query, size=size, aggs=copy.deepcopy(aggs), **kw)
        got = self.port.search(query, size=size, aggs=copy.deepcopy(aggs), **kw)
        bad = agg_mismatches(got.get("aggregations"), want.get("aggregations"), atol=atol)
        assert not bad, bad[:10]
        assert got["hits"]["total"] == want["hits"]["total"]
        assert [h["_id"] for h in got["hits"]["hits"]] == [h["_id"] for h in want["hits"]["hits"]]
        return got


@pytest.fixture(scope="module")
def pair():
    p = Pair(agg_docs())
    yield p
    p.close()


@pytest.fixture(autouse=True)
def _cold_planners():
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()
    yield


DH = {"date_histogram": {"field": "ts", "fixed_interval": "1d"}}
_Q = {"match": {"body": "alpha"}}

# (id, aggs, query): every ported agg type, nested forms, C3's request
CASES = [
    ("terms_nested", {"t": {"terms": {"field": "status"}, "aggs": {
        "h": {"date_histogram": {"field": "ts", "calendar_interval": "day"}},
        "s": {"sum": {"field": "big"}}}}}, None),
    ("terms_mv", {"t": {"terms": {"field": "tag", "size": 20}}}, _Q),
    ("terms_key_order", {"t": {"terms": {"field": "tag", "order": {"_key": "desc"},
                                         "size": 3}}}, None),
    ("terms_long", {"t": {"terms": {"field": "n", "size": 5}, "aggs": {
        "a": {"avg": {"field": "f"}}}}}, None),
    ("terms_bool_date", {"b": {"terms": {"field": "b"}}, "d": {"terms": {"field": "ts",
                                                                          "size": 3}}}, _Q),
    ("metrics_long", {"mn": {"min": {"field": "n"}}, "mx": {"max": {"field": "big"}},
                      "s": {"sum": {"field": "n"}}, "a": {"avg": {"field": "big"}},
                      "vc": {"value_count": {"field": "tag"}}, "st": {"stats": {"field": "n"}}},
     None),
    ("metrics_float", {"mn": {"min": {"field": "f"}}, "mx": {"max": {"field": "f"}},
                       "s": {"sum": {"field": "f"}}, "a": {"avg": {"field": "f"}},
                       "st": {"stats": {"field": "f"}}, "vc": {"value_count": {"field": "f"}}},
     _Q),
    ("cardinality", {"c1": {"cardinality": {"field": "tag"}},
                     "c2": {"cardinality": {"field": "n"}},
                     "c3": {"terms": {"field": "status"},
                            "aggs": {"c": {"cardinality": {"field": "n"}}}}}, None),
    ("percentiles", {"p": {"percentiles": {"field": "f", "percents": [1, 50, 90, 99.9]}},
                     "q": {"percentiles": {"field": "n"}}}, _Q),
    ("extended_stats", {"e": {"extended_stats": {"field": "f", "sigma": 3}}}, None),
    ("weighted_avg", {"w": {"weighted_avg": {"value": {"field": "f"},
                                             "weight": {"field": "w"}}}}, None),
    ("histogram", {"h": {"histogram": {"field": "f", "interval": 50}},
                   "h2": {"histogram": {"field": "n", "interval": 7, "offset": 3,
                                        "min_doc_count": 1}, "aggs": {
                       "m": {"max": {"field": "f"}}}}}, None),
    ("date_histogram", {"d1": DH, "d2": {"date_histogram": {
        "field": "ts", "calendar_interval": "month"}, "aggs": {"s": {"sum": {"field": "n"}}}},
        "d3": {"date_histogram": {"field": "ts", "calendar_interval": "week", "offset": "1h"}},
        "d4": {"date_histogram": {"field": "ts", "fixed_interval": "12h",
                                  "min_doc_count": 30}}}, _Q),
    ("range", {"r": {"range": {"field": "f", "ranges": [
        {"to": 100}, {"from": 100, "to": 550.5}, {"from": 500}]}, "aggs": {
        "t": {"terms": {"field": "status"}}}},
        "rk": {"range": {"field": "n", "keyed": True, "ranges": [
            {"key": "neg", "to": 0}, {"from": 0}]}}}, None),
    ("date_range", {"r": {"date_range": {"field": "ts", "ranges": [
        {"to": "2020-10-01"}, {"from": "2020-10-01", "to": "2020-11-15T12:00:00Z"},
        {"from": T0 + 100 * 86_400_000}]}}}, None),
    ("filter_filters", {"f": {"filter": {"term": {"status": "404"}}, "aggs": {
        "s": {"stats": {"field": "f"}}}},
        "fs": {"filters": {"filters": {"ok": {"term": {"status": "200"}},
                                       "late": {"range": {"ts": {"gte": "2020-11-01"}}}}},
               "aggs": {"a": {"avg": {"field": "n"}}}}}, _Q),
    ("missing_global", {"m": {"missing": {"field": "n"}, "aggs": {"c": {"value_count": {
        "field": "f"}}}}, "g": {"global": {}, "aggs": {"a": {"avg": {"field": "f"}}}}}, _Q),
    ("top_hits", {"t": {"terms": {"field": "status"}, "aggs": {
        "top": {"top_hits": {"size": 3}}}}, "all": {"top_hits": {"size": 2}}},
     {"match": {"body": "alpha beta"}}),
    ("rare_terms", {"r": {"rare_terms": {"field": "tag", "max_doc_count": 400}},
                    "r2": {"rare_terms": {"field": "n", "max_doc_count": 1}}}, None),
    ("multi_terms", {"m": {"multi_terms": {"terms": [{"field": "status"}, {"field": "b"}],
                                           "size": 6}, "aggs": {
        "s": {"sum": {"field": "f"}}}}}, None),
    ("significant_terms", {"s": {"significant_terms": {"field": "status",
                                                       "min_doc_count": 1}}},
     {"range": {"f": {"gte": 900}}}),
    ("auto_date_histogram", {"a": {"auto_date_histogram": {"field": "ts", "buckets": 8}},
                             "a2": {"auto_date_histogram": {"field": "ts",
                                                            "buckets": 200}}}, None),
    ("composite", {"c": {"composite": {"size": 7, "sources": [
        {"st": {"terms": {"field": "status"}}},
        {"day": {"date_histogram": {"field": "ts", "fixed_interval": "1d",
                                    "order": "desc"}}}]},
        "aggs": {"m": {"max": {"field": "n"}}}}}, None),
    ("composite_after", {"c": {"composite": {"size": 5, "after": {"st": "301", "h": 200.0},
                                             "sources": [
        {"st": {"terms": {"field": "status", "order": "desc"}}},
        {"h": {"histogram": {"field": "f", "interval": 100}}}]}}}, _Q),
    ("c3", C3_AGGS, None),
    ("bool_date_filters", {"t": {"terms": {"field": "b"}}},
     {"bool": {"filter": [{"term": {"b": True}},
                          {"range": {"ts": {"gte": "2020-10-15", "lt": T0 + 90 * 86_400_000}}}]}}),
]

_PIPE_PARENT = {"d": {"date_histogram": {"field": "ts", "fixed_interval": "7d"}, "aggs": {
    "s": {"sum": {"field": "f"}}, "n": {"avg": {"field": "n"}}}}}


def _with_parent(name, spec):
    out = copy.deepcopy(_PIPE_PARENT)
    out["d"]["aggs"][name] = spec
    return out


PIPELINES = [
    ("avg_bucket", {**_PIPE_PARENT, "x": {"avg_bucket": {"buckets_path": "d>s"}}}),
    ("sum_bucket", {**_PIPE_PARENT, "x": {"sum_bucket": {"buckets_path": "d>s"}}}),
    ("min_bucket", {**_PIPE_PARENT, "x": {"min_bucket": {"buckets_path": "d>n"}}}),
    ("max_bucket", {**_PIPE_PARENT, "x": {"max_bucket": {"buckets_path": "d>_count"}}}),
    ("stats_bucket", {**_PIPE_PARENT, "x": {"stats_bucket": {"buckets_path": "d>s"}}}),
    ("extended_stats_bucket", {**_PIPE_PARENT, "x": {"extended_stats_bucket": {
        "buckets_path": "d>s"}}}),
    ("percentiles_bucket", {**_PIPE_PARENT, "x": {"percentiles_bucket": {
        "buckets_path": "d>s", "percents": [25, 50, 75]}}}),
    ("derivative", _with_parent("x", {"derivative": {"buckets_path": "s"}})),
    ("cumulative_sum", _with_parent("x", {"cumulative_sum": {"buckets_path": "s"}})),
    ("bucket_script", _with_parent("x", {"bucket_script": {
        "buckets_path": {"a": "s", "b": "_count"}, "script": "a / b"}})),
    ("bucket_selector", _with_parent("x", {"bucket_selector": {
        "buckets_path": {"c": "_count"}, "script": "c > 140"}})),
    ("bucket_sort", _with_parent("x", {"bucket_sort": {"sort": [{"s": {"order": "desc"}}],
                                                       "size": 4, "from": 1}})),
    ("serial_diff", _with_parent("x", {"serial_diff": {"buckets_path": "s", "lag": 2}})),
    ("moving_fn", _with_parent("x", {"moving_fn": {"buckets_path": "s", "window": 3,
                                                   "shift": 1}})),
    ("filters_keyed_selector", {"fs": {"filters": {"filters": {
        "a": {"term": {"status": "200"}}, "b": {"term": {"status": "404"}}}},
        "aggs": {"x": {"bucket_selector": {"buckets_path": {"c": "_count"},
                                           "script": "c > 200"}}}}}),
]


# pipelines that subtract one bucket's sum from another's: a value within
# 1e-6 of the two sums' Σ|v| (the float sums of 7-day buckets stay below
# ~1e5 here, so 2e-6 * 1e5)
_DIFF_ATOL = {"pipeline-derivative": 0.2, "pipeline-serial_diff": 0.2}


@pytest.mark.parametrize("aggs,query,atol", [pytest.param(a, q, 0.0, id=i) for i, a, q in CASES]
                         + [pytest.param(a, None, _DIFF_ATOL.get(f"pipeline-{i}", 0.0),
                                         id=f"pipeline-{i}") for i, a in PIPELINES])
def test_agg_matches_reference(pair, aggs, query, atol):
    got = pair.check(aggs, query=query, size=3 if query is not None else 0, atol=atol)
    if atol:  # the bound above holds: every bucket's sum is below 1e5
        assert max(b["s"]["value"] for b in got["aggregations"]["d"]["buckets"]) < 1e5


def test_two_pass_terms_and_paged_composite(pair, monkeypatch):
    """TWO_PASS_MIN_V lowered in both packages: a terms agg with sub-aggs
    over `n` (~1,000 values) takes the two-pass candidate scheme, and a
    composite over status x n the paged scheme."""
    monkeypatch.setattr(ref_nodes, "TWO_PASS_MIN_V", 64)
    monkeypatch.setattr(nodes, "TWO_PASS_MIN_V", 64)
    aggs = {"t": {"terms": {"field": "n", "size": 4}, "aggs": {
        "s": {"sum": {"field": "big"}}, "f": {"stats": {"field": "f"}}}},
        "c": {"composite": {"size": 6, "after": {"st": "200", "n": 3}, "sources": [
            {"st": {"terms": {"field": "status"}}}, {"n": {"terms": {"field": "n"}}}]},
            "aggs": {"a": {"avg": {"field": "f"}}}}}
    got = pair.check(aggs, query={"match": {"body": "beta"}})
    assert len(got["aggregations"]["t"]["buckets"]) == 4
    assert "s" in got["aggregations"]["t"]["buckets"][0]


def test_exact_long_sum_above_2_53(pair):
    """`sum` of longs above 2^53 is bit-exact: the Python-int sum of the
    matching docs' values."""
    docs = dict(agg_docs())
    got = pair.port.search({"term": {"status": "500"}}, size=0, aggs={"s": {"sum": {
        "field": "big"}}, "a": {"avg": {"field": "big"}}})
    want = sum(d["big"] for d in docs.values() if d["status"] == "500")
    assert got["aggregations"]["s"]["value"] == want
    assert abs(want) > 2**53
    n = sum(1 for d in docs.values() if d["status"] == "500")
    assert got["aggregations"]["a"]["value"] == want / n


def test_c3_corpus_packs_byte_equal_to_reference():
    """bench.py C3's generator and `build_stacked_pack` at n = 5,000: the
    port's `c3_corpus` draws the same docs, and its pack (through EsIndex's
    builder) holds the reference's docvalues byte for byte, the aggregation
    arrays included."""
    from elasticsearch_tpu.index.mappings import Mappings as RefMappings
    from elasticsearch_tpu.parallel.stacked import build_stacked_pack
    from elasticsearch_tpu_torch.index.mappings import Mappings
    from elasticsearch_tpu_torch.parallel.stacked import build_stacked_pack as port_build

    docs = c3_corpus(np.random.default_rng(3), 5000)
    ref = build_stacked_pack(docs, RefMappings(C3_MAPPINGS), num_shards=1)
    got = port_build(docs, Mappings(C3_MAPPINGS), num_shards=1)
    assert set(got.shards[0].docvalues) == set(ref.shards[0].docvalues)
    for fld, want in ref.shards[0].docvalues.items():
        col = got.shards[0].docvalues[fld]
        for name in ("values", "has_value", "uniq_values", "uniq_ords", "mv_pair_docs",
                     "mv_pair_ords"):
            a, b = getattr(col, name), getattr(want, name)
            assert (a is None) == (b is None), (fld, name)
            if a is not None:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (fld, name)
        assert (col.vmin, col.vmax, col.ord_terms) == (want.vmin, want.vmax, want.ord_terms)
    for fld, want in ref.stacked_docvalues.items():
        col = got.global_docvalues[fld]
        for name in ("values", "has_value", "uniq_values", "uniq_ords"):
            a, b = getattr(col, name), getattr(want, name)
            assert (a is None) == (b is None), (fld, name)
            if a is not None:
                assert a.tobytes() == b.tobytes(), (fld, name)
    assert len(ref.shards[0].docvalues["status"].ord_terms) == 5


def test_c3_request_on_c3_corpus():
    p = Pair(c3_corpus(np.random.default_rng(5), 3000), mapping=C3_MAPPINGS)
    try:
        got = p.check(C3_AGGS)
        buckets = got["aggregations"]["by_status"]["buckets"]
        assert len(buckets) == 5 and len(buckets[0]["over_time"]["buckets"]) == 30
        p.check({"ip": {"cardinality": {"field": "clientip"}},
                 "p": {"percentiles": {"field": "size"}}},
                query={"range": {"@timestamp": {"gte": "2015-01-10", "lt": "2015-01-20"}}})
    finally:
        p.close()


@pytest.mark.parametrize("aggs,what", [
    ({"h": {"histogram": {"field": "f", "interval": 0.001}}}, "max_buckets"),
    ({"t": {"terms": {"field": "status"}, "aggs": {"tt": {"terms": {"field": "n"},
                                                          "aggs": {"s": {"sum": {
                                                              "field": "f"}}}}}}},
     "must be top-level"),
    ({"t": {"terms": {"field": "f"}}}, "float field"),
    ({"p": {"terms": {"field": "status"}, "aggs": {"q": {"percentiles": {"field": "f"}}}}},
     "percentiles under bucket aggs"),
])
def test_agg_errors_match_reference(pair, monkeypatch, aggs, what):
    monkeypatch.setattr(ref_nodes, "TWO_PASS_MIN_V", 64)
    monkeypatch.setattr(nodes, "TWO_PASS_MIN_V", 64)
    with pytest.raises(Exception) as ref_ex:
        pair.ref.search(query=None, size=0, aggs=aggs)
    with pytest.raises(ElasticsearchTpuError) as ex:
        pair.port.search(None, size=0, aggs=aggs)
    assert what in str(ex.value) and what in str(ref_ex.value)
    assert ex.value.status == 400


@pytest.mark.parametrize("typ,body", [("geo_bounds", {"field": "loc"}),
                                       ("geo_centroid", {"field": "loc"}),
                                       ("geotile_grid", {"field": "loc", "precision": 3})])
def test_geo_aggs_not_yet_ported(pair, typ, body):
    """The geo aggs are ported (tests/test_torch_geo.py); over a field this
    index lacks they answer as the reference's: no bounds, a zero count,
    no buckets."""
    pair.check({"g": {typ: body}})


def test_aggs_beside_knn():
    """`knn` alone with aggs: the aggs run over the kNN node's match set
    (its k nearest), as the reference's; with a query: over the hybrid's."""
    mapping = {"properties": {"vec": {"type": "dense_vector", "dims": 4},
                              "status": {"type": "keyword"}, "n": {"type": "long"}}}
    rng = np.random.default_rng(11)
    docs = [(f"v{i}", {"vec": rng.standard_normal(4).round(3).tolist(),
                       "status": str(rng.choice(["a", "b", "c"])), "n": int(rng.integers(0, 50))})
            for i in range(400)]
    p = Pair(docs, mapping=mapping)
    try:
        aggs = {"t": {"terms": {"field": "status"}, "aggs": {"s": {"sum": {"field": "n"}}}}}
        knn = {"field": "vec", "query_vector": [0.5, -0.2, 0.1, 0.9], "k": 25,
               "num_candidates": 50}
        got = p.check(aggs, size=5, knn=knn)
        # the match set is the section's num_candidates nearest
        assert sum(b["doc_count"] for b in got["aggregations"]["t"]["buckets"]) == 50
        p.check(aggs, query={"range": {"n": {"lt": 10}}}, size=5, knn=knn)
    finally:
        p.close()


def test_msearch_and_wave_rows_equal_solo(pair):
    """`msearch` bodies with aggs answer as `search`; a serving wave's rows
    (generic lane) are byte-equal to their solo searches."""
    import json

    bodies = [{"query": _Q, "size": 2, "aggs": CASES[0][1]},
              {"size": 0, "aggregations": {"p": {"percentiles": {"field": "f"}}}},
              {"query": {"match": {"body": "gamma"}}, "size": 3}]
    out = pair.port.msearch(bodies)
    for body, r in zip(bodies, out["responses"]):
        solo = pair.port.search(body.get("query"), size=body["size"],
                                aggs=body.get("aggs") or body.get("aggregations"))
        assert r["status"] == 200
        assert json.dumps({**solo, "status": 200}, sort_keys=True) == json.dumps(r, sort_keys=True)
    entries = [dict(query=_Q, size=2, aggs=a) for _i, a, _q in CASES[:6]]
    entries.append(dict(query=None, size=0, aggs=PIPELINES[0][1]))
    rows = pair.port.search_wave(entries)
    for e, row in zip(entries, rows):
        solo = pair.port.search(**e)
        assert json.dumps(row, sort_keys=True) == json.dumps(solo, sort_keys=True)


def test_convert_carries_agg_docvalues():
    """`pack_from_reference` carries the aggregations' arrays across, from
    the reference pack object and from a plain dict of numpy arrays, and
    `stacked_pack_from_reference` checks the global ordinals against the
    source's; an EsIndex searcher over the carried pack answers the aggs
    as the port's own build does."""
    from dataclasses import asdict

    from elasticsearch_tpu.index import Mappings as RefMappings
    from elasticsearch_tpu.index import PackBuilder as RefPackBuilder
    from elasticsearch_tpu.parallel.stacked import build_stacked_pack
    from elasticsearch_tpu_torch.convert import pack_from_reference, stacked_pack_from_reference
    from elasticsearch_tpu_torch.index.mappings import Mappings
    from elasticsearch_tpu_torch.index.pack import PackBuilder
    from elasticsearch_tpu_torch.query.executor import ShardSearcher

    docs = agg_docs(n=600)
    rm = RefMappings(MAPPING)
    rb = RefPackBuilder(rm)
    for i, d in docs:
        rb.add_document(rm.parse_document(d), doc_id=i)
    ref = rb.build()
    m = Mappings(MAPPING)
    pb = PackBuilder(m)
    for i, d in docs:
        pb.add_document(m.parse_document(d), doc_id=i)
    own = pb.build()
    as_dict = {k: getattr(ref, k) for k in ref.__dataclass_fields__}
    as_dict["docvalues"] = {f: asdict(c) for f, c in ref.docvalues.items()}
    for src in (ref, as_dict):
        got = pack_from_reference(src)
        for fld, col in own.docvalues.items():
            c = got.docvalues[fld]
            for name in ("values", "has_value", "uniq_values", "uniq_ords", "mv_pair_docs",
                         "mv_pair_ords"):
                a, b = getattr(c, name), getattr(col, name)
                assert (a is None) == (b is None) and (a is None or a.tobytes() == b.tobytes())
            assert (c.vmin, c.vmax) == (col.vmin, col.vmax)
    aggs = {"t": {"terms": {"field": "tag"}}, "h": {"histogram": {"field": "f", "interval": 100}},
            "n": {"terms": {"field": "n", "size": 3}}}
    a = ShardSearcher(got, device="cpu", mappings=m).search(None, size=0, aggs=aggs)
    b = ShardSearcher(own, device="cpu", mappings=m).search(None, size=0, aggs=aggs)
    assert a.aggregations == b.aggregations
    sp = stacked_pack_from_reference(build_stacked_pack(docs, rm, num_shards=3), MAPPING)
    assert sp.global_docvalues["tag"].mv_pair_docs.shape[0] == 3
