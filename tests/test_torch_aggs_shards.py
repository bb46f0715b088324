"""Aggregations on several shards, on tail tiers, over REST and in the
serving wave: the port against the JAX package's `Engine(None)` indices on
the same documents (`test_torch_aggs.agg_docs`).

On 2 and 4 murmur3 shards every shard evaluates the aggs with
`ctx.sharded` and the partials merge on the host (global ordinals, the OR
of cardinality bitmaps, the Python-int `sum_exact` merge); the port's
answers equal the reference's sharded answers with the tolerances of
`test_torch_aggs.py` (counts, keys, exact long sums, cardinalities equal;
floats within 1e-6 relative), and the counts and exact sums equal the
port's own one-shard answers. With tail segments a search with aggs merges
the tiers first, as the reference's does, and equals a full refresh. REST
`_search` / `_msearch` and serving-wave rows equal `EsIndex.search` byte
for byte.
"""

import copy
import json

import numpy as np
import pytest

from elasticsearch_tpu.aggs import nodes as ref_nodes
from elasticsearch_tpu_torch.aggs import nodes
from elasticsearch_tpu_torch.aggs.check import agg_mismatches, without_floats
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.rest import make_app
from test_torch_aggs import CASES, MAPPING, PIPELINES, Pair, agg_docs

SHARD_CASES = [c for c in CASES if c[0] in (
    "terms_nested", "terms_mv", "terms_long", "metrics_long", "metrics_float", "cardinality",
    "percentiles", "extended_stats", "histogram", "date_histogram", "range",
    "filter_filters", "missing_global", "top_hits", "rare_terms", "multi_terms",
    "significant_terms", "composite", "composite_after", "c3")]


@pytest.fixture(autouse=True)
def _cold_planners():
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()
    yield


@pytest.fixture(scope="module", params=[2, 4], ids=["2shards", "4shards"])
def spair(request):
    p = Pair(agg_docs(n=1600), shards=request.param)
    yield p
    p.close()


@pytest.fixture(scope="module")
def one_shard():
    engine = Engine(device="cpu")
    idx = engine.create_index("idx", MAPPING)
    for i, d in agg_docs(n=1600):
        idx.index_doc(i, d)
    idx.refresh()
    yield idx
    engine.close()


@pytest.mark.parametrize("aggs,query", [pytest.param(a, q, id=i) for i, a, q in SHARD_CASES]
                         + [pytest.param(PIPELINES[4][1], None, id="pipeline-stats_bucket")])
def test_sharded_aggs_match_reference_and_one_shard(spair, one_shard, aggs, query):
    got = spair.check(aggs, query=query, size=3 if query is not None else 0)
    if "top_hits" in json.dumps(aggs):
        return  # equal scores tie-break by (shard, doc) here, by doc on one shard
    one = one_shard.search(query, size=0, aggs=copy.deepcopy(aggs))
    assert not agg_mismatches(got["aggregations"], one["aggregations"])
    if "percentiles" not in json.dumps(aggs):
        # counts, keys, int sums and cardinalities byte-equal to one shard
        assert json.dumps(without_floats(got["aggregations"]), sort_keys=True) == \
            json.dumps(without_floats(one["aggregations"]), sort_keys=True)


def test_sharded_two_pass_terms(spair, monkeypatch):
    """The two-pass scheme on shards: candidates from the GLOBAL merged
    counts, pass 2 on every shard, merged."""
    monkeypatch.setattr(ref_nodes, "TWO_PASS_MIN_V", 64)
    monkeypatch.setattr(nodes, "TWO_PASS_MIN_V", 64)
    got = spair.check({"t": {"terms": {"field": "n", "size": 5}, "aggs": {
        "s": {"sum": {"field": "big"}}, "c": {"cardinality": {"field": "tag"}}}},
        "c": {"composite": {"size": 4, "sources": [{"n": {"terms": {"field": "n"}}},
                                                   {"b": {"terms": {"field": "b"}}}]},
              "aggs": {"a": {"avg": {"field": "f"}}}}})
    assert len(got["aggregations"]["t"]["buckets"]) == 5


@pytest.mark.parametrize("shards", [1, 3])
def test_aggs_on_tail_tiers_merge_and_equal_full_refresh(shards):
    """Writes after the base leave tail segments; a search with aggs merges
    the tiers into one base first (as the reference's) and answers what a
    full refresh of the same docs answers."""
    docs = agg_docs(seed=21, n=1200)
    p = Pair(docs, shards=shards)
    try:
        rng = np.random.default_rng(4)
        upd = [(f"d{int(i)}", dict(docs[int(i)][1], n=int(rng.integers(-9, 9)), status="418"))
               for i in rng.choice(len(docs), 60, replace=False)]
        new = [(f"x{i}", d) for i, d in agg_docs(seed=22, n=40)]
        for i, d in upd + new:
            p.ref.index_doc(i, d)
            p.port.index_doc(i, d)
        p.port.delete_doc("d3")
        p.ref.delete_doc("d3")
        p.ref.refresh()
        p.port.refresh()
        assert p.port._tails and p.port.last_refresh_kind == "incremental"
        aggs = {"t": {"terms": {"field": "status"}, "aggs": {"s": {"sum": {"field": "n"}},
                                                          "h": {"date_histogram": {
                                                              "field": "ts",
                                                              "calendar_interval": "month"}}}},
                "c": {"cardinality": {"field": "tag"}}}
        got = p.check(aggs, query={"range": {"f": {"gte": 100}}})
        assert not p.port._tails  # merged
        full = Engine(device="cpu").create_index("full", MAPPING, {"number_of_shards": shards})
        final = dict(docs)
        final.update(dict(upd + new))
        del final["d3"]
        for i, d in final.items():
            full.index_doc(i, d)
        full.refresh()
        want = full.search({"range": {"f": {"gte": 100}}}, size=0, aggs=aggs)
        assert json.dumps(without_floats(got["aggregations"]), sort_keys=True) == \
            json.dumps(without_floats(want["aggregations"]), sort_keys=True)
        assert not agg_mismatches(got["aggregations"], want["aggregations"])
        assert any(b["key"] == "418" for b in got["aggregations"]["t"]["buckets"])
    finally:
        p.close()


def _call(app, method, path, body=None, params=None, ndjson=False):
    payload = b"" if body is None else (
        ("\n".join(json.dumps(x) for x in body) + "\n").encode() if ndjson
        else json.dumps(body).encode())
    ctype = "application/x-ndjson" if ndjson else "application/json"
    status, _h, raw = app.handle(method, path, params or {}, {"Content-Type": ctype}, payload)
    return status, json.loads(raw) if raw else None


@pytest.mark.parametrize("serving", [False, True], ids=["solo", "serving"])
def test_rest_search_and_msearch_equal_esindex(serving):
    """REST `_search` with `aggs` / `aggregations` and `_msearch` bodies
    with aggs answer what `EsIndex.search` answers (serving off: the solo
    path; on: the wave's generic lane), byte for byte."""
    app = make_app(device="cpu")
    try:
        assert _call(app, "PUT", "/idx", {"mappings": MAPPING,
                                          "settings": {"number_of_shards": 2}})[0] == 200
        lines = []
        for i, d in agg_docs(n=600):
            lines += [{"index": {"_index": "idx", "_id": i}}, d]
        assert _call(app, "POST", "/_bulk", lines, {"refresh": "true"}, ndjson=True)[0] == 200
        if serving:
            _call(app, "PUT", "/_cluster/settings",
                  {"transient": {"serving.enabled": True}})
        idx = app.engine.get_index("idx")
        bodies = [{"size": 0, "aggs": CASES[0][1]},
                  {"query": {"match": {"body": "beta"}}, "size": 2,
                   "aggregations": {"p": {"percentiles": {"field": "f"}},
                                    "c": {"cardinality": {"field": "tag"}}}},
                  {"size": 0, "aggs": PIPELINES[7][1]}]
        for b in bodies:
            status, got = _call(app, "POST", "/idx/_search", b)
            assert status == 200
            want = idx.search(b.get("query"), size=b["size"],
                              aggs=b.get("aggs") or b.get("aggregations"))
            assert json.dumps(got["aggregations"], sort_keys=True) == \
                json.dumps(want["aggregations"], sort_keys=True)
        ms = []
        for b in bodies:
            ms += [{"index": "idx"}, b]
        status, out = _call(app, "POST", "/_msearch", ms, ndjson=True)
        assert status == 200
        for b, r in zip(bodies, out["responses"]):
            want = idx.search(b.get("query"), size=b["size"],
                              aggs=b.get("aggs") or b.get("aggregations"))
            assert r["status"] == 200
            assert json.dumps(r["aggregations"], sort_keys=True) == \
                json.dumps(want["aggregations"], sort_keys=True)
        if serving:
            st = _call(app, "GET", "/_serving/stats")[1]
            assert st["serving"]["completed"] >= len(bodies) * 2
    finally:
        app.close()


def test_aggs_over_several_indices_answer_400():
    engine = Engine(device="cpu")
    try:
        for name in ("a1", "a2"):
            idx = engine.create_index(name, MAPPING)
            idx.index_doc("1", agg_docs(n=1)[0][1])
            idx.refresh()
        from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

        with pytest.raises(IllegalArgumentError) as ex:
            engine.search_multi("a*", aggs={"t": {"terms": {"field": "status"}}})
        assert "multiple indices" in str(ex.value)
    finally:
        engine.close()
