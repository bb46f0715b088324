"""The port's REST layer (`elasticsearch_tpu_torch.rest`) against the JAX
package's aiohttp app on the same request sequence.

The same seeded documents and requests go through the reference app
(`elasticsearch_tpu.rest.app.make_app` over its `Engine`, through aiohttp's
TestClient) and the port's `RestApp` (device="cpu", no socket): index
creation, `_bulk`, `_refresh`, `_search` (match, bool, range, term on a
keyword, size=0, `from` past the hits, track_total_hits false and an
integer, `_source` filtering, query-string size), `_msearch`, `_count`,
`_doc` get, put and the `_create` conflict, `_doc` delete, `_update`
(doc, noop, upsert, doc_as_upsert, a missing doc), `_bulk` delete and
update items, searches over the tiers those writes leave, and the error
envelopes.

Tolerances: equal status, equal envelope keys and error types, equal totals
and sources, ids equal up to fp-ties (1e-5 relative) and scores within
1e-6 relative. Then the port alone: the standard library's HTTP server over
keep-alive, the serving front end over REST, and the server's entry point
(no aiohttp, jax or elasticsearch_tpu in its process; refuses to start
without a card unless --device cpu).
"""

import asyncio
import http.client
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.rest.server import serve

REPO = Path(__file__).resolve().parent.parent
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "théta", "日本"]
TAGS = ["red", "green", "blue", "grün"]
MAPPING = {"properties": {"title": {"type": "text"}, "tag": {"type": "keyword"},
                          "n": {"type": "long"}, "price": {"type": "float"}}}
N_DOCS = 90


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


def _docs():
    rng = np.random.default_rng(17)
    out = []
    for i in range(N_DOCS):
        words = rng.choice(WORDS, size=int(rng.integers(2, 7)))
        out.append((str(i), {"title": " ".join(words), "tag": TAGS[int(rng.integers(0, 4))],
                             "n": int(rng.integers(0, 1000)),
                             "price": float(np.round(rng.random() * 100, 2))}))
    return out


def _ndjson(lines) -> str:
    return "\n".join(json.dumps(x) for x in lines) + "\n"


def _bulk_body(docs) -> str:
    lines = []
    for j, (i, d) in enumerate(docs):
        lines += [{("create" if j % 5 == 0 else "index"): {"_id": i}}, d]
    return _ndjson(lines)


SEARCHES = {
    "match": {"query": {"match": {"title": "alpha beta"}}},
    "match_and": {"query": {"match": {"title": {"query": "alpha gamma",
                                                "operator": "and"}}}, "size": 5},
    "bool": {"query": {"bool": {"must": [{"match": {"title": "delta"}}],
                                "filter": [{"range": {"n": {"gte": 100, "lt": 700}}}],
                                "must_not": [{"term": {"tag": "red"}}]}}, "size": 20},
    "range": {"query": {"range": {"price": {"gte": 20.5, "lte": 60}}}, "size": 7},
    "term_keyword": {"query": {"term": {"tag": "grün"}}, "size": 30},
    "terms": {"query": {"terms": {"tag": ["green", "blue"]}}, "size": 4},
    "match_all": {"query": {"match_all": {}}, "size": 3, "from": 10},
    "size_0": {"query": {"match": {"title": "epsilon"}}, "size": 0},
    "from_past_hits": {"query": {"match": {"title": "zeta"}}, "from": 500},
    "tth_false": {"query": {"match": {"title": "eta"}}, "track_total_hits": False},
    "tth_int": {"query": {"match": {"title": "eta théta"}}, "track_total_hits": 5},
    "source_list": {"query": {"match": {"title": "日本"}}, "_source": ["tag", "n"]},
    "source_false": {"query": {"match": {"title": "gamma"}}, "_source": False, "size": 4},
    "source_dict": {"query": {"match": {"title": "beta"}},
                    "_source": {"includes": ["t*"], "excludes": ["tag"]}},
    "no_body": None,
}

# (name, method, path, body, query params); bodies are JSON objects or
# NDJSON text
SEQUENCE = [
    ("create_index", "PUT", "/books", {"mappings": MAPPING, "settings": {
        "number_of_shards": 1, "refresh_interval": "-1"}}, {}),
    ("create_index_again", "PUT", "/books", {"mappings": MAPPING}, {}),
    ("create_index_bad_name", "PUT", "/Books", {}, {}),
    ("bulk", "POST", "/books/_bulk", _bulk_body(_docs()), {}),
    ("bulk_create_conflict", "POST", "/_bulk",
     _ndjson([{"create": {"_index": "books", "_id": "3"}}, {"title": "x"}]), {}),
    ("refresh", "POST", "/books/_refresh", None, {}),
    ("mapping", "GET", "/books/_mapping", None, {}),
    *[(f"search_{k}", "POST", "/books/_search", b, {}) for k, b in SEARCHES.items()],
    ("search_qs_size", "GET", "/books/_search", {"query": {"match": {"title": "alpha"}}},
     {"size": "2", "from": "1"}),
    ("search_qs_source", "POST", "/books/_search", {"query": {"match": {"title": "beta"}}},
     {"_source_includes": "title"}),
    ("search_total_as_int", "POST", "/books/_search", {"query": {"match": {"title": "beta"}}},
     {"rest_total_hits_as_int": "true"}),
    ("search_all_indices", "POST", "/_search", {"query": {"match": {"title": "beta"}}}, {}),
    ("msearch", "POST", "/_msearch", _ndjson([
        {"index": "books"}, {"query": {"match": {"title": "alpha"}}, "size": 3},
        {"index": "books"}, {"query": {"match": {"title": "beta delta"}}, "from": 2},
        {"index": "nope"}, {"query": {"match_all": {}}},
        {"index": "books"}, {"query": {"term": {"tag": "blue"}}, "size": 2}]), {}),
    ("msearch_default_index", "POST", "/books/_msearch", _ndjson([
        {}, {"query": {"match": {"title": "gamma"}}},
        {}, {"query": {"match": {"title": "epsilon zeta"}}, "track_total_hits": False}]), {}),
    ("count", "POST", "/books/_count", {"query": {"match": {"title": "alpha"}}}, {}),
    ("count_all", "GET", "/books/_count", None, {}),
    ("get_doc", "GET", "/books/_doc/7", None, {}),
    ("get_doc_missing", "GET", "/books/_doc/missing", None, {}),
    ("create_conflict", "PUT", "/books/_create/7", {"title": "x"}, {}),
    ("op_type_create_conflict", "PUT", "/books/_doc/8", {"title": "x"}, {"op_type": "create"}),
    ("create_new", "PUT", "/books/_create/new-1", {"title": "omega beta", "tag": "blue",
                                                   "n": 1, "price": 2.0}, {}),
    ("put_doc_refresh", "PUT", "/books/_doc/new-2", {"title": "omega", "n": 2},
     {"refresh": "true"}),
    ("search_after_writes", "POST", "/books/_search",
     {"query": {"match": {"title": "omega alpha"}}, "size": 5}, {}),
    ("put_doc_update", "PUT", "/books/_doc/7", {"title": "alpha alpha omega", "tag": "red",
                                                "n": 5, "price": 1.5}, {}),
    ("get_doc_updated", "GET", "/books/_doc/7", None, {}),
    # deletes and updates: both keep the replaced and deleted copies in
    # their statistics until a merge
    ("delete_doc", "DELETE", "/books/_doc/8", None, {}),
    ("delete_doc_missing", "DELETE", "/books/_doc/8", None, {}),
    ("get_doc_deleted", "GET", "/books/_doc/8", None, {}),
    ("update_doc", "POST", "/books/_update/9", {"doc": {"tag": "green", "n": 7}}, {}),
    ("update_noop", "POST", "/books/_update/9", {"doc": {"tag": "green"}}, {}),
    ("update_upsert", "POST", "/books/_update/up-1",
     {"doc": {"title": "x"}, "upsert": {"title": "omega upsert", "n": 3}}, {}),
    ("update_doc_as_upsert", "POST", "/books/_update/up-2",
     {"doc": {"title": "omega gamma", "n": 4}, "doc_as_upsert": True}, {}),
    ("update_missing", "POST", "/books/_update/nope-1", {"doc": {"title": "x"}}, {}),
    ("update_no_doc", "POST", "/books/_update/9", {}, {}),
    ("bulk_delete_update", "POST", "/_bulk", _ndjson([
        {"delete": {"_index": "books", "_id": "10"}},
        {"update": {"_index": "books", "_id": "11"}}, {"doc": {"tag": "blue", "n": 11}},
        {"delete": {"_index": "books", "_id": "nope-2"}},
        {"update": {"_index": "books", "_id": "nope-3"}}, {"doc": {"n": 1}},
        {"index": {"_index": "books", "_id": "8"}}, {"title": "alpha omega again"}]),
     {"refresh": "true"}),
    ("search_after_deletes", "POST", "/books/_search",
     {"query": {"match": {"title": "alpha omega"}}, "size": 12}, {}),
    ("search_tag_after_updates", "POST", "/books/_search",
     {"query": {"bool": {"filter": [{"term": {"tag": "blue"}}]}}, "size": 30}, {}),
    ("count_after_deletes", "POST", "/books/_count", {"query": {"match_all": {}}}, {}),
    ("delete_doc_refresh", "DELETE", "/books/_doc/12", None, {"refresh": "true"}),
    ("update_doc_refresh", "POST", "/books/_update/13", {"doc": {"title": "omega omega"}},
     {"refresh": "true"}),
    ("search_after_refreshed_writes", "POST", "/books/_search",
     {"query": {"match": {"title": "omega beta"}}, "size": 8}, {}),
    ("msearch_after_writes", "POST", "/books/_msearch", _ndjson([
        {}, {"query": {"match": {"title": "alpha"}}, "size": 5},
        {}, {"query": {"range": {"n": {"lt": 100}}}, "size": 3}]), {}),
    ("search_unknown_index", "POST", "/nope/_search", {"query": {"match_all": {}}}, {}),
    ("search_bad_query", "POST", "/books/_search", {"query": {"match": {"title": {
        "query": "alpha", "operator": "xor"}}}}, {}),
    ("search_bad_tth", "POST", "/books/_search", {"track_total_hits": "lots"}, {}),
    ("count_unknown_index", "POST", "/nope/_count", {}, {}),
    ("get_doc_unknown_index", "GET", "/nope/_doc/1", None, {}),
    ("delete_unknown_index", "DELETE", "/nope", None, {}),
    ("head_index", "HEAD", "/books", None, {}),
    ("head_unknown_index", "HEAD", "/nope", None, {}),
    ("cluster_health", "GET", "/_cluster/health", None, {}),
    ("put_settings", "PUT", "/_cluster/settings",
     {"persistent": {"serving.max_wave": 64}}, {}),
    ("get_settings", "GET", "/_cluster/settings", None, {}),
    ("put_settings_unknown", "PUT", "/_cluster/settings",
     {"persistent": {"no.such.setting": 1}}, {}),
    ("put_settings_bad_value", "PUT", "/_cluster/settings",
     {"transient": {"serving.coalesce.max_wait": "soon"}}, {}),
    ("delete_index", "DELETE", "/books", None, {}),
    ("search_deleted_index", "POST", "/books/_search", {}, {}),
]


def _payload(body) -> bytes:
    if body is None:
        return b""
    return body.encode() if isinstance(body, str) else json.dumps(body).encode()


def _content_type(body) -> str:
    return "application/x-ndjson" if isinstance(body, str) else "application/json"


def _run_reference(tmp_path) -> dict:
    from aiohttp.test_utils import TestClient, TestServer

    from elasticsearch_tpu.engine.engine import Engine
    from elasticsearch_tpu.rest.app import make_app as ref_make_app

    async def scenario():
        client = TestClient(TestServer(ref_make_app(engine=Engine(str(tmp_path / "ref")))))
        await client.start_server()
        out = {}
        try:
            for name, method, path, body, params in SEQUENCE:
                r = await client.request(method, path, params=params, data=_payload(body),
                                         headers={"Content-Type": _content_type(body)})
                raw = await r.read()
                out[name] = (r.status, json.loads(raw) if raw else None)
        finally:
            await client.close()
        return out

    # the reference's impact tier, as the port serves `_search` from its own
    old = os.environ.get("ES_TPU_IMPACT")
    os.environ["ES_TPU_IMPACT"] = "force"
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(scenario())
    finally:
        loop.close()
        if old is None:
            os.environ.pop("ES_TPU_IMPACT", None)
        else:
            os.environ["ES_TPU_IMPACT"] = old


def _run_port() -> dict:
    app = make_app(device="cpu")
    out = {}
    try:
        for name, method, path, body, params in SEQUENCE:
            status, _headers, raw = app.handle(method, path, params,
                                               {"Content-Type": _content_type(body)},
                                               _payload(body))
            out[name] = (status, json.loads(raw) if raw else None)
    finally:
        app.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("rest")), _run_port()


def _close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def _same_hits(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    if "total" in want:
        assert got["total"] == want["total"], what
    if want["max_score"] is None:
        assert got["max_score"] is None, what
    else:
        assert _close(got["max_score"], want["max_score"], 1e-6), what
    gh, wh = got["hits"], want["hits"]
    assert len(gh) == len(wh), what
    for g, w in zip(gh, wh):
        assert set(g) == set(w) and g["_index"] == w["_index"], what
        assert _close(g["_score"], w["_score"], 1e-6), what
        if g["_id"] != w["_id"]:  # fp-ties only
            assert _close(g["_score"], w["_score"], 1e-5), what
            continue
        assert g.get("_source") == w.get("_source"), what


def _same_response(got, want, what: str) -> None:
    if isinstance(want, dict) and "error" in want:
        assert set(got) == set(want), what
        if isinstance(want["error"], dict):
            assert got["error"]["type"] == want["error"]["type"], what
            assert set(want["error"]) <= set(got["error"]) | {"index_uuid", "resource.id",
                                                              "resource.type"}, what
        return
    if isinstance(want, dict) and "hits" in want:
        assert set(got) == set(want), what
        assert got["_shards"] == want["_shards"] and got["timed_out"] == want["timed_out"], what
        if isinstance(want["hits"].get("total"), int):
            assert got["hits"]["total"] == want["hits"]["total"], what
            _same_hits({**got["hits"], "total": 0}, {**want["hits"], "total": 0}, what)
        else:
            _same_hits(got["hits"], want["hits"], what)
        return
    if isinstance(want, dict) and "responses" in want:
        assert len(got["responses"]) == len(want["responses"]), what
        for j, (g, w) in enumerate(zip(got["responses"], want["responses"])):
            assert g["status"] == w["status"], f"{what}[{j}]"
            _same_response(g, w, f"{what}[{j}]")
        return
    if isinstance(want, dict) and "items" in want:
        assert got["errors"] == want["errors"], what
        for g, w in zip(got["items"], want["items"]):
            (ga, gi), = g.items()
            (wa, wi), = w.items()
            assert ga == wa and gi["status"] == wi["status"] and gi["_id"] == wi["_id"], what
            if "error" in wi:
                assert gi["error"]["type"] == wi["error"]["type"], what
            else:
                assert {k: gi[k] for k in ("_index", "_version", "_seq_no", "result")} == \
                    {k: wi[k] for k in ("_index", "_version", "_seq_no", "result")}, what
        assert len(got["items"]) == len(want["items"]), what
        return
    assert got == want, what


# responses that carry values of their own process: a clock, an auto id
_VOLATILE = {
    "create_new": ("_shards",),
    "cluster_health": ("active_shards_percent_as_number",),
}


@pytest.mark.parametrize("name", [s[0] for s in SEQUENCE])
def test_rest_sequence_matches_reference(runs, name):
    ref, port = runs
    (ws, want), (gs, got) = ref[name], port[name]
    assert gs == ws, (name, got, want)
    if want is None or got is None:
        assert want is None and got is None, name
        return
    if name == "cluster_health":
        assert got["status"] == want["status"] and set(got) == set(want)
        return
    if name in ("get_settings", "put_settings"):
        # the reference persists every setting it ever applied; compare ours
        assert got["persistent"] == {"serving.max_wave": 64}
        assert want["persistent"]["serving.max_wave"] == 64
        return
    _same_response(got, want, name)


def test_bulk_and_doc_results_carry_the_reference_keys(runs):
    ref, port = runs
    for name in ("put_doc_update", "create_new", "put_doc_refresh", "get_doc", "delete_doc",
                 "update_doc", "update_noop", "update_upsert", "update_doc_as_upsert",
                 "delete_doc_refresh", "update_doc_refresh"):
        assert set(port[name][1]) == set(ref[name][1]), name
    assert port["put_doc_refresh"][1]["forced_refresh"] is True
    assert port["update_doc_refresh"][1]["forced_refresh"] is True


def test_update_keeps_replaced_statistics_until_merge(monkeypatch):
    """After an update, both packages' incremental refresh score with the
    replaced version still in the statistics (Lucene's deleted documents
    count until a merge): the port's hits and scores equal the reference's,
    and differ from a fresh index of the live documents."""
    from elasticsearch_tpu.engine.engine import Engine as RefEngine
    from elasticsearch_tpu_torch.engine import Engine

    docs = [(str(i), {"title": ["alpha beta", "alpha", "beta gamma", "gamma"][i % 4]})
            for i in range(40)]
    monkeypatch.setenv("ES_TPU_IMPACT", "force")  # the impact tier on both sides
    ref, port = RefEngine(None), Engine(device="cpu")
    try:
        a = ref.create_index("a", {"properties": {"title": {"type": "text"}}},
                             {"refresh_interval": "-1"})
        p = port.create_index("a", {"properties": {"title": {"type": "text"}}})
        fresh = port.create_index("fresh", {"properties": {"title": {"type": "text"}}})
        for i, d in docs:
            a.index_doc(i, d)
            p.index_doc(i, d)
            fresh.index_doc(i, {"title": "alpha alpha"} if i == "7" else d)
        a.refresh()
        p.refresh()
        fresh.refresh()
        a.index_doc("7", {"title": "alpha alpha"})
        p.index_doc("7", {"title": "alpha alpha"})
        a.refresh()
        p.refresh()
        assert p.last_refresh_kind == "incremental" and len(p._tails) == len(a._tails) == 2
        q = {"match": {"title": "alpha"}}
        got, want = p.search(q, size=40)["hits"], a.search(query=q, size=40)["hits"]
        assert got["total"] == want["total"] and len(got["hits"]) == len(want["hits"])
        assert _close(got["max_score"], want["max_score"], 1e-6)
        for g, w in zip(got["hits"], want["hits"]):
            assert _close(g["_score"], w["_score"], 1e-6), (g, w)
            assert g["_id"] == w["_id"] or _close(g["_score"], w["_score"], 1e-5), (g, w)
        assert got["hits"][0]["_id"] == "7"
        live = fresh.search(q, size=40)["hits"]
        assert not _close(live["max_score"], got["max_score"], 1e-3)
    finally:
        ref.close()
        port.close()


def test_update_script_is_not_yet_ported():
    """`_update` with a [script] runs the reference's painless subset
    (`script/update.py`, ported since); a statement outside it answers 400
    and leaves the doc as it was."""
    app = make_app(device="cpu")
    try:
        app.handle("PUT", "/s/_doc/1", {"refresh": "true"}, {}, b'{"n": 1}')
        status, _, raw = app.handle("POST", "/s/_update/1", {}, {},
                                    b'{"script": {"source": "ctx._source.n += 1"}}')
        assert status == 200 and json.loads(raw)["result"] == "updated"
        assert app.engine.get_index("s").get_doc("1")["_source"] == {"n": 2}
        status, _, raw = app.handle("POST", "/s/_update/1", {}, {},
                                    b'{"script": {"source": "for (x in y) {}"}}')
        out = json.loads(raw)
        assert status == 400 and "unsupported update-script" in out["error"]["reason"]
        assert app.engine.get_index("s").get_doc("1")["_source"] == {"n": 2}
    finally:
        app.close()


# ---- the port alone -------------------------------------------------------


def _http(conn, method, path, body=None, headers=None):
    conn.request(method, path, body=_payload(body), headers={
        "Content-Type": _content_type(body), **(headers or {})})
    r = conn.getresponse()
    raw = r.read()
    return r.status, dict(r.getheaders()), (json.loads(raw) if raw else None)


@pytest.fixture
def served():
    app = make_app(device="cpu")
    server = serve(app, "127.0.0.1", 0)
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        yield app, conn
    finally:
        conn.close()
        server.stop()


def test_http_server_keep_alive_round_trip(served):
    """The standard library's server: one persistent connection carries
    index creation, `_bulk`, `_refresh`, `_search` and error envelopes."""
    app, conn = served
    assert _http(conn, "GET", "/")[0] == 200
    assert _http(conn, "PUT", "/books", {"mappings": MAPPING})[0] == 200
    status, _, out = _http(conn, "POST", "/books/_bulk?refresh=true", _bulk_body(_docs()))
    assert status == 200 and not out["errors"]
    status, _, out = _http(conn, "POST", "/books/_search",
                           {"query": {"match": {"title": "alpha"}}, "size": 3})
    want = app.engine.get_index("books").search({"match": {"title": "alpha"}}, size=3)
    assert status == 200 and out["hits"] == json.loads(json.dumps(want["hits"]))
    status, _, out = _http(conn, "GET", "/nope/_search")
    assert status == 404 and out["error"]["type"] == "index_not_found_exception"
    status, headers, out = _http(conn, "HEAD", "/books")
    assert status == 200 and out is None and headers["Content-Length"] == "0"
    status, _, out = _http(conn, "GET", "/books/_no_such_endpoint")
    assert status == 400 and "no handler found" in out["error"]["reason"]
    status, _, out = _http(conn, "DELETE", "/_cluster/settings")
    assert status == 405


def test_rest_serving_coalesces_and_sheds(served):
    """Serving on over REST: concurrent `_search`es and an `_msearch` equal
    the serving-off answers (the wave contract), `/_serving/stats` counts
    the waves, and a tripped in_flight_requests breaker answers 429
    circuit_breaking_exception with Retry-After >= 1."""
    from concurrent.futures import ThreadPoolExecutor

    app, conn = served
    _http(conn, "PUT", "/books", {"mappings": MAPPING})
    _http(conn, "POST", "/books/_bulk?refresh=true", _bulk_body(_docs()))
    bodies = [{"query": {"match": {"title": w}}, "size": 4} for w in WORDS]
    bodies += [{"query": {"bool": {"must": [{"match": {"title": "alpha"}}],
                                   "filter": [{"range": {"n": {"lt": 500}}}]}}}]
    solo = [app.handle("POST", "/books/_search", {}, {}, _payload(b))[2] for b in bodies]
    status, _, _ = _http(conn, "PUT", "/_cluster/settings",
                         {"transient": {"serving.enabled": True}})
    assert status == 200 and app.engine.serving_if_enabled() is not None

    def one(b):
        return app.handle("POST", "/books/_search", {}, {"X-Opaque-Id": "team a"}, _payload(b))

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(one, bodies * 3))
    idx = app.engine.get_index("books")
    for j, (status, _, raw) in enumerate(got):
        assert status == 200
        g, w = json.loads(raw), json.loads(solo[j % len(bodies)])
        _same_wave_hits(idx, bodies[j % len(bodies)], g["hits"], w["hits"], f"wave {j}")
    status, _, out = _http(conn, "POST", "/_msearch", _ndjson(
        [x for b in bodies for x in ({"index": "books"}, b)]))
    assert status == 200 and [r["status"] for r in out["responses"]] == [200] * len(bodies)
    # a queue shallower than the msearch: its sub-searches wait their turn
    # (at most the queue's depth in flight) instead of being shed
    app.engine.serving.set_queue_depth(3)
    status, _, out = _http(conn, "POST", "/books/_msearch", _ndjson(
        [x for b in bodies * 2 for x in ({}, b)]))
    assert [r["status"] for r in out["responses"]] == [200] * (2 * len(bodies))
    app.engine.serving.set_queue_depth(1000)
    st = _http(conn, "GET", "/_serving/stats")[2]["serving"]
    assert st["enabled"] and st["completed"] >= 4 * len(bodies)
    assert 1 <= st["waves"] and st["term_packed"] > 0
    app.engine.breakers.children["in_flight_requests"].limit = 1
    status, headers, out = _http(conn, "POST", "/books/_search", bodies[0])
    assert status == 429 and int(headers["Retry-After"]) >= 1
    assert out["error"]["type"] == "circuit_breaking_exception"
    app.engine.breakers.children["in_flight_requests"].limit = app.engine.breakers.total
    assert app.engine.serving._reserved_bytes == 0


def _same_wave_hits(idx, body, got: dict, want: dict, what: str) -> None:
    """A wave's answer against the solo answer: the generic lane's equal;
    a term-lane row (served by the batched arms) with totals equal and
    scores and ids within the impact arm's quantization tie class
    (`ops.batched.impact_tie_class`, at least 1e-7) plus 1e-6 relative."""
    from elasticsearch_tpu_torch.ops.batched import impact_tie_class
    from elasticsearch_tpu_torch.query.dsl import parse_query
    from elasticsearch_tpu_torch.serving.coalesce import term_disjunction_of

    spec = term_disjunction_of(parse_query(body["query"], idx.mappings))
    if spec is None:
        assert got == want, what
        return
    tie = impact_tie_class(idx.searcher.pack, *spec)
    assert got["total"] == want["total"] and len(got["hits"]) == len(want["hits"]), what
    for g, w in zip(got["hits"], want["hits"]):
        gap = abs(g["_score"] - w["_score"])
        assert gap <= tie + 1e-6 * abs(w["_score"]), what
        assert g["_id"] == w["_id"] or gap <= tie, what


def _subprocess(code: str, timeout: int = 120) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=timeout)


def test_server_entry_point_loads_no_reference():
    """`python -m elasticsearch_tpu_torch.rest.server --device cpu --port 0`
    starts, answers over HTTP, and its process holds no aiohttp, jax or
    elasticsearch_tpu module."""
    code = (
        "import http.client, json, sys, threading\n"
        "from elasticsearch_tpu_torch.rest import server\n"
        "import http.server as hs\n"
        "orig = hs.ThreadingHTTPServer.serve_forever\n"
        "def once(self, *a, **kw):\n"
        "    t = threading.Thread(target=orig, args=(self,), daemon=True); t.start()\n"
        "    c = http.client.HTTPConnection('127.0.0.1', self.port, timeout=30)\n"
        "    c.request('PUT', '/x', body=b'{}'); c.getresponse().read()\n"
        "    c.request('GET', '/x/_search'); r = c.getresponse(); body = json.loads(r.read())\n"
        "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'aiohttp', 'elasticsearch_tpu'))\n"
        "    print(json.dumps({'status': r.status, 'total': body['hits']['total'], 'bad': bad}))\n"
        "    self.shutdown()\n"
        "hs.ThreadingHTTPServer.serve_forever = once\n"
        "sys.exit(server.main(['--device', 'cpu', '--port', '0']))\n"
    )
    res = _subprocess(code)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("listening on http://127.0.0.1:")
    assert json.loads(lines[-1]) == {"status": 200, "total": {"value": 0, "relation": "eq"},
                                     "bad": []}


def test_server_refuses_to_start_without_a_card():
    """Without a CUDA card and without --device cpu the server exits
    non-zero before it binds a port."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device starts")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-m", "elasticsearch_tpu_torch.rest.server",
                          "--port", "0"], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "listening" not in res.stdout
