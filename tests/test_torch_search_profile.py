"""The port's `profile: true` (`search/profile.py` and the REST flow) against
the JAX package's.

Both packages' REST apps (the reference's aiohttp app through its
TestClient, the port's `RestApp` with device="cpu") answer the same
profiled `_search`es on 1 and 3 shards: each shard's entry id, the tree's
node types, descriptions and shape of children, the breakdown's keys and
counts, the collector's name and reason, and the hits are equal with the
timings left out. The `device` sections name the port's kernels: one
`scan_topk` event per selection the request made, the main search's and
two per profiled node, on every shard's section. Then a tree over the
MAX_PROFILED_NODES budget, an index with no documents, the reference's
`empty_shard` entry, tests/test_suggest.py's REST case (a suggest and a
profile in one body), and a profiled request with serving on, which takes
the solo path.
"""

import json

import pytest

from elasticsearch_tpu.search import profile as ref_profile
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.search import profile
from torch_parity import rest_both, same_hits, text_docs

MAPPING = {"properties": {"body": {"type": "text"}, "title": {"type": "text"},
                          "tag": {"type": "keyword"}, "n": {"type": "long"},
                          "p": {"type": "double"}}}
QUERIES = {
    "term": {"match": {"body": "w3"}},
    "or4": {"bool": {"should": [{"match": {"body": w}} for w in ("w1", "w4", "w9", "w17")]}},
    "match_multi": {"match": {"body": "w2 w5 w30"}},
    "match_and": {"match": {"body": {"query": "w1 w2", "operator": "and"}}},
    "bool_full": {"bool": {"must": [{"match": {"body": "w1"}}],
                           "filter": [{"range": {"n": {"gte": 10, "lt": 40}}}],
                           "should": [{"match": {"title": "w2"}}],
                           "must_not": [{"term": {"tag": "k03"}}]}},
    "range": {"range": {"p": {"gt": -1.0}}},
    "terms": {"terms": {"tag": ["k01", "k02", "k05"]}},
    "phrase": {"match_phrase": {"body": "w1 w2"}},
    "prefix": {"prefix": {"body": "w1"}},
    "wildcard": {"wildcard": {"body": "w?5"}},
    "dis_max": {"dis_max": {"queries": [{"match": {"body": "w6"}},
                                        {"match": {"title": "w6"}}]}},
    "constant_score": {"constant_score": {"filter": {"term": {"tag": "k07"}}, "boost": 2}},
    "match_all": {"match_all": {}},
    "no_query": None,
    "over_budget": {"bool": {"should": [{"match": {"body": f"w{i} w{i + 30}"}}
                                        for i in range(14)]}},
}
_TIMINGS = {"time_in_nanos", "rewrite_time"}


def strip(tree):
    """A profile entry without its timings (the breakdown's counts stay)."""
    if isinstance(tree, list):
        return [strip(x) for x in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in _TIMINGS or k in ("device", "phases"):
            continue
        if k == "breakdown":
            v = {bk: bv for bk, bv in v.items() if bk.endswith("_count")}
        out[k] = strip(v)
    return out


def count_nodes(tree: dict) -> int:
    return 1 + sum(count_nodes(c) for c in tree.get("children", ()))


def _bulk(docs) -> str:
    lines = []
    for i, d in docs:
        lines += [json.dumps({"index": {"_id": i}}), json.dumps(d)]
    return "\n".join(lines) + "\n"


def _sequence(shards: int) -> list:
    seq = [("create", "PUT", "/pf", {"mappings": MAPPING,
                                     "settings": {"number_of_shards": shards}}, {}),
           ("bulk", "POST", "/pf/_bulk", _bulk(text_docs(shards, 200)), {}),
           ("refresh", "POST", "/pf/_refresh", None, {}),
           ("create_empty", "PUT", "/pf_empty", {"mappings": MAPPING}, {}),
           ("empty", "POST", "/pf_empty/_search", {"query": {"match": {"body": "w1"}},
                                                    "profile": True}, {})]
    for name, q in QUERIES.items():
        body = {"profile": True, "size": 5}
        if q is not None:
            body["query"] = q
        seq.append((name, "POST", "/pf/_search", body, {}))
    return seq


@pytest.fixture(scope="module", params=[1, 3], ids=["1shard", "3shards"])
def runs(request, tmp_path_factory):
    port, ref = rest_both(_sequence(request.param),
                          tmp_path_factory.mktemp(f"pf_ref{request.param}"))
    return request.param, port, ref


@pytest.mark.parametrize("name", [*QUERIES, "empty"])
def test_profile_trees_equal_reference(runs, name):
    shards, port, ref = runs
    (gs, got), (ws, want) = port[name], ref[name]
    assert gs == ws == 200, (got, want)
    assert strip(got["profile"]) == strip(want["profile"])
    assert len(got["profile"]["shards"]) == (shards if name != "empty" else 1)
    same_hits(got, want, name)
    tree = got["profile"]["shards"][0]["searches"][0]["query"][0]
    assert tree["time_in_nanos"] > 0 and tree["breakdown"]["score"] > 0


@pytest.mark.parametrize("name", list(QUERIES))
def test_device_sections_name_the_ports_kernels(runs, name):
    """One `scan_topk` event per selection: the main search's (1 at size
    5), then 2 per profiled node (cold, warm), marked phase "profile"; on
    every shard's section (one selection over every shard's lanes). Past
    MAX_PROFILED_NODES a node's children are not walked (its siblings
    still are, as in the reference): 1 + 14 + 28 nodes give 31."""
    shards, port, _ref = runs
    res = port[name][1]
    nodes = count_nodes(res["profile"]["shards"][0]["searches"][0]["query"][0])
    if name == "over_budget":
        assert nodes == 31 and profile.MAX_PROFILED_NODES == 24
    for entry in res["profile"]["shards"]:
        dev = entry["device"]
        names = [k["name"] for k in dev["kernels"]]
        assert set(names) == {"scan_topk"}, names
        walk = [k for k in dev["kernels"] if k.get("phase") == "profile"]
        assert len(names) - len(walk) == 1 and len(walk) == 2 * nodes
        assert all(k["scope"] == "mesh" and k["k"] == 1 and k["queries"] == 1 for k in walk)
        assert dev["tier"] == "xla_topk" and dev["request_cache"] == {"hits": 0, "misses": 0}
        assert entry["phases"]["query_ms"] >= 0 and "fetch_ms" in entry["phases"]


def test_empty_shard_entry_equals_reference():
    engine = Engine(device="cpu")
    try:
        idx = engine.create_index("never", MAPPING)
        assert profile.empty_shard(idx, engine.node_name) == ref_profile.empty_shard(
            idx, "node-0")
        assert profile.device_sections(None, 3) == [
            {k: v for k, v in sec.items()} for sec in ref_profile.device_sections(None, 3)]
    finally:
        engine.close()


def test_rest_suggest_and_profile(tmp_path):
    """tests/test_suggest.py's REST case on both apps."""
    seq = [("create", "PUT", "/s", {"mappings": {"properties": {
        "body": {"type": "text"}, "sug": {"type": "completion"}}}}, {}),
        ("bulk", "POST", "/_bulk", "\n".join(json.dumps(x) for x in [
            {"index": {"_index": "s", "_id": "1"}}, {"body": "quick brown fox", "sug": "quick"},
            {"index": {"_index": "s", "_id": "2"}}, {"body": "lazy dog", "sug": "lazy"}]) + "\n",
         {}),
        ("refresh", "POST", "/s/_refresh", None, {}),
        ("search", "POST", "/s/_search", {"query": {"match": {"body": "quick"}},
                                          "suggest": {"sg": {"text": "quik",
                                                             "term": {"field": "body"}}},
                                          "profile": True}, {})]
    port, ref = rest_both(seq, tmp_path)
    got, want = port["search"][1], ref["search"][1]
    assert got["suggest"] == want["suggest"]
    assert got["suggest"]["sg"][0]["options"][0]["text"] == "quick"
    assert got["profile"]["shards"][0]["searches"][0]["query"][0]["time_in_nanos"] > 0
    assert strip(got["profile"]) == strip(want["profile"])
    assert got["hits"]["total"]["value"] == 1


def test_profiled_request_takes_the_solo_path_with_serving_on():
    app = make_app(device="cpu")
    try:
        for name, method, path, body, params in _sequence(1)[:3]:
            payload = body.encode() if isinstance(body, str) else json.dumps(body).encode() \
                if body is not None else b""
            assert app.handle(method, path, params, {}, payload)[0] == 200
        put = json.dumps({"transient": {"serving.enabled": True}}).encode()
        assert app.handle("PUT", "/_cluster/settings", {}, {}, put)[0] == 200
        body = {"query": QUERIES["or4"], "profile": True}
        status, _h, raw = app.handle("POST", "/pf/_search", {}, {}, json.dumps(body).encode())
        assert status == 200 and json.loads(raw)["profile"]["shards"]
        stats = json.loads(app.handle("GET", "/_serving/stats", {}, {}, b"")[2])["serving"]
        assert stats["admitted"] == 0 and stats["waves"] == 0
        body.pop("profile")
        assert app.handle("POST", "/pf/_search", {}, {}, json.dumps(body).encode())[0] == 200
        stats = json.loads(app.handle("GET", "/_serving/stats", {}, {}, b"")[2])["serving"]
        assert stats["admitted"] == 1
    finally:
        app.close()
