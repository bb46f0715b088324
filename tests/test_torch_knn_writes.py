"""Writes to a vector index, tiered kNN, kNN in `_msearch`, the serving
wave and REST, and the `exists` query: the port against the JAX package's.

Each script indexes, updates (with new vectors), deletes and refreshes
through the reference's `Engine(None)` index and the port's
`Engine(device="cpu")` index alike, so both take the same incremental
refreshes and seal the same tail segments; a segment packs its vectors
with the index's mappings, so one that holds enough vectors carries its
own small IVF index, which kNN probes as it probes the base. At each
checkpoint the same kNN, hybrid and `exists` requests run on both. The
reference's text part scores from its impact tier (ES_TPU_IMPACT=force),
as the port does.

Tolerances: totals equal; scores within 1e-6 relative (l2_norm: 64 ulp of
|d|^2 + |q|^2 carried through 1/(1 + l2)); ids equal except where the two
scores agree within 1e-5 relative (fp-ties); `_source` equal.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.engine.engine import Engine as RefEngine
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu.query.executor import ShardSearcher as RefShardSearcher
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.query.executor import ShardSearcher
from elasticsearch_tpu_torch.rest import make_app

D = 16
F32_EPS = 2.0 ** -24
WORDS = [f"w{i}" for i in range(25)]
MAPPING = {"properties": {
    "vec": {"type": "dense_vector", "dims": D, "similarity": "l2_norm",
            "index_options": {"type": "ivf", "nlist": 10}},
    "body": {"type": "text"}, "tag": {"type": "keyword"}, "n": {"type": "long"}}}


@pytest.fixture(autouse=True)
def _cold_planners_and_impact(monkeypatch):
    """Both planners start each test cold; the reference's text part
    scores from its impact tier, as the port's does."""
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


def _clustered(rng, n, ncl=10):
    """The clustered corpus of tests/test_ann.py."""
    centers = rng.normal(size=(ncl, D)).astype(np.float32) * 4.0
    assign = rng.integers(0, ncl, size=n)
    return centers[assign] + rng.normal(size=(n, D)).astype(np.float32) * 0.6


def _doc(rng, v, n: int, tag: str | None = None) -> dict:
    return {"vec": [float(x) for x in v], "body": " ".join(rng.choice(WORDS, size=4)),
            "tag": tag or f"t{n % 4}", "n": n}


def _same_hits(got, want, what, l2_sq=None):
    """Totals equal, scores within 1e-6 relative (or the l2 allowance for
    `l2_sq` = the largest |d|^2 + |q|^2), ids equal up to fp-ties."""
    gh, wh = got["hits"], want["hits"]
    assert gh.get("total") == wh.get("total"), what
    assert len(gh["hits"]) == len(wh["hits"]), what
    gs = np.array([h["_score"] for h in gh["hits"]])
    ws = np.array([h["_score"] for h in wh["hits"]])
    tol = 1e-6 * np.abs(ws)
    if l2_sq is not None:
        tol = tol + ws ** 2 * 64 * F32_EPS * l2_sq
    assert (np.abs(gs - ws) <= tol).all(), (what, gs, ws)
    for g, w in zip(gh["hits"], wh["hits"]):
        if g["_id"] != w["_id"]:
            assert abs(g["_score"] - w["_score"]) <= max(1e-5 * abs(w["_score"]),
                                                         float(np.max(tol, initial=0))), what
        else:
            assert g["_source"] == w["_source"], what


class Pair:
    """The same index in both packages, driven by the same calls."""

    def __init__(self, mapping=MAPPING, shards: int = 1):
        settings = {"number_of_shards": shards, "refresh_interval": "-1"}
        self.ref = RefEngine(None).create_index("v", mapping, dict(settings))
        self.port = Engine(device="cpu").create_index("v", mapping, dict(settings))

    def index(self, doc_id, d):
        self.ref.index_doc(doc_id, d)
        self.port.index_doc(doc_id, d)

    def delete(self, doc_id):
        self.ref.delete_doc(doc_id)
        self.port.delete_doc(doc_id)

    def refresh(self):
        self.ref.refresh()
        self.port.refresh()

    def same(self, what, l2_sq=None, **kw):
        got = self.port.search(**kw)
        _same_hits(got, self.ref.search(**kw), (what, kw.get("query"),
                                                kw.get("size"), kw.get("from_")), l2_sq)
        return got


def _written_pair(shards: int, seed: int, rounds: int = 3):
    """A base of 700 docs, then `rounds` rounds of 30 updates with new
    vectors, 10 deletes and 40 new docs, each refreshed incrementally."""
    rng = np.random.default_rng(seed)
    vecs = _clustered(rng, 700 + rounds * 70)
    p = Pair(shards=shards)
    for i in range(700):
        p.index(f"d{i}", _doc(rng, vecs[i], i))
    p.refresh()
    alive = {f"d{i}" for i in range(700)}
    deleted, fresh = set(), []
    for r in range(rounds):
        for i in rng.choice(sorted(alive), 30, replace=False):
            p.index(i, _doc(rng, vecs[700 + int(rng.integers(0, rounds * 70))] + 0.05,
                            int(i[1:]), "upd"))
        for i in rng.choice(sorted(alive), 10, replace=False):
            p.delete(i)
            alive.discard(i)
            deleted.add(i)
        for j in range(40):
            i = 700 + r * 70 + j
            p.index(f"n{i}", _doc(rng, vecs[i], i, "fresh"))
            alive.add(f"n{i}")
            fresh.append((f"n{i}", vecs[i]))
        p.refresh()
        assert p.port.last_refresh_kind == "incremental"
    assert len(p.port._tails) == len(p.ref._tails) == rounds
    l2_sq = float((vecs ** 2).sum(1).max() * 4)
    return p, rng, vecs, deleted, fresh, l2_sq


def _knn_bodies(rng, vecs, fresh):
    base = {"field": "vec", "k": 5, "num_candidates": 30}
    q = [[float(x) for x in vecs[int(i)] + 0.1] for i in rng.integers(0, len(vecs), 8)]
    out = [({**base, "query_vector": v}, 10, 0) for v in q[:4]]
    out += [
        ({**base, "query_vector": [float(x) for x in fresh[0][1]], "k": 3}, 10, 0),
        ({**base, "query_vector": q[4], "filter": {"term": {"tag": "upd"}}}, 10, 0),
        ({**base, "query_vector": q[5], "filter": {"range": {"n": {"lt": 40}}}}, 10, 0),
        ([{**base, "query_vector": q[6], "k": 2}, {**base, "query_vector": q[7], "k": 4}], 10, 0),
        ({**base, "query_vector": q[0], "nprobe": 10}, 4, 1),
        ({**base, "query_vector": q[1], "nprobe": 1}, 3, 4),
    ]
    return out


@pytest.mark.parametrize("shards,seed", [(1, 3), (3, 5)])
def test_tiered_knn_after_writes_matches_reference(shards, seed):
    """Base + 3 segments after updates, deletes and new docs: kNN runs on
    each tier and merges, without merging the tiers; no deleted doc comes
    back; a new doc's own vector finds it first; equal to the reference."""
    p, rng, vecs, deleted, fresh, l2_sq = _written_pair(shards, seed)
    tails = list(p.port._tails)
    # a one-shard segment of 70 docs builds its own IVF index (>= 4 * nlist
    # vectors); on 3 shards each segment shard is too small and is scanned
    seg_anns = [seg.searcher.sp.vectors["vec"].ann is not None for seg in tails]
    assert seg_anns == [shards == 1] * len(tails)
    for body, size, from_ in _knn_bodies(rng, vecs, fresh):
        got = p.same("tiered knn", l2_sq, knn=body, size=size, from_=from_)
        assert not {h["_id"] for h in got["hits"]["hits"]} & deleted
    for doc_id, v in fresh[::17]:
        got = p.port.search(knn={"field": "vec", "query_vector": [float(x) for x in v],
                                 "k": 3, "num_candidates": 30})
        assert got["hits"]["hits"][0]["_id"] == doc_id
    assert p.port._tails == tails and len(p.ref._tails) == 3
    # exists on every tier, and inside a kNN filter
    for fld in ("vec", "tag", "n", "body"):
        p.same("exists", query={"exists": {"field": fld}}, size=5)
    p.same("knn filter exists", l2_sq, knn={"field": "vec", "query_vector": fresh[1][1].tolist(),
                                            "k": 4, "filter": {"exists": {"field": "tag"}}})
    # a hybrid search merges the tiers first, in both packages
    p.same("hybrid on tiers", query={"match": {"body": "w1 w2"}},
           knn={"field": "vec", "query_vector": fresh[2][1].tolist(), "k": 4}, size=20)
    assert not p.port._tails and not p.ref._tails


def test_incremental_refresh_tail_knn():
    """tests/test_ann.py:166: a few far-away docs take an incremental
    refresh; kNN finds them in the segment without merging it, the merge
    honors k, and a deleted doc drops out of kNN."""
    rng = np.random.default_rng(0)
    vecs = _clustered(rng, 800)
    idx = Engine(device="cpu").create_index("v", MAPPING)
    for i in range(800):
        idx.index_doc(str(i), {"vec": [float(x) for x in vecs[i]], "tag": f"t{i % 4}"})
    idx.refresh()
    assert idx.searcher.pack.vectors["vec"].ann is not None
    far = rng.normal(size=(5, D)).astype(np.float32) + 30.0
    for j in range(5):
        idx.index_doc(f"new{j}", {"vec": [float(x) for x in far[j]], "tag": "fresh"})
    idx.refresh()
    assert idx.last_refresh_kind == "incremental" and len(idx._tails) == 1
    r = idx.search(knn={"field": "vec", "query_vector": [float(x) for x in far[2]], "k": 3})
    assert r["hits"]["hits"][0]["_id"] == "new2"
    assert len(r["hits"]["hits"]) == 3 and r["hits"]["total"]["value"] == 3
    assert len(idx._tails) == 1, "knn search merged the tiers"
    q0 = [float(x) for x in vecs[11]]
    top = idx.search(knn={"field": "vec", "query_vector": q0, "k": 1,
                          "nprobe": 10})["hits"]["hits"][0]["_id"]
    idx.delete_doc(top)
    idx.refresh()
    r2 = idx.search(knn={"field": "vec", "query_vector": q0, "k": 3, "nprobe": 10})
    assert top not in [h["_id"] for h in r2["hits"]["hits"]]


@pytest.mark.parametrize("shards", [1, 4])
def test_msearch_and_wave_take_knn_bodies(shards):
    """`EsIndex.msearch` with knn-only, hybrid and text bodies answers each
    as `search` does; a serving wave holding each kind answers each as its
    solo `search`, on a flat index and (merging the tiers first) on a
    tiered one."""
    p, rng, vecs, _, fresh, l2_sq = _written_pair(shards, 11, rounds=1)
    port = p.port
    v = [[float(x) for x in vecs[i]] for i in range(6)]
    knn = {"field": "vec", "k": 4, "num_candidates": 20}
    bodies = [
        {"knn": {**knn, "query_vector": v[0]}},
        {"knn": [{**knn, "query_vector": v[1]}, {**knn, "query_vector": v[2], "k": 2}],
         "size": 3, "from": 1},
        {"query": {"match": {"body": "w3 w5"}}, "knn": {**knn, "query_vector": v[3]},
         "size": 15},
        {"query": {"bool": {"must": [{"match": {"body": "w1"}}],
                            "filter": [{"term": {"tag": "t2"}}]}}, "size": 5},
        {"query": {"exists": {"field": "vec"}}, "size": 2},
        {"knn": {**knn, "query_vector": v[4], "filter": {"term": {"tag": "fresh"}}}},
    ]

    def solo(b):
        return port.search(b.get("query"), size=b.get("size", 10), from_=b.get("from", 0),
                           knn=b.get("knn"))

    # on the tiers each body runs as `search` (the hybrid body merges them,
    # in both packages)
    out = port.msearch(bodies)["responses"]
    for b, r in zip(bodies, out):
        assert r.pop("status") == 200
        _same_hits(r, p.ref.search(b.get("query"), size=b.get("size", 10),
                                   from_=b.get("from", 0), knn=b.get("knn")), b, l2_sq)
    assert not port._tails and not p.ref._tails
    # tiers again: a wave holding a knn entry merges them before its lanes
    for i in range(20):
        port.index_doc(f"w{i}", _doc(rng, vecs[i] + 0.2, 5000 + i))
    port.refresh()
    assert len(port._tails) == 1
    entries = [dict(query=b.get("query"), knn=b.get("knn"), size=b.get("size", 10),
                    from_=b.get("from", 0)) for b in bodies]
    waved = port.search_wave(entries)
    assert not port._tails
    for b, got in zip(bodies, waved):
        assert json.dumps(got, sort_keys=True) == json.dumps(solo(b), sort_keys=True), b
    for b, r in zip(bodies, port.msearch(bodies)["responses"]):
        assert r.pop("status") == 200
        assert json.dumps(r, sort_keys=True) == json.dumps(solo(b), sort_keys=True), b


def test_rest_answers_hybrid_and_knn_msearch():
    """REST `_search` with knn + query and `_msearch` with knn, hybrid and
    text bodies, with serving off and on, each equal to `EsIndex.search`."""
    rng = np.random.default_rng(9)
    vecs = _clustered(rng, 600)
    app = make_app(device="cpu")
    try:
        assert app.handle("PUT", "/v", {}, {}, json.dumps(
            {"mappings": MAPPING, "settings": {"number_of_shards": 2}}).encode())[0] == 200
        lines = []
        for i in range(600):
            lines += [json.dumps({"index": {"_index": "v", "_id": f"d{i}"}}),
                      json.dumps(_doc(rng, vecs[i], i))]
        st, _, raw = app.handle("POST", "/_bulk", {"refresh": "true"}, {},
                                ("\n".join(lines) + "\n").encode())
        assert st == 200 and not json.loads(raw)["errors"]
        idx = app.engine.get_index("v")
        knn = {"field": "vec", "query_vector": [float(x) for x in vecs[7]], "k": 5}
        bodies = [{"query": {"match": {"body": "w2 w9"}}, "knn": knn, "size": 12},
                  {"knn": knn, "size": 3},
                  {"query": {"match": {"body": "w4"}}, "size": 6}]
        want = [idx.search(b.get("query"), size=b.get("size", 10), knn=b.get("knn"))
                for b in bodies]
        for serving in ("false", "true"):
            app.handle("PUT", "/_cluster/settings", {}, {}, json.dumps(
                {"transient": {"serving.enabled": serving}}).encode())
            st, _, raw = app.handle("POST", "/v/_search", {}, {}, json.dumps(bodies[0]).encode())
            assert st == 200
            _same_hits(json.loads(raw), want[0], ("rest hybrid", serving))
            body = "".join(json.dumps({"index": "v"}) + "\n" + json.dumps(b) + "\n"
                           for b in bodies)
            st, _, raw = app.handle("POST", "/_msearch", {}, {}, body.encode())
            assert st == 200
            for b, r, w in zip(bodies, json.loads(raw)["responses"], want):
                assert r["status"] == 200, r
                _same_hits(r, w, ("rest msearch", serving, b))
    finally:
        app.close()


# ---- exists ------------------------------------------------------------------


def test_exists_matches_reference():
    """`exists` on a keyword, a long, a text and a vector field, with a
    boost, inside bool and inside a kNN filter; docs miss each field in
    turn; `n` on every doc gives every doc (tests/test_search.py:202)."""
    rng = np.random.default_rng(4)
    vecs = _clustered(rng, 300)
    p = Pair()
    for i in range(300):
        d = _doc(rng, vecs[i], i)
        for j, fld in enumerate(("vec", "body", "tag")):
            if i % (3 + j) == 0:
                del d[fld]
        p.index(f"d{i}", d)
    p.refresh()
    for fld in ("vec", "body", "tag", "n", "nope"):
        got = p.same("exists", query={"exists": {"field": fld}}, size=20)
        want_total = sum(1 for i in range(300)
                         if fld == "n" or (fld != "nope" and i % (3 + ("vec", "body",
                                                                       "tag").index(fld))))
        assert got["hits"]["total"]["value"] == want_total, fld
    p.same("boost", query={"exists": {"field": "tag", "boost": 2.5}}, size=5)
    p.same("bool", query={"bool": {"must": [{"match": {"body": "w1"}}],
                                   "must_not": [{"exists": {"field": "vec"}}]}}, size=30)
    p.same("knn filter", float((vecs ** 2).sum(1).max() * 4),
           knn={"field": "vec", "query_vector": vecs[5].tolist(), "k": 6,
                "filter": {"exists": {"field": "body"}}})
    assert p.port.count({"exists": {"field": "n"}}) == 300


def test_exists_on_a_field_first_seen_in_a_segment():
    """A field that only a tail segment holds: exists answers per tier and
    merges, as the reference's does."""
    p = Pair({"properties": {"body": {"type": "text"}}})
    for i in range(300):
        p.index(f"d{i}", {"body": f"w{i % 7}"})
    p.refresh()
    p.index("x1", {"body": "w1", "late": "yes"})
    p.index("x2", {"late": "no", "score": 3})
    p.index("d4", {"body": "w2", "score": 1.5})
    p.refresh()
    assert p.port.last_refresh_kind == "incremental" and len(p.port._tails) == 1
    for fld in ("late", "score", "body"):
        got = p.same("exists on tiers", query={"exists": {"field": fld}}, size=10)
        assert p.port._tails
        assert got["hits"]["total"]["value"] == {"late": 2, "score": 2, "body": 301}[fld]
    p.delete("d4")
    p.refresh()
    p.same("after delete", query={"exists": {"field": "score"}}, size=10)
    assert p.port.count({"exists": {"field": "score"}}) == 1


def test_exists_zero_token_text():
    """tests/test_search.py:291: a text value that analyzes to no token
    still exists (the field was indexed, with length 0); a doc without the
    field does not."""
    m = {"properties": {"body": {"type": "text"}}}
    rm, pm = RefMappings(m), Mappings(m)
    rb, pb = RefPackBuilder(rm), PackBuilder(pm)
    for src in ({"body": "!!!"}, {}, {"body": "a b"}):
        rb.add_document(rm.parse_document(src))
        pb.add_document(pm.parse_document(src))
    got = ShardSearcher(pb.build(), device="cpu", mappings=pm).search(
        {"exists": {"field": "body"}})
    want = RefShardSearcher(rb.build(), mappings=rm).search({"exists": {"field": "body"}})
    assert got.total == want.total == 2 and list(got.doc_ids) == list(want.doc_ids) == [0, 2]
    assert got.scores.tolist() == want.scores.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("source", [
    {"a": 1, "b": [1, 2.5, True, None, "x"], "c": {"d": (1, 2)}},
    {"v": [float("nan"), float("inf"), -0.0, 1e-300, 10 ** 30]},
    {1: "x", "1": "y", None: 2},
    {"t": ((1, 2), [3, {"k": "é\ud800"}])},
    {"vec": [0.1 * i for i in range(384)], "n": 3},
])
def test_index_doc_snapshot_is_the_json_round_trip(source):
    """The stored source equals `json.loads(json.dumps(source))` (tuples to
    lists, non-str keys to str), and a later mutation of the caller's
    document does not reach it."""
    from elasticsearch_tpu_torch.engine.engine import _json_snapshot

    want = json.loads(json.dumps(source, separators=(",", ":")))
    got = _json_snapshot(source)
    assert json.dumps(got) == json.dumps(want)
    props = {"vec": {"type": "dense_vector", "dims": 384}} if "vec" in source else {}
    idx = Engine(device="cpu").create_index("s", {"dynamic": "false", "properties": props})
    doc = json.loads(json.dumps(want))
    idx.index_doc("x", doc)
    first = next(iter(doc))
    doc[first] = "changed"
    assert json.dumps(idx.get_doc("x")["_source"]) == json.dumps(want)
    cyclic = {"a": []}
    cyclic["a"].append(cyclic)
    with pytest.raises(ValueError, match="Circular reference"):
        _json_snapshot(cyclic)
    with pytest.raises(TypeError, match="not JSON serializable"):
        _json_snapshot({"x": object()})
