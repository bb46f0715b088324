"""The long-tail query kinds of the port (`query/extra.py`): more_like_this,
terms_set, combined_fields, rank_feature, distance_feature, pinned and
wrapper, against the JAX package on the same numpy-seeded docs, on 1 and
3 shards.

Mirrors tests/test_extra_queries.py's bodies, then seeded bodies beyond
them: more_like_this by text and by `_id` on several shards (the global df
and each shard's `doc_sources`), terms_set with per-doc requirements,
rank_feature in each function with and without a pivot, distance_feature
on a date and on a geo_point inside a bool, pinned over an organic query,
a tiered index and REST.

Tolerances (`torch_parity.same_hits`): totals equal, scores within 1e-6
relative, ids equal but for fp-ties (1e-5 relative). The reference side
scores sparse terms from its impact tier (`ES_TPU_IMPACT=force`), as the
port does.
"""

import base64
import json

import numpy as np
import pytest

from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.utils.errors import QueryParsingError
from torch_parity import Pair, same_hits

ART_MAPPING = {"properties": {
    "title": {"type": "text"}, "body": {"type": "text"}, "tags": {"type": "keyword"},
    "pagerank": {"type": "rank_feature"}, "published": {"type": "date"},
    "codes": {"type": "keyword"}, "required_matches": {"type": "integer"},
    "loc": {"type": "geo_point"}}}
ART_DOCS = [
    ("1", {"title": "jax on tpus", "body": "jax compiles numpy programs for tpus and gpus using xla",
           "pagerank": 10.0, "published": 1700000000000, "codes": ["a", "b"],
           "required_matches": 2}),
    ("2", {"title": "pallas kernels", "body": "pallas writes custom tpu kernels inside jax programs",
           "pagerank": 50.0, "published": 1700086400000, "codes": ["a"], "required_matches": 1}),
    ("3", {"title": "cooking pasta", "body": "boil water add salt cook pasta drain and serve",
           "pagerank": 1.0, "published": 1600000000000, "codes": ["c"], "required_matches": 1}),
    ("4", {"title": "tpu programs", "body": "xla programs run fast on tpu hardware with jax",
           "pagerank": 5.0, "published": 1700172800000, "codes": ["a", "b", "c"],
           "required_matches": 3}),
]


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()


@pytest.fixture(params=[1, 3], ids=["1shard", "3shards"], scope="module")
def art(request):
    p = Pair(ART_MAPPING, {"number_of_shards": request.param})
    p.index(ART_DOCS)
    p.refresh()
    yield p
    p.close()


def _wrap(q) -> str:
    return base64.b64encode(json.dumps(q).encode()).decode()


REFERENCE_BODIES = {
    "mlt_by_id": {"more_like_this": {"fields": ["body"], "like": [{"_id": "1"}],
                                     "min_term_freq": 1, "min_doc_freq": 2,
                                     "minimum_should_match": "30%"}},
    "mlt_text": {"more_like_this": {"fields": ["body"], "like": "custom tpu kernels with jax",
                                    "min_term_freq": 1, "min_doc_freq": 1,
                                    "minimum_should_match": 1}},
    "terms_set_abc": {"terms_set": {"codes": {"terms": ["a", "b", "c"],
                                              "minimum_should_match_field": "required_matches"}}},
    "terms_set_ab": {"terms_set": {"codes": {"terms": ["a", "b"],
                                             "minimum_should_match_field": "required_matches"}}},
    "combined_fields": {"combined_fields": {"query": "pasta kernels", "fields": ["title", "body"]}},
    "rank_saturation": {"rank_feature": {"field": "pagerank", "saturation": {"pivot": 10}}},
    "rank_log": {"rank_feature": {"field": "pagerank", "log": {"scaling_factor": 1}}},
    "distance_feature_date": {"bool": {"must": [{"match": {"body": "tpu"}}], "should": [
        {"distance_feature": {"field": "published", "origin": 1700172800000, "pivot": "1d"}}]}},
    "pinned": {"pinned": {"ids": ["3", "1"], "organic": {"match": {"body": "tpu"}}}},
    "wrapper": {"wrapper": {"query": _wrap({"match": {"body": "pasta"}})}},
}
REFERENCE_FIRST = {"mlt_text": "2", "rank_saturation": "2", "rank_log": "2",
                   "distance_feature_date": "4", "pinned": "3", "wrapper": "3"}


@pytest.mark.parametrize("name", sorted(REFERENCE_BODIES))
def test_reference_extra_bodies(art, name):
    got = art.check(name, query=REFERENCE_BODIES[name], size=10)
    ids = [h["_id"] for h in got["hits"]["hits"]]
    if name in REFERENCE_FIRST:
        assert ids[0] == REFERENCE_FIRST[name]
    if name == "pinned":
        assert ids[:2] == ["3", "1"] and set(ids[2:]) == {"2", "4"}
    if name == "terms_set_ab":
        assert set(ids) == {"1", "2"}
    if name == "combined_fields":
        assert set(ids) == {"2", "3"}


def test_rank_feature_saturation_values(art):
    got = art.port.search({"rank_feature": {"field": "pagerank", "saturation": {"pivot": 10}}})
    scores = {h["_id"]: h["_score"] for h in got["hits"]["hits"]}
    assert scores["2"] == pytest.approx(50 / 60, rel=1e-6)
    assert scores["1"] == pytest.approx(10 / 20, rel=1e-6)


def test_wrapper_errors_are_parse_errors(art):
    with pytest.raises(QueryParsingError):
        art.port.search({"wrapper": {"query": "not base64 json!"}})
    with pytest.raises(QueryParsingError):
        art.port.search({"wrapper": {}})


# ---------------------------------------------------------------------------
# seeded bodies
# ---------------------------------------------------------------------------

def extra_docs(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 61)
    p /= p.sum()
    docs = []
    for i in range(n):
        words = rng.choice(60, size=int(rng.integers(3, 14)), p=p)
        src = {"body": " ".join(f"w{w}" for w in words),
               "title": " ".join(f"w{w}" for w in words[:2]),
               "codes": [f"c{int(c)}" for c in rng.choice(8, size=int(rng.integers(1, 4)),
                                                          replace=False)],
               "required_matches": int(rng.integers(1, 4)),
               "published": 1_700_000_000_000 + int(rng.integers(0, 30)) * 86_400_000,
               "loc": {"lat": float(rng.uniform(40, 50)), "lon": float(rng.uniform(0, 15))}}
        if i % 6:
            src["pagerank"] = float(rng.uniform(0.1, 200.0))
        docs.append((f"e{i}", src))
    return docs


@pytest.fixture(params=[1, 3], ids=["1shard", "3shards"], scope="module")
def seeded(request):
    docs = extra_docs(request.param, 500)
    p = Pair(ART_MAPPING, {"number_of_shards": request.param})
    p.index(docs)
    p.refresh()
    yield p, docs
    p.close()


def _seeded_bodies(docs) -> list:
    like_text = docs[7][1]["body"] + " " + docs[9][1]["body"]
    return [
        {"more_like_this": {"fields": ["body"], "like": like_text, "min_term_freq": 1,
                            "min_doc_freq": 2}},
        {"more_like_this": {"fields": ["body", "title"], "like": [like_text, {"_id": "e3"}],
                            "min_term_freq": 1, "min_doc_freq": 1, "max_query_terms": 8,
                            "minimum_should_match": "50%"}},
        {"more_like_this": {"like": [{"_id": "e11"}, {"_id": "e12"}], "unlike": "w0 w1",
                            "min_term_freq": 1, "min_doc_freq": 3}},
        {"more_like_this": {"fields": ["body"], "like": "zzz unknown", "min_term_freq": 1}},
        {"terms_set": {"codes": {"terms": ["c0", "c1", "c2", "c5"],
                                 "minimum_should_match_field": "required_matches"}}},
        {"terms_set": {"codes": {"terms": ["c3"], "minimum_should_match_field": "required_matches",
                                 "boost": 2.0}}},
        {"combined_fields": {"query": "w3 w5 w8", "fields": ["title", "body^2"],
                             "operator": "and"}},
        {"combined_fields": {"query": "w1 w20", "fields": ["title", "body"]}},
        {"rank_feature": {"field": "pagerank"}},
        {"rank_feature": {"field": "pagerank", "saturation": {"pivot": 25}, "boost": 3}},
        {"rank_feature": {"field": "pagerank", "log": {"scaling_factor": 2.5}}},
        {"rank_feature": {"field": "pagerank", "sigmoid": {"pivot": 30, "exponent": 0.7}}},
        {"rank_feature": {"field": "pagerank", "linear": {}}},
        {"bool": {"must": [{"match": {"body": "w2"}}],
                  "should": [{"rank_feature": {"field": "pagerank", "log": {"scaling_factor": 1}}},
                             {"distance_feature": {"field": "published",
                                                   "origin": "2023-11-20", "pivot": "3d"}}]}},
        {"bool": {"must": [{"match": {"body": "w4 w6"}}], "should": [
            {"distance_feature": {"field": "loc", "origin": {"lat": 45, "lon": 7},
                                  "pivot": "50km"}}]}},
        {"distance_feature": {"field": "loc", "origin": "44.5,8.25", "pivot": "10km", "boost": 2}},
        {"wrapper": {"query": _wrap({"bool": {"must": [{"match": {"body": "w1"}}],
                                              "filter": [{"range": {"required_matches": {"gte": 2}}}]}})}},
    ]


def test_seeded_extra_bodies(seeded):
    p, docs = seeded
    for q in _seeded_bodies(docs):
        p.check(json.dumps(q), query=q, size=20)


def test_pinned_over_organic(seeded):
    """The pinned ids first, in list order (an unknown id skipped), then the
    organic hits as the reference's organic query ranks them. On one shard
    the whole response equals the reference's; on several the reference's
    stacked route pads each shard's pinned id list with docid 0 (ROADMAP
    queue C), so there the port is held to the reference's organic query."""
    p, docs = seeded
    ids = ["e40", "e2", "nope", "e13"]
    organic = {"match": {"body": "w7"}}
    q = {"pinned": {"ids": ids, "organic": organic}}
    got = p.port.search(q, size=25)
    want_org = p.ref.search(query=organic, size=25)
    pinned = [i for i in ids if i != "nope"]
    hits = got["hits"]["hits"]
    assert [h["_id"] for h in hits[:3]] == pinned
    assert [h["_score"] for h in hits[:3]] == sorted((h["_score"] for h in hits[:3]), reverse=True)
    rest = [h for h in want_org["hits"]["hits"] if h["_id"] not in pinned][:22]
    assert [h["_id"] for h in hits[3:]] == [h["_id"] for h in rest] or all(
        abs(a["_score"] - b["_score"]) <= 1e-5 * b["_score"] for a, b in zip(hits[3:], rest))
    org_ids = {h["_id"] for h in p.ref.search(query=organic, size=len(docs))["hits"]["hits"]}
    assert got["hits"]["total"]["value"] == len(org_ids | set(pinned))
    if p.port.num_shards == 1:
        same_hits(got, p.ref.search(query=q, size=25), "pinned")


def test_more_like_this_by_id_reads_every_shard(seeded):
    """A like `_id` on another shard still contributes its text: the
    selected terms are those of one shard's whole index."""
    p, docs = seeded
    q = {"more_like_this": {"fields": ["body"], "like": [{"_id": d} for d, _ in docs[40:46]],
                            "min_term_freq": 2, "min_doc_freq": 2}}
    got = p.check("mlt ids", query=q, size=30)
    assert got["hits"]["total"]["value"] > 0


def test_extra_on_a_tiered_index():
    """more_like_this by id, pinned and terms_set resolve docs across the
    index, so the tiers merge first, as the reference's do; rank_feature
    after."""
    docs = extra_docs(77, 600)
    p = Pair(ART_MAPPING)
    try:
        p.index(docs[:450])
        p.refresh()
        p.index(docs[450:560])
        p.refresh()
        p.index(docs[560:])
        p.refresh()
        for q in ({"more_like_this": {"like": [{"_id": "e500"}], "min_term_freq": 1,
                                      "min_doc_freq": 2}},
                  {"pinned": {"ids": ["e590", "e10"], "organic": {"match": {"body": "w3"}}}},
                  {"terms_set": {"codes": {"terms": ["c1", "c2"],
                                           "minimum_should_match_field": "required_matches"}}},
                  {"rank_feature": {"field": "pagerank", "sigmoid": {"pivot": 9, "exponent": 1.3}}}):
            p.check(json.dumps(q), query=q, size=15)
    finally:
        p.close()


def test_extra_over_rest():
    docs = extra_docs(5, 200)
    app = make_app(device="cpu")
    try:
        assert app.handle("PUT", "/e", {}, {}, json.dumps({"mappings": ART_MAPPING}).encode())[0] == 200
        nd = "".join(json.dumps({"index": {"_index": "e", "_id": i}}) + "\n" + json.dumps(s) + "\n"
                     for i, s in docs).encode()
        assert app.handle("POST", "/_bulk", {"refresh": "true"}, {}, nd)[0] == 200
        idx = app.engine.get_index("e")
        for q in _seeded_bodies(docs)[:3] + _seeded_bodies(docs)[-3:]:
            st, _h, out = app.handle("POST", "/e/_search", {}, {},
                                     json.dumps({"query": q, "size": 12}).encode())
            assert st == 200
            same_hits(json.loads(out), idx.search(q, size=12), json.dumps(q))
    finally:
        app.close()
