"""The port's `_rank_eval` and RRF retriever (`search/rankeval.py`) against
the JAX package's.

The reference's tests/test_percolate_rankeval.py rank-eval cases
(`test_rank_eval_precision_and_mrr`, `test_rrf_retriever`,
`test_rest_rank_eval_and_retriever`) run through the port and the
reference. Then two seeded indices in both packages, on 1 and 3 shards,
on a fresh base and after a tiered refresh: every metric (precision,
recall, mean_reciprocal_rank, dcg with and without `normalize`,
expected_reciprocal_rank) over ratings that span both indices, with their
options; the RRF retriever over a `standard` query and a `knn` section
with `rank_constant` and `rank_window_size`, paged; the errors; and the
same over REST, where the path's index is not what the requests search.

Tolerances: each request's ranked (index, id) list equal to the
reference's up to fp-ties (`torch_parity.same_hits` on the searches the
metrics read; after a tiered refresh, within the impact tier's
quantization tie class, `torch_parity.impact_tie`), and where the two lists are equal the metric scores within
1e-12 and the details `==`; RRF scores within 1e-12 where the fused lists
agree; errors `==`.
"""

import json

import numpy as np
import pytest

from elasticsearch_tpu.engine import Engine as RefEngine
from elasticsearch_tpu.search import rankeval as ref_rankeval
from elasticsearch_tpu.utils.errors import ElasticsearchTpuError as RefError
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.search import rankeval
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuError
from torch_parity import MAPPING, close, impact_tie, rest_both, same_hits, text_docs


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")


def _both(fn):
    """fn(engine class, kwargs) for each package -> (port's, reference's)."""
    return fn(Engine, {"device": "cpu"}), fn(RefEngine, {})


def _ratings_engine(cls, kw):
    e = cls(None, **kw) if cls is RefEngine else cls(**kw)
    e.create_index("d", {"properties": {"t": {"type": "text"}}})
    idx = e.indices["d"]
    for i, txt in [("1", "apple apple apple"), ("2", "apple banana"),
                   ("3", "banana cherry"), ("4", "apple")]:
        idx.index_doc(i, {"t": txt})
    idx.refresh()
    return e


def test_rank_eval_precision_and_mrr():
    port_e, ref_e = _both(_ratings_engine)
    try:
        body = {
            "requests": [{
                "id": "q1",
                "request": {"query": {"match": {"t": "apple"}}, "size": 4},
                "ratings": [{"_index": "d", "_id": "1", "rating": 1},
                            {"_index": "d", "_id": "2", "rating": 1},
                            {"_index": "d", "_id": "3", "rating": 0}],
            }],
            "metric": {"precision": {"k": 3}},
        }
        out = rankeval.rank_eval(port_e, body)
        assert out == ref_rankeval.rank_eval(ref_e, body)
        # top-3 by BM25 for "apple": docs 1, 4, 2 -> rated relevant: 1 and 2
        assert out["details"]["q1"]["metric_score"] == pytest.approx(2 / 3)
        assert {d["_id"] for d in out["details"]["q1"]["unrated_docs"]} == {"4"}
        body["metric"] = {"mean_reciprocal_rank": {"k": 4}}
        out = rankeval.rank_eval(port_e, body)
        assert out["metric_score"] == 1.0 and out == ref_rankeval.rank_eval(ref_e, body)
        body["metric"] = {"dcg": {"k": 4, "normalize": True}}
        out = rankeval.rank_eval(port_e, body)
        assert 0 < out["metric_score"] <= 1.0 and out == ref_rankeval.rank_eval(ref_e, body)
    finally:
        port_e.close()
        ref_e.close()


def _rrf_engine(cls, kw):
    e = cls(None, **kw) if cls is RefEngine else cls(**kw)
    e.create_index("r", {"properties": {"t": {"type": "text"},
                                        "v": {"type": "dense_vector", "dims": 2}}})
    idx = e.indices["r"]
    idx.index_doc("1", {"t": "alpha beta", "v": [1.0, 0.0]})
    idx.index_doc("2", {"t": "alpha", "v": [0.0, 1.0]})
    idx.index_doc("3", {"t": "beta gamma", "v": [0.9, 0.1]})
    idx.refresh()
    return e


def test_rrf_retriever():
    port_e, ref_e = _both(_rrf_engine)
    try:
        retr = {"rrf": {"retrievers": [
            {"standard": {"query": {"match": {"t": "alpha"}}}},
            {"knn": {"field": "v", "query_vector": [1.0, 0.0], "k": 3, "num_candidates": 3}},
        ], "rank_constant": 60}}
        res = rankeval.rrf_retriever_search(port_e, "r", retr, size=3, from_=0)
        hits = res["hits"]["hits"]
        # doc 1 ranks in both lists -> fused first
        assert hits[0]["_id"] == "1"
        assert hits[0]["_score"] > hits[1]["_score"]
        assert {h["_id"] for h in hits} == {"1", "2", "3"}
        want = ref_rankeval.rrf_retriever_search(ref_e, "r", retr, size=3, from_=0)
        assert [(h["_id"], h["_score"]) for h in hits] == \
            [(h["_id"], h["_score"]) for h in want["hits"]["hits"]]
    finally:
        port_e.close()
        ref_e.close()


def test_rest_rank_eval_and_retriever(tmp_path):
    nd = "".join(json.dumps({"index": {"_index": "d", "_id": i}}) + "\n"
                 + json.dumps({"t": txt}) + "\n" for i, txt in [("1", "x y"), ("2", "x")])
    seq = [
        ("put", "PUT", "/d", {"mappings": {"properties": {"t": {"type": "text"}}}}, {}),
        ("bulk", "POST", "/_bulk", nd, {}),
        ("refresh", "POST", "/d/_refresh", None, {}),
        ("rank_eval", "POST", "/d/_rank_eval", {
            "requests": [{"id": "a", "request": {"query": {"match": {"t": "x"}}},
                          "ratings": [{"_index": "d", "_id": "2", "rating": 1}]}],
            "metric": {"recall": {"k": 2}}}, {}),
        ("retriever", "POST", "/d/_search", {"retriever": {"standard": {
            "query": {"match": {"t": "x"}}}}}, {}),
    ]
    port, ref = rest_both(seq, tmp_path)
    assert port["rank_eval"] == ref["rank_eval"]
    assert port["rank_eval"][1]["metric_score"] == 1.0
    assert port["retriever"][1]["hits"]["total"]["value"] == 2
    assert port["retriever"][1]["_shards"] == ref["retriever"][1]["_shards"]
    same_hits(port["retriever"][1], ref["retriever"][1], "retriever")


# ---------------------------------------------------------------------------
# seeded indices: every metric over ratings that span two indices
# ---------------------------------------------------------------------------

VEC_MAPPING = {"properties": {**MAPPING["properties"],
                              "v": {"type": "dense_vector", "dims": 4,
                                    "similarity": "l2_norm"}}}


class Two:
    """Two indices (`a`, `b`) in both packages, with a 4-d vector field."""

    def __init__(self, shards: int, tiered: bool, seed: int):
        self.ref, self.port = RefEngine(None), Engine(device="cpu")
        rng = np.random.default_rng(seed)
        for name in ("a", "b"):
            docs = text_docs(seed + ord(name), 90)
            vecs = rng.normal(size=(len(docs), 4)).round(3)
            docs = [(i, {**d, "v": [float(x) for x in v]}) for (i, d), v in zip(docs, vecs)]
            for e in (self.ref, self.port):
                idx = e.create_index(name, VEC_MAPPING, {"number_of_shards": shards})
                for i, d in docs:
                    idx.index_doc(i, d)
                idx.refresh()
            if tiered:
                more = text_docs(seed + 7 + ord(name), 20)
                more = [(i if k % 2 else f"{i}-n",
                         {**d, "v": [float(x) for x in rng.normal(size=4).round(3)]})
                        for k, (i, d) in enumerate(more)]
                gone = sorted({f"d{int(x)}" for x in rng.integers(20, 90, 6)})
                for e in (self.ref, self.port):
                    idx = e.get_index(name)
                    for i, d in more:
                        idx.index_doc(i, d)
                    for i in gone:
                        idx.delete_doc(i)
                    idx.refresh()
                assert self.port.get_index(name)._tails

    def close(self):
        self.ref.close()
        self.port.close()


METRICS = {
    "precision": {"precision": {"k": 5}},
    "precision_threshold": {"precision": {"k": 10, "relevant_rating_threshold": 2}},
    "recall": {"recall": {"k": 10}},
    "mean_reciprocal_rank": {"mean_reciprocal_rank": {"k": 8, "relevant_rating_threshold": 2}},
    "dcg": {"dcg": {"k": 10}},
    "dcg_normalize": {"dcg": {"k": 6, "normalize": True}},
    "expected_reciprocal_rank": {"expected_reciprocal_rank": {"k": 10, "maximum_relevance": 3}},
}


def _rank_eval_body(rng, n_requests: int, metric: dict) -> dict:
    requests = []
    for r in range(n_requests):
        q = " ".join(f"w{int(x)}" for x in rng.integers(0, 25, 2))
        ratings = [{"_index": str(rng.choice(["a", "b"])), "_id": f"d{int(x)}",
                    "rating": int(rng.integers(0, 4))} for x in rng.integers(0, 90, 14)]
        if r % 3 == 0:  # a request whose ratings name one index
            ratings = [dict(x, _index="a") for x in ratings]
        req = {"query": {"match": {"body": q}}}
        if r % 2:
            req["size"] = int(rng.integers(3, 15))
        requests.append({"id": f"q{r}", "request": req, "ratings": ratings})
    return {"requests": requests, "metric": metric}


def _ranked(e, req: dict, k: int):
    expr = ",".join(sorted({r["_index"] for r in req["ratings"]})) or "_all"
    return e.search_multi(expr, query=req["request"].get("query"),
                          size=int(req["request"].get("size", k)), from_=0)


@pytest.mark.parametrize("tiered", [False, True], ids=["fresh", "tiered"])
@pytest.mark.parametrize("shards", [1, 3])
def test_every_metric_matches_reference(shards, tiered):
    two = Two(shards, tiered, seed=shards + 10 * tiered)
    try:
        rng = np.random.default_rng(shards * 3 + tiered)
        equal_lists = 0
        for name, metric in METRICS.items():
            body = _rank_eval_body(rng, 6, metric)
            k = int(next(iter(metric.values())).get("k", 10))
            got = rankeval.rank_eval(two.port, body)
            want = ref_rankeval.rank_eval(two.ref, body)
            assert got["failures"] == want["failures"] == {}
            for req in body["requests"]:
                tie = max(impact_tie(two.port.get_index(n), req["request"]["query"])
                          for n in "ab") if tiered else 0.0
                g, w = _ranked(two.port, req, k), _ranked(two.ref, req, k)
                same_hits(g, w, f"{name} {req['id']}", tie)
                if [(h["_index"], h["_id"]) for h in g["hits"]["hits"]] == \
                        [(h["_index"], h["_id"]) for h in w["hits"]["hits"]]:
                    equal_lists += 1
                    gd, wd = got["details"][req["id"]], want["details"][req["id"]]
                    assert close(gd["metric_score"], wd["metric_score"], 1e-12), name
                    assert gd["hits"] == wd["hits"] and gd["unrated_docs"] == wd["unrated_docs"]
            if all(got["details"][r]["hits"] == want["details"][r]["hits"] for r in got["details"]):
                assert close(got["metric_score"], want["metric_score"], 1e-12), name
        assert equal_lists >= 0.8 * 6 * len(METRICS)
    finally:
        two.close()


@pytest.mark.parametrize("tiered", [False, True], ids=["fresh", "tiered"])
@pytest.mark.parametrize("shards", [1, 3])
def test_rrf_retriever_matches_reference(shards, tiered):
    two = Two(shards, tiered, seed=40 + shards + 10 * tiered)
    try:
        rng = np.random.default_rng(shards + tiered)
        for j in range(8):
            q = " ".join(f"w{int(x)}" for x in rng.integers(0, 25, 2))
            qv = [float(x) for x in rng.normal(size=4).round(3)]
            index = "a" if j % 2 else "b"
            retr = {"rrf": {"retrievers": [
                {"standard": {"query": {"match": {"body": q}}}},
                {"knn": {"field": "v", "query_vector": qv, "k": 10, "num_candidates": 40}}],
                "rank_constant": int(rng.choice([1, 20, 60])),
                "rank_window_size": int(rng.choice([5, 20, 100]))}}
            size, from_ = int(rng.integers(3, 12)), int(rng.integers(0, 4))
            got = rankeval.rrf_retriever_search(two.port, index, retr, size, from_)
            want = ref_rankeval.rrf_retriever_search(two.ref, index, retr, size, from_)
            assert got["hits"]["total"] == want["hits"]["total"]
            # the sub-retrievers' lists, held as searches are
            for sub in retr["rrf"]["retrievers"]:
                (kind, sb), = sub.items()
                w = int(retr["rrf"]["rank_window_size"])
                kw = {"query": sb["query"]} if kind == "standard" else {"knn": sb}
                tie = impact_tie(two.port.get_index(index), sb["query"]) \
                    if tiered and kind == "standard" else 0.0
                same_hits(two.port.search_multi(index, size=w, from_=0, **kw),
                          two.ref.search_multi(index, size=w, from_=0, **kw), f"rrf {kind}", tie)
            g = [(h["_index"], h["_id"], h["_score"]) for h in got["hits"]["hits"]]
            wl = [(h["_index"], h["_id"], h["_score"]) for h in want["hits"]["hits"]]
            if [x[:2] for x in g] == [x[:2] for x in wl]:
                assert all(close(a[2], b[2], 1e-12) for a, b in zip(g, wl))
                assert [h["_source"] for h in got["hits"]["hits"]] == \
                    [h["_source"] for h in want["hits"]["hits"]]
    finally:
        two.close()


ERRORS = {
    "no_requests": ("rank_eval", {"requests": []}),
    "no_id": ("rank_eval", {"requests": [{"request": {"query": {"match_all": {}}},
                                          "ratings": []}]}),
    "unknown_metric": ("rank_eval", {"requests": [{"id": "x", "request": {}, "ratings": [
        {"_index": "a", "_id": "d1", "rating": 1}]}], "metric": {"ndcg": {}}}),
    "unknown_retriever": ("rrf", {"linear": {}}),
    "rrf_one_retriever": ("rrf", {"rrf": {"retrievers": [{"standard": {}}]}}),
    "rrf_unknown_sub": ("rrf", {"rrf": {"retrievers": [{"standard": {}}, {"text": {}}]}}),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_reference(case):
    two = Two(1, False, seed=99)
    try:
        kind, body = ERRORS[case]

        def run(mod, e):
            try:
                if kind == "rank_eval":
                    return ("ok", mod.rank_eval(e, body)["metric_score"])
                return ("ok", len(mod.rrf_retriever_search(e, "a", body, 5, 0)["hits"]["hits"]))
            except (ElasticsearchTpuError, RefError) as ex:
                return ("error", ex.status, ex.type, ex.reason)

        got, want = run(rankeval, two.port), run(ref_rankeval, two.ref)
        assert got == want and got[0] == "error"
    finally:
        two.close()


def test_rest_rank_eval_searches_the_ratings_indices(tmp_path):
    """The path's index is not what the requests search: the ratings'
    indices are (`rest/app.py:1592-1596` of the reference)."""
    docs = text_docs(5, 40)
    nd = "".join(json.dumps({"index": {"_index": ix, "_id": i}}) + "\n" + json.dumps(d) + "\n"
                 for ix in ("a", "b") for i, d in docs)
    body = {"requests": [{"id": "q", "request": {"query": {"match": {"body": "w1 w2"}}},
                          "ratings": [{"_index": "b", "_id": "d3", "rating": 2},
                                      {"_index": "a", "_id": "d5", "rating": 1}]}],
            "metric": {"dcg": {"k": 10, "normalize": True}}}
    seq = [("put_a", "PUT", "/a", {"mappings": MAPPING}, {}),
           ("put_b", "PUT", "/b", {"mappings": MAPPING}, {}),
           ("bulk", "POST", "/_bulk", nd, {"refresh": "true"}),
           ("on_a", "POST", "/a/_rank_eval", body, {}),
           ("no_index", "POST", "/_rank_eval", body, {}),
           ("bad", "POST", "/_rank_eval", {"requests": []}, {}),
           ("rrf", "POST", "/a,b/_search", {"retriever": {"rrf": {"retrievers": [
               {"standard": {"query": {"match": {"body": "w1"}}}},
               {"standard": {"query": {"match": {"body": "w2"}}}}]}}, "size": 4}, {})]
    port, ref = rest_both(seq, tmp_path)
    assert {k: v[0] for k, v in port.items()} == {k: v[0] for k, v in ref.items()}
    assert port["on_a"] == port["no_index"]
    for name in ("on_a", "bad"):
        assert port[name] == ref[name], name
    assert [h["_id"] for h in port["rrf"][1]["hits"]["hits"]] == \
        [h["_id"] for h in ref["rrf"][1]["hits"]["hits"]]
