"""The port's `EsIndex.msearch` against its own per-query `EsIndex.search`.

Term-disjunction bodies ride the batched impact and tiered arms, whose
scores are the impact tier's quantized BM25: each row is held to the
per-query exact `_search` in the quantization tie class of
tests/test_impact.py (every score within 2 * sum(boost * idf * ubf / QMAX)
over the query's impact-served terms + 1e-7, plus rtol 1e-6; a swapped id
only between scores that close). Totals are exact below 10,000 docs.
Other bodies take the per-query route, shown by a spy.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from elasticsearch_tpu_torch import EsIndex
from elasticsearch_tpu_torch.corpus import (
    MAPPINGS, corpus_docs, make_corpus, sample_queries, traffic)
from elasticsearch_tpu_torch.ops.scoring import bm25_idf

REPO = Path(__file__).resolve().parent.parent
N_DOCS, VOCAB = 2500, 400


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


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(23)
    lens, tok, nums = make_corpus(rng, N_DOCS, vocab=VOCAB, mean_len=12)
    idx = EsIndex("corpus", MAPPINGS, device="cpu")
    for i, d in enumerate(corpus_docs(lens, tok, nums, vocab=VOCAB)):
        idx.index_doc(str(i), d)
    idx.refresh()
    # a dense tier at this size needs df >= 64 (the default threshold)
    assert idx.searcher.pack.dense_dict
    matches = []
    for j, q in enumerate(sample_queries(rng, lens, tok, 60)):
        body = {"query": {"match": {"body": " ".join(t for t, _ in q)}}}
        matches.append({**body, "from": 5, "size": 20} if j % 2 else body)
    bools = [{"query": q} for q in traffic(rng, lens, tok, 0, 0, 6)]
    return idx, matches, bools


def _tie_bound(idx, query_text: str) -> float:
    pack = idx.searcher.pack
    doc_count = pack.field_stats["body"]["doc_count"]
    bound = 0.0
    for t in dict.fromkeys(query_text.split()):
        _, _, df = pack.term_blocks("body", t)
        if df > 0 and pack.dense_row_of("body", t) is None:
            ubf = float(pack.impact_ubf[pack.term_dict[("body", t)]])
            bound += bm25_idf(doc_count, df) * ubf / pack.impact_meta["qmax"]
    return 2 * bound + 1e-7


def test_msearch_matches_per_query_search(index):
    idx, matches, _ = index
    out = idx.msearch(matches)
    arms = idx.searcher.batched().last_stats["queries"]
    assert arms.get("impact", 0) > 0 and arms.get("tiered", 0) > 0
    n_hits = 0
    for body, got in zip(matches, out["responses"]):
        size, from_ = body.get("size", 10), body.get("from", 0)
        want = idx.search(body["query"], size=size, from_=from_)["hits"]
        gh = got["hits"]
        assert gh["total"] == want["total"]
        tol = _tie_bound(idx, body["query"]["match"]["body"])
        gs = np.array([h["_score"] for h in gh["hits"]])
        ws = np.array([h["_score"] for h in want["hits"]])
        assert gs.shape == ws.shape
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=tol)
        for g, w in zip(gh["hits"], want["hits"]):
            if g["_id"] != w["_id"]:
                assert abs(g["_score"] - w["_score"]) <= tol
            assert g["_source"] == idx._hits_src[int(g["_id"])][1]
        if want["max_score"] is None:
            assert gh["max_score"] is None
        else:
            assert gh["max_score"] == pytest.approx(want["max_score"], rel=1e-6, abs=tol)
        n_hits += len(gh["hits"])
    assert n_hits > 300


def test_msearch_response_shape_and_status(index):
    idx, matches, bools = index
    aggs = {"query": {"match_all": {}}, "size": 0, "aggs": {"n": {"stats": {"field": "n"}}}}
    bad = [{"query": {"span_near": {"clauses": [{"span_term": {"body": "t1"}}]}}},
           {"query": {"match_all": {}}, "suggest": {"x": {"text": "t1"}}},
           {"query": {"match": {"body": "t1"}}, "size": "ten"}]
    out = idx.msearch(matches[:3] + bools[:2] + [aggs] + bad)
    assert set(out) == {"took", "responses"} and out["took"] == 0
    resp = out["responses"]
    assert len(resp) == 9
    # a body with aggs answers as `search`, with its aggregations
    assert resp[5] == {**idx.search({"match_all": {}}, size=0, aggs=aggs["aggs"]), "status": 200}
    assert resp[5]["aggregations"]["n"]["count"] == len(idx._docs)
    resp = resp[:5] + resp[6:]
    for r in resp[:5]:
        assert r["status"] == 200 and set(r) == {"hits", "status"}
        assert set(r["hits"]) == {"total", "max_score", "hits"}
        assert r["hits"]["total"]["relation"] == "eq"
        for h in r["hits"]["hits"]:
            assert set(h) == {"_index", "_id", "_score", "_source"}
    assert resp[5]["status"] == 400
    assert resp[5]["error"]["type"] == "parsing_exception"
    assert "not yet ported" in resp[5]["error"]["reason"]
    for r in resp[6:]:
        assert r["status"] == 400
        assert r["error"]["type"] == "illegal_argument_exception"
    assert idx.msearch([]) == {"took": 0, "responses": []}


def test_non_disjunction_bodies_take_the_per_query_route(index, monkeypatch):
    """Bool bodies with a filter, and a match that analyzes to nothing, go
    through EsIndex.search; match bodies through ShardSearcher.msearch,
    one call per (field, k) group."""
    idx, matches, bools = index
    searcher = idx.searcher
    per_query, batched = [], []
    search, msearch = idx.search, searcher.msearch
    monkeypatch.setattr(idx, "search", lambda *a, **kw: per_query.append(a) or search(*a, **kw))
    monkeypatch.setattr(searcher, "msearch",
                        lambda fld, qs, k=10, **kw: batched.append((fld, len(qs), k))
                        or msearch(fld, qs, k, **kw))
    empty = {"query": {"match": {"body": "!!!"}}}
    out = idx.msearch(matches + bools + [empty])
    assert all(r["status"] == 200 for r in out["responses"])
    assert len(per_query) == len(bools) + 1
    assert sorted(batched) == [("body", 30, 10), ("body", 30, 25)]
    for body, r in zip(bools, out["responses"][len(matches):]):
        assert r == {**search(body["query"]), "status": 200}


def test_msearch_imports_no_jax():
    """An msearch through the port loads neither jax nor the JAX package."""
    code = (
        "import sys, json\n"
        "from elasticsearch_tpu_torch import EsIndex\n"
        "idx = EsIndex('x', {'properties': {'body': {'type': 'text'}}}, device='cpu')\n"
        "for i in range(300):\n"
        "    idx.index_doc(str(i), {'body': 'hello world' if i % 3 else 'hello there'})\n"
        "idx.refresh()\n"
        "out = idx.msearch([{'query': {'match': {'body': 'hello there'}}},\n"
        "                   {'query': {'match': {'body': 'world'}}, 'size': 3}])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'elasticsearch_tpu')\n"
        "print(json.dumps({'totals': [r['hits']['total']['value'] for r in out['responses']],"
        " 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"totals": [300, 200], "bad": []}
