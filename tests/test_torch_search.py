"""The port's EsIndex against the JAX package's, on the same index and queries.

100 seeded queries of the traffic mix (`or` and `and` matches, bool with a
must match, a range filter and a must_not term) go through the reference
`EsIndex(..., data_dir=None).search` on its exact BM25 path
(ES_TPU_IMPACT=0) and through the port's `EsIndex(device="cpu").search`.

Tolerances: totals equal. Scores within 1e-6 relative: both sides run the
same f32 operations in the same order, except that XLA on the CPU may
contract a multiply-add into one FMA (about 1 ulp per term). Hit ids equal,
except where the two scores agree within 1e-5 relative — the reference's
own fp-tie contract (bench.py `_rank_ok`).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from elasticsearch_tpu.engine.engine import EsIndex as RefEsIndex
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu_torch import EsIndex
from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, make_corpus, traffic
from elasticsearch_tpu_torch.query.executor import ShardSearcher
from elasticsearch_tpu_torch.utils.errors import QueryParsingError

REPO = Path(__file__).resolve().parent.parent
N_DOCS, VOCAB = 2000, 400


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(5)
    lens, tok, nums = make_corpus(rng, N_DOCS, vocab=VOCAB, mean_len=12)
    docs = corpus_docs(lens, tok, nums, vocab=VOCAB)
    queries = traffic(rng, lens, tok, 60, 20, 20)
    old = os.environ.get("ES_TPU_IMPACT")
    os.environ["ES_TPU_IMPACT"] = "0"  # the reference's exact BM25 path
    try:
        ref = RefEsIndex("corpus", RefMappings(MAPPINGS), {}, None)
        port = EsIndex("corpus", MAPPINGS, device="cpu")
        for i, d in enumerate(docs):
            ref.index_doc(str(i), d)
            port.index_doc(str(i), d)
        ref.refresh()
        port.refresh()
        # (size, from_) alternates between the two shapes of the traffic
        shapes = [(10, 0) if i % 2 == 0 else (20, 5) for i in range(len(queries))]
        ref_out = [ref.search(query=q, size=s, from_=f)
                   for q, (s, f) in zip(queries, shapes)]
    finally:
        if old is None:
            os.environ.pop("ES_TPU_IMPACT", None)
        else:
            os.environ["ES_TPU_IMPACT"] = old
    return port, queries, shapes, ref_out, ref


def test_search_matches_reference(indexes):
    port, queries, shapes, ref_out, _ = indexes
    assert len(queries) == 100
    n_hits = 0
    for q, (size, from_), want in zip(queries, shapes, ref_out):
        got = port.search(query=q, size=size, from_=from_)
        gh, wh = got["hits"], want["hits"]
        assert gh["total"] == wh["total"], q
        assert len(gh["hits"]) == len(wh["hits"]), q
        gs = np.array([h["_score"] for h in gh["hits"]])
        ws = np.array([h["_score"] for h in wh["hits"]])
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
        for g, w in zip(gh["hits"], wh["hits"]):
            if g["_id"] != w["_id"]:
                assert abs(g["_score"] - w["_score"]) <= 1e-5 * max(abs(w["_score"]), 1.0), q
            assert g["_source"] == port._hits_src[int(g["_id"])][1]
        if wh["max_score"] is None:
            assert gh["max_score"] is None
        else:
            assert gh["max_score"] == pytest.approx(wh["max_score"], rel=1e-6)
        n_hits += len(gh["hits"])
    assert n_hits > 500  # the mix really returns hits


def test_response_shape(indexes):
    port, queries = indexes[:2]
    out = port.search(query=queries[0], size=3)
    assert set(out) == {"hits"}
    hits = out["hits"]
    assert set(hits) == {"total", "max_score", "hits"}
    assert hits["total"]["relation"] == "eq" and isinstance(hits["total"]["value"], int)
    assert len(hits["hits"]) == 3
    for h in hits["hits"]:
        assert set(h) == {"_index", "_id", "_score", "_source"}
        assert h["_index"] == "corpus" and isinstance(h["_score"], float)
    assert hits["max_score"] == hits["hits"][0]["_score"]
    empty = port.search(query={"match_none": {}})
    assert empty == {"hits": {"total": {"value": 0, "relation": "eq"},
                              "max_score": None, "hits": []}}


OTHER_QUERIES = {
    "match_all": {"match_all": {"boost": 2.0}},
    "term_id": {"term": {"_id": "17"}},
    "terms_id": {"terms": {"_id": ["3", "999", "nope"]}},
    "term_long": {"term": {"n": 5}},
    "terms_long": {"terms": {"n": [1, 2, 3, 4, 5, 6, 7]}},
    "match_long": {"match": {"n": "12"}},
    "range_gt_lte": {"range": {"n": {"gt": 1000, "lte": 250_000, "boost": 3.0}}},
    "range_open": {"range": {"n": {"lt": 5000}}},
    "constant_score": {"constant_score": {"filter": {"match": {"body": "t1 t2"}},
                                          "boost": 1.5}},
    "terms_text": {"terms": {"body": ["t3", "t40"]}},
    "msm": {"match": {"body": {"query": "t0 t1 t2 t5", "minimum_should_match": 2}}},
    "bool_should_filter": {"bool": {"should": [{"term": {"body": "t7"}},
                                               {"term": {"body": {"value": "t9", "boost": 2}}}],
                                    "filter": {"range": {"n": {"gte": 100_000}}}}},
    "bool_msm": {"bool": {"should": [{"term": {"body": "t4"}}, {"term": {"body": "t8"}},
                                     {"term": {"body": "t20"}}],
                          "minimum_should_match": 2, "boost": 0.5}},
    "must_not_only": {"bool": {"must_not": {"term": {"body": "t0"}}}},
    "match_none": {"match_none": {}},
    "unknown_term": {"match": {"body": "zzz"}},
}


@pytest.mark.parametrize("name", sorted(OTHER_QUERIES))
def test_other_query_kinds_match_reference(indexes, monkeypatch, name):
    port, ref = indexes[0], indexes[4]
    monkeypatch.setenv("ES_TPU_IMPACT", "0")
    q = OTHER_QUERIES[name]
    want = ref.search(query=q, size=10)["hits"]
    got = port.search(query=q, size=10)["hits"]
    assert got["total"] == want["total"]
    assert [h["_id"] for h in got["hits"]] == [h["_id"] for h in want["hits"]]
    np.testing.assert_allclose([h["_score"] for h in got["hits"]],
                               [h["_score"] for h in want["hits"]], rtol=1e-6, atol=0)


def test_unported_query_raises(indexes):
    port = indexes[0]
    with pytest.raises(QueryParsingError, match="not yet ported"):
        port.search(query={"match_phrase": {"body": "t1 t2"}})


def test_entry_points_raise_without_card(indexes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EsIndex("x", MAPPINGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardSearcher(indexes[0].searcher.pack)


def test_port_imports_no_jax():
    """Importing the port and running a search, and a kNN search through
    the ANN index, a search and an msearch over three shards, writes, an
    incremental refresh and a tiered search and count on three shards and
    on one, and requests through the REST app and its server module, loads
    neither jax nor the JAX package nor aiohttp."""
    code = (
        "import sys, json\n"
        "from elasticsearch_tpu_torch import EsIndex\n"
        "import elasticsearch_tpu_torch.ops.fused\n"
        "import elasticsearch_tpu_torch.cluster, elasticsearch_tpu_torch.parallel\n"
        "import elasticsearch_tpu_torch.convert\n"
        "sh = EsIndex('s', {'properties': {'body': {'type': 'text'}}},"
        " settings={'number_of_shards': 3}, device='cpu')\n"
        "for i in range(9):\n"
        "    sh.index_doc(f'd{i}', {'body': f'hello w{i}'})\n"
        "sh.refresh()\n"
        "assert sh.search({'match': {'body': 'hello'}})['hits']['total']['value'] == 9\n"
        "assert sh.msearch([{'query': {'match': {'body': 'w3'}}}])['responses'][0]"
        "['hits']['hits'][0]['_id'] == 'd3'\n"
        "sh.index_doc('d0', {'body': 'hello again'})\n"
        "sh.delete_doc('d1')\n"
        "sh.index_doc('n1', {'body': 'new hello'})\n"
        "sh.refresh()\n"
        "assert sh.last_refresh_kind == 'incremental' and len(sh._tails) == 2\n"
        "assert sh.search({'match': {'body': 'hello'}})['hits']['total']['value'] == 9\n"
        "one = EsIndex('o', {'properties': {'body': {'type': 'text'}}}, device='cpu')\n"
        "for i in range(5):\n"
        "    one.index_doc(f'd{i}', {'body': f'hello w{i}'})\n"
        "one.refresh()\n"
        "one.index_doc('d2', {'body': 'bye'})\n"
        "one.refresh()\n"
        "assert len(one._tails) == 2 and one.count({'match': {'body': 'hello'}}) == 4\n"
        "idx = EsIndex('x', {'properties': {'body': {'type': 'text'}, 'vec': {"
        "'type': 'dense_vector', 'dims': 2, 'index_options': {'type': 'ivf', 'nlist': 2}}}},"
        " device='cpu')\n"
        "idx.index_doc('1', {'body': 'hello world'})\n"
        "for i in range(12):\n"
        "    idx.index_doc(f'v{i}', {'vec': [float(i % 3), float(i % 5) + 1.0]})\n"
        "idx.refresh()\n"
        "assert idx.searcher.pack.vectors['vec'].ann is not None\n"
        "out = idx.search({'match': {'body': 'hello'}})\n"
        "knn = idx.search(knn={'field': 'vec', 'query_vector': [1.0, 2.0], 'k': 3})\n"
        "from elasticsearch_tpu_torch.rest import make_app, server\n"
        "app = make_app(device='cpu')\n"
        "assert app.handle('PUT', '/r', {}, {}, b'{}')[0] == 200\n"
        "assert app.handle('POST', '/_msearch', {}, {}, b'{\"index\": \"r\"}\\n{}\\n')[0] == 200\n"
        "app.close()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] in ('elasticsearch_tpu', 'aiohttp'))\n"
        "print(json.dumps({'total': out['hits']['total']['value'],"
        " 'knn': len(knn['hits']['hits']), 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"total": 1, "knn": 3, "bad": []}
