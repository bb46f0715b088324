"""The port's EsIndex against the JAX package's, on the same index and queries.

100 seeded queries of the traffic mix (`or` and `and` matches, bool with a
must match, a range filter and a must_not term) go through the reference
`EsIndex(..., data_dir=None).search` and through the port's
`EsIndex(device="cpu").search`. The port scores sparse terms from the
impact tier wherever its codes are resident, as the reference does on its
accelerator, so the reference runs with ES_TPU_IMPACT=force; its exact
BM25 path (ES_TPU_IMPACT=0) is the oracle of the port's `mark_exact` plans
and of the impact tier's error bound.

Tolerances: totals equal. Scores within 1e-6 relative: both sides run the
same f32 operations in the same order, except that XLA on the CPU may
contract a multiply-add into one FMA (about 1 ulp per term). Hit ids equal,
except where the two scores agree within 1e-5 relative — the reference's
own fp-tie contract (bench.py `_rank_ok`). Against exact BM25 the impact
rows hold the quantization tie class (`ops.batched.impact_tie_class`).
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
from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, make_corpus, traffic
from elasticsearch_tpu_torch.ops.batched import impact_tie_class
from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.query.executor import ShardSearcher
from elasticsearch_tpu_torch.query.nodes import BoolNode, TermNode, mark_exact
from elasticsearch_tpu_torch.utils.errors import QueryParsingError

REPO = Path(__file__).resolve().parent.parent
N_DOCS, VOCAB = 2000, 400


@pytest.fixture(autouse=True)
def _cold_planners():
    """Both packages' execution planners start each test cold."""
    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


def _with_impact(mode: str, fn):
    old = os.environ.get("ES_TPU_IMPACT")
    os.environ["ES_TPU_IMPACT"] = mode
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("ES_TPU_IMPACT", None)
        else:
            os.environ["ES_TPU_IMPACT"] = old


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(5)
    lens, tok, nums = make_corpus(rng, N_DOCS, vocab=VOCAB, mean_len=12)
    docs = corpus_docs(lens, tok, nums, vocab=VOCAB)
    queries = traffic(rng, lens, tok, 60, 20, 20)
    ref = RefEsIndex("corpus", RefMappings(MAPPINGS), {}, None)
    port = EsIndex("corpus", MAPPINGS, device="cpu")
    for i, d in enumerate(docs):
        ref.index_doc(str(i), d)
        port.index_doc(str(i), d)
    ref.refresh()
    port.refresh()
    # (size, from_) alternates between the two shapes of the traffic
    shapes = [(10, 0) if i % 2 == 0 else (20, 5) for i in range(len(queries))]

    def run():
        ref._invalidate_request_cache()  # an answer cached under the other mode
        return [ref.search(query=q, size=s, from_=f) for q, (s, f) in zip(queries, shapes)]

    ref_out = _with_impact("force", run)  # the reference's impact tier
    ref_exact = _with_impact("0", run)  # its exact BM25 path
    return port, queries, shapes, ref_out, ref, ref_exact


def _term_nodes(node) -> list[TermNode]:
    """Every term node of a plan tree."""
    if isinstance(node, TermNode):
        return [node]
    if isinstance(node, BoolNode):
        return [t for grp in (node.must, node.filter, node.should, node.must_not)
                for c in grp for t in _term_nodes(c)]
    return []


def test_search_matches_reference(indexes):
    port, queries, shapes, ref_out, *_ = indexes
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


def test_impact_search_holds_exact_bm25_within_the_tie_class(indexes):
    """The impact rows against the reference's exact BM25 rows: totals equal
    (codes >= 1 keep the match sets), each rank's score within the query's
    quantization tie class, ids swapped only within it; and the plans
    really took the impact tier."""
    port, queries, shapes, _, _, ref_exact = indexes
    pack = port.searcher.pack
    n_impact = 0
    worst = 0.0
    for q, (size, from_), want in zip(queries, shapes, ref_exact):
        node = parse_query(q, port.mappings)
        terms = [(n.term, n.boost) for n in _term_nodes(node) if n.fld == "body"]
        tol = impact_tie_class(pack, "body", terms)
        n_impact += sum(TermNode("body", t).prepare(pack)[0] == "impact" for t, _ in terms)
        got = port.search(query=q, size=size, from_=from_)["hits"]
        wh = want["hits"]
        assert got["total"] == wh["total"], q
        gs = np.array([h["_score"] for h in got["hits"]])
        ws = np.array([h["_score"] for h in wh["hits"]])
        assert gs.shape == ws.shape, q
        gap = np.abs(gs - ws)
        assert (gap <= tol + 1e-6 * np.abs(ws)).all(), (q, gap.max(), tol)
        worst = max(worst, float(gap.max(initial=0.0)))
        for g, w, d in zip(got["hits"], wh["hits"], gap):
            if g["_id"] != w["_id"]:
                assert d <= tol, q
    assert n_impact > 100
    assert worst > 0  # the impact tier's scores are quantized, not exact


def test_mark_exact_restores_exact_bm25(indexes):
    """mark_exact on the parsed plans: exact BM25 from the raw postings,
    equal to the reference's exact path as test_search_matches_reference
    holds the impact path."""
    port, queries, shapes, _, _, ref_exact = indexes
    searcher = port.searcher
    for q, (size, from_), want in zip(queries, shapes, ref_exact):
        node = mark_exact(parse_query(q, port.mappings))
        assert all(n.exact_scores for n in _term_nodes(node))
        got = searcher.search(node, size=size, from_=from_)
        wh = want["hits"]
        assert got.total == wh["total"]["value"], q
        ws = np.array([h["_score"] for h in wh["hits"]])
        np.testing.assert_allclose(got.scores, ws, rtol=1e-6, atol=0)
        for d, s, w in zip(got.doc_ids, ws, wh["hits"]):
            if str(int(d)) != w["_id"]:
                assert abs(s - w["_score"]) <= 1e-5 * max(abs(w["_score"]), 1.0), q


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
    monkeypatch.setenv("ES_TPU_IMPACT", "force")
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
        port.search(query={"span_near": {"clauses": [{"span_term": {"body": "t1"}}]}})


def test_entry_points_raise_without_card(indexes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EsIndex("x", MAPPINGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardSearcher(indexes[0].searcher.pack)


def test_port_imports_no_jax():
    """Importing the port and running a search, a geo_distance, a nested
    search, a percolate and a custom-analyzer (synonym) refresh and phrase
    on two shards, an analyze_burst and a
    device-routed build on CPU tensors, and a kNN search through
    the ANN index, a search, a phrase search and an msearch over three
    shards, writes, an
    incremental refresh and a tiered search and count on three shards and
    on one, a kNN search, a hybrid search, a tiered kNN search and an
    `exists` query on two shards, an aggregation search (terms, a
    date_histogram on a date field, a sum, a pipeline agg, a filter on a
    boolean field) and a sorted page by search_after on two shards, an
    ES|QL STATS and SORT | LIMIT (both exchanges), a SQL query, an EQL event
    query and an EQL sequence on two shards, requests through the REST
    app and its server module, a metered `_bulk`, a `function_score` search
    and a superpack wave, and a highlighted, profiled search with a
    completion suggest, a search over three indices with can_match, a
    templated search from a stored script, a `_rank_eval` and an `_explain`
    over REST, loads neither jax nor the JAX package nor aiohttp. The
    searches take the impact tier and the msearches are routed by the
    execution planner."""
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
        "from elasticsearch_tpu_torch.parallel import msearch_sharded\n"
        "from elasticsearch_tpu_torch.planner import execution_planner\n"
        "from elasticsearch_tpu_torch.query.nodes import TermNode\n"
        "seg, seg3 = one._tails[0].searcher, sh._tails[0].searcher\n"
        "assert TermNode('body', 'hello').prepare(seg._views[0])[0] == 'impact'\n"
        "assert TermNode('body', 'hello').prepare(seg3._views[0])[0] == 'impact'\n"
        "assert msearch_sharded(seg, 'body', [[('hello', 1.0)]], 2)[3][0] == 4\n"
        "assert msearch_sharded(seg3, 'body', [[('hello', 1.0)]], 2)[3][0] == 7\n"
        "assert execution_planner().stats()['decisions'] == {'impact': 2}\n"
        "out = idx.search({'match': {'body': 'hello'}})\n"
        "knn = idx.search(knn={'field': 'vec', 'query_vector': [1.0, 2.0], 'k': 3})\n"
        "v2 = EsIndex('v2', {'properties': {'body': {'type': 'text'}, 'vec': {"
        "'type': 'dense_vector', 'dims': 2, 'similarity': 'l2_norm',"
        " 'index_options': {'type': 'ivf', 'nlist': 2}}}},"
        " settings={'number_of_shards': 2}, device='cpu')\n"
        "for i in range(24):\n"
        "    v2.index_doc(f'v{i}', {'body': f'hi w{i % 3}', 'vec': [float(i % 3), i % 5 + 1.0]})\n"
        "v2.refresh()\n"
        "assert v2.searcher.sp.vectors['vec'].ann is not None\n"
        "kq = {'field': 'vec', 'query_vector': [1.0, 2.0], 'k': 3}\n"
        "assert len(v2.search(knn=kq)['hits']['hits']) == 3\n"
        "assert v2.search({'match': {'body': 'w1'}}, knn=kq)['hits']['total']['value'] >= 8\n"
        "v2.index_doc('n1', {'vec': [9.0, 9.0]})\n"
        "v2.refresh()\n"
        "tq = {'field': 'vec', 'query_vector': [9.0, 9.0], 'k': 2}\n"
        "assert v2.search(knn=tq)['hits']['hits'][0]['_id'] == 'n1' and len(v2._tails) == 1\n"
        "assert v2.search({'exists': {'field': 'body'}})['hits']['total']['value'] == 24\n"
        "ag = EsIndex('ag', {'properties': {'st': {'type': 'keyword'}, 'ts': {'type': 'date'},"
        " 'sz': {'type': 'long'}, 'ok': {'type': 'boolean'}}}, settings={'number_of_shards': 2},"
        " device='cpu')\n"
        "for i in range(30):\n"
        "    ag.index_doc(f'a{i}', {'st': str(i % 3), 'ts': f'2015-01-{i % 28 + 1:02d}',"
        " 'sz': i, 'ok': i % 2 == 0})\n"
        "ag.refresh()\n"
        "aq = {'t': {'terms': {'field': 'st'}, 'aggs': {'h': {'date_histogram': {"
        "'field': 'ts', 'calendar_interval': 'week'}}, 's': {'sum': {'field': 'sz'}}}},"
        " 'x': {'max_bucket': {'buckets_path': 't>s'}}}\n"
        "ar = ag.search({'term': {'ok': True}}, size=0, aggs=aq)['aggregations']\n"
        "assert ar['x']['value'] == 80.0 and len(ar['t']['buckets']) == 3\n"
        "ph = sh.search({'match_phrase': {'body': 'hello w3'}})['hits']\n"
        "assert [h['_id'] for h in ph['hits']] == ['d3']\n"
        "so = ag.search({'match_all': {}}, sort=[{'sz': 'desc'}], size=2,"
        " search_after=[20])['hits']['hits']\n"
        "assert [h['sort'] for h in so] == [[19], [18]]\n"
        "from elasticsearch_tpu_torch import Engine\n"
        "from elasticsearch_tpu_torch.esql import esql_query\n"
        "from elasticsearch_tpu_torch.esql.eql import eql_search\n"
        "from elasticsearch_tpu_torch.esql.sql import sql_query\n"
        "en = Engine(device='cpu')\n"
        "lg = en.create_index('lg', {'properties': {'st': {'type': 'keyword'}, '@timestamp': {"
        "'type': 'date'}, 'sz': {'type': 'long'}}}, {'number_of_shards': 2})\n"
        "for i in range(20):\n"
        "    lg.index_doc(f'l{i}', {'st': str(i % 3), '@timestamp': 1000 * i, 'sz': i})\n"
        "lg.refresh()\n"
        "eq = esql_query(en, {'query': 'FROM lg | STATS c = COUNT(*), s = SUM(sz) BY st"
        " | SORT st', 'profile': True})\n"
        "assert eq['values'][0] == [7, 63, '0'] and 'stats_exchange' in json.dumps(eq)\n"
        "tn = esql_query(en, {'query': 'FROM lg | SORT sz DESC | LIMIT 2 | KEEP sz',"
        " 'profile': True})\n"
        "assert tn['values'] == [[19], [18]] and 'topn_exchange' in json.dumps(tn)\n"
        "assert sql_query(en, {'query': 'SELECT st, COUNT(*) FROM lg GROUP BY st ORDER BY st'})"
        "['rows'][1] == ['1', 7]\n"
        "assert eql_search(en, 'lg', {'query': 'any where sz > 15'})['hits']['total']"
        "['value'] == 4\n"
        "assert eql_search(en, 'lg', {'query': 'sequence by st [any where sz == 1]"
        " [any where sz == 4]'})['hits']['total']['value'] == 1\n"
        "en.close()\n"
        "from elasticsearch_tpu_torch.rest import make_app, server\n"
        "app = make_app(device='cpu')\n"
        "assert app.handle('PUT', '/r', {}, {}, b'{}')[0] == 200\n"
        "assert app.handle('POST', '/_msearch', {}, {}, b'{\"index\": \"r\"}\\n{}\\n')[0] == 200\n"
        "app.close()\n"
        "app = make_app(device='cpu')\n"
        "nd = b'{\"index\": {\"_index\": \"tb\", \"_id\": \"1\"}}\\n{\"n\": 3}\\n'\n"
        "assert app.handle('POST', '/_bulk', {'refresh': 'true'}, {'X-Opaque-Id': 'w1'}, nd)[0]"
        " == 200\n"
        "assert app.engine.metering.rows()['w1']['ingest_docs'] == 1\n"
        "fq = {'function_score': {'query': {'match_all': {}}, 'functions': ["
        "{'field_value_factor': {'field': 'n'}}, {'random_score': {'seed': 1}}]}}\n"
        "assert app.engine.get_index('tb').search(fq)['hits']['total']['value'] == 1\n"
        "app.close()\n"
        "sp = Engine(device='cpu')\n"
        "sp.settings.update({'persistent': {'superpack.enabled': True}})\n"
        "for t in range(3):\n"
        "    ti = sp.create_index(f't{t}', {'properties': {'body': {'type': 'text'}}})\n"
        "    ti.index_doc('1', {'body': f'hello w{t}'})\n"
        "    ti.refresh()\n"
        "    assert sp.superpacks.adopt(ti)\n"
        "ents = [{'index': f't{t}', 'kwargs': {'query': {'match': {'body': 'hello'}}}}"
        " for t in range(3)]\n"
        "assert all(sp.superpacks.wave_claim(e) for e in ents)\n"
        "job = sp.superpacks.search_wave_begin(ents)\n"
        "sp.superpacks.search_wave_fetch(job)\n"
        "assert [r['hits']['total']['value'] for r in sp.superpacks.search_wave_finish(job)]"
        " == [1, 1, 1]\n"
        "sp.close()\n"
        "from elasticsearch_tpu_torch.analysis.batched import BatchedAnalyzer, analyze_burst\n"
        "from elasticsearch_tpu_torch.analysis import StandardAnalyzer\n"
        "from elasticsearch_tpu_torch.index import device_build as db\n"
        "br = analyze_burst(BatchedAnalyzer(StandardAnalyzer()), ['a b', 'c'], [0, 1], 2,"
        " mode='device', device='cpu')\n"
        "assert list(br.term_strings()) == ['a', 'b', 'c']\n"
        "db.DEVICE_BUILD_MIN = db.ANALYZE_DEVICE_MIN = 0\n"
        "db.use_device_build = lambda e, d, floor=None: d is not None\n"
        "dv = EsIndex('dv', {'properties': {'body': {'type': 'text'}}}, device='cpu')\n"
        "for i in range(300):\n"
        "    dv.index_doc(f'd{i}', {'body': f'hello w{i % 7}'})\n"
        "dv.refresh()\n"
        "assert dv.search({'match': {'body': 'w3'}})['hits']['total']['value'] == 43\n"
        "gm = {'properties': {'loc': {'type': 'geo_point'}, 'q': {'type': 'percolator'},"
        " 'm': {'type': 'text'}, 'a': {'type': 'nested', 'properties': {'u': {'type': 'keyword'}}},"
        " 'e': {'type': 'text', 'analyzer': 'syn'}}}\n"
        "gs = {'number_of_shards': 2, 'analysis': {'filter': {'s': {'type': 'synonym_graph',"
        " 'synonyms': ['fast, quick']}}, 'analyzer': {'syn': {'tokenizer': 'standard',"
        " 'filter': ['lowercase', 's']}}}}\n"
        "gx = EsIndex('gx', gm, settings=gs, device='cpu')\n"
        "for i in range(12):\n"
        "    gx.index_doc(f'g{i}', {'loc': {'lat': i, 'lon': -i}, 'q': {'match': {'m': f'w{i}'}},"
        " 'a': [{'u': f'u{i % 3}'}], 'e': 'fast car' if i % 2 else 'slow car'})\n"
        "gx.refresh()\n"
        "assert gx.search({'geo_distance': {'distance': '200km', 'loc': '0,0'}})"
        "['hits']['total']['value'] == 2\n"
        "assert gx.search({'nested': {'path': 'a', 'query': {'term': {'a.u': 'u1'}}}})"
        "['hits']['total']['value'] == 4\n"
        "assert sorted(h['_id'] for h in gx.search({'percolate': {'field': 'q',"
        " 'document': {'m': 'w5 w7'}}})['hits']['hits']) == ['g5', 'g7']\n"
        "assert gx.search({'match_phrase': {'e': 'quick car'}})['hits']['total']['value'] == 6\n"
        "app = make_app(device='cpu')\n"
        "cm = {'mappings': {'properties': {'body': {'type': 'text'}, 'sg': {'type': 'completion'}}}}\n"
        "assert app.handle('PUT', '/hs', {}, {}, json.dumps(cm).encode())[0] == 200\n"
        "nd = b'{\"index\": {\"_id\": \"1\"}}\\n{\"body\": \"quick fox\", \"sg\": \"quick\"}\\n'\n"
        "assert app.handle('POST', '/hs/_bulk', {'refresh': 'true'}, {}, nd)[0] == 200\n"
        "hb = {'query': {'match': {'body': 'fox'}}, 'highlight': {'fields': {'body': {}}},"
        " 'suggest': {'c': {'prefix': 'qu', 'completion': {'field': 'sg'}}}, 'profile': True}\n"
        "hr = json.loads(app.handle('POST', '/hs/_search', {}, {}, json.dumps(hb).encode())[2])\n"
        "assert hr['hits']['hits'][0]['highlight'] == {'body': ['quick <em>fox</em>']}\n"
        "assert hr['suggest']['c'][0]['options'][0]['_id'] == '1'\n"
        "assert hr['profile']['shards'][0]['device']['kernels'][0]['name'] == 'scan_topk'\n"
        "mi = {'mappings': {'properties': {'body': {'type': 'text'}, 'n': {'type': 'long'}}}}\n"
        "for k in range(3):\n"
        "    assert app.handle('PUT', f'/lg{k}', {}, {}, json.dumps(mi).encode())[0] == 200\n"
        "    nd = json.dumps({'index': {'_id': f'{k}'}}) + '\\n' + json.dumps({'body': 'fox',"
        " 'n': k}) + '\\n'\n"
        "    assert app.handle('POST', f'/lg{k}/_bulk', {'refresh': 'true'}, {}, nd.encode())[0]"
        " == 200\n"
        "mb = {'query': {'bool': {'must': [{'match': {'body': 'fox'}}], 'filter': [{'range':"
        " {'n': {'gte': 2}}}]}}}\n"
        "mr = json.loads(app.handle('POST', '/lg*/_search', {}, {}, json.dumps(mb).encode())[2])\n"
        "assert mr['_shards']['skipped'] == 2 and mr['hits']['hits'][0]['_id'] == '2'\n"
        "st = {'script': {'source': '{\"query\": {\"match\": {\"body\": \"{{q}}\"}}}'}}\n"
        "assert app.handle('PUT', '/_scripts/t', {}, {}, json.dumps(st).encode())[0] == 200\n"
        "tb = {'id': 't', 'params': {'q': 'fox'}}\n"
        "tr = json.loads(app.handle('POST', '/lg*/_search/template', {}, {},"
        " json.dumps(tb).encode())[2])\n"
        "assert tr['hits']['total']['value'] == 3\n"
        "rb = {'requests': [{'id': 'a', 'request': {'query': {'match': {'body': 'fox'}}},"
        " 'ratings': [{'_index': 'lg1', '_id': '1', 'rating': 1}]}],"
        " 'metric': {'recall': {'k': 3}}}\n"
        "assert json.loads(app.handle('POST', '/_rank_eval', {}, {}, json.dumps(rb).encode())[2])"
        "['metric_score'] == 1.0\n"
        "eb = {'query': {'match': {'body': 'fox'}}}\n"
        "assert json.loads(app.handle('POST', '/lg0/_explain/0', {}, {}, json.dumps(eb).encode())"
        "[2])['matched'] is True\n"
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
