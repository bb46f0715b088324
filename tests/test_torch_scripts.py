"""Scripted search of the port: `script_score`, `function_score` (every function
kind, score_mode and boost_mode), the `script` filter, `script_fields`,
`runtime_mappings` and the scripted `_update`, against the JAX package on
the same numpy-seeded docs, on 1 and 2 shards.

Mirrors tests/test_script.py and the runtime-field cases of
tests/test_runtime_querystring.py. Tolerances (`torch_parity.same_hits`):
totals equal, scores within 1e-6 relative, ids equal but for fp-ties
(1e-5 relative). The reference side scores sparse terms from its impact
tier (`ES_TPU_IMPACT=force`) as the port does; the scripted queries mark
their inner query exact on both sides.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from elasticsearch_tpu.query import script_nodes as ref_script_nodes
from elasticsearch_tpu_torch.query.script_nodes import random_score_values
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.script.expression import ScriptError, compile_script
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
from torch_parity import MAPPING, Pair, close, same_hits, text_docs

DATE_MAPPING = {"properties": {**MAPPING["properties"], "ts": {"type": "date"}}}


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


def _docs(seed, n=120):
    docs = text_docs(seed, n)
    rng = np.random.default_rng(seed + 1)
    for i, (_id, src) in enumerate(docs):
        if i % 4:
            day, hour = int(rng.integers(1, 29)), int(rng.integers(0, 24))
            src["ts"] = f"2024-01-{day:02d}T{hour:02d}:00:00Z"
    return docs


@pytest.fixture(params=[1, 2], ids=["1shard", "2shards"], scope="module")
def pair(request):
    p = Pair(DATE_MAPPING, {"number_of_shards": request.param})
    p.index(_docs(request.param))
    p.refresh()
    yield p
    p.close()


# ---------------------------------------------------------------------------
# the expression language on tensors
# ---------------------------------------------------------------------------

def test_compile_and_eval_on_tensors_and_arrays():
    import torch

    s = compile_script({"source": "x > 2 ? Math.log(x) : sqrt(min(x, 1)) + params.a % 2",
                        "params": {"a": 3}})
    x = np.array([1.0, 4.0, 0.5, 9.0], np.float32)
    host = np.asarray(s.evaluate({"x": x}))
    dev = s.evaluate({"x": torch.from_numpy(x)})
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    np.testing.assert_allclose(dev.numpy(), host, rtol=1e-6)
    assert s.fields == {"x"}
    with pytest.raises(ScriptError):
        compile_script("x +")
    with pytest.raises(ScriptError):
        compile_script("params.missing + 1")
    with pytest.raises(ScriptError):
        compile_script({"source": "unknownfn(1, 2, 3)"}).evaluate({"x": torch.ones(2)})


@pytest.mark.parametrize("seed", [0, 42, 7919, -3, 2 ** 40 + 5])
def test_random_score_values_equal_reference_bits(seed):
    n = 5000
    got = random_score_values(n, seed, "cpu").numpy()
    fn = ref_script_nodes.ScoreFunction("random_score", seed=seed)
    want = np.asarray(fn.value({}, SimpleNamespace(num_docs=n), None))
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()
    assert got.min() >= 0.0 and got.max() < 1.0 and len(np.unique(got)) > n * 0.99


# ---------------------------------------------------------------------------
# scripted queries against the reference
# ---------------------------------------------------------------------------

SCRIPTED = {
    "script_score_field": {"script_score": {"query": {"match_all": {}},
                                            "script": {"source": "doc['p'].value + 3"}}},
    "script_score_inner": {"script_score": {"query": {"match": {"body": "w1 w3"}},
                                            "script": "_score * 2 + doc['n'].value / 10",
                                            "boost": 1.5}},
    "script_score_min": {"script_score": {"query": {"match": {"body": "w2"}},
                                          "script": {"source": "_score * params.f",
                                                     "params": {"f": 0.5}},
                                          "min_score": 0.3}},
    "script_filter": {"bool": {"must": [{"match": {"body": "w1"}}],
                               "filter": [{"script": {"script": "doc['n'].value >= 20"}}]}},
    "script_filter_alone": {"script": {"script": {"source": "doc.n.value % 3 == 1"}}},
}


def _fs(functions, **kw):
    return {"function_score": {"query": {"match": {"body": "w1 w4"}}, "functions": functions,
                               **kw}}


FUNCTIONS = {
    "weight_filter": [{"filter": {"term": {"tag": "k03"}}, "weight": 5.0},
                      {"filter": {"range": {"n": {"gte": 25}}}, "weight": 7.0}],
    "random": [{"random_score": {"seed": 42}}],
    "script": [{"script_score": {"script": "_score + doc['n'].value"}, "weight": 0.5}],
    "gauss": [{"gauss": {"n": {"origin": 20, "scale": 10, "decay": 0.5}}}],
    "exp": [{"exp": {"p": {"origin": 0.0, "scale": 2.0, "offset": 0.5, "decay": 0.3}}}],
    "linear": [{"linear": {"n": {"origin": 10, "scale": 30}}}],
    "date_gauss": [{"gauss": {"ts": {"origin": "2024-01-10", "scale": "2d", "offset": "1d"}}}],
    "date_exp": [{"exp": {"ts": {"origin": "2024-01-20T00:00:00Z", "scale": "5d"}}}],
    "mixed": [{"field_value_factor": {"field": "n", "factor": 0.1, "modifier": "ln2p"}},
              {"gauss": {"n": {"origin": 20, "scale": 10}}},
              {"filter": {"term": {"tag": "k01"}}, "weight": 3.0},
              {"filter": {"match": {"body": "w2"}}, "random_score": {"seed": 3}}],
}
MODIFIERS = ["none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p", "square", "sqrt",
             "reciprocal"]


@pytest.mark.parametrize("kind", sorted(SCRIPTED))
def test_scripted_query_matches_reference(pair, kind):
    pair.check(kind, query=SCRIPTED[kind], size=20)


@pytest.mark.parametrize("fname", sorted(FUNCTIONS))
def test_function_kinds_match_reference(pair, fname):
    pair.check(fname, query=_fs(FUNCTIONS[fname]), size=20)


@pytest.mark.parametrize("modifier", MODIFIERS)
def test_field_value_factor_modifiers_match_reference(pair, modifier):
    fvf = {"field_value_factor": {"field": "n", "factor": 1.5, "modifier": modifier}}
    pair.check(modifier, query=_fs([fvf], boost_mode="replace"), size=20)
    pair.check(modifier + " missing",
               query=_fs([{"field_value_factor": {"field": "p", "modifier": modifier,
                                                  "missing": 2.0}}]), size=20)


@pytest.mark.parametrize("score_mode", ["multiply", "sum", "avg", "max", "min", "first"])
@pytest.mark.parametrize("boost_mode", ["multiply", "replace", "sum", "avg", "max", "min"])
def test_score_and_boost_modes_match_reference(pair, score_mode, boost_mode):
    pair.check(f"{score_mode}/{boost_mode}",
               query=_fs(FUNCTIONS["mixed"], score_mode=score_mode, boost_mode=boost_mode),
               size=15)


def test_function_score_shorthand_caps_and_cuts(pair):
    pair.check("shorthand", query={"function_score": {
        "query": {"match": {"body": "w1"}},
        "field_value_factor": {"field": "n", "modifier": "sqrt"}, "boost": 2.0}}, size=20)
    pair.check("no functions", query={"function_score": {"query": {"match": {"body": "w5"}}}},
               size=10)
    pair.check("max_boost min_score", query={"function_score": {
        "query": {"match_all": {}}, "functions": [{"field_value_factor": {"field": "n"}}],
        "boost_mode": "replace", "max_boost": 30.0, "min_score": 9.0}}, size=50)
    pair.check("weight only", query={"function_score": {"weight": 2.5}}, size=5)


def test_scripted_queries_with_aggs_and_sort(pair):
    pair.check("aggs", query=SCRIPTED["script_filter_alone"], size=5,
               aggs={"t": {"terms": {"field": "tag"}}, "s": {"sum": {"field": "n"}}})
    pair.check("sorted", query=_fs(FUNCTIONS["gauss"]), size=10, sort=[{"n": "desc"}])


# ---------------------------------------------------------------------------
# script_fields and runtime_mappings
# ---------------------------------------------------------------------------

def test_script_fields_match_reference(pair):
    sf = {"double_n": {"script": {"source": "doc['n'].value * params.f", "params": {"f": 2}}},
          "p_plus": {"script": "doc['p'].value + 1"}}
    got, want = pair.search(query={"match": {"body": "w3"}}, size=10, script_fields=sf)
    same_hits(got, want, "script_fields")
    assert got["hits"]["hits"] and all(set(h["fields"]) == set(sf) for h in got["hits"]["hits"])
    got, want = pair.search(query={"match": {"body": "w3"}}, size=10,
                            script_fields={"s": {"script": "_score * 10"}})
    for g, w in zip(got["hits"]["hits"], want["hits"]["hits"]):
        if g["_id"] == w["_id"]:
            assert close(g["fields"]["s"][0], w["fields"]["s"][0], 1e-6)
    pair.check("sorted script_fields", query={"match_all": {}}, size=5, sort=[{"n": "asc"}],
               script_fields={"neg": {"script": "0 - doc['n'].value"}})


RUNTIME = {
    "total": {"type": "double", "script": {"source": "emit(doc['p'].value * doc['n'].value)"}},
    "bucket": {"type": "long", "script": {"source": "emit(doc['n'].value % params.m)",
                                          "params": {"m": 7}}},
    "flag": {"type": "boolean", "script": "emit(doc['n'].value > 25 ? 1 : 0)"},
}


def test_runtime_fields_in_query_aggs_and_sort(pair):
    pair.check("range", query={"range": {"total": {"gte": 10}}}, size=20, runtime_mappings=RUNTIME)
    pair.check("terms agg", query={"match": {"body": "w1"}}, size=5, runtime_mappings=RUNTIME,
               aggs={"b": {"terms": {"field": "bucket"}}, "m": {"max": {"field": "total"}},
                     "f": {"terms": {"field": "flag"}}})
    pair.check("sort", query={"match_all": {}}, size=15, runtime_mappings=RUNTIME,
               sort=[{"bucket": "desc"}, {"n": "asc"}])
    pair.check("in a script", query={"script_score": {
        "query": {"range": {"bucket": {"lte": 3}}}, "script": "doc['total'].value + 1"}},
        size=10, runtime_mappings=RUNTIME)
    pair.check("constant", query={"term": {"one": 1}}, size=5,
               runtime_mappings={"one": {"type": "long", "script": "emit(1)"}})


def test_runtime_field_shadow_and_bad_type_rejected(pair):
    for rm in ({"n": {"type": "long", "script": {"source": "emit(1)"}}},
               {"x": {"type": "keyword", "script": {"source": "emit(1)"}}},
               {"x": {"type": "long"}}):
        with pytest.raises(IllegalArgumentError):
            pair.port.search(runtime_mappings=rm)


def test_runtime_field_is_request_scoped(pair):
    rm = {"dbl": {"type": "double", "script": {"source": "emit(n * 2)"}}}
    got, want = pair.search(runtime_mappings=rm, aggs={"m": {"max": {"field": "dbl"}}}, size=0)
    assert got["aggregations"] == want["aggregations"]
    assert got["aggregations"]["m"]["value"] == 2 * max(
        src["n"] for _i, src in _docs(pair.port.num_shards))
    searcher = pair.port._searcher
    dv = searcher.pack.docvalues if pair.port.num_shards == 1 else searcher.sp.global_docvalues
    assert "dbl" not in dv
    mappings = searcher.mappings if pair.port.num_shards == 1 else searcher.sp.mappings
    assert "dbl" not in mappings.fields
    for f in (3, 5):  # a redefinition, and a params change, recompute
        rm2 = {"dbl": {"type": "double", "script": {"source": "emit(n * params.f)",
                                                     "params": {"f": f}}}}
        got, want = pair.search(runtime_mappings=rm2, aggs={"m": {"max": {"field": "dbl"}}},
                                size=0)
        assert got["aggregations"] == want["aggregations"]


# ---------------------------------------------------------------------------
# the scripted _update
# ---------------------------------------------------------------------------

UPDATES = [
    ("d1", {"script": {"source": "ctx._source.n += params.k", "params": {"k": 5}}}),
    ("d2", {"script": "ctx._source.tag = 'updated'; ctx._source.n *= 2"}),
    ("d3", {"script": "ctx._source.remove('tag'); ctx._source['p'] = 0.5"}),
    ("d4", {"script": "ctx.op = 'noop'"}),
    ("d5", {"script": "ctx._source.extra.deep = 3; ctx._source.flag = true"}),
    ("d6", {"script": "ctx.op = 'delete'"}),
    ("new1", {"script": "ctx._source.n = 7", "upsert": {"n": 1, "tag": "u"},
              "scripted_upsert": True}),
    ("new2", {"script": "ctx._source.n = 7", "upsert": {"n": 1}}),
    ("d7", {"script": "ctx._source.n = ctx._source.n / 4"}),
]


def test_scripted_update_matches_reference():
    pair = Pair(MAPPING)
    try:
        pair.index(text_docs(11, 20))
        pair.refresh()
        for doc_id, body in UPDATES:
            got = pair.port_engine.update_doc_api("idx", doc_id, json.loads(json.dumps(body)))
            want = pair.ref_engine.update_doc_api("idx", doc_id, json.loads(json.dumps(body)))
            assert got["result"] == want["result"], doc_id
            g, w = pair.port.get_doc(doc_id), pair.ref.get_doc(doc_id)
            assert (g is None) == (w is None), doc_id
            if g is not None:
                assert g["_source"] == w["_source"], doc_id
                assert g["_version"] == w["_version"], doc_id
        with pytest.raises(IllegalArgumentError):
            pair.port_engine.update_doc_api("idx", "d8", {"script": "while (true) {}"})
        pair.refresh()
        pair.check("after updates", query={"range": {"n": {"gte": 0}}}, size=30)
    finally:
        pair.close()


def test_scripted_update_over_rest():
    app = make_app(device="cpu")
    try:
        app.handle("PUT", "/s/_doc/1", {"refresh": "true"}, {}, b'{"n": 1}')
        status, _, raw = app.handle("POST", "/s/_update/1", {"refresh": "true"}, {},
                                    b'{"script": {"source": "ctx._source.n += 1"}}')
        assert status == 200 and json.loads(raw)["result"] == "updated"
        assert app.engine.get_index("s").get_doc("1")["_source"] == {"n": 2}
        status, _, raw = app.handle("POST", "/s/_search", {}, {},
                                    b'{"query": {"term": {"n": 2}}}')
        assert json.loads(raw)["hits"]["total"]["value"] == 1
    finally:
        app.close()
