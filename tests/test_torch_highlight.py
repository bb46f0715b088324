"""The port's fetch sub-phases (`search/fetch.py`: the stored_fields gate,
`fields`, `docvalue_fields`, `_source` filtering) and highlighter
(`search/highlight.py`) against the JAX package's.

The cases of the reference's tests/test_fetch_phase.py run through both
packages on the same inputs. Then seeded indices in both packages
(`torch_parity.Pair`): highlighted searches over punctuated, mixed-case
text with every option (fragment_size, number_of_fragments 0-3, order,
tags, highlight_query, require_field_match off, wildcard fields, the array
form), over fields with custom analyzers and synonym sets (char filters
and synonyms move offsets), `docvalue_fields` with formats, and the
stored_fields gate with its 400. Then the same over REST against the
reference's aiohttp app, URL parameters included, and a serving wave
against the solo path.

Tolerances: fragments, `fields`, `_source` and error envelopes `==`;
hits are matched by `_id` (the two packages' scores may differ by an ulp,
which can swap fp-ties).
"""

import copy
import json

import numpy as np
import pytest

from elasticsearch_tpu.engine import Engine as RefEngine
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.search import fetch as ref_fetch
from elasticsearch_tpu.search import highlight as ref_highlight
from elasticsearch_tpu.utils.errors import ElasticsearchTpuError as RefError
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.search import fetch, highlight
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuError
from torch_parity import Pair, rest_both


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()


PORT = {"fetch": fetch, "highlight": highlight, "Mappings": Mappings}
REF = {"fetch": ref_fetch, "highlight": ref_highlight, "Mappings": RefMappings}

# ---------------------------------------------------------------------------
# tests/test_fetch_phase.py's cases, through both packages
# ---------------------------------------------------------------------------

SRC = {"title": "quick brown fox",
       "meta": {"author": "jane", "year": 2024, "tags": ["a", "b"]},
       "stats": {"views": 10, "likes": 3},
       "date": "2024-03-05T12:00:00Z"}
FETCH_MAPPING = {"properties": {
    "title": {"type": "text"},
    "meta": {"properties": {"author": {"type": "keyword"}, "year": {"type": "long"},
                            "tags": {"type": "keyword"}}},
    "stats": {"properties": {"views": {"type": "long"}, "likes": {"type": "long"}}},
    "date": {"type": "date"}}}
LONG = {"title": ("alpha " * 30) + "needle " + ("beta " * 30) + "needle tail"}


def _hl(src, spec, query):
    return lambda p, m: p["highlight"].highlight_hit(src, spec, query, m)


CARRIED = {
    "source_true_false": lambda p, m: (p["fetch"].filter_source(SRC, True) is SRC,
                                       p["fetch"].filter_source(SRC, False)),
    "source_include_list": lambda p, m: p["fetch"].filter_source(SRC, ["title", "meta.author"]),
    "source_include_object": lambda p, m: p["fetch"].filter_source(SRC, "meta"),
    "source_wildcard_include": lambda p, m: p["fetch"].filter_source(SRC, "stats.*"),
    "source_excludes": lambda p, m: p["fetch"].filter_source(
        SRC, {"excludes": ["meta.tags", "stats"]}),
    "source_include_and_exclude": lambda p, m: p["fetch"].filter_source(
        SRC, {"includes": ["meta.*"], "excludes": ["meta.year"]}),
    "source_exclude_subtree": lambda p, m: p["fetch"].filter_source(SRC, {"excludes": ["meta"]}),
    "fields_flatten_wildcard": lambda p, m: p["fetch"].fields_option(SRC, ["meta.*"], m),
    "fields_date_epoch": lambda p, m: p["fetch"].fields_option(
        SRC, [{"field": "date", "format": "epoch_millis"}], m),
    "docvalue_fields_skip_text": lambda p, m: p["fetch"].docvalue_fields_option(
        SRC, ["title", "meta.author"], m),
    "terms_match_analyzed": lambda p, m: p["highlight"].extract_query_terms(
        {"match": {"title": "Quick FOX"}}, m),
    "terms_bool_and_term": lambda p, m: p["highlight"].extract_query_terms(
        {"bool": {"must": [{"match": {"title": "brown"}}],
                  "filter": [{"term": {"meta.author": "jane"}}]}}, m),
    "terms_prefix_pattern": lambda p, m: p["highlight"].extract_query_terms(
        {"prefix": {"title": {"value": "qui"}}}, m),
    "hl_basic": _hl(SRC, {"fields": {"title": {}}}, {"match": {"title": "fox"}}),
    "hl_custom_tags": _hl(SRC, {"fields": {"title": {}}, "pre_tags": ["<b>"],
                                "post_tags": ["</b>"]}, {"match": {"title": "quick"}}),
    "hl_require_field_match": lambda p, m: (
        _hl(SRC, {"fields": {"title": {}}}, {"term": {"meta.author": "jane"}})(p, m),
        _hl(SRC, {"fields": {"title": {"require_field_match": False}}},
            {"match": {"title": "jane quick"}})(p, m)),
    "hl_fragmenting_long_text": _hl(
        LONG, {"fields": {"title": {"fragment_size": 40, "number_of_fragments": 2}}},
        {"match": {"title": "needle"}}),
    "hl_whole_field": _hl(SRC, {"fields": {"title": {"number_of_fragments": 0}}},
                          {"match": {"title": "quick fox"}}),
    "hl_prefix": _hl(SRC, {"fields": {"title": {}}}, {"prefix": {"title": {"value": "bro"}}}),
}


@pytest.mark.parametrize("case", sorted(CARRIED))
def test_fetch_phase_cases_match_reference(case):
    fn = CARRIED[case]
    got = fn(PORT, Mappings(FETCH_MAPPING))
    want = fn(REF, RefMappings(FETCH_MAPPING))
    assert got == want, case


def test_search_with_fetch_phase_end_to_end():
    """The reference's TestEndToEnd: a search, then the fetch phase with
    _source filtering, fields and highlight."""
    body = {"_source": ["tag"], "fields": ["n"], "highlight": {"fields": {"body": {}}},
            "query": {"match": {"body": "fox"}}}
    out = []
    for eng in (Engine(device="cpu"), RefEngine()):
        try:
            idx = eng.create_index("docs", {"properties": {
                "body": {"type": "text"}, "tag": {"type": "keyword"}, "n": {"type": "long"}}})
            idx.index_doc("1", {"body": "the quick brown fox jumps", "tag": "x", "n": 7})
            idx.refresh()
            hits = eng.search_multi("docs", query=body["query"])["hits"]["hits"]
            mod = fetch if isinstance(eng, Engine) else ref_fetch
            mod.apply_fetch_phase(hits, body, lambda name, e=eng: e.get_index(name).mappings)
            out.append(hits)
        finally:
            eng.close()
    got, want = out
    assert got[0]["_source"] == {"tag": "x"} and got[0]["fields"]["n"] == [7]
    assert "<em>fox</em>" in got[0]["highlight"]["body"][0]
    assert [(h["_id"], h.get("_source"), h.get("fields"), h.get("highlight")) for h in got] == \
        [(h["_id"], h.get("_source"), h.get("fields"), h.get("highlight")) for h in want]


# ---------------------------------------------------------------------------
# seeded indices
# ---------------------------------------------------------------------------

VOCAB = ["Alpha", "beta", "GAMMA", "delta's", "e-mail", "zeta,", "eta.", "théta", "日本",
         "fox", "Foxes", "quick", "brown", "3.14", "C++", "x-ray", "(needle)", "hay"]
MAPPING = {"properties": {"body": {"type": "text"}, "title": {"type": "text"},
                          "tag": {"type": "keyword"}, "n": {"type": "long"},
                          "price": {"type": "double"}, "when": {"type": "date"},
                          "flag": {"type": "boolean"}}}


def seeded_docs(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = rng.choice(VOCAB, size=int(rng.integers(3, 60)))
        src = {"body": " ".join(words), "n": int(rng.integers(-50, 5000)),
               "price": float(np.round(rng.random() * 100, 3)),
               "when": f"2024-0{int(rng.integers(1, 9))}-1{int(rng.integers(0, 9))}T0"
                       f"{int(rng.integers(0, 9))}:00:00Z",
               "flag": bool(rng.integers(0, 2))}
        if i % 3 == 0:
            src["title"] = [" ".join(words[:4]), "fox in the hay"]
        if i % 4:
            src["tag"] = f"t{int(rng.integers(0, 5))}"
        docs.append((f"d{i}", src))
    return docs


HL_QUERIES = [
    {"match": {"body": "fox quick"}},
    {"bool": {"should": [{"match": {"body": "needle"}}, {"match": {"title": "hay"}},
                         {"term": {"tag": "t1"}}]}},
    {"match_phrase": {"body": "quick brown"}},
    {"prefix": {"body": {"value": "fo"}}},
    {"wildcard": {"body": {"value": "*ta"}}},
    {"multi_match": {"query": "Alpha gamma", "fields": ["body^2", "title"]}},
    {"dis_max": {"queries": [{"match": {"title": "fox"}}, {"match": {"body": "e-mail"}}]}},
    {"constant_score": {"filter": {"match": {"body": "théta 日本"}}}},
]
HL_SPECS = [
    {"fields": {"body": {}}},
    {"fields": {"body": {"fragment_size": 30, "number_of_fragments": 3}, "title": {}}},
    {"fields": {"*": {}}, "order": "score", "number_of_fragments": 2, "fragment_size": 50},
    {"fields": {"body": {"number_of_fragments": 0}}, "pre_tags": ["<b>"], "post_tags": ["</b>"]},
    {"fields": [{"title": {}}, {"body": {"fragment_size": 20}}], "require_field_match": False},
    {"fields": {"body": {"highlight_query": {"match": {"body": "hay needle"}},
                         "fragment_size": 100, "number_of_fragments": 3}}},
    {"fields": {"t*": {"require_field_match": False}}},
]


def _fetch_both(pair: Pair, body: dict, size: int = 20):
    """The search, then each package's fetch phase on its own hits -> the
    hits of both by `_id`: (_source, fields, highlight)."""
    got, want = pair.search(query=body.get("query"), size=size)
    fetch.apply_fetch_phase(got["hits"]["hits"], body,
                            lambda name: pair.port.mappings)
    ref_fetch.apply_fetch_phase(want["hits"]["hits"], body, lambda name: pair.ref.mappings)

    def by_id(res):
        return {h["_id"]: (h.get("_source"), h.get("fields"), h.get("highlight"))
                for h in res["hits"]["hits"]}

    return by_id(got), by_id(want)


@pytest.fixture(scope="module", params=[1, 3], ids=["1shard", "3shards"])
def seeded(request):
    p = Pair(MAPPING, {"number_of_shards": request.param})
    p.index(seeded_docs(request.param, 300))
    p.refresh()
    yield p
    p.close()


@pytest.mark.parametrize("spec", range(len(HL_SPECS)))
def test_highlight_fragments_equal_reference(seeded, spec):
    hits = 0
    for q in HL_QUERIES:
        got, want = _fetch_both(seeded, {"query": q, "highlight": HL_SPECS[spec]})
        common = set(got) & set(want)
        assert len(common) >= min(len(got), len(want)) - 2, q
        for doc_id in common:
            assert got[doc_id] == want[doc_id], (q, HL_SPECS[spec], doc_id)
            hits += bool(got[doc_id][2])
    assert hits > 20


DOCVALUE_SPECS = [
    ["n", "price", "tag", "body", "flag"],
    [{"field": "n", "format": "#.0"}, {"field": "price", "format": "#.00"}],
    [{"field": "when"}, {"field": "when", "format": "epoch_millis"}],
    [{"field": "when", "format": "yyyy-MM-dd"}, "t*", "*"],
]


@pytest.mark.parametrize("spec", range(len(DOCVALUE_SPECS)))
def test_docvalue_fields_equal_reference(seeded, spec):
    body = {"query": {"match": {"body": "fox"}}, "docvalue_fields": DOCVALUE_SPECS[spec],
            "fields": ["tag"] if spec == 1 else None}
    got, want = _fetch_both(seeded, body)
    assert got and got == want


STORED = [
    {"stored_fields": "_none_"},
    {"stored_fields": ["_none_"]},
    {"stored_fields": ["n"]},
    {"stored_fields": ["_source"]},
    {"stored_fields": "n"},
    {"stored_fields": ["n"], "_source": ["tag"]},
    {"stored_fields": ["n"], "_source": True},
    {"stored_fields": "_none_", "_source": False},
    {"stored_fields": "_none_", "_source": True},
    {"stored_fields": ["_none_"], "_source": ["tag"]},
    {"stored_fields": "_none_", "_source": {"includes": ["n"]}},
    {"_source": False, "docvalue_fields": ["n"]},
]


@pytest.mark.parametrize("case", range(len(STORED)))
def test_stored_fields_gate_and_its_errors_equal_reference(seeded, case):
    body = {"query": {"match": {"body": "quick"}}, **STORED[case]}
    try:
        want = _fetch_both(seeded, body)
    except (ElasticsearchTpuError, RefError) as ex:
        want = ex
    if isinstance(want, Exception):
        # which package raised: both must, with the same type and reason
        with pytest.raises(ElasticsearchTpuError) as got:
            fetch.apply_fetch_phase([], body, lambda name: None)
        with pytest.raises(RefError) as ref:
            ref_fetch.apply_fetch_phase([], body, lambda name: None)
        assert got.value.status == ref.value.status == 400
        assert got.value.to_dict() == ref.value.to_dict()
        return
    got, want = want
    assert got == want


# ---------------------------------------------------------------------------
# custom analyzers and synonym sets: offsets through char filters and synonyms
# ---------------------------------------------------------------------------

# every char filter here keeps the text's length: both packages' analyzers
# give offsets into the filtered text (see the test after this one)
ANALYSIS = {"analysis": {
    "char_filter": {"map": {"type": "mapping", "mappings": ["ü => u", "& => +"]}},
    "filter": {"sg": {"type": "synonym_graph", "synonyms": ["quick, fast", "tv, television"]},
               "syn": {"type": "synonym", "synonyms": ["lazy => idle, slow", "dog => hound"]},
               "st": {"type": "stop", "stopwords": "_english_"},
               "stem": {"type": "stemmer", "language": "english"}},
    "analyzer": {"syn_graph": {"tokenizer": "standard", "filter": ["lowercase", "sg"]},
                 "syn_plain": {"tokenizer": "whitespace", "filter": ["lowercase", "syn"]},
                 "chars": {"tokenizer": "standard", "char_filter": ["map"],
                           "filter": ["lowercase", "st", "stem"]}}}}
ANALYZED = ["syn_graph", "syn_plain", "chars"]
ANALYZED_MAPPING = {"properties": {**{f: {"type": "text", "analyzer": f} for f in ANALYZED},
                                   "eng": {"type": "text", "analyzer": "english"},
                                   "syn_search": {"type": "text", "search_analyzer": "syn_plain"}}}
PHRASES = ["the quick dog", "a lazy <b>fox</b>", "Müller & sons", "fast TV jumps", "running dogs",
           "<p>Lazy Dog</p> and the television", "quickly, slowly", "über & Co"]


def analyzed_docs(n: int) -> list:
    rng = np.random.default_rng(5)
    docs = []
    for i in range(n):
        text = " ".join(rng.choice(PHRASES, size=int(rng.integers(1, 6))))
        docs.append((f"a{i}", {**{f: text for f in ANALYZED}, "eng": text, "syn_search": text}))
    return docs


ANALYZED_QUERIES = [
    {"match": {"syn_graph": "fast"}}, {"match": {"syn_graph": "television quick"}},
    {"match": {"syn_plain": "lazy"}}, {"match": {"syn_plain": "hound"}},
    {"match": {"chars": "muller sons running"}}, {"match": {"chars": "b fox"}},
    {"match": {"eng": "runs dog"}}, {"match": {"syn_search": "lazy"}},
    {"multi_match": {"query": "fast dog", "fields": ["syn_graph", "syn_plain", "eng"]}},
]


def test_highlight_on_custom_analyzers_and_synonyms_equals_reference():
    p = Pair(ANALYZED_MAPPING, copy.deepcopy(ANALYSIS))
    try:
        p.index(analyzed_docs(120))
        p.refresh()
        marked = 0
        for q in ANALYZED_QUERIES:
            for spec in ({"fields": {"*": {}}}, {"fields": {"*": {"fragment_size": 60}},
                                                 "number_of_fragments": 2,
                                                 "require_field_match": False}):
                got, want = _fetch_both(p, {"query": q, "highlight": spec})
                assert got.keys() == want.keys(), q
                assert got == want, (q, spec)
                marked += sum(bool(v[2]) for v in got.values())
        assert marked > 50
    finally:
        p.close()


def test_matches_past_their_window_or_the_text_end_make_fragments():
    """Two inputs on which the reference's `_fragment_spans` never moves
    past a match (it appends empty fragments until memory runs out): a
    match longer than fragment_size, and offsets past the text's end, which
    a char filter that lengthens the text gives (both packages' analyzers
    report offsets into the filtered text). The port's fragment holds the
    match and the walk moves on."""
    m = Mappings({"properties": {"t": {"type": "text", "analyzer": "whitespace"}}})
    src = {"t": "a <b>fox</b> and <b>fox</b> on the long road of the <b>fox</b> x"}
    out = highlight.highlight_hit(src, {"fields": {"t": {"fragment_size": 6,
                                                          "number_of_fragments": 5}}},
                                  {"term": {"t": "<b>fox</b>"}}, m)
    assert out == {"t": ["<em><b>fox</b></em>"] * 3}
    eng = Engine(device="cpu")
    try:
        idx = eng.create_index("cf", {"properties": {"t": {"type": "text", "analyzer": "cf"}}},
                               {"analysis": {
                                   "char_filter": {"m": {"type": "mapping",
                                                         "mappings": ["& => and"]}},
                                   "analyzer": {"cf": {"tokenizer": "standard",
                                                       "char_filter": ["m"]}}}})
        # "sons" sits at 18-22 of "Tom and Jerry and sons", past the end of
        # the 18 characters of the source: the mark is empty, the call returns
        out = highlight.highlight_hit({"t": "Tom & Jerry & sons"}, {"fields": {"t": {}}},
                                      {"match": {"t": "sons"}}, idx.mappings)
        assert out == {"t": ["Tom & Jerry & sons<em></em>"]}
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# REST
# ---------------------------------------------------------------------------

def _bulk(docs) -> str:
    lines = []
    for i, d in docs:
        lines += [json.dumps({"index": {"_id": i}}), json.dumps(d)]
    return "\n".join(lines) + "\n"


REST_BODIES = {
    "highlight": {"query": {"match": {"body": "fox needle"}}, "size": 15,
                  "highlight": {"fields": {"body": {"fragment_size": 100,
                                                    "number_of_fragments": 3}}}},
    "highlight_query": {"query": {"match": {"body": "quick"}},
                        "highlight": {"fields": {"body": {"highlight_query": {
                            "match": {"body": "hay"}}}}}},
    "highlight_any_field": {"query": {"match": {"title": "fox"}},
                            "highlight": {"require_field_match": False,
                                          "fields": {"body": {}, "title": {}}}},
    "docvalue_fields": {"query": {"match": {"body": "beta"}},
                        "docvalue_fields": ["n", {"field": "n", "format": "#.0"}, "when"]},
    "stored_none": {"query": {"match": {"body": "beta"}}, "stored_fields": "_none_"},
    "stored_list": {"query": {"match": {"body": "beta"}}, "stored_fields": ["n", "tag"]},
    "stored_none_with_source": {"query": {"match": {"body": "beta"}},
                                "stored_fields": "_none_", "_source": ["n"]},
    "highlight_no_fields": {"query": {"match": {"body": "beta"}}, "highlight": {}},
}
URL_PARAMS = {"url_docvalue_fields": {"docvalue_fields": "n,price"},
              "url_stored_fields": {"stored_fields": "_none_"},
              "url_source_excludes": {"_source_excludes": "body"}}


def rest_sequence(index: str = "hl") -> list:
    seq = [("create", "PUT", f"/{index}", {"mappings": MAPPING,
                                           "settings": {"refresh_interval": "-1"}}, {}),
           ("bulk", "POST", f"/{index}/_bulk", _bulk(seeded_docs(9, 120)), {}),
           ("refresh", "POST", f"/{index}/_refresh", None, {})]
    seq += [(k, "POST", f"/{index}/_search", b, {}) for k, b in REST_BODIES.items()]
    seq += [(k, "POST", f"/{index}/_search", {"query": {"match": {"body": "fox"}}}, q)
            for k, q in URL_PARAMS.items()]
    return seq


def _rest_hits(resp):
    status, body = resp
    if status != 200:
        return status, body["error"]["type"], body["error"]["reason"]
    return status, {h["_id"]: (h.get("_source"), h.get("fields"), h.get("highlight"))
                    for h in body["hits"]["hits"]}


@pytest.fixture(scope="module")
def rest_runs(tmp_path_factory):
    return rest_both(rest_sequence(), tmp_path_factory.mktemp("hl_ref"))


@pytest.mark.parametrize("name", [*REST_BODIES, *URL_PARAMS])
def test_rest_fetch_phase_equals_reference(rest_runs, name):
    got, want = (_rest_hits(r[name]) for r in rest_runs)
    assert got[0] == want[0], (name, got, want)
    if got[0] != 200:
        assert got == want
        return
    common = set(got[1]) & set(want[1])
    assert common and len(common) >= len(want[1]) - 2, name
    assert {i: got[1][i] for i in common} == {i: want[1][i] for i in common}, name


def test_serving_wave_applies_the_fetch_phase_to_each_entry():
    """Highlighted and docvalue `_search`es in one `_msearch` with serving
    on ride waves; each answer equals its solo answer with serving off."""
    app = make_app(device="cpu")
    try:
        for name, method, path, body, params in rest_sequence()[:3]:
            payload = body.encode() if isinstance(body, str) else \
                json.dumps(body).encode() if body is not None else b""
            assert app.handle(method, path, params, {}, payload)[0] == 200
        bodies = [{"query": {"match": {"body": w}}, "size": 5,
                   "highlight": {"fields": {"body": {"number_of_fragments": 2}}},
                   "docvalue_fields": [{"field": "n", "format": "#.0"}],
                   "stored_fields": ["n"] if k % 2 else None}
                  for k, w in enumerate(["fox", "quick", "hay", "beta", "eta", "fox hay"] * 4)]
        bodies = [{k: v for k, v in b.items() if v is not None} for b in bodies]
        ndjson = "".join(json.dumps({}) + "\n" + json.dumps(b) + "\n" for b in bodies).encode()

        def msearch():
            status, _h, raw = app.handle("POST", "/hl/_msearch", {}, {}, ndjson)
            assert status == 200
            return [{h["_id"]: (h.get("_source"), h.get("fields"), h.get("highlight"))
                     for h in r["hits"]["hits"]} for r in json.loads(raw)["responses"]]

        solo = msearch()
        put = json.dumps({"transient": {"serving.enabled": True}}).encode()
        assert app.handle("PUT", "/_cluster/settings", {}, {}, put)[0] == 200
        waved = msearch()
        stats = json.loads(app.handle("GET", "/_serving/stats", {}, {}, b"")[2])
        assert stats["serving"]["waves"] >= 1 and stats["serving"]["completed"] >= len(bodies)
        assert waved == solo
        assert all(any(v[2] for v in r.values()) for r in waved)
        assert all(v[0] is None for r in waved[1::2] for v in r.values())
    finally:
        app.close()
