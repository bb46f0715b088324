"""The port's analysis beyond `standard`: the built-in analyzers
(`whitespace`, `simple`, `stop`, `keyword`, `english`), custom chains from
index settings (`analysis/custom.py`: the Porter stemmer, the tokenizers,
synonym and synonym_graph, trim, length, unique, edge_ngram, ngram and
shingle filters, the char filters), `_synonyms` with the reload of search
analyzers, and the refresh route of a field with such an analyzer.

Mirrors tests/test_custom_analysis.py and tests/test_graph_synonyms.py:81-116,
then seeded bodies beyond them: every component's tokens against the JAX
package's on the same texts, `match` and `match_phrase` over synonym and
stemmed fields on 1 and 3 shards, the pack's positions on a synonym field
byte-equal to the reference's (synonyms share their source's position),
and the card's build route against the host's.

Tolerances: tokens, positions and packs `==` (the impact codes within one
code: the reference's build contracts an FMA there); responses by
`torch_parity.same_hits` (scores within 1e-6 relative, ids up to fp-ties
at 1e-5). The reference side scores sparse terms from its impact tier
(`ES_TPU_IMPACT=force`), as the port does.
"""

import copy
import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis import get_analyzer as ref_get_analyzer
from elasticsearch_tpu.analysis.custom import build_analysis_registry as ref_registry
from elasticsearch_tpu.analysis.custom import porter_stem as ref_porter
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu_torch.analysis import get_analyzer
from elasticsearch_tpu_torch.analysis.batched import BatchedAnalyzer, analyze_burst
from elasticsearch_tpu_torch.analysis.custom import build_analysis_registry, porter_stem
from elasticsearch_tpu_torch.engine import EsIndex
from elasticsearch_tpu_torch.index import device_build as db
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.monitoring.refresh_profile import collect_build_stages
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
from torch_parity import Pair


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()


def _toks(an, text):
    return [(t.term, t.position, t.start_offset, t.end_offset) for t in an.analyze(text)]


# ---------------------------------------------------------------------------
# tests/test_custom_analysis.py's bodies
# ---------------------------------------------------------------------------

def test_porter_stemmer_classics():
    cases = {"caresses": "caress", "ponies": "poni", "running": "run", "relational": "relat",
             "conditional": "condit", "happy": "happi", "hopping": "hop",
             "generalization": "gener", "adjustable": "adjust", "cats": "cat", "agreed": "agre",
             "controllable": "control"}
    for w, want in cases.items():
        assert porter_stem(w) == want == ref_porter(w), w


def test_porter_stemmer_matches_reference_on_words():
    rng = np.random.default_rng(3)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    suffixes = ["", "s", "es", "ies", "ed", "ing", "ational", "ization", "ness", "ful", "ive",
                "ement", "ly", "y", "eed", "ble", "iveness", "alism", "ous", "ion", "sses"]
    words = ["".join(rng.choice(letters, size=int(rng.integers(1, 8)))) + suffixes[k % len(suffixes)]
             for k in range(3000)]
    assert [porter_stem(w) for w in words] == [ref_porter(w) for w in words]


CHAIN = {
    "char_filter": {"strip_html": {"type": "html_strip"}},
    "filter": {"my_stop": {"type": "stop", "stopwords": ["the", "a", "is"]},
               "my_stem": {"type": "stemmer", "language": "english"},
               "my_syn": {"type": "synonym", "synonyms": ["tv => television", "fast, quick"]}},
    "analyzer": {"my_an": {"type": "custom", "tokenizer": "standard", "char_filter": ["strip_html"],
                           "filter": ["lowercase", "my_stop", "my_syn", "my_stem"]}},
}


def test_custom_analyzer_chain():
    an, ref = build_analysis_registry(CHAIN)["my_an"], ref_registry(CHAIN)["my_an"]
    text = "<b>The</b> RUNNING tv is fast"
    assert [t.term for t in an.analyze(text)] == ["run", "televis", "fast", "quick"]
    assert _toks(an, text) == _toks(ref, text)


def test_english_analyzer_stems():
    assert [t.term for t in get_analyzer("english").analyze("The running foxes")] == ["run", "fox"]


def test_edge_ngram_autocomplete():
    spec = {"filter": {"autocomplete": {"type": "edge_ngram", "min_gram": 2, "max_gram": 4}},
            "analyzer": {"ac": {"type": "custom", "tokenizer": "standard",
                                "filter": ["lowercase", "autocomplete"]}}}
    assert [t.term for t in build_analysis_registry(spec)["ac"].analyze("Search")] == \
        ["se", "sea", "sear"]


@pytest.mark.parametrize("shards", [1, 3])
def test_index_with_custom_analyzer_end_to_end(shards):
    p = Pair({"properties": {"body": {"type": "text", "analyzer": "stemmed"}}},
             {"number_of_shards": shards, "analysis": {"analyzer": {"stemmed": {
                 "type": "custom", "tokenizer": "standard", "filter": ["lowercase", "porter_stem"]}}}})
    try:
        p.index([("1", {"body": "running shoes"}), ("2", {"body": "he runs daily"}),
                 ("3", {"body": "unrelated text"})])
        p.refresh()
        got = p.check("stemmed", query={"match": {"body": "runs"}}, size=10)
        assert {h["_id"] for h in got["hits"]["hits"]} == {"1", "2"}
    finally:
        p.close()


# ---------------------------------------------------------------------------
# every component against the reference on seeded texts
# ---------------------------------------------------------------------------

WORDS = ["The", "quick", "fast", "Dog", "hound", "running", "jumps", "over", "lazy", "Foxes",
         "it's", "a", "Café", "naïve", "  padded ", "x" * 12, "TV", "don't", "42", "co-op",
         "<i>html</i>", "e-mail", "Ünïcode", "the"]


def seeded_texts(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 12)))) for _ in range(n)] + [
        "", "   ", "<p>only tags</p>", "a" * 300]


@pytest.mark.parametrize("name", ["standard", "whitespace", "simple", "stop", "keyword", "english"])
def test_builtin_analyzers_match_reference(name):
    an, ref = get_analyzer(name), ref_get_analyzer(name)
    for text in seeded_texts(1, 150):
        assert _toks(an, text) == _toks(ref, text), (name, text)


COMPONENTS = {
    "analysis": {
        "char_filter": {"html": {"type": "html_strip"},
                        "map": {"type": "mapping", "mappings": ["ü => ue", "- => _"]},
                        "pat": {"type": "pattern_replace", "pattern": "\\d+", "replacement": "N"}},
        "tokenizer": {"pat_tok": {"type": "pattern", "pattern": "[\\s,]+"}},
        "filter": {
            "sg": {"type": "synonym_graph", "synonyms": ["quick, fast", "dog => hound",
                                                         "tv, television, telly"]},
            "syn": {"type": "synonym", "synonyms": ["lazy => idle, slow"]},
            "len": {"type": "length", "min": 2, "max": 6},
            "eg": {"type": "edge_ngram", "min_gram": 2, "max_gram": 5},
            "ng": {"type": "ngram", "min_gram": 2, "max_gram": 3},
            "sh": {"type": "shingle", "min_shingle_size": 2, "max_shingle_size": 3},
            "sh_only": {"type": "shingle", "output_unigrams": False, "token_separator": "_"},
            "st": {"type": "stop", "stopwords": "_english_"},
            "stem": {"type": "stemmer", "language": "english"}},
        "analyzer": {
            "syn_graph": {"tokenizer": "standard", "filter": ["lowercase", "sg", "eg"]},
            "syn_plain": {"tokenizer": "whitespace", "filter": ["lowercase", "syn", "unique"]},
            "trim_len": {"tokenizer": "keyword", "filter": ["trim", "lowercase", "len"]},
            "ngrams": {"tokenizer": "letter", "filter": ["lowercase", "ng"]},
            "shingles": {"tokenizer": "standard", "filter": ["lowercase", "st", "sh"]},
            "shingles_only": {"tokenizer": "standard", "filter": ["lowercase", "sh_only"]},
            "chars": {"tokenizer": "pat_tok", "char_filter": ["html", "map", "pat"],
                      "filter": ["asciifolding", "uppercase"]},
            "stemmed_stop": {"tokenizer": "standard", "filter": ["lowercase", "st", "stem"]},
            "builtin_ref": {"type": "english"}},
    }}


@pytest.mark.parametrize("name", sorted(COMPONENTS["analysis"]["analyzer"]))
def test_custom_components_match_reference(name):
    an = build_analysis_registry(COMPONENTS["analysis"])[name]
    ref = ref_registry(copy.deepcopy(COMPONENTS["analysis"]))[name]
    for text in seeded_texts(2, 150):
        assert _toks(an, text) == _toks(ref, text), (name, text)


def test_unknown_components_are_400s():
    for spec in ({"analyzer": {"a": {"tokenizer": "nope"}}},
                 {"analyzer": {"a": {"tokenizer": "standard", "filter": ["nope"]}}},
                 {"analyzer": {"a": {"tokenizer": "standard", "char_filter": ["nope"]}}},
                 {"filter": {"s": {"type": "stemmer", "language": "klingon"}},
                  "analyzer": {"a": {"tokenizer": "standard", "filter": ["s"]}}}):
        with pytest.raises(IllegalArgumentError) as ex:
            build_analysis_registry(spec)
        assert ex.value.status == 400
    with pytest.raises(IllegalArgumentError):
        Mappings({"properties": {"t": {"type": "text", "analyzer": "nope"}}})


# ---------------------------------------------------------------------------
# indices with these analyzers
# ---------------------------------------------------------------------------

FIELDS = ["syn_graph", "syn_plain", "shingles", "stemmed_stop", "chars"]
MAPPING = {"properties": {
    **{f: {"type": "text", "analyzer": f} for f in FIELDS},
    "eng": {"type": "text", "analyzer": "english"}, "ws": {"type": "text", "analyzer": "whitespace"},
    "simple": {"type": "text", "analyzer": "simple"}, "stop": {"type": "text", "analyzer": "stop"},
    "kw": {"type": "text", "analyzer": "keyword"},
    "std": {"type": "text", "search_analyzer": "syn_plain"}}}


def analysis_docs(seed: int, n: int) -> list:
    texts = seeded_texts(seed, n)
    out = []
    for i, t in enumerate(texts[:n]):
        src = {f: t for f in [*FIELDS, "eng", "ws", "simple", "stop", "kw", "std"]}
        if i % 5 == 0:
            src["syn_graph"] = [t, "quick dog"]  # multi-valued: the +100 position gap
        out.append((f"a{i}", src))
    return out


def _queries() -> list:
    return [{"match": {"syn_graph": "fast hound"}}, {"match_phrase": {"syn_graph": "quick dog"}},
            {"match_phrase": {"syn_graph": "fast hound"}}, {"match": {"syn_plain": "lazy"}},
            {"match_phrase": {"syn_plain": "idle dog"}}, {"match": {"shingles": "quick dog"}},
            {"match_phrase": {"shingles": "lazy foxes"}}, {"match": {"stemmed_stop": "jumping"}},
            {"match": {"chars": "CAFE"}}, {"match": {"eng": "runs"}},
            {"match_phrase": {"eng": "lazi fox"}}, {"match": {"ws": "Dog"}},
            {"match": {"simple": "it"}}, {"match": {"stop": "the lazy"}},
            {"term": {"kw": "lazy"}}, {"match": {"std": "lazy"}},
            {"multi_match": {"query": "fast dog", "fields": ["syn_graph", "eng"]}},
            {"match_phrase_prefix": {"syn_plain": "quick fo"}}]


@pytest.fixture(params=[1, 3], ids=["1shard", "3shards"], scope="module")
def indexed(request):
    p = Pair(MAPPING, {"number_of_shards": request.param, **copy.deepcopy(COMPONENTS)})
    p.index(analysis_docs(request.param, 250))
    p.refresh()
    yield p
    p.close()


def test_searches_over_analyzed_fields_match_reference(indexed):
    for q in _queries():
        indexed.check(json.dumps(q), query=q, size=15)


def _packs(docs, settings, device=None):
    m = Mappings(MAPPING, analysis_registry=build_analysis_registry(settings["analysis"]))
    rm = RefMappings(MAPPING)
    rm.set_analysis(ref_registry(copy.deepcopy(settings["analysis"])))
    b = PackBuilder(m, device=device)
    b.add_documents_batch([m.parse_document(d) for _i, d in docs], [i for i, _d in docs])
    rb = RefPackBuilder(rm)
    rb.add_documents_batch([rm.parse_document(d) for _i, d in docs],
                           doc_ids=[i for i, _d in docs])
    return b, rb


PACK_ARRAYS = ["post_docids", "post_tfs", "post_dls", "term_block_start", "term_df", "pos_keys",
               "term_pos_start", "term_pos_count", "impact_ubf"]


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same_pack(got, want):
    assert got.term_dict == want.term_dict and got.field_stats == want.field_stats
    for name in PACK_ARRAYS:
        a, b = _np(getattr(got, name)), _np(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    for f in want.norms:
        assert _np(got.norms[f]).tobytes() == _np(want.norms[f]).tobytes(), f
    # impact codes: within one code of each other (the reference's build
    # quantizes through XLA above its device floor, which contracts
    # k_base + k_slope * dl into one FMA on the CPU; the port rounds each op)
    a, b = _np(got.impact_codes).astype(np.int64), _np(want.impact_codes).astype(np.int64)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_synonym_positions_and_pack_byte_equal_reference():
    """Synonyms share their source token's position: the pack's position keys,
    postings, norms and dictionary equal the reference's byte for byte."""
    docs = analysis_docs(5, 300)
    b, rb = _packs(docs, COMPONENTS)
    got, want = b.build(), rb.build()
    _assert_same_pack(got, want)
    an = build_analysis_registry(COMPONENTS["analysis"])["syn_graph"]
    toks = an.analyze("quick dog")
    pos = {t.term: t.position for t in toks}
    assert pos["quick"] == pos["fast"] == 0 and pos["hound"] == 1


def test_card_route_equals_host_route_and_names_the_analyzer_route(monkeypatch):
    """A refresh routed to the device (forced on CPU tensors) builds such a
    field on the host by its analyzer's type, not by an exception: the pack
    is byte-equal to the host route's, and the `build.analyze` stage's basis
    names the route."""
    docs = analysis_docs(6, 200)
    host, _rb = _packs(docs, COMPONENTS)
    want = host.build()
    monkeypatch.setattr(db, "DEVICE_BUILD_MIN", 0)
    monkeypatch.setattr(db, "ANALYZE_DEVICE_MIN", 0)
    monkeypatch.setattr(db, "use_device_build", lambda elements, device, floor=None:
                        device is not None)
    with collect_build_stages() as c:
        card, _rb = _packs(docs, COMPONENTS, device=torch.device("cpu"))
        got = card.build()
    _assert_same_pack(got, want)
    assert c.bases["build.analyze"] == "mixed"  # `std` took the device path, the rest the host
    for name in ("english", "whitespace", "simple", "stop", "keyword"):
        assert BatchedAnalyzer(get_analyzer(name)).route == "host_analyzer"
    with collect_build_stages() as c:
        m = Mappings({"properties": {"e": {"type": "text", "analyzer": "english"}}})
        analyze_burst(m.fields["e"].get_batched_analyzer(), ["The running foxes"],
                      np.zeros(1, np.int64), 1, device=torch.device("cpu"))
    assert c.bases["build.analyze"] == "host_analyzer"
    idx = EsIndex("r", MAPPING, {"number_of_shards": 2, **copy.deepcopy(COMPONENTS)},
                  device="cpu")
    for i, d in docs:
        idx.index_doc(i, d)
    idx.refresh()
    engine_free = idx.search({"match_phrase": {"syn_graph": "fast hound"}}, size=5)
    assert engine_free["hits"]["total"]["value"] > 0


# ---------------------------------------------------------------------------
# _synonyms (tests/test_graph_synonyms.py:81-116)
# ---------------------------------------------------------------------------

def _req(app, method, path, body=None, query=None):
    st, _h, out = app.handle(method, path, query or {}, {},
                             json.dumps(body).encode() if body is not None else b"")
    return st, (json.loads(out) if out else None)


def test_synonyms_api_and_recovery():
    app = make_app(device="cpu")
    try:
        st, out = _req(app, "PUT", "/_synonyms/tech", {"synonyms_set": [
            {"synonyms": "laptop, notebook"}, {"synonyms": "tv => television"}]})
        assert st == 200 and out["result"] == "created"
        assert _req(app, "GET", "/_synonyms/tech")[1]["count"] == 2
        assert _req(app, "GET", "/_synonyms")[1] == {"count": 1, "results": [
            {"synonyms_set": "tech", "count": 2}]}
        st, _ = _req(app, "PUT", "/shop", {
            "settings": {"analysis": {
                "filter": {"syn": {"type": "synonym", "synonyms_set": "tech"}},
                "analyzer": {"with_syn": {"type": "custom", "tokenizer": "standard",
                                          "filter": ["lowercase", "syn"]}}}},
            "mappings": {"properties": {"t": {"type": "text", "analyzer": "with_syn"}}}})
        assert st == 200
        assert _req(app, "PUT", "/shop/_doc/1", {"t": "new laptop"}, {"refresh": "true"})[0] in (200, 201)
        st, out = _req(app, "POST", "/shop/_search", {"query": {"match": {"t": "notebook"}}})
        assert out["hits"]["total"]["value"] == 1
        assert _req(app, "DELETE", "/_synonyms/tech")[1] == {"acknowledged": True}
        assert _req(app, "GET", "/_synonyms/tech")[0] == 404
        assert _req(app, "DELETE", "/_synonyms/tech")[0] == 404
        st, out = _req(app, "PUT", "/other", {"settings": {"analysis": {
            "filter": {"syn": {"type": "synonym", "synonyms_set": "tech"}},
            "analyzer": {"a": {"tokenizer": "standard", "filter": ["syn"]}}}}})
        assert st == 400 and "not found" in out["error"]["reason"]
    finally:
        app.close()


def test_synonym_set_update_reloads_search_analyzers():
    app = make_app(device="cpu")
    try:
        _req(app, "PUT", "/_synonyms/s1", {"synonyms_set": [{"synonyms": "car, auto"}]})
        _req(app, "PUT", "/garage", {
            "settings": {"analysis": {
                "filter": {"syn": {"type": "synonym", "synonyms_set": "s1"}},
                "analyzer": {"a": {"type": "custom", "tokenizer": "standard",
                                   "filter": ["lowercase", "syn"]}}}},
            "mappings": {"properties": {"t": {"type": "text", "search_analyzer": "a",
                                              "analyzer": "standard"}}}})
        _req(app, "PUT", "/garage/_doc/1", {"t": "bike"}, {"refresh": "true"})
        q = {"query": {"match": {"t": "cycle"}}}
        assert _req(app, "POST", "/garage/_search", q)[1]["hits"]["total"]["value"] == 0
        gen = app.engine.get_index("garage").mappings.analysis_generation
        st, out = _req(app, "PUT", "/_synonyms/s1", {"synonyms_set": [
            {"synonyms": "car, auto"}, {"synonyms": "bike, cycle"}]})
        assert out["result"] == "updated"
        assert app.engine.get_index("garage").mappings.analysis_generation == gen + 1
        assert _req(app, "POST", "/garage/_search", q)[1]["hits"]["total"]["value"] == 1
    finally:
        app.close()


def test_analysis_on_a_tiered_index():
    """Base + tail segments of a synonym field: match (tier-safe) on each
    tier and match_phrase, as the reference's tiers answer them."""
    docs = analysis_docs(9, 400)
    p = Pair(MAPPING, copy.deepcopy(COMPONENTS))
    try:
        p.index(docs[:300])
        p.refresh()
        p.index(docs[300:360])
        p.refresh()
        p.index(docs[360:])
        p.refresh()
        for q in _queries()[:6]:
            p.check(json.dumps(q), query=q, size=15)
    finally:
        p.close()
