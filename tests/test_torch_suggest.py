"""The port's suggesters (`search/suggest.py`: term, phrase, completion) and
the `completion` field type against the JAX package's.

The cases of the reference's tests/test_suggest.py run through both
packages' engines. Then seeded indices on 1 and 3 shards
(`torch_parity.Pair`): term suggestions for misspelt words with every
option (size, max_edits, prefix_length, suggest_mode), phrase suggestions
with highlight and max_errors, completion prefixes of 1-4 characters with
weights, several inputs per doc, size and skip_duplicates; an index with
tail tiers; the errors. The completion lists of a pack built by each
package's host route, of the card route's build (forced on CPU tensors),
of a reference pack carried across (`convert.pack_from_reference`) and of
a stacked pack are held equal. Then the same suggestions over REST against
the reference's aiohttp app.

Tolerances: every suggestion entry and option `==` (texts, offsets,
scores, freqs, ids, sources), the completion lists `==`.
"""

import copy
import json

import numpy as np
import pytest

from elasticsearch_tpu.engine import Engine as RefEngine
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu.parallel.stacked import build_stacked_pack as ref_build_stacked
from elasticsearch_tpu.utils.errors import ElasticsearchTpuError as RefError
from elasticsearch_tpu_torch.convert import pack_from_reference, stacked_pack_from_reference
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.index import device_build as db
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.parallel.stacked import build_stacked_pack
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuError
from torch_parity import Pair, rest_both


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")


# ---------------------------------------------------------------------------
# tests/test_suggest.py's cases
# ---------------------------------------------------------------------------

SMALL_MAPPING = {"properties": {"body": {"type": "text"}, "sug": {"type": "completion"}}}
SMALL_DOCS = [
    ("1", {"body": "the quick brown fox", "sug": {"input": ["quick fox", "quality"], "weight": 3}}),
    ("2", {"body": "quick silver surfer", "sug": "quick silver"}),
    ("3", {"body": "brown bread recipe", "sug": {"input": "bread", "weight": 10}}),
    ("4", {"body": "slow brown snail", "sug": "snail pace"}),
]
CARRIED = {
    "term_typo": {"fix": {"text": "quik browm", "term": {"field": "body"}}},
    "term_spelled_right": {"ok": {"text": "brown", "term": {"field": "body"}}},
    "phrase": {"p": {"text": "quik brown", "phrase": {
        "field": "body", "highlight": {"pre_tag": "<em>", "post_tag": "</em>"}}}},
    "completion_prefix_weight": {"c": {"prefix": "qu", "completion": {"field": "sug"}}},
    "completion_bread": {"c": {"prefix": "bre", "completion": {"field": "sug"}}},
}


@pytest.fixture(scope="module")
def small():
    engines = (Engine(device="cpu"), RefEngine(None))
    for e in engines:
        e.create_index("s", SMALL_MAPPING)
        for i, src in SMALL_DOCS:
            e.indices["s"].index_doc(i, src)
        e.indices["s"].refresh()
    yield engines
    for e in engines:
        e.close()


@pytest.mark.parametrize("case", sorted(CARRIED))
def test_suggest_cases_match_reference(small, case):
    port, ref = small
    got = port.suggest_multi("s", copy.deepcopy(CARRIED[case]))
    assert got == ref.suggest_multi("s", copy.deepcopy(CARRIED[case]))
    if case == "term_typo":
        assert [o["options"][0]["text"] for o in got["fix"]] == ["quick", "brown"]
        assert got["fix"][0]["options"][0]["freq"] == 2
    elif case == "term_spelled_right":
        assert got["ok"][0]["options"] == []
    elif case == "phrase":
        assert got["p"][0]["options"][0]["text"] == "quick brown"
        assert "<em>quick</em>" in got["p"][0]["options"][0]["highlighted"]
    elif case == "completion_prefix_weight":
        assert got["c"][0]["options"][0]["_score"] == 3.0
        assert {o["_id"] for o in got["c"][0]["options"]} == {"1", "2"}


# ---------------------------------------------------------------------------
# seeded indices
# ---------------------------------------------------------------------------

WORDS = ["search", "engine", "index", "shard", "replica", "query", "filter", "analyzer",
         "token", "vector", "cluster", "mapping", "document", "refresh", "segment", "merge",
         "suggest", "complete", "phrase", "highlight", "seaside", "season", "seattle"]
PLACES = ["San Francisco", "San Diego", "Santa Fe", "Santiago", "Sao Paulo", "Seattle",
          "Berlin", "Bern", "Bergen", "Boston", "Bogota", "Lagos", "Lima", "Lisbon", "London",
          "Los Angeles", "Louisville", "Zurich", "Zagreb", "Ürümqi", "Åre", "Ōsaka"]
MAPPING = {"properties": {"body": {"type": "text"}, "tag": {"type": "keyword"},
                          "place": {"type": "completion"}, "alt": {"type": "completion"}}}


def _misspell(rng, w: str) -> str:
    i = int(rng.integers(0, len(w)))
    op = int(rng.integers(0, 3))
    c = "abcdefghijklmnopqrstuvwxyz"[int(rng.integers(0, 26))]
    if op == 0:
        return w[:i] + c + w[i + 1:]
    if op == 1:
        return w[:i] + w[i + 1:]
    return w[:i] + c + w[i:]


def seeded_docs(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        words = [WORDS[k] for k in rng.choice(len(WORDS), size=int(rng.integers(2, 12)), p=p)]
        if i % 5 == 0:
            words.append(_misspell(rng, words[0]))  # rare misspellings in the dictionary
        src = {"body": " ".join(words), "tag": f"t{i % 4}"}
        k = int(rng.integers(0, len(PLACES)))
        form = i % 4
        if form == 0:
            src["place"] = {"input": [PLACES[k], PLACES[(k + 3) % len(PLACES)]],
                            "weight": int(rng.integers(1, 50))}
        elif form == 1:
            src["place"] = PLACES[k]
        elif form == 2:
            src["place"] = [PLACES[k], PLACES[(k + 1) % len(PLACES)]]
        if i % 3 == 0:
            src["alt"] = {"input": PLACES[k].lower(), "weight": int(rng.integers(1, 5))}
        docs.append((f"d{i}", src))
    return docs


def term_requests(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for j in range(24):
        text = " ".join(_misspell(rng, WORDS[int(rng.integers(0, len(WORDS)))])
                        for _ in range(int(rng.integers(1, 4))))
        spec = {"field": "body", "size": [1, 3, 5][j % 3], "max_edits": [1, 2][j % 2],
                "prefix_length": [0, 1, 2][j % 3],
                "suggest_mode": ["missing", "popular", "always"][(j // 3) % 3]}
        out.append({"t": {"text": text, "term": spec}})
    return out


def phrase_requests(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for j in range(12):
        toks = [WORDS[int(rng.integers(0, len(WORDS)))] for _ in range(int(rng.integers(2, 4)))]
        toks[j % len(toks)] = _misspell(rng, toks[j % len(toks)])
        spec = {"field": "body", "size": 3 + j % 3,
                "max_errors": [1.0, 0.5, 2][j % 3]}
        if j % 2:
            spec["highlight"] = {"pre_tag": "<em>", "post_tag": "</em>"}
        out.append({"p": {"text": " ".join(toks), "phrase": spec}})
    return out


def completion_requests() -> list:
    out = []
    for j, pre in enumerate(["S", "Sa", "San", "San ", "Be", "Ber", "L", "Lo", "Lon", "Z", "Ü",
                             "Å", "Ō", "x", "", "Se", "Bo", "sa", "ber", "lis"]):
        fld = "alt" if pre.islower() else "place"
        spec = {"field": fld, "size": [5, 2, 10][j % 3]}
        if j % 2:
            spec["skip_duplicates"] = True
        out.append({"c": {"prefix": pre, "completion": spec}})
    # the suggestion text stands in for a missing prefix; two suggestions in one body
    out.append({"text": "Sa", "c": {"completion": {"field": "place"}},
                "t": {"term": {"field": "body"}}})
    return out


@pytest.fixture(scope="module", params=[1, 3], ids=["1shard", "3shards"])
def seeded(request):
    p = Pair(MAPPING, {"number_of_shards": request.param})
    p.index(seeded_docs(request.param, 400))
    p.refresh()
    yield p
    p.close()


@pytest.mark.parametrize("kind", ["term", "phrase", "completion"])
def test_suggestions_equal_reference(seeded, kind):
    reqs = {"term": term_requests(4), "phrase": phrase_requests(5),
            "completion": completion_requests()}[kind]
    options = 0
    for body in reqs:
        got = seeded.port_engine.suggest_multi("idx", copy.deepcopy(body))
        want = seeded.ref_engine.suggest_multi("idx", copy.deepcopy(body))
        assert got == want, body
        options += sum(len(e["options"]) for v in got.values() for e in v)
    assert options > 20


@pytest.mark.parametrize("max_edits", [0, 1, 2])
def test_term_candidates_on_a_dense_dictionary_equal_reference(max_edits):
    """The vectorized edit-distance table (`query.dsl.edits_within_many`) against
    the reference's per-term loop: every string of 1-6 characters over a
    4-letter alphabet (transpositions, repeats and the scalar version's
    early exit all occur) as the dictionary, 120 tokens, every
    prefix_length and suggest_mode."""
    import itertools as it

    from elasticsearch_tpu.search import suggest as ref_suggest
    from elasticsearch_tpu_torch.search import suggest

    rng = np.random.default_rng(max_edits)
    alphabet = "abéd"
    words = ["".join(w) for n in range(1, 7) for w in it.product(alphabet, repeat=n)]
    keep = rng.random(len(words)) < 0.35
    global_df = {("f", w): int(rng.integers(1, 9)) for w, k in zip(words, keep) if k}
    mapping = {"properties": {"f": {"type": "text", "analyzer": "whitespace"}}}
    view = suggest.SuggestView(global_df, {})

    class RefView:
        pass

    ref_view = RefView()
    ref_view.global_df = global_df
    tokens = [words[int(j)] for j in rng.integers(0, len(words), size=120)]
    options = 0
    for k, tok in enumerate(tokens):
        spec = {"field": "f", "size": 7, "max_edits": max_edits, "prefix_length": k % 4,
                "suggest_mode": ["missing", "popular", "always"][k % 3]}
        got = suggest.term_suggest(view, Mappings(mapping), tok, spec)
        want = ref_suggest.term_suggest(ref_view, RefMappings(mapping), tok, spec)
        assert got == want, (tok, spec)
        options += len(got[0]["options"])
    assert options > 150 or max_edits == 0


@pytest.mark.parametrize("shards", [1, 3])
def test_fuzzy_queries_over_a_dense_dictionary_equal_reference(shards):
    """The fuzzy query's expansion through the same table
    (`FuzzyMatcher.match_run`, each shard's dictionary by length) against
    the reference's per-term walk: docs of words of 1-5 characters over a
    4-letter alphabet, fuzziness 0-2 and AUTO, prefix_length 0-2,
    transpositions on and off, on 1 and 3 shards."""
    import itertools as it

    from torch_parity import same_hits

    rng = np.random.default_rng(30 + shards)
    words = ["".join(w) for n in range(1, 6) for w in it.product("abéd", repeat=n)]
    docs = [(f"z{i}", {"w": " ".join(rng.choice(words, size=int(rng.integers(1, 8))))})
            for i in range(300)]
    p = Pair({"properties": {"w": {"type": "text", "analyzer": "whitespace"}}},
             {"number_of_shards": shards})
    try:
        p.index(docs)
        p.refresh()
        for k in range(40):
            spec = {"value": words[int(rng.integers(0, len(words)))],
                    "fuzziness": [0, 1, 2, "AUTO"][k % 4], "prefix_length": (k // 4) % 3,
                    "transpositions": bool(k % 2), "max_expansions": 1000}
            q = {"fuzzy": {"w": spec}}
            got, want = p.search(query=q, size=20)
            same_hits(got, want, str(q))
    finally:
        p.close()


def test_suggest_on_a_tiered_index_reads_the_merged_searcher():
    """Writes after the base leave tail segments; a suggest merges them
    first in both packages (reference `engine.py:567-578`)."""
    p = Pair(MAPPING)
    try:
        docs = seeded_docs(7, 560)
        p.index(docs[:500])
        p.refresh()
        p.index(docs[500:])
        p.index([("d3", {"body": "seattle seasde", "place": {"input": "Seattle", "weight": 99}})])
        p.refresh()
        assert p.port._tails
        for body in [*completion_requests()[:8], *term_requests(8)[:6]]:
            got = p.port_engine.suggest_multi("idx", copy.deepcopy(body))
            assert got == p.ref_engine.suggest_multi("idx", copy.deepcopy(body)), body
        assert not p.port._tails
    finally:
        p.close()


ERRORS = [
    {"t": {"text": "x", "term": {}}},
    {"t": {"text": "x", "term": {"field": "nope"}}},
    {"t": {"text": "x", "phrase": {}}},
    {"t": {"text": "x", "completion": {}}},
    {"t": {"text": "x", "fuzzy": {"field": "body"}}},
    {"t": "not an object"},
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_suggest_errors_equal_reference(seeded, case):
    with pytest.raises(ElasticsearchTpuError) as got:
        seeded.port_engine.suggest_multi("idx", copy.deepcopy(ERRORS[case]))
    with pytest.raises(RefError) as want:
        seeded.ref_engine.suggest_multi("idx", copy.deepcopy(ERRORS[case]))
    assert got.value.status == want.value.status == 400
    assert got.value.to_dict() == want.value.to_dict()


def test_suggest_over_several_indices_is_a_400():
    engines = (Engine(device="cpu"), RefEngine(None))
    try:
        errs = []
        for e, err in zip(engines, (ElasticsearchTpuError, RefError)):
            for name in ("a", "b"):
                e.create_index(name, MAPPING)
            with pytest.raises(err) as ex:
                e.suggest_multi("a,b", {"c": {"prefix": "S", "completion": {"field": "place"}}})
            errs.append(ex.value.to_dict())
        assert errs[0] == errs[1] and errs[0]["status"] == 400
    finally:
        for e in engines:
            e.close()


# ---------------------------------------------------------------------------
# the completion lists of every build route
# ---------------------------------------------------------------------------

def _built(builder_cls, mappings, docs):
    b = builder_cls(mappings)
    for i, src in docs:
        b.add_document(mappings.parse_document(src), doc_id=i)
    return b.build()


def test_completion_lists_of_every_build_route_equal_reference(monkeypatch):
    docs = seeded_docs(11, 300)
    ref = _built(RefPackBuilder, RefMappings(MAPPING), docs)
    host = _built(PackBuilder, Mappings(MAPPING), docs)
    assert host.completion == ref.completion and set(host.completion) == {"place", "alt"}
    assert pack_from_reference(ref).completion == ref.completion
    # the card's build route, forced on CPU tensors
    monkeypatch.setattr(db, "DEVICE_BUILD_MIN", 0)
    monkeypatch.setattr(db, "ANALYZE_DEVICE_MIN", 0)
    monkeypatch.setattr(db, "use_device_build", lambda e, d, floor=None: d is not None)
    m = Mappings(MAPPING)
    b = PackBuilder(m, device="cpu")
    b.add_documents_batch([m.parse_document(s) for _i, s in docs], doc_ids=[i for i, _s in docs])
    assert b.build().completion == ref.completion
    # stacked: the union with shard tags, input-sorted
    sp = build_stacked_pack(docs, Mappings(MAPPING), 3)
    ref_sp = ref_build_stacked(docs, RefMappings(MAPPING), 3)
    assert sp.completion == ref_sp.completion
    assert stacked_pack_from_reference(ref_sp, MAPPING).completion == ref_sp.completion


# ---------------------------------------------------------------------------
# REST
# ---------------------------------------------------------------------------

def _bulk(docs) -> str:
    lines = []
    for i, d in docs:
        lines += [json.dumps({"index": {"_id": i}}), json.dumps(d)]
    return "\n".join(lines) + "\n"


REST_BODIES = {
    "term": {"query": {"match": {"body": "engine"}}, "size": 2,
             "suggest": {"fix": {"text": "engnie qeury", "term": {"field": "body"}}}},
    "phrase": {"size": 0, "suggest": {"p": {"text": "serch engine",
                                            "phrase": {"field": "body"}}}},
    "completion": {"size": 0, "suggest": {"c": {"prefix": "San", "completion": {
        "field": "place", "size": 3, "skip_duplicates": True}}}},
    "global_text": {"size": 0, "suggest": {"text": "Lo", "c": {"completion": {"field": "place"}}}},
    "error": {"suggest": {"t": {"text": "x", "term": {}}}},
}


def rest_sequence(index: str = "sg") -> list:
    seq = [("create", "PUT", f"/{index}", {"mappings": MAPPING,
                                           "settings": {"number_of_shards": 2}}, {}),
           ("bulk", "POST", f"/{index}/_bulk", _bulk(seeded_docs(2, 150)), {}),
           ("refresh", "POST", f"/{index}/_refresh", None, {}),
           ("mapping", "GET", f"/{index}/_mapping", None, {})]
    return seq + [(k, "POST", f"/{index}/_search", b, {}) for k, b in REST_BODIES.items()]


@pytest.fixture(scope="module")
def rest_runs(tmp_path_factory):
    return rest_both(rest_sequence(), tmp_path_factory.mktemp("sg_ref"))


@pytest.mark.parametrize("name", ["mapping", *REST_BODIES])
def test_rest_suggest_equals_reference(rest_runs, name):
    (gs, got), (ws, want) = (r[name] for r in rest_runs)
    assert gs == ws, (name, got, want)
    if gs != 200:
        assert got["error"]["type"] == want["error"]["type"]
        assert got["error"]["reason"] == want["error"]["reason"]
        return
    if name == "mapping":
        assert got == want
        return
    assert got["suggest"] == want["suggest"]
    assert got["hits"]["total"] == want["hits"]["total"]
