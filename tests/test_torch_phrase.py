"""Phrases over positions: the port's `match_phrase`, `match_phrase_prefix`
and `multi_match` of type phrase against the JAX package's, on one shard,
on three shards and on a base with tail segments, and the position arrays
of the stacked pack.

Both packages index the same seeded documents (`torch_parity.text_docs`,
and the fixed sentences of the reference's `tests/test_phrase.py`); every
phrase is drawn from a real document, so it matches. The reference scores
sparse terms from its impact tier (ES_TPU_IMPACT=force), as the port does;
a phrase scores exact BM25 from its phrase frequency in both.
Tolerances: `torch_parity.same_hits` (totals equal, scores within 1e-6
relative, ids up to fp-ties).
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.parallel.stacked import build_stacked_pack as ref_build_stacked
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.parallel.stacked import build_stacked_pack
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.query.nodes import PhraseNode
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError
from torch_parity import MAPPING, Pair, same_hits, text_docs

SENTENCES = [
    "the quick brown fox jumps over the lazy dog",
    "quick brown foxes and quick brown bears",
    "brown quick reversal here",
    "quick thinking saves the brown fox",
    "nothing relevant at all",
    "quick brown quick brown quick brown",
]
CASES = [
    {"match_phrase": {"body": "quick brown"}},
    {"match_phrase": {"body": "brown quick"}},
    {"match_phrase": {"body": "quick brown fox"}},
    {"match_phrase": {"body": "lazy fox"}},
    {"match_phrase": {"body": "quick missing"}},
    {"match_phrase": {"body": "fox"}},
    {"match_phrase": {"body": {"query": "the brown fox", "boost": 2.5}}},
    {"match_phrase_prefix": {"body": "quick brown fo"}},
    {"match_phrase_prefix": {"body": "qui"}},
    {"multi_match": {"query": "brown fox", "fields": ["body", "title^3"], "type": "phrase"}},
]


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """The reference scores from its impact tier, and both execution
    planners start cold."""
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


def _sentences():
    docs = [(f"s{i}", {"body": b, "title": b.split()[0] + " fox"})
            for i, b in enumerate(SENTENCES)]
    # a multi-valued field: "fox and" spans the 100-position gap, no match
    docs.append(("mv", {"body": ["a brown fox", "and quick brown"]}))
    return docs


@pytest.fixture(scope="module", params=[1, 3], ids=["1shard", "3shards"])
def small(request):
    p = Pair(MAPPING, {"number_of_shards": request.param})
    p.index(_sentences())
    p.refresh()
    yield p
    p.close()


@pytest.mark.parametrize("q", CASES, ids=[f"{list(q)[0]}{i}" for i, q in enumerate(CASES)])
def test_phrase_cases_match_reference(small, q):
    got = small.check("phrase", query=q, size=10)
    if q == CASES[1]:  # order matters: only "brown quick" in order
        assert sorted(h["_id"] for h in got["hits"]["hits"]) == ["s2", "s5"]
    if q == CASES[2]:
        assert [h["_id"] for h in got["hits"]["hits"]] == ["s0"]


def test_phrase_frequency_ranks_first(small):
    got = small.check("freq", query={"match_phrase": {"body": "quick brown"}}, size=10)
    assert got["hits"]["hits"][0]["_id"] == "s5"  # three occurrences


def test_position_gap_between_values(small):
    got = small.check("gap", query={"match_phrase": {"body": "fox and"}}, size=10)
    assert got["hits"]["total"]["value"] == 0
    got = small.check("gap2", query={"match_phrase": {"body": "brown fox"}}, size=10)
    assert "mv" in {h["_id"] for h in got["hits"]["hits"]}


def test_slop_is_refused(small):
    with pytest.raises(IllegalArgumentError, match="slop"):
        small.port.search({"match_phrase": {"body": {"query": "quick fox", "slop": 1}}})
    with pytest.raises(Exception, match="slop"):
        small.ref.search(query={"match_phrase": {"body": {"query": "quick fox", "slop": 1}}})


@pytest.fixture(scope="module")
def corpus():
    docs = text_docs(7, 700)
    rng = np.random.default_rng(8)
    phrases = []
    for _ in range(24):
        words = docs[int(rng.integers(0, len(docs)))][1]["body"].split()
        while len(words) < 4:
            words = docs[int(rng.integers(0, len(docs)))][1]["body"].split()
        s = int(rng.integers(0, len(words) - 3))
        phrases.append(words[s: s + 2 + int(rng.integers(0, 2))])
    return docs, phrases


def _phrase_queries(phrases):
    qs = [{"match_phrase": {"body": " ".join(w)}} for w in phrases[:10]]
    qs += [{"match_phrase_prefix": {"body": " ".join(w[:-1]) + " " + w[-1][:2]}}
           for w in phrases[10:16]]
    qs += [{"multi_match": {"query": " ".join(w), "fields": ["body", "title"], "type": "phrase"}}
           for w in phrases[16:20]]
    qs += [{"bool": {"must": [{"match_phrase": {"body": " ".join(w)}}],
                     "filter": [{"range": {"n": {"lt": 30}}}]}} for w in phrases[20:]]
    return qs


@pytest.mark.parametrize("shards", [1, 3])
def test_corpus_phrases_match_reference(corpus, shards):
    docs, phrases = corpus
    p = Pair(MAPPING, {"number_of_shards": shards})
    try:
        p.index(docs)
        p.refresh()
        for q in _phrase_queries(phrases):
            got = p.check(f"{shards} shards", query=q, size=15)
            if "match_phrase" in q:
                assert got["hits"]["total"]["value"] >= 1  # drawn from a doc
    finally:
        p.close()


def test_phrases_on_tiers_match_reference(corpus):
    """Base + two tail segments: each tier evaluates the phrase under the
    combined statistics and the hits merge, in both packages."""
    docs, phrases = corpus
    p = Pair(MAPPING)
    try:
        p.index(docs[:500])
        p.refresh()
        p.index(docs[500:600])
        p.refresh()
        p.index(docs[600:])
        p.index([("d3", {"body": "w0 w1 w2 w3", "n": 1})])  # an update into a tail
        p.refresh()
        assert len(p.port._tails) == 2 and len(p.ref._tails) == 2
        qs = _phrase_queries(phrases)
        for q in qs[:10] + qs[20:]:
            p.check("tiers", query=q, size=10)
        assert len(p.port._tails) == 2  # served per tier, not merged
        # a phrase prefix expands over one dictionary: the tiers merge first
        p.check("merged", query=qs[10], size=10)
        assert len(p.port._tails) == 0 and len(p.ref._tails) == 0
    finally:
        p.close()


def test_wave_with_phrase_entries_equals_solo(corpus):
    docs, phrases = corpus
    p = Pair(MAPPING)
    try:
        p.index(docs)
        p.refresh()
        entries = [{"query": q, "size": 5} for q in _phrase_queries(phrases)[:8]]
        entries.append({"query": {"match": {"body": "w1 w2"}}, "size": 5})
        wave = p.port.search_wave(entries)
        for e, r in zip(entries, wave):
            assert r == p.port.search(**e)
    finally:
        p.close()


def test_stacked_position_keys_equal_reference(corpus):
    docs, _ = corpus
    ref = ref_build_stacked(docs, RefMappings(MAPPING), 3)
    port = build_stacked_pack(docs, Mappings(MAPPING), 3)
    assert port.pos_keys.dtype == ref.pos_keys.dtype and port.pos_keys.shape == ref.pos_keys.shape
    assert port.pos_keys.tobytes() == ref.pos_keys.tobytes()
    for s in range(3):
        for key in [("body", "w0"), ("body", "w5"), ("title", "w1"), ("body", "nope")]:
            assert port.shard_view(s).term_pos_blocks(*key) == \
                ref.shard_view(s).term_pos_blocks(*key)
    assert port.nbytes() >= port.pos_keys.nbytes


def test_phrase_frequency_counts_in_int32(corpus):
    """The phrase frequency is an integer count: a phrase repeated in one
    doc scores from tf = its occurrences, and a node run twice gives the
    same bits."""
    m = Mappings(MAPPING)
    p = Pair(MAPPING)
    try:
        p.index([("a", {"body": "x y x y x y z"}), ("b", {"body": "x y z"})])
        p.refresh()
        s = p.port.searcher
        node = parse_query({"match_phrase": {"body": "x y"}}, m)
        assert isinstance(node, PhraseNode)
        a = node.device_eval(s.dev, node.prepare(s.view), s.ctx)
        b = node.device_eval(s.dev, node.prepare(s.view), s.ctx)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert a[1][:2].tolist() == [True, True] and a[0][0] > a[0][1]
        p.check("tf", query={"match_phrase": {"body": "x y"}}, size=5)
    finally:
        p.close()
