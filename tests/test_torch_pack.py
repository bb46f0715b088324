"""The port's PackBuilder against the JAX package's, on the same documents.

Both builders pack the same ~3,000 seeded documents (a Zipf vocabulary of
400 terms, a low dense_min_df so the dense tier is populated, one long, one
keyword and one float field). Every array the port carries must be
byte-equal, and term_dict / field_stats / dense_dict equal, the impact
tier for both of its storage types too, and the position keys (a
multi-valued text field, its 100-position gap, and a doc whose tail passes
POS_L - 64 included). `convert.py` must turn the
reference pack into one that searches exactly like the port-built pack,
with or without the impact tier.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.pack import PackBuilder as RefPackBuilder
from elasticsearch_tpu_torch.analysis import StandardAnalyzer
from elasticsearch_tpu_torch.convert import pack_from_reference
from elasticsearch_tpu_torch.corpus import corpus_docs, make_corpus, traffic
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.query.executor import ShardSearcher
from elasticsearch_tpu_torch.query.nodes import mark_exact
from elasticsearch_tpu_torch.utils.errors import MapperParsingError

N_DOCS, VOCAB, DENSE_MIN_DF = 3000, 400, 100
MAPPING = {"properties": {
    "body": {"type": "text"}, "n": {"type": "long"},
    "tag": {"type": "keyword"}, "f": {"type": "float"},
}}
ARRAYS = ["post_docids", "post_tfs", "post_dls", "term_block_start", "term_df",
          "block_max_tf", "block_min_len", "live", "dense_tfn",
          "pos_keys", "term_pos_start", "term_pos_count"]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    lens, tok, nums = make_corpus(rng, N_DOCS, vocab=VOCAB, mean_len=12)
    docs = corpus_docs(lens, tok, nums, vocab=VOCAB)
    for d in docs:
        d["tag"] = f"k{int(rng.integers(0, 20))}"
        d["f"] = float(rng.random())
    docs[5]["body"] = "Café NAÏVE don't " + docs[5]["body"]  # non-ASCII analysis
    del docs[7]["tag"]  # a doc without the keyword
    docs[9]["body"] = [docs[9]["body"], "", "second value t1 t2"]  # multi-valued text
    # a doc whose positions pass POS_L - 64: its tail is not stored
    docs[11]["body"] = " ".join(f"t{i % 40}" for i in range(131_100))
    queries = traffic(rng, lens, tok, 20, 5, 5)
    return docs, queries


def _ref_pack(docs):
    m = RefMappings(MAPPING)
    b = RefPackBuilder(m)
    b.add_documents_batch([m.parse_document(d) for d in docs],
                          doc_ids=[str(i) for i in range(len(docs))])
    return b.build(dense_min_df=DENSE_MIN_DF)


def _port_pack(docs, batch: bool):
    m = Mappings(MAPPING)
    b = PackBuilder(m)
    parsed = [m.parse_document(d) for d in docs]
    ids = [str(i) for i in range(len(docs))]
    if batch:
        b.add_documents_batch(parsed, doc_ids=ids)
    else:
        for p, i in zip(parsed, ids):
            b.add_document(p, doc_id=i)
    return b.build(dense_min_df=DENSE_MIN_DF), m


@pytest.mark.parametrize("batch", [True, False], ids=["batch", "per_doc"])
def test_pack_arrays_byte_equal(corpus, batch):
    docs, _ = corpus
    ref = _ref_pack(docs)
    port, _ = _port_pack(docs, batch)
    assert port.num_docs == ref.num_docs
    assert ref.dense_tfn is not None and ref.dense_tfn.shape[0] >= 128
    for name in ARRAYS:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert port.term_dict == ref.term_dict
    assert list(port.term_dict) == list(ref.term_dict)  # sorted (field, term)
    assert port.field_stats == ref.field_stats
    assert port.dense_dict == ref.dense_dict
    assert set(port.norms) == set(ref.norms)
    for f in ref.norms:
        assert port.norms[f].tobytes() == ref.norms[f].tobytes()
        assert port.text_present[f].tobytes() == ref.text_present[f].tobytes()
    assert set(port.docvalues) == set(ref.docvalues) == {"_id", "n", "tag", "f"}
    for f, col in ref.docvalues.items():
        pc = port.docvalues[f]
        assert pc.kind == col.kind
        assert pc.values.dtype == col.values.dtype
        assert pc.values.tobytes() == col.values.tobytes()
        assert pc.has_value.tobytes() == col.has_value.tobytes()
        assert pc.ord_terms == col.ord_terms


@pytest.mark.parametrize("as_dict", [False, True], ids=["object", "dict"])
def test_converted_reference_pack_searches_identically(corpus, as_dict):
    docs, queries = corpus
    ref = _ref_pack(docs)
    src = ref
    if as_dict:
        src = {name: getattr(ref, name) for name in (
            ARRAYS + ["num_docs", "term_dict", "norms", "text_present",
                      "field_stats", "docvalues", "dense_dict"])}
    converted = pack_from_reference(src)
    port, m = _port_pack(docs, batch=True)
    a = ShardSearcher(converted, device="cpu", mappings=m)
    b = ShardSearcher(port, device="cpu", mappings=m)
    assert (converted.impact_codes is None) == as_dict  # the dict carries no impact tier
    for q in queries:
        for size, from_ in ((10, 0), (20, 5)):
            # without the tier the converted pack scores exact BM25: so does b
            qb = mark_exact(parse_query(q, m)) if as_dict else q
            ra, rb = a.search(q, size, from_), b.search(qb, size, from_)
            assert ra.total == rb.total
            np.testing.assert_array_equal(ra.doc_ids, rb.doc_ids)
            np.testing.assert_array_equal(ra.scores, rb.scores)
            assert ra.max_score == rb.max_score


def test_convert_rejects_wrong_dtype(corpus):
    docs, _ = corpus
    ref = _ref_pack(docs[:50])
    bad = {name: getattr(ref, name) for name in (
        ARRAYS + ["num_docs", "term_dict", "norms", "text_present",
                  "field_stats", "docvalues", "dense_dict"])}
    bad["post_tfs"] = bad["post_tfs"].astype(np.float64)
    with pytest.raises(ValueError, match="post_tfs"):
        pack_from_reference(bad)


@pytest.mark.parametrize("text", [
    "Hello World", "don't STOP", "naïve café Ünïcode", "a_b c-d 42x", "x" * 300,
    "Ǆemal ﬁne", "",
])
def test_analyzer_terms_match_reference(text):
    from elasticsearch_tpu.analysis.analyzers import StandardAnalyzer as RefStandard

    ours, ref = StandardAnalyzer(), RefStandard()
    assert ours.terms(text) == [t.term for t in ref.analyze(text)]
    assert [(t.term, t.position) for t in ours.analyze(text)] == \
        [(t.term, t.position) for t in ref.analyze(text)]


@pytest.mark.parametrize("mapping,doc", [
    ({"properties": {"d": {"type": "completion"}}}, None),
    ({"properties": {"o": {"properties": {"v": {"type": "completion"}}}}}, None),
    ({"properties": {"n": {"type": "nested", "properties": {"s": {"type": "completion"}}}}},
     {"n": [{"s": "x"}]}),
    ({"properties": {"k": {"type": "keyword", "fields": {"n": {"type": "completion"}}}}},
     {"k": "2024-01-02"}),
])
def test_unported_types_raise(mapping, doc):
    """`completion` maps at the top level, inside an object or a nested
    object, and parses as the reference's does; as a keyword's sub-field
    it answers the reference's "unsupported type" at parse time. A type
    that neither package knows answers the reference's "no handler for
    type" at each of these places (the other types: tests/test_torch_dates.py,
    tests/test_torch_types.py)."""
    from elasticsearch_tpu.index.mappings import Mappings as RefMappings
    from elasticsearch_tpu.utils.errors import MapperParsingError as RefMapperParsingError

    def outcome(mappings_cls, error_cls, m):
        try:
            mm = mappings_cls(m)
            return ("ok", mm.parse_document(doc or {}),
                    {f: ft.type for f, ft in mm.fields.items()})
        except error_cls as ex:
            return ("error", ex.status, str(ex))

    got = outcome(Mappings, MapperParsingError, mapping)
    assert got == outcome(RefMappings, RefMapperParsingError, mapping)
    assert got[0] == ("error" if "fields" in json.dumps(mapping) else "ok")
    unknown = json.loads(json.dumps(mapping).replace('"completion"', '"no_such_type"'))
    got = outcome(Mappings, MapperParsingError, unknown)
    assert got[0] == "error" and got[1] == 400
    assert got == outcome(RefMappings, RefMapperParsingError, unknown)


@pytest.mark.parametrize("dtype", ["uint16", "int8"])
def test_impact_tier_byte_equal(corpus, monkeypatch, dtype):
    """The impact codes, per-term bounds and quantization contract are
    byte-equal to the reference's for both storage types."""
    docs, _ = corpus
    monkeypatch.setenv("ES_TPU_IMPACT_DTYPE", dtype)
    ref = _ref_pack(docs)
    m = Mappings(MAPPING)
    b = PackBuilder(m, impact_dtype=dtype)
    b.add_documents_batch([m.parse_document(d) for d in docs],
                          doc_ids=[str(i) for i in range(len(docs))])
    port = b.build(dense_min_df=DENSE_MIN_DF)
    assert ref.impact_meta["dtype"] == dtype
    for name in ("impact_codes", "impact_ubf"):
        a, p = getattr(ref, name), getattr(port, name)
        assert a.dtype == p.dtype and a.shape == p.shape, name
        assert a.tobytes() == p.tobytes(), name
    assert port.impact_meta == ref.impact_meta
    for key in list(ref.term_dict)[::37]:
        assert port.impact_wscale(*key) == ref.impact_wscale(*key)
    assert port.impact_wscale("body", "no-such-term") is None


def test_pack_builder_rejects_unknown_impact_dtype():
    with pytest.raises(ValueError, match="impact_dtype"):
        PackBuilder(Mappings(MAPPING), impact_dtype="float16")


@pytest.mark.parametrize("with_tier", [True, False], ids=["with_impact", "without_impact"])
def test_convert_carries_impact_tier(corpus, with_tier):
    """convert.py carries the impact tier across, or, from a source without
    it, gives a pack with no impact tier that searches the same."""
    docs, queries = corpus
    ref = _ref_pack(docs)
    src = {name: getattr(ref, name) for name in (
        ARRAYS + ["num_docs", "term_dict", "norms", "text_present",
                  "field_stats", "docvalues", "dense_dict"])}
    if with_tier:
        src.update(impact_codes=ref.impact_codes, impact_ubf=ref.impact_ubf,
                   impact_meta=ref.impact_meta)
    converted = pack_from_reference(src)
    port, m = _port_pack(docs, batch=True)
    if with_tier:
        assert converted.impact_codes.tobytes() == ref.impact_codes.tobytes()
        assert converted.impact_ubf.tobytes() == ref.impact_ubf.tobytes()
        assert converted.impact_meta == ref.impact_meta
    else:
        assert converted.impact_codes is None and converted.impact_meta is None
        assert converted.impact_wscale("body", "t3") is None
    searcher = ShardSearcher(converted, device="cpu", mappings=m)
    assert ("impact_codes" in searcher.dev) == with_tier
    if with_tier:
        assert searcher.dev["impact_codes"].dtype == torch.uint16
    b = ShardSearcher(port, device="cpu", mappings=m)
    for q in queries[:10]:
        ra, rb = searcher.search(q, 10, 0), b.search(q, 10, 0)
        assert ra.total == rb.total
        np.testing.assert_array_equal(ra.doc_ids, rb.doc_ids)
