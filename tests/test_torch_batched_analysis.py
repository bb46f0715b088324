"""The port's batched text analysis (`analysis/batched.py`) against the
oracle `StandardAnalyzer.analyze` and the JAX package's `BatchedAnalyzer`.

The value streams (terms, value index, within-value position, last position
and token count per value) and the burst streams (terms, doc index,
positions chained with the +100 multi-value gap, tokens per doc) of the
host, batched and device modes must equal the oracle's and the JAX
package's in each of its modes (its device mode forced with
ES_TPU_ANALYZE=device, its kernel run by JAX on the CPU). The texts cover
case, digits, underscores, one and two apostrophes, leading and trailing
apostrophes, `’`, é and CJK, tokens over 255 characters, empty values,
multi-valued fields and docs with no token. With the hash multipliers
lowered so that distinct tokens collide, the device path must still give
the oracle's terms: the port never merges two terms. Tolerance: none.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis.analyzers import StandardAnalyzer as RefStandard
from elasticsearch_tpu.analysis.batched import BatchedAnalyzer as RefBatched
from elasticsearch_tpu.analysis.batched import analyze_burst as ref_analyze_burst
from elasticsearch_tpu_torch.analysis import StandardAnalyzer
from elasticsearch_tpu_torch.analysis.batched import BatchedAnalyzer, analyze_burst
from elasticsearch_tpu_torch.index import device_build as db
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import PackBuilder

MODES = ["host", "batched", "device"]
REF_MODES = ["host", "batched", "device"]

TEXTS = [
    "The quick brown Fox jumps over the lazy dog",
    "",
    "   \t\n  ",
    "don't stop BELIEVIN' it's l'heure",
    "a'b'c rock'n'roll ''quoted'' trailin' 'lead x'' ''y",
    "café résumé naïve",
    "café decomposed vs café composed",
    "日本語のテキスト and ascii words",
    "under_scores and-hyphens 42 3.14 v2 x86_64",
    "x" * 300 + " short tail",
    "it’s the curly one’s",
    "MiXeD CaSe 123abc ABC123 a1b2c3",
    "'",
    "''''",
    "o'",
    "'o",
    "z" * 255 + " " + "y" * 256,
    "end with apostrophe'",
]


def _random_texts(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    atoms = ["ab", "CD", "e", "9", "_", "'", " ", "  ", "-", ".", "x'y", "é", "’", "日",
             "Q", "q", "don't", "\t", "A1", "k"]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 30))
        out.append("".join(rng.choice(atoms, k)))
    out.append("w" * 600)
    return out


VALUES = TEXTS + _random_texts(7, 400)


def _oracle(values):
    an = StandardAnalyzer()
    terms, vidx, pos, last, counts = [], [], [], [], []
    for i, v in enumerate(values):
        toks = an.analyze(v)
        terms += [t.term for t in toks]
        vidx += [i] * len(toks)
        pos += [t.position for t in toks]
        last.append(toks[-1].position if toks else -1)
        counts.append(len(toks))
    return terms, vidx, pos, last, counts


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _value_streams(vt):
    return (list(vt.term_strings()), _np(vt.value_idx).tolist(), _np(vt.pos_pre).tolist(),
            _np(vt.last_pos).tolist(), _np(vt.counts).tolist())


@pytest.mark.parametrize("mode", MODES)
def test_value_streams_equal_oracle(mode):
    vt = BatchedAnalyzer(StandardAnalyzer()).analyze_values(VALUES, mode=mode, device="cpu")
    assert vt.basis == ("device" if mode == "device" else "host")
    assert _value_streams(vt) == tuple(_oracle(VALUES))


@pytest.mark.parametrize("ref_mode", REF_MODES)
@pytest.mark.parametrize("mode", MODES)
def test_value_streams_equal_reference(mode, ref_mode, monkeypatch):
    monkeypatch.setenv("ES_TPU_ANALYZE", ref_mode)
    want = RefBatched(RefStandard()).analyze_values(VALUES, mode=ref_mode)
    got = BatchedAnalyzer(StandardAnalyzer()).analyze_values(VALUES, mode=mode, device="cpu")
    assert _value_streams(got) == (list(want.terms), want.value_idx.tolist(),
                                   want.pos_pre.tolist(), want.last_pos.tolist(),
                                   want.counts.tolist())


def _burst_input(seed: int):
    """Docs of 0-3 values each (multi-valued, empty values, no-token docs)."""
    rng = np.random.default_rng(seed)
    values, vdoc = [], []
    pool = VALUES
    for d in range(150):
        for _ in range(int(rng.integers(0, 4))):
            values.append(pool[int(rng.integers(0, len(pool)))])
            vdoc.append(d)
    return values, np.asarray(vdoc, np.int64), 150


@pytest.mark.parametrize("ref_mode", ["batched", "device"])
@pytest.mark.parametrize("mode", MODES)
def test_burst_streams_equal_reference(mode, ref_mode, monkeypatch):
    monkeypatch.setenv("ES_TPU_ANALYZE", ref_mode)
    values, vdoc, n = _burst_input(3)
    want = ref_analyze_burst(RefBatched(RefStandard()), values, vdoc, n, mode=ref_mode)
    got = analyze_burst(BatchedAnalyzer(StandardAnalyzer()), values, vdoc, n, mode=mode,
                        device="cpu")
    assert list(got.term_strings()) == list(want.terms)
    assert _np(got.doc_idx).tolist() == want.doc_idx.tolist()
    assert _np(got.positions).tolist() == want.positions.tolist()
    assert got.lengths.tolist() == want.lengths.tolist()
    assert len(got.lengths) == n and got.lengths[-1] >= 0


def test_burst_positions_chain_the_multi_value_gap():
    vt = analyze_burst(BatchedAnalyzer(StandardAnalyzer()), ["a b", "", "c", "d e f"],
                       [0, 0, 0, 1], 3, mode="device", device="cpu")
    assert list(vt.term_strings()) == ["a", "b", "c", "d", "e", "f"]
    assert _np(vt.positions).tolist() == [0, 1, 202, 0, 1, 2]
    assert vt.lengths.tolist() == [3, 3, 0]


@pytest.mark.parametrize("mults", [(1, 1), (2, 3), (31, 1)])
def test_forced_hash_collisions_keep_the_oracle_terms(mults, monkeypatch):
    """With tiny multipliers anagrams and more collide on (h1, h2, length);
    the byte comparison sends their values to the host path."""
    monkeypatch.setattr(db, "HASH_MULT_1", mults[0])
    monkeypatch.setattr(db, "HASH_MULT_2", mults[1])
    values = ["ab ba", "abc cab bca", "ab", "ba ab", "listen silent enlist", "x"] + VALUES
    vt = BatchedAnalyzer(StandardAnalyzer()).analyze_values(values, mode="device", device="cpu")
    assert vt.basis == "device"
    assert _value_streams(vt) == tuple(_oracle(values))
    assert len(set(vt.vocab)) == len(vt.vocab)  # no term listed twice


def test_forced_collisions_pack_equals_host_route(monkeypatch):
    docs = [{"body": v} for v in ["ab ba", "stop pots tops", "ba", "spot post"] + VALUES[:60]]
    m = Mappings({"properties": {"body": {"type": "text"}}})

    def pack(device):
        b = PackBuilder(m, device=device)
        b.add_documents_batch([m.parse_document(d) for d in docs])
        return b.build(dense_min_df=3)

    want = pack(None)
    monkeypatch.setattr(db, "HASH_MULT_1", 1)
    monkeypatch.setattr(db, "HASH_MULT_2", 1)
    monkeypatch.setattr(db, "DEVICE_BUILD_MIN", 0)
    monkeypatch.setattr(db, "ANALYZE_DEVICE_MIN", 0)
    monkeypatch.setattr(db, "use_device_build", lambda e, d, floor=None: d is not None)
    got = pack("cpu")
    assert got.term_dict == want.term_dict
    for name in ("post_docids", "post_tfs", "pos_keys", "impact_codes"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes(), name
    assert _np(got.dense_tfn).tobytes() == want.dense_tfn.tobytes()


def test_device_path_falls_back_value_by_value():
    values = ["plain ascii", "café", "a'b'c", "q" * 300, "", "ok again"]
    vt = BatchedAnalyzer(StandardAnalyzer()).analyze_values(values, mode="device", device="cpu")
    assert _value_streams(vt) == tuple(_oracle(values))
    assert vt.basis == "device" and {"café", "a'b", "c"} <= set(vt.vocab)
    vt = BatchedAnalyzer(StandardAnalyzer()).analyze_values(["é"], mode="device", device="cpu")
    assert vt.basis == "host" and list(vt.terms) == ["é"]


def test_stopwords_analyzer_takes_the_batched_path():
    an = StandardAnalyzer(stopwords=["the", "a"])
    ba = BatchedAnalyzer(an)
    assert not ba.device_eligible
    values = ["the cat and a dog", "a", "The End"]
    vt = ba.analyze_values(values, mode="device", device="cpu")
    assert vt.basis == "host"
    want = [[(t.term, t.position) for t in an.analyze(v)] for v in values]
    got_terms, got_pos = list(vt.terms), vt.pos_pre.tolist()
    assert [(t, p) for t, p in zip(got_terms, got_pos)] == [x for w in want for x in w]


def test_auto_route_is_batched_off_the_card():
    """mode None: the device path only on the card above the byte floor."""
    values = ["hello world"] * 10_000
    vt = analyze_burst(BatchedAnalyzer(StandardAnalyzer()), values, np.arange(10_000), 10_000,
                       device="cpu")
    assert vt.basis == "host" and vt.terms is not None
    assert not db.use_device_build(sum(map(len, values)), "cpu", db.ANALYZE_DEVICE_MIN)


def test_batched_analyzer_memo_follows_the_analyzer():
    m = Mappings({"properties": {"body": {"type": "text"}}})
    ft = m.fields["body"]
    a = ft.get_batched_analyzer()
    assert ft.get_batched_analyzer() is a and a.analyzer is ft.get_analyzer()
    ft._analyzer_obj = None  # a rebuilt analyzer gets a new batched twin
    b = ft.get_batched_analyzer()
    assert b is not a and b.analyzer is ft.get_analyzer()
