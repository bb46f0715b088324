"""The port's `_search` over several indices (`Engine.search_multi`: the
fan-out and the coordinator's merge) and its can-match pre-filter
(`search/canmatch.py`) against the JAX package's.

The reference's tests/test_canmatch.py runs through both packages' REST
apps. Then seeded daily log indices in both packages, on 1 and 3 shards,
on a fresh base and after a tiered refresh (new docs, updates, deletes):
`match`, `range` (required by a `bool`, a `constant_score`, or at the top),
field sorts with `missing`, paging, `collapse`, `track_total_hits` off, a
range on an unmapped field, wildcard and `_all` expressions; `can_match`
alone on each index for seeded ranges; the 400s of aggs and knn over
several indices; `_shards` over REST. Then the failure envelope: a search
error of one index becomes a `_shards.failures` entry (and the request a
503 when every index failed, or when partial results are refused), while a
kernel launch error, in a search or in can-match's refresh, propagates.

Tolerances: `torch_parity.same_hits` (totals equal, scores within 1e-6
relative, ids up to fp-ties, sorted hits up to full-key ties; after a
tiered refresh, scores and ids within the impact tier's quantization tie
class, `torch_parity.impact_tie`, where a tail segment scores), the
skipped and failed shard counts `==`, can_match's answers `==`.
"""

import numpy as np
import pytest

from elasticsearch_tpu.engine import Engine as RefEngine
from elasticsearch_tpu.search.canmatch import can_match as ref_can_match
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.ops import scoring as port_scoring
from elasticsearch_tpu_torch.search.canmatch import can_match
from elasticsearch_tpu_torch.utils.errors import (IllegalArgumentError, QueryParsingError,
                                                  SearchPhaseExecutionError)
from torch_parity import impact_tie, rest_both, same_hits, sorted_ties_hold


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")


DAY_MS = 86_400_000
T0 = 1_704_067_200_000  # 2024-01-01
LOG_MAPPING = {"properties": {"@timestamp": {"type": "date"}, "body": {"type": "text"},
                              "n": {"type": "long"}, "tag": {"type": "keyword"},
                              "p": {"type": "double"}}}


def log_docs(seed: int, day0: int, days: int, n: int, prefix: str, vocab: int = 40) -> list:
    """(id, source) docs over `days` days from `day0`: a Zipf `body`, a
    long `n`, a keyword `tag` (missing on some) and a double `p` (missing
    on some)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        words = rng.choice(vocab, size=int(rng.integers(2, 12)), p=p)
        src = {"@timestamp": T0 + (day0 + int(rng.integers(0, days))) * DAY_MS
               + int(rng.integers(0, DAY_MS)),
               "body": " ".join(f"w{w}" for w in words), "n": int(rng.integers(0, 100))}
        if i % 5:
            src["tag"] = f"k{int(rng.integers(0, 9))}"
        if i % 4:
            src["p"] = float(rng.choice([-1.5, 0.0, 2.25, 3.0, 7.5]))
        docs.append((f"{prefix}-{i}", src))
    return docs


class Multi:
    """The same indices in both packages (reference `Engine(None)`, port
    `Engine(device="cpu")`)."""

    def __init__(self, names, shards: int, mapping=LOG_MAPPING):
        self.ref, self.port = RefEngine(None), Engine(device="cpu")
        for name in names:
            for e in (self.ref, self.port):
                e.create_index(name, mapping, {"number_of_shards": shards})

    def close(self):
        self.ref.close()
        self.port.close()

    def index(self, name, docs):
        for e in (self.ref, self.port):
            idx = e.get_index(name)
            for i, d in docs:
                idx.index_doc(i, d)

    def delete(self, name, ids):
        for e in (self.ref, self.port):
            for i in ids:
                e.get_index(name).delete_doc(i)

    def refresh(self):
        for e in (self.ref, self.port):
            for idx in e.indices.values():
                idx.refresh()

    def search(self, expression, **kw):
        return (self.port.search_multi(expression, **kw),
                self.ref.search_multi(expression, **kw))


NAMES = ("logs-0", "logs-1", "logs-2")


def build(shards: int, tiered: bool, seed: int = 3) -> Multi:
    m = Multi(NAMES, shards)
    for k, name in enumerate(NAMES):
        m.index(name, log_docs(seed + k, 5 * k, 5, 120, name))
    m.refresh()
    if tiered:
        rng = np.random.default_rng(seed + 10)
        for k, name in enumerate(NAMES):
            new = log_docs(seed + 20 + k, 5 * k, 5, 30, name)
            new = [(f"{i}-new" if j % 2 else i, d) for j, (i, d) in enumerate(new)]
            m.index(name, new)  # half update ids of the base, half are new
            m.delete(name, sorted({f"{name}-{int(x)}" for x in rng.integers(30, 120, 12)}))
        m.refresh()
        assert all(m.port.get_index(n)._tails for n in NAMES)
    return m


def days(a: int, b: int) -> dict:
    return {"gte": T0 + a * DAY_MS, "lt": T0 + b * DAY_MS}


def requests(seed: int) -> list:
    """(expression, kwargs) of the seeded multi-index searches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        w = " ".join(f"w{int(x)}" for x in rng.integers(0, 30, 2))
        a = int(rng.integers(0, 14))
        out += [
            ("logs-*", {"query": {"match": {"body": w}}, "size": 10}),
            ("logs-0,logs-1,logs-2", {"query": {"bool": {
                "must": [{"match": {"body": w}}],
                "filter": [{"range": {"@timestamp": days(a, a + 3)}}]}}, "size": 15}),
            ("_all", {"query": {"constant_score": {"filter": {"range": {
                "@timestamp": days(a, a + 1)}}}}, "size": 5, "from_": 2}),
            ("logs-*", {"query": {"range": {"n": {"gte": int(rng.integers(0, 90))}}},
                        "size": 8, "from_": int(rng.integers(0, 6))}),
        ]
    out += [
        ("logs-*", {"query": {"match": {"body": "w1 w2"}}, "sort": [{"@timestamp": "desc"}],
                    "size": 30}),
        ("logs-*", {"query": None, "sort": [{"tag": "asc"}, {"n": "desc"}], "size": 25,
                    "from_": 5}),
        ("logs-*", {"query": {"match": {"body": "w0"}},
                    "sort": [{"p": {"order": "desc", "missing": "_first"}}], "size": 40}),
        ("logs-*", {"query": {"match": {"body": "w0"}}, "sort": [{"tag": "desc"}], "size": 40}),
        ("logs-*", {"query": {"match": {"body": "w3 w4"}}, "collapse": {"field": "tag"},
                    "size": 12}),
        ("logs-*", {"query": {"match": {"body": "w5"}}, "track_total_hits": False}),
        ("logs-*", {"query": {"range": {"missing_field": {"gte": 1}}}}),
        ("logs-*", {"query": {"range": {"@timestamp": {"gte": T0 + 100 * DAY_MS}}}}),
        ("logs-1,logs-2", {"query": {"bool": {"filter": [{"range": {"n": {"gt": 98}}}]}},
                           "size": 50}),
    ]
    return out


@pytest.mark.parametrize("tiered", [False, True], ids=["fresh", "tiered"])
@pytest.mark.parametrize("shards", [1, 3])
def test_multi_index_search_matches_reference(shards, tiered):
    m = build(shards, tiered)
    try:
        skipped = 0
        for expression, kw in requests(shards + 2 * tiered):
            tie = max(impact_tie(m.port.get_index(n), kw.get("query")) for n in NAMES) \
                if tiered else 0.0
            got, want = m.search(expression, **kw)
            what = f"{expression} {kw}"
            assert got["skipped_shards"] == want["skipped_shards"], what
            assert "failed_shards" not in got and "failed_shards" not in want, what
            same_hits(got, want, what, tie)
            if kw.get("sort"):
                sorted_ties_hold(got, want)
            skipped += got["skipped_shards"]
        assert skipped > 0
    finally:
        m.close()


@pytest.mark.parametrize("tiered", [False, True], ids=["fresh", "tiered"])
@pytest.mark.parametrize("shards", [1, 3])
def test_can_match_matches_reference(shards, tiered):
    m = build(shards, tiered, seed=7)
    try:
        rng = np.random.default_rng(shards)
        queries = [{"range": {"@timestamp": days(a, a + int(w))}}
                   for a, w in zip(rng.integers(-3, 18, 12), rng.integers(1, 4, 12))]
        queries += [{"range": {"n": {op: int(v)}}} for op, v in
                    zip(["gte", "gt", "lte", "lt"] * 3, rng.integers(-5, 110, 12))]
        queries += [
            {"range": {"p": {"gt": 7.5}}}, {"range": {"p": {"gte": 7.5}}},
            {"range": {"p": {"lt": -1.5}}}, {"range": {"tag": {"gte": "k3"}}},
            {"range": {"nope": {"gte": 0}}}, {"range": {"@timestamp": {"gte": "not a date"}}},
            {"range": {"n": {"gte": "abc"}}}, {"match": {"body": "w1"}}, None,
            {"bool": {"must": {"range": {"n": {"gt": 200}}}}},
            {"bool": {"should": [{"range": {"n": {"gt": 200}}}]}},
            {"bool": {"filter": [{"range": {"n": {"gte": 0}}},
                                 {"bool": {"must": [{"range": {"@timestamp": days(50, 60)}}]}}]}},
            {"constant_score": {"filter": {"range": {"@timestamp": days(-5, 0)}}}},
        ]
        answers = []
        for q in queries:
            for name in NAMES:
                got = can_match(m.port.get_index(name), q)
                assert got == ref_can_match(m.ref.get_index(name), q), (name, q)
                answers.append(got)
        assert True in answers and False in answers
    finally:
        m.close()


def test_canmatch_skips_out_of_range_indices(tmp_path):
    """The reference's tests/test_canmatch.py through both apps."""
    seq = []
    for month, idx in (("01", "logs-1"), ("02", "logs-2"), ("03", "logs-3")):
        seq.append((f"put {idx}", "PUT", f"/{idx}", {"mappings": {"properties": {
            "@timestamp": {"type": "date"}, "msg": {"type": "text"}}}}, {}))
        for d in ("05", "15"):
            seq.append((f"doc {month}-{d}", "PUT", f"/{idx}/_doc/{month}-{d}",
                        {"@timestamp": f"2024-{month}-{d}", "msg": f"event {month} {d}"},
                        {"refresh": "true"}))
    path = "/logs-1,logs-2,logs-3/_search"
    seq += [
        ("feb", "POST", path, {"query": {"bool": {"filter": [
            {"range": {"@timestamp": {"gte": "2024-02-01", "lt": "2024-03-01"}}}]}}}, {}),
        ("all3", "POST", path, {"query": {"range": {"@timestamp": {"gte": "2024-01-10"}}}}, {}),
        ("unmapped", "POST", path, {"query": {"range": {"nope": {"gte": 1}}}}, {}),
        ("match", "POST", path, {"query": {"match": {"msg": "event"}}}, {}),
        ("wild", "POST", "/logs-*/_search", {"query": {"match": {"msg": "event 02"}},
                                             "size": 3}, {}),
        ("sorted", "POST", path, {"sort": [{"@timestamp": "desc"}], "size": 4}, {}),
        ("aggs", "POST", path, {"aggs": {"t": {"terms": {"field": "msg"}}}}, {}),
    ]
    port, ref = rest_both(seq, tmp_path)
    for name in port:
        assert port[name][0] == ref[name][0], name
    for name in ("feb", "all3", "unmapped", "match", "wild", "sorted"):
        (_s, got), (_r, want) = port[name], ref[name]
        assert got["_shards"] == want["_shards"], name
        same_hits(got, want, name)
    assert port["feb"][1]["_shards"]["skipped"] == 2
    assert {h["_index"] for h in port["feb"][1]["hits"]["hits"]} == {"logs-2"}
    assert port["all3"][1]["_shards"]["skipped"] == 0
    assert port["all3"][1]["hits"]["total"]["value"] == 5
    assert port["unmapped"][1]["_shards"]["skipped"] == 3
    assert port["match"][1]["hits"]["total"]["value"] == 6
    assert port["aggs"][1]["error"]["type"] == ref["aggs"][1]["error"]["type"]
    assert port["aggs"][1]["error"]["reason"] == ref["aggs"][1]["error"]["reason"]


def test_aggs_and_knn_over_several_indices_answer_the_reference_400s():
    m = Multi(NAMES[:2], 1)
    try:
        for kw in ({"aggs": {"t": {"terms": {"field": "tag"}}}},
                   {"knn": {"field": "v", "query_vector": [1.0], "k": 1}}):
            with pytest.raises(IllegalArgumentError) as got:
                m.port.search_multi("logs-*", **kw)
            with pytest.raises(Exception) as want:
                m.ref.search_multi("logs-*", **kw)
            assert got.value.reason == want.value.reason
            assert got.value.status == want.value.status == 400
    finally:
        m.close()


def _fail_index(monkeypatch, idx, exc):
    def boom(**_kw):
        raise exc

    monkeypatch.setattr(idx, "search", boom)


def test_a_search_error_is_a_shard_failure_and_all_failed_is_a_503(monkeypatch):
    m = build(1, False, seed=11)
    try:
        q = {"match": {"body": "w1"}}
        _fail_index(monkeypatch, m.port.get_index("logs-1"),
                    QueryParsingError("failed to create query"))
        from elasticsearch_tpu.utils.errors import QueryParsingError as RefQPE

        _fail_index(monkeypatch, m.ref.get_index("logs-1"), RefQPE("failed to create query"))
        got, want = m.search("logs-*", query=q, size=20)
        assert got["failed_shards"] == want["failed_shards"] == 1
        assert got["shard_failures"] == want["shard_failures"]
        same_hits(got, want, "partial")
        assert {h["_index"] for h in got["hits"]["hits"]} == {"logs-0", "logs-2"}
        for name in ("logs-0", "logs-2"):
            _fail_index(monkeypatch, m.port.get_index(name), QueryParsingError("bad"))
        with pytest.raises(SearchPhaseExecutionError) as ex:
            m.port.search_multi("logs-*", query=q)
        assert ex.value.status == 503 and len(ex.value.meta["failed_shards"]) == 3
        _fail_index(monkeypatch, m.port.get_index("logs-0"), IllegalArgumentError("bad arg"))
        with pytest.raises(IllegalArgumentError):
            m.port.search_multi("logs-*", query=q)
    finally:
        m.close()


def test_a_launch_error_propagates_from_search_and_from_can_match(monkeypatch):
    m = build(1, True, seed=12)
    try:
        q = {"bool": {"must": [{"match": {"body": "w1"}}],
                      "filter": [{"range": {"@timestamp": days(0, 15)}}]}}

        def launch_failure(*_a, **_k):
            raise RuntimeError("CUDA error: unspecified launch failure")

        with monkeypatch.context() as mp:
            mp.setattr(port_scoring, "scan_topk", launch_failure)
            with pytest.raises(RuntimeError, match="launch failure"):
                m.port.search_multi("logs-*", query={"match": {"body": "w1"}})
        # can_match's refresh: the tiers merge first, and a failure there
        # is never taken for "can match"
        idx = m.port.get_index("logs-0")
        with monkeypatch.context() as mp:
            mp.setattr(idx, "_merge_tiers", lambda: launch_failure())
            with pytest.raises(RuntimeError, match="launch failure"):
                can_match(idx, q)
            with pytest.raises(RuntimeError, match="launch failure"):
                m.port.search_multi("logs-*", query=q)
        assert idx._tails  # the failed merge left the tiers serving
        assert can_match(idx, q)
        # no searchable state yet: can match, and the search itself decides
        searcher, idx._searcher = idx._searcher, None
        try:
            assert can_match(idx, q) is True
        finally:
            idx._searcher = searcher
        # a bound that does not parse for its field: can match, in both
        for bad in ({"range": {"@timestamp": {"gte": "not a date"}}},
                    {"range": {"n": {"lt": "x"}}}):
            assert can_match(idx, bad) is ref_can_match(m.ref.get_index("logs-0"), bad) is True
    finally:
        m.close()


def test_rest_multi_index_shards_and_partial_results(monkeypatch):
    from elasticsearch_tpu_torch.rest import make_app

    app = make_app(device="cpu")
    try:
        eng = app.engine
        for k, name in enumerate(NAMES):
            idx = eng.create_index(name, LOG_MAPPING, {"number_of_shards": k + 1})
            for i, d in log_docs(30 + k, 5 * k, 5, 40, name):
                idx.index_doc(i, d)
            idx.refresh()
        import json

        def search(body, params=None, path="/logs-*/_search"):
            st, _h, raw = app.handle("POST", path, params or {}, {}, json.dumps(body).encode())
            return st, json.loads(raw)

        st, r = search({"query": {"range": {"@timestamp": days(5, 10)}}})
        assert st == 200 and r["_shards"] == {"total": 6, "successful": 6, "skipped": 4,
                                              "failed": 0}
        assert {h["_index"] for h in r["hits"]["hits"]} == {"logs-1"}
        _fail_index(monkeypatch, eng.get_index("logs-1"), QueryParsingError("broken"))
        st, r = search({"query": {"match": {"body": "w1"}}})
        assert st == 200 and r["_shards"]["failed"] == 2 and r["_shards"]["successful"] == 4
        assert r["_shards"]["failures"][0]["index"] == "logs-1"
        st, r = search({"query": {"match": {"body": "w1"}},
                        "allow_partial_search_results": False})
        assert st == 503 and r["error"]["type"] == "search_phase_execution_exception"
        st, r = search({"query": {"match": {"body": "w1"}}},
                       {"allow_partial_search_results": "false"})
        assert st == 503
    finally:
        app.close()
