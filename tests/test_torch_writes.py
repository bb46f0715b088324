"""Deletes, updates and the tiered (LSM) refresh of the port against the JAX
package's, on the same seeded documents and the same write scripts.

Each script writes, deletes, updates and refreshes through the reference's
`Engine(None)` index and the port's `Engine(device="cpu")` index alike, and
at each checkpoint runs the same queries through both `search` and
`count`. The queries include a term of the base's dense tier (df >=
`default_dense_min_df`), whose base scores come from the tier that bakes
avgdl, a bool with a range filter, a keyword term, terms, constant_score,
match_all and pages past the first. Scenarios: additions (also against a
full rebuild of the same docs), updates and deletes, one segment per
incremental refresh, an update of a doc whose newest copy is in an older
segment, the inline fold past `indexing.tiers.max_segments`, growth past
max(256, base/10) taking the full refresh, a refresh that only deletes,
a query that fails to parse merging the tiers, a 3-shard index,
`refresh_interval`, and a breaker trip during an incremental refresh.

The port's `_search` scores sparse terms from the impact tier on the base
and on every segment (each tier's codes are resident), as the reference
does on its accelerator: the reference runs with ES_TPU_IMPACT=force here.
Its exact BM25 path (ES_TPU_IMPACT=0) is the oracle of the tiers' impact
error bound and of `mark_exact` plans.

Tolerances: totals equal; scores within 1e-6 relative; ids equal, except
where the two scores agree within 1e-5 relative (fp-ties); each hit's
`_source` equal. The base's re-derived dense tier within 2 ulps of the
reference's (XLA on the CPU may contract a multiply-add), its impact codes
equal.
"""

import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu.engine.engine import Engine as RefEngine
from elasticsearch_tpu_torch.common.breaker import CircuitBreakingError
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.index.pack import default_dense_min_df
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.query.nodes import mark_exact
from elasticsearch_tpu_torch.utils.errors import DocumentMissingError

MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"},
                          "tag": {"type": "keyword"}}}
WORDS = [f"w{i}" for i in range(40)]
_P = 1.0 / np.arange(1, len(WORDS) + 1)
_P /= _P.sum()
BASE = 400  # base docs: incremental while the docs outside it stay <= 256

QUERIES = [
    ({"match": {"body": "w0 w7"}}, 10, 0),  # w0: a dense-tier term of the base
    ({"match": {"body": "w0"}}, 20, 5),
    ({"term": {"body": "w3"}}, 12, 0),
    ({"match": {"body": {"query": "w1 w2", "operator": "and"}}}, 10, 0),
    ({"bool": {"must": [{"match": {"body": "w5"}}], "filter": [{"range": {"n": {"lt": 300}}}],
               "must_not": [{"term": {"tag": "t3"}}]}}, 15, 0),
    ({"bool": {"should": [{"term": {"body": "w9"}}, {"term": {"tag": "fresh"}}]}}, 10, 0),
    ({"terms": {"tag": ["t1", "upd"]}}, 8, 0),
    ({"constant_score": {"filter": {"term": {"body": "w4"}}, "boost": 2.0}}, 5, 3),
    ({"match": {"body": "special fresh"}}, 10, 0),
    ({"match_all": {}}, 7, 0),
    (None, 3, 0),
]


@pytest.fixture(autouse=True)
def _cold_planners():
    """Both packages' execution planners start each test cold: a planner
    warmed by an earlier test could route a batch to another arm."""
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()
    yield
    planner_reset()
    ref_planner_reset()


def _doc(rng, n: int, tag: str | None = None, extra: str = "") -> dict:
    words = rng.choice(WORDS, size=int(rng.integers(3, 9)), p=_P)
    return {"body": " ".join(words) + extra, "n": n, "tag": tag or f"t{n % 7}"}


def _base_docs(seed: int = 0, n: int = BASE):
    rng = np.random.default_rng(seed)
    return [(f"d{i}", _doc(rng, i)) for i in range(n)]


@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    """The reference scores from its impact tier, as the port does."""
    monkeypatch.setenv("ES_TPU_IMPACT", "force")


class Pair:
    """The same index in both packages, driven by the same calls."""

    def __init__(self, settings=None, cluster=None):
        self.ref_engine, self.port_engine = RefEngine(None), Engine(device="cpu")
        if cluster:
            self.ref_engine.settings.update({"transient": cluster})
            self.port_engine.settings.update({"transient": cluster})
        self.ref = self.ref_engine.create_index("idx", MAPPING, dict(settings or {}))
        self.port = self.port_engine.create_index("idx", MAPPING, dict(settings or {}))

    def close(self):
        self.ref_engine.close()
        self.port_engine.close()

    def index(self, docs):
        for i, d in docs:
            self.ref.index_doc(i, d)
            self.port.index_doc(i, d)

    def delete(self, ids):
        for i in ids:
            self.ref.delete_doc(i)
            self.port.delete_doc(i)

    def refresh(self):
        self.ref.refresh()
        self.port.refresh()

    def check(self, what: str, queries=QUERIES, ref_count: bool = False):
        """Every query on both: the same answers, and the port's `count`
        equal to the tiered total (and to the reference's `count`)."""
        for q, size, from_ in queries:
            want = self.ref.search(query=q, size=size, from_=from_)
            got = self.port.search(q, size=size, from_=from_)
            _same_hits(got["hits"], want["hits"], f"{what} {q}")
            assert self.port.count(q) == got["hits"]["total"]["value"], (what, q)
            if ref_count:
                assert self.ref.count(q) == got["hits"]["total"]["value"], (what, q)


def _close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def _same_hits(got: dict, want: dict, what: str) -> None:
    assert got["total"] == want["total"], what
    if want["max_score"] is None:
        assert got["max_score"] is None, what
    else:
        assert _close(got["max_score"], want["max_score"], 1e-6), what
    assert len(got["hits"]) == len(want["hits"]), what
    for g, w in zip(got["hits"], want["hits"]):
        assert _close(g["_score"], w["_score"], 1e-6), (what, g, w)
        if g["_id"] != w["_id"]:  # fp-ties only
            assert _close(g["_score"], w["_score"], 1e-5), (what, g, w)
            continue
        assert g["_source"] == w["_source"] and g["_index"] == w["_index"], what


@pytest.fixture
def pair():
    p = Pair()
    p.index(_base_docs())
    p.refresh()
    # the base has a dense tier, and w0 is in it
    assert p.port._searcher.pack.dense_row_of("body", "w0") is not None
    assert default_dense_min_df(BASE) <= p.port._searcher.pack.term_blocks("body", "w0")[2]
    yield p
    p.close()


def _kinds(p: Pair) -> tuple:
    return p.port.last_refresh_kind, len(p.port._tails), len(p.ref._tails)


def test_additions_match_reference_and_full_rebuild(pair):
    """Reference `test_tiered_refresh.py:46`: docs written after the base
    seal land in a segment; the tiered answers equal the reference's, and
    on exact BM25 plans a full rebuild's of the same docs (within the
    tolerances: the combined statistics of additions equal the live ones)."""
    rng = np.random.default_rng(2)
    extra = [(f"x{i}", _doc(rng, 1000 + i, "fresh", " fresh")) for i in range(30)]
    pair.index(extra)
    pair.refresh()
    assert _kinds(pair) == ("incremental", 1, 1)
    base = pair.port._searcher
    pair.check("additions")
    full = Engine(device="cpu").create_index("idx", MAPPING)
    for i, d in _base_docs() + extra:
        full.index_doc(i, d)
    full.refresh()
    assert not full._tails
    for q, size, from_ in QUERIES:
        # exact BM25 plans: each tier quantizes its impact codes with its own
        # per-term bound, so impact answers agree only within the tie class
        node = mark_exact(parse_query(q, full.mappings))
        _same_hits(pair.port._search_tiered(node, size, from_)["hits"],
                   full._format_generic_hits(full._searcher.search(node, size=size, from_=from_))
                   ["hits"], f"full {q}")
    assert pair.port._searcher is base  # the base stayed sealed


def test_updates_and_deletes(pair):
    """Reference `test_tiered_refresh.py:87`: updates supersede their base
    copies, deletes clear theirs, and the replaced and deleted docs keep
    counting in df and avgdl until a merge (as in the reference)."""
    rng = np.random.default_rng(3)
    pair.index([(f"d{i}", _doc(rng, -1, "upd", " updated special")) for i in range(8)])
    pair.delete([f"d{i}" for i in range(10, 16)])
    pair.refresh()
    assert _kinds(pair) == ("incremental", 1, 1)
    pair.check("updates and deletes")
    hits = pair.port.search({"match_all": {}}, size=1000)["hits"]
    ids = {h["_id"] for h in hits["hits"]}
    assert hits["total"]["value"] == BASE - 6 and not ids & {f"d{i}" for i in range(10, 16)}
    assert pair.port.get_doc("d10") is None and pair.port.get_doc("d0")["_source"]["tag"] == "upd"
    st = pair.port.tier_stats()
    assert st == {**pair.ref.tier_stats(), "tail_fraction": st["tail_fraction"]}
    with pytest.raises(DocumentMissingError):
        pair.port.delete_doc("d10")
    assert pair.port.index_doc("d10", {"body": "back"})["result"] == "created"
    assert pair.ref.index_doc("d10", {"body": "back"})["result"] == "created"
    pair.refresh()
    pair.check("recreated", QUERIES[:2])


def test_one_segment_per_incremental_refresh(pair):
    """Reference `test_lsm_tiers.py:50`: each refresh with new docs seals
    exactly one segment and leaves the base and the older segments
    sealed."""
    base = pair.port._searcher
    segs = []
    for r in range(3):
        rng = np.random.default_rng(10 + r)
        pair.index([(f"r{r}_{i}", _doc(rng, 2000 + i, "fresh", " fresh")) for i in range(6)])
        pair.refresh()
        assert _kinds(pair) == ("incremental", r + 1, r + 1)
        assert [s.searcher for s in pair.port._tails[:-1]] == segs
        segs = [s.searcher for s in pair.port._tails]
        assert pair.port._searcher is base
    pair.check("three segments", ref_count=True)


def test_update_supersedes_an_older_segment_copy(pair):
    """Reference `test_lsm_tiers.py:104`: a doc whose newest copy is in an
    older segment is updated: that copy's live bit is cleared there."""
    rng = np.random.default_rng(4)
    pair.index([(f"s{i}", _doc(rng, 3000 + i, "fresh", " fresh")) for i in range(5)])
    pair.refresh()
    pair.index([("s1", _doc(rng, -5, "upd", " special")), ("d3", _doc(rng, -6, "upd"))])
    pair.delete(["s2"])
    pair.refresh()
    assert _kinds(pair) == ("incremental", 2, 2)
    seg0 = pair.port._tails[0].searcher
    s, d = pair.port._tails[0].pos["s1"]
    assert not seg0.sp.live[s, d] and seg0.dead_count == 2
    assert pair.port._tail_pos["s1"][0] == 1 and "s2" not in pair.port._tail_pos
    pair.check("supersede")


def test_inline_fold_past_max_segments():
    """Reference `test_lsm_tiers.py:129`: past `indexing.tiers.max_segments`
    the segments fold into one inline, the replaced copies drop out of the
    statistics, and the answers still equal the reference's."""
    p = Pair(cluster={"indexing.tiers.max_segments": 2})
    try:
        p.index(_base_docs())
        p.refresh()
        for r in range(3):
            rng = np.random.default_rng(20 + r)
            p.index([(f"f{r}_{i}", _doc(rng, 4000 + i, "fresh", " fresh")) for i in range(5)])
            p.index([(f"f0_{r}", _doc(rng, -r, "upd", " special"))])
            p.refresh()
        assert _kinds(p) == ("incremental", 1, 1)
        assert p.port.counters["segment_merge_total"] == 1
        assert p.port.counters.get("merge_failures", 0) == 0
        assert p.ref.counters.get("merge_failures", 0) == 0
        p.check("folded")
    finally:
        p.close()


def test_growth_past_bound_takes_the_full_refresh(pair):
    """Reference `test_tiered_refresh.py:136`: the docs outside the base
    past max(256, base/10) rebuild the base."""
    rng = np.random.default_rng(6)
    pair.index([(f"y{i}", _doc(rng, 5000 + i)) for i in range(200)])
    pair.refresh()
    base = pair.port._searcher
    assert _kinds(pair) == ("incremental", 1, 1)
    pair.index([(f"z{i}", _doc(rng, 6000 + i)) for i in range(100)])
    pair.refresh()
    assert _kinds(pair) == ("full", 0, 0) and pair.port._searcher is not base
    pair.check("rebuilt")
    assert pair.port.count({"match_all": {}}) == BASE + 300


def test_delete_only_refresh_seals_no_segment(pair):
    """A refresh that only deletes clears live bits and seals nothing, in
    the base and in an older segment."""
    rng = np.random.default_rng(7)
    pair.index([(f"e{i}", _doc(rng, 7000 + i, "fresh", " fresh")) for i in range(4)])
    pair.refresh()
    seg = pair.port._tails[0].searcher
    pair.delete(["d1", "d2", "e0"])
    pair.refresh()
    assert _kinds(pair) == ("incremental", 1, 1) and pair.port._tails[0].searcher is seg
    pair.check("deletes only")


def test_unparsable_query_merges_the_tiers(pair):
    """Reference `test_tiered_refresh.py:118`: a request the tiers cannot
    serve goes to the merged searcher, which merges them first: here a
    query that fails to parse (both answer its 400)."""
    rng = np.random.default_rng(8)
    pair.index([(f"m{i}", _doc(rng, 8000 + i, "fresh", " fresh")) for i in range(5)])
    pair.delete(["d5"])
    pair.refresh()
    bad = {"term": {}}
    with pytest.raises(Exception) as ref_err:
        pair.ref.search(query=bad)
    with pytest.raises(Exception) as port_err:
        pair.port.search(bad)
    assert type(port_err.value).__name__ == type(ref_err.value).__name__
    assert pair.port._tails == [] and pair.ref._tail is None
    assert pair.port.last_refresh_kind == "incremental"  # a merge, not a refresh
    pair.check("merged")


def test_three_shards_with_tails():
    """A 3-shard index: the segments are routed by murmur3 like the base."""
    p = Pair(settings={"number_of_shards": 3})
    try:
        p.index(_base_docs(9))
        p.refresh()
        rng = np.random.default_rng(9)
        p.index([(f"g{i}", _doc(rng, 9000 + i, "fresh", " fresh")) for i in range(12)])
        p.index([(f"d{i}", _doc(rng, -i, "upd", " special")) for i in range(4)])
        p.delete(["d20", "d21"])
        p.refresh()
        assert _kinds(p) == ("incremental", 1, 1)
        assert [len(x) for x in p.port._tails[0].shard_docs] == \
            [len(x) for x in p.ref._tails[0].shard_docs]
        p.check("3 shards")
    finally:
        p.close()


def test_refresh_interval(monkeypatch):
    """`refresh_interval`: with "1s" a write becomes visible to a search
    once a second has passed since the last refresh; with "-1" only an
    explicit refresh shows it (time.monotonic patched in both packages)."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    for interval, visible in (("1s", True), ("-1", False)):
        p = Pair(settings={"refresh_interval": interval})
        try:
            p.index(_base_docs(1))
            p.refresh()
            rng = np.random.default_rng(11)
            p.index([("late", _doc(rng, 1, "fresh", " fresh"))])
            q = ({"term": {"tag": "fresh"}}, 5, 0)
            clock[0] += 0.5
            p.check(f"{interval} before", [q])
            assert p.port.count(q[0]) == 0
            clock[0] += 1.0
            p.check(f"{interval} after", [q])
            assert p.port.count(q[0]) == int(visible)
            assert p.port.search_wave([{"query": q[0]}])[0]["hits"]["total"]["value"] == \
                int(visible)
        finally:
            p.close()


def test_breaker_trip_leaves_old_tiers_serving(pair):
    """A breaker trip during an incremental refresh installs nothing: the
    old tiers answer as before, the writes stay pending, and the refresh
    after the limit is raised equals the reference's (which refreshed with
    no trip)."""
    rng = np.random.default_rng(12)
    before = [pair.port.search(q, size=s, from_=f) for q, s, f in QUERIES]
    writes = [(f"b{i}", _doc(rng, 9500 + i, "fresh", " fresh")) for i in range(6)]
    for i, d in writes:
        pair.port.index_doc(i, d)
    pair.port.delete_doc("d7")
    fielddata = pair.port_engine.breakers.children["fielddata"]
    limit = fielddata.limit
    fielddata.limit = 1
    with pytest.raises(CircuitBreakingError):
        pair.port.refresh()
    fielddata.limit = limit
    assert pair.port._tails == [] and pair.port._searcher.pack.live.all()
    pair.port.settings["refresh_interval"] = "-1"
    for (q, s, f), want in zip(QUERIES, before):
        assert pair.port.search(q, size=s, from_=f) == want
    pair.index([])  # the reference gets the same writes
    for i, d in writes:
        pair.ref.index_doc(i, d)
    pair.ref.delete_doc("d7")
    pair.refresh()
    assert _kinds(pair) == ("incremental", 1, 1)
    pair.check("after the trip")


def test_combined_stats_rederive_the_base_tiers(pair):
    """After `_install_combined_stats`, the base's dense tier (re-derived on
    the device from the resident postings) is within 2 ulps of the
    reference's, and its impact codes equal the reference's."""
    rng = np.random.default_rng(13)
    pair.index([(f"c{i}", _doc(rng, 9900 + i, "fresh", " fresh long words here"))
                for i in range(40)])
    pair.index([(f"d{i}", _doc(rng, -i, "upd")) for i in range(10)])
    pair.refresh()
    base, rbase = pair.port._searcher, pair.ref._searcher
    assert base.stats_override is pair.port._tails[0].searcher.sp.stats_override
    want_fs = rbase.sp.stats_override["field_stats"]
    assert base.stats_override["field_stats"] == want_fs
    assert base.stats_override["global_df"] == rbase.sp.stats_override["global_df"]
    V = len(base.pack.dense_dict)
    got = base.dev["dense_tfn"][:V].numpy()
    want = np.asarray(rbase.dev["dense_tfn"])[0, :V]
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 2 and (got >= 0).all()
    assert not np.array_equal(got, base.pack.dense_tfn[:V])  # avgdl moved
    codes = base.dev["impact_codes"].view(torch.int16).numpy().view(np.uint16)
    rcodes = np.asarray(rbase.dev["impact_codes"])[0]
    np.testing.assert_array_equal(codes, rcodes[: codes.shape[0]])
    assert rbase.sp.impact_serving()
    pair.check("re-derived")


def _term_nodes(node):
    from elasticsearch_tpu_torch.query.nodes import BoolNode, ConstantScoreNode, TermNode

    if isinstance(node, TermNode):
        return [node]
    if isinstance(node, BoolNode):
        return [t for grp in (node.must, node.filter, node.should, node.must_not)
                for c in grp for t in _term_nodes(c)]
    if isinstance(node, ConstantScoreNode):
        return _term_nodes(node.child)
    return []


def test_impact_search_on_tiers_holds_exact_bm25(pair, monkeypatch):
    """On base + 2 segments under the combined statistics: every tier takes
    the impact tier; the answers hold the reference's exact BM25 answers
    within the quantization tie class (each tier quantizes with its own
    per-term ubf, read by `impact_wscale` from the pack whose codes were
    re-derived), and `mark_exact` plans equal them up to fp-ties."""
    rng = np.random.default_rng(17)
    for r in range(2):
        pair.index([(f"e{r}-{i}", _doc(rng, 5000 + 50 * r + i, "fresh", " fresh"))
                    for i in range(30)])
        pair.index([(str(i), _doc(rng, i, "upd")) for i in range(r, 40, 7)])
        pair.refresh()
    p = pair.port
    assert p.last_refresh_kind == "incremental" and len(p._tails) == 2
    tiers = [p._searcher] + [seg.searcher for seg in p._tails]
    views = [(v, pk) for tr in tiers for v, pk in (
        zip(tr._views, tr.sp.shards) if hasattr(tr, "_views") else [(tr.view, tr.pack)])]
    qmax = views[0][1].impact_meta["qmax"]
    monkeypatch.setenv("ES_TPU_IMPACT", "0")
    pair.ref._invalidate_request_cache()
    for q, size, from_ in QUERIES:
        want = pair.ref.search(query=q, size=size, from_=from_)["hits"]
        got = p.search(q, size=size, from_=from_)["hits"]
        tie = 0.0
        for t in _term_nodes(parse_query(q, p.mappings)):
            key = (t.fld, t.term)
            # the term's largest bound over the tiers that serve it sparse
            best = 0.0
            for view, pk in views:
                params = t.prepare(view)
                if params[0] == "impact" and key in pk.term_dict:
                    best = max(best, params[2] * float(pk.impact_ubf[pk.term_dict[key]]) / qmax)
            tie += best
        tie = 2 * tie + 1e-7
        assert got["total"] == want["total"], q
        gs = np.array([h["_score"] for h in got["hits"]])
        ws = np.array([h["_score"] for h in want["hits"]])
        assert gs.shape == ws.shape and (np.abs(gs - ws) <= tie + 1e-6 * ws).all(), (q, tie)
        for g, w in zip(got["hits"], want["hits"]):
            assert g["_id"] == w["_id"] or abs(g["_score"] - w["_score"]) <= tie, q
        exact = p._search_tiered(mark_exact(parse_query(q, p.mappings)), size, from_)
        _same_hits(exact["hits"], want, f"mark_exact {q}")
    for t in ("w3", "w9"):
        assert all(tr._views[0].impact_wscale("body", t) is not None if hasattr(tr, "_views")
                   else tr.view.impact_wscale("body", t) is not None for tr in tiers)


def test_vector_index_keeps_the_full_rebuild():
    """An index whose mappings hold a dense_vector field (once kept on the
    full rebuild) refreshes incrementally under the reference's rule: an
    update and a delete seal one segment, and kNN over base + segment, and
    each query's total, equal those of a fresh index of the live docs (kNN
    scores and totals read no term statistics, so the dead copy the tiers
    still count changes neither)."""
    mapping = {"properties": {**MAPPING["properties"],
                              "v": {"type": "dense_vector", "dims": 2}}}
    port, fresh = Engine(device="cpu"), Engine(device="cpu")
    idx, want = port.create_index("idx", mapping), fresh.create_index("idx", mapping)
    rng = np.random.default_rng(14)
    docs = [(i, {**d, "v": [float(j % 3), 1.0]}) for j, (i, d) in enumerate(_base_docs(14))]
    for i, d in docs:
        idx.index_doc(i, d)
    idx.refresh()
    idx.index_doc("d0", {**_doc(rng, -1, "upd", " special"), "v": [2.0, 2.0]})
    idx.delete_doc("d1")
    idx.refresh()
    assert idx.last_refresh_kind == "incremental" and len(idx._tails) == 1
    for i, d in docs[2:] + [("d0", idx.get_doc("d0")["_source"])]:
        want.index_doc(i, d)
    want.refresh()
    for q in ([2.0, 2.0], [0.0, 1.0], [1.5, 1.0]):
        for k, filt in ((5, None), (3, {"term": {"tag": "upd"}}), (4, {"range": {"n": {"lt": 9}}})):
            body = {"field": "v", "query_vector": q, "k": k, "num_candidates": 50}
            if filt is not None:
                body["filter"] = filt
            got, exp = idx.search(knn=body)["hits"], want.search(knn=body)["hits"]
            assert got["total"] == exp["total"], (q, k)
            assert [h["_score"] for h in got["hits"]] == [h["_score"] for h in exp["hits"]]
            assert {h["_id"] for h in got["hits"]} == {h["_id"] for h in exp["hits"]}
    assert len(idx._tails) == 1
    for q, _size, _from in QUERIES:
        assert idx.count(q) == want.count(q), q


def _refresh_same_kind(p: Pair) -> str:
    """Refresh both; the port's kind equals the reference's (a full refresh
    replaces the reference's base searcher, an incremental one keeps it)."""
    before = p.ref._searcher
    p.refresh()
    kind = "full" if p.ref._searcher is not before else "incremental"
    assert p.port.last_refresh_kind == kind
    return kind


def _smallest_case(p: Pair) -> list:
    """ROADMAP queue C's smallest input: 2 docs, an update, 255 docs."""
    p.index([("a", {"body": "apple banana"}), ("b", {"body": "apple"})])
    kinds = [_refresh_same_kind(p)]
    p.index([("a", {"body": "cherry"})])
    kinds.append(_refresh_same_kind(p))
    p.check("after the update", [({"match": {"body": "apple"}}, 10, 0)])
    p.index([(f"f{i}", {"body": "filler words"}) for i in range(255)])
    kinds.append(_refresh_same_kind(p))
    p.check("after the fillers", [({"match": {"body": "apple"}}, 10, 0),
                                  ({"match": {"body": "filler"}}, 10, 0)])
    return kinds


def _corpus_case(p: Pair) -> list:
    """The 40-word corpus: 120 docs, 30 updates, 200 docs, then 30 updates
    and 10 deletes, each refreshed and checked on every query."""
    rng = np.random.default_rng(21)
    kinds = []
    steps = [[(f"d{i}", _doc(rng, i)) for i in range(120)],
             [(f"d{i}", _doc(rng, -int(i), "upd", " updated")) for i in rng.choice(120, 30, False)],
             [(f"d{i}", _doc(rng, i)) for i in range(120, 320)],
             [(f"d{i}", _doc(rng, -int(i), "upd", " special")) for i in rng.choice(320, 30, False)]]
    for j, docs in enumerate(steps):
        p.index(docs)
        if j == 3:
            p.delete(sorted({f"d{i}" for i in rng.choice(320, 10, False)} - {i for i, _ in docs}))
        kinds.append(_refresh_same_kind(p))
        p.check(f"corpus step {j}")
    return kinds


@pytest.mark.parametrize("case", ["smallest", "corpus40"])
def test_new_index_starts_on_an_empty_base(case):
    """ROADMAP queue C entry 1: a new index refreshes at creation, as the
    reference's does (`engine.py:193-196`), so each later refresh is full
    or incremental by the reference's rule counted against an empty base,
    max(256, 0): the same kind of refresh on every call, and the same
    answers (scores within 1e-6 relative, ids up to fp-ties)."""
    p = Pair()
    try:
        assert p.port.last_refresh_kind == "full" and p.port.tier_stats()["base_docs"] == 0
        if case == "smallest":
            # 257 docs outside the empty base take the full rebuild; the
            # replaced copy of "a" then drops out of df and avgdl
            assert _smallest_case(p) == ["incremental", "incremental", "full"]
        else:
            assert _corpus_case(p) == ["incremental", "incremental", "full", "incremental"]
    finally:
        p.close()


def test_empty_tier_is_searchable_and_launches_nothing(monkeypatch):
    """A new index answers as empty before its first write, and a base of
    zero docs under tail segments adds no hits and a total of 0: no kernel
    (here, its twin on the CPU) is ever called on zero docs."""
    from elasticsearch_tpu_torch.ann import kernels as ann_kernels
    from elasticsearch_tpu_torch.ops import fused
    from elasticsearch_tpu_torch.ops import kernels

    def guard(mod, name, docs):
        fn = getattr(mod, name)

        def checked(*a, **kw):
            assert docs(*a) > 0, f"{name} called on zero docs"
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, checked)

    guard(kernels, "scan_topk_reference", lambda q, mat_t, *a: mat_t.shape[1])
    guard(kernels, "tiered_candidates_reference", lambda q, hi, *a: hi.shape[1])
    guard(kernels, "impact_gather_reference", lambda codes, *a: codes.shape[0])
    guard(fused, "fused_tile_candidates_reference", lambda hi, *a: hi.shape[1])
    guard(ann_kernels, "ann_gather_scan_reference", lambda q, probes, *a: probes.shape[1])
    p = Pair()
    try:
        p.check("empty", ref_count=True)
        bodies = [{"query": q, "size": size, "from": from_} for q, size, from_ in QUERIES if q]
        got = p.port.msearch(bodies)["responses"]
        for b, g in zip(bodies, got):
            _same_hits(g["hits"], p.ref.search(query=b["query"], size=b["size"],
                                               from_=b["from"])["hits"], str(b))
        p.index(_base_docs(n=40))
        assert _refresh_same_kind(p) == "incremental"
        p.check("empty base + 1 segment", ref_count=True)
        wave = p.port.search_wave([{"query": q, "size": size, "from_": from_}
                                   for q, size, from_ in QUERIES])
        for (q, size, from_), w in zip(QUERIES, wave):
            _same_hits(w["hits"], p.port.search(q, size=size, from_=from_)["hits"], str(q))
    finally:
        p.close()
