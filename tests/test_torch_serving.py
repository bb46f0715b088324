"""The port's serving front end (`serving/`), its wave lanes
(`EsIndex.search_wave_begin` / `_fetch` / `_finish`) and `msearch_wave`,
mirroring the JAX package's `tests/test_serving.py`.

The wave contract the port holds (queue C of ROADMAP.md):
  - a term row in a padded wave equals its 1-query wave byte for byte on
    the fused arm (k <= 16, >= 4,096 docs per shard), on 1 and on 8 shards;
  - on the impact and exact arms (k = 25, or smaller packs) the rows may
    move by the f32 dense products' summation order, which depends on the
    batch's row count: totals equal, scores within 1e-6 relative, ids up to
    fp-ties (1e-5 relative);
  - a coalesced response against the solo `_search`: the generic lane's
    equal byte for byte; a term-lane row with totals equal and scores and
    ids within the impact arm's quantization tie class
    (`ops.batched.impact_tie_class`) plus 1e-6 relative, since the solo
    path scores exact BM25 and the wave the batched arms.
Then admission: a full queue and a breaker trip shed 429 with Retry-After
before any device work, the in_flight_requests reservation is released on
every exit path, deadlines expire before dispatch, `stop` resolves queued
entries, and tenants share waves by weighted round robin.
"""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pytest

from elasticsearch_tpu_torch.common.breaker import CircuitBreakingError
from elasticsearch_tpu_torch.corpus import MAPPINGS, corpus_docs, make_corpus, sample_queries
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.ops.batched import BatchTermSearcher, impact_tie_class
from elasticsearch_tpu_torch.parallel.sharded import msearch_wave
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.serving import (
    PendingSearch,
    ServingRejectedError,
    TenantQueues,
    parse_tenant_weights,
    term_disjunction_of,
)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"]
SMALL_MAPPING = {"properties": {"title": {"type": "text"}, "tag": {"type": "keyword"},
                                "n": {"type": "long"},
                                "v": {"type": "dense_vector", "dims": 4}}}


# ---- msearch_wave: padded rows against 1-query waves ---------------------

_CORPORA: dict = {}


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


def _wave_index(S: int):
    """A text index whose shards hold >= 4,096 docs each (the fused arm's
    floor), and 24 C1-shaped queries plus an empty and an unknown one."""
    if S not in _CORPORA:
        rng = np.random.default_rng(3)
        n = 6000 if S == 1 else 34000
        lens, tok, nums = make_corpus(rng, n, vocab=400, mean_len=8)
        idx = Engine(device="cpu").create_index("c", MAPPINGS, {"number_of_shards": S})
        for i, d in enumerate(corpus_docs(lens, tok, nums, vocab=400)):
            idx.index_doc(str(i), d)
        idx.refresh()
        qs = sample_queries(rng, lens, tok, 24) + [[], [("zzz", 1.0)]]
        _CORPORA[S] = (idx, qs)
    return _CORPORA[S]


@pytest.fixture(scope="module", autouse=True)
def _drop_corpora():
    yield
    _CORPORA.clear()


@pytest.mark.parametrize("q,tier", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (255, 256),
                                    (256, 256), (257, 512)])
def test_wave_q_tier(q, tier):
    assert BatchTermSearcher.wave_q_tier(q) == tier


def _arm(ss) -> dict:
    return ss.last_stats["queries"] if hasattr(ss, "sp") else ss.batched().last_stats["queries"]


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("k", [10, 25])
def test_term_row_in_padded_wave_equals_one_query_wave(S, k):
    idx, qs = _wave_index(S)
    ss = idx.searcher
    (v, s, d, t), tier = msearch_wave(ss, "body", qs, k)
    assert tier == 32 and v.shape == (len(qs), k)
    # k=25: the pad rows plan dense-only and take the tiered arm on one shard
    assert list(_arm(ss)) == ["fused"] if k == 10 else "impact" in _arm(ss)
    for i, q in enumerate(qs):
        (v1, s1, d1, t1), tier1 = msearch_wave(ss, "body", [q], k)
        assert tier1 == 1 and t1[0] == t[i]
        if k == 10:  # the fused arm: byte for byte
            assert v1[0].tobytes() == v[i].tobytes(), q
            assert np.array_equal(s1[0], s[i]) and np.array_equal(d1[0], d[i]), q
            continue
        fin = np.isfinite(v[i])
        assert np.array_equal(np.isfinite(v1[0]), fin)
        np.testing.assert_allclose(v1[0][fin], v[i][fin], rtol=1e-6)
        for a, b, sa, sb in zip(zip(s[i][fin], d[i][fin]), zip(s1[0][fin], d1[0][fin]),
                                v[i][fin], v1[0][fin]):
            assert a == b or abs(sa - sb) <= 1e-5 * abs(sb)
    assert t[-2] == 0 and t[-1] == 0 and not np.isfinite(v[-2:]).any()


def test_pad_queries_score_nothing_on_every_arm():
    """Empty pad queries plan to zero weights: on the fused, impact, tiered
    and exact arms their rows are empty and the real rows unchanged."""
    idx, qs = _wave_index(1)
    bs = idx.searcher.batched()
    pack = idx.searcher.pack
    dense_only = [q for q in qs if q and all(pack.dense_row_of("body", t) is not None
                                             for t, _ in q)]
    assert dense_only, "the corpus has no dense-only query"
    for k, fast, batch, want_arm in ((10, True, qs[:4], "fused"), (25, True, qs[:4], "impact"),
                                     (25, True, dense_only[:2], "tiered"),
                                     (25, False, qs[:4], "exact")):
        real = bs.msearch("body", batch, k, fast=fast)
        padded = bs.msearch("body", batch + [[]] * 4, k, fast=fast)
        assert want_arm in bs.last_stats["queries"], (want_arm, bs.last_stats)
        assert (padded[2][len(batch):] == 0).all() and not np.isfinite(padded[0][len(batch):]).any()
        np.testing.assert_allclose(padded[0][:len(batch)], real[0], rtol=1e-6)
        assert np.array_equal(padded[2][:len(batch)], real[2])


def test_msearch_wave_matches_reference(monkeypatch):
    """The port's msearch_wave against the reference's on the same stacked
    pack (2 shards of >= 4,096 docs): at k=10 the port's fused arm against
    the reference's exact arm (the CPU's default), at k=25 impact against
    its forced impact arm; totals equal, scores within 1e-6 relative (k=25:
    the tie class), (shard, id) up to ties; the same tiers."""
    from elasticsearch_tpu.index.mappings import Mappings as RefMappings
    from elasticsearch_tpu.parallel import sharded as ref_sharded
    from elasticsearch_tpu.parallel import stacked as ref_stacked
    from elasticsearch_tpu_torch.index.mappings import Mappings
    from elasticsearch_tpu_torch.parallel import sharded, stacked

    monkeypatch.setenv("ES_TPU_IMPACT", "0")
    rng = np.random.default_rng(5)
    lens, tok, nums = make_corpus(rng, 9000, vocab=400, mean_len=12)
    docs = [(str(i), d) for i, d in enumerate(corpus_docs(lens, tok, nums, vocab=400))]
    rs = ref_sharded.StackedSearcher(
        ref_stacked.build_stacked_pack(docs, RefMappings(MAPPINGS), 2), mesh=None)
    ps = sharded.StackedSearcher(stacked.build_stacked_pack(docs, Mappings(MAPPINGS), 2),
                                 device="cpu")
    qs = sample_queries(rng, lens, tok, 13) + [[("t399", 1.0), ("t1", 2.0)]]
    for k, impact in ((10, "0"), (25, "force")):
        monkeypatch.setenv("ES_TPU_IMPACT", impact)
        (gv, gs, gd, gt), gtier = sharded.msearch_wave(ps, "body", qs, k)
        (wv, ws, wd, wt), wtier = ref_sharded.msearch_wave(rs, "body", qs, k)
        assert gtier == wtier == 16 and np.array_equal(gt, wt)
        for row, q in enumerate(qs):
            tie = impact_tie_class(ps.sp, "body", q) if k == 25 else 0.0
            fin = np.isfinite(wv[row])
            assert np.array_equal(np.isfinite(gv[row]), fin), q
            gap = np.abs(gv[row][fin].astype(np.float64) - wv[row][fin])
            assert (gap <= tie + 1e-6 * np.abs(wv[row][fin])).all(), (k, q, gap.max())
            for j in np.nonzero(fin)[0]:
                if (gs[row][j], gd[row][j]) != (ws[row][j], wd[row][j]):
                    assert gap[j] <= max(tie, 1e-5 * abs(wv[row][j])), (k, q)


# ---- the serving service --------------------------------------------------


def _fill(idx, n=60):
    for i in range(n):
        idx.index_doc(str(i), {"title": f"{WORDS[i % 7]} {WORDS[(i + 2) % 7]} common",
                               "tag": WORDS[i % 3], "n": i,
                               "v": [float(i % 3), 1.0, float(i % 5), float(i % 4)]})
    idx.refresh()
    # a new index's first 60 docs land in a tail segment over its empty
    # base (a vector index refreshes incrementally too); fold them into the
    # base so waves take the term and generic lanes, not the tiered one
    idx.searcher
    assert not idx._tails


@pytest.fixture
def served():
    engine = Engine(device="cpu")
    idx = engine.create_index("idx", SMALL_MAPPING)
    _fill(idx)
    svc = engine.serving
    yield engine, idx, svc
    svc.stop()
    assert svc._reserved_bytes == 0


def _bodies():
    return [
        {"query": {"match": {"title": "alpha"}}, "size": 5},
        {"query": {"match": {"title": "beta gamma"}}, "size": 3},
        {"query": {"term": {"tag": "beta"}}, "size": 4},
        {"query": {"bool": {"should": [{"term": {"title": "alpha"}},
                                       {"term": {"title": "delta"}}]}}, "size": 6},
        {"query": {"match": {"title": "common"}}, "size": 25, "from": 2},
        {"knn": {"field": "v", "query_vector": [1, 1, 2, 1], "k": 5, "num_candidates": 20},
         "size": 5},
        {"query": {"match_all": {}}, "size": 2, "from": 3},
        {"query": {"range": {"n": {"gte": 10, "lt": 30}}}, "size": 4},
        {"query": {"match": {"title": "epsilon"}}, "size": 5, "track_total_hits": False},
        {"query": {"bool": {"must": [{"match": {"title": "alpha"}}],
                            "must_not": [{"term": {"tag": "alpha"}}]}}},
    ]


def _solo(engine, b):
    return engine.search_multi("idx", query=b.get("query"), knn=b.get("knn"),
                               size=b.get("size", 10), from_=b.get("from", 0),
                               track_total_hits=b.get("track_total_hits"))


def _check_wave_against_solo(idx, body, got, want):
    spec = (term_disjunction_of(parse_query(body["query"], idx.mappings))
            if body.get("query") else None)
    if spec is None:  # generic lane and knn: byte for byte
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), body
        return
    tie = impact_tie_class(idx.searcher.pack, *spec)
    g, w = got["hits"], want["hits"]
    assert g.get("total") == w.get("total") and len(g["hits"]) == len(w["hits"]), body
    for a, b in zip(g["hits"], w["hits"]):
        gap = abs(a["_score"] - b["_score"])
        assert gap <= tie + 1e-6 * abs(b["_score"]), body
        assert a["_id"] == b["_id"] or gap <= tie, body
        assert a["_source"] == idx.get_doc(a["_id"])["_source"]


def test_mixed_shape_wave_against_solo(served):
    """Every wave-eligible shape: term lane (k=5..27), generic (bool, range,
    match_all, paginated), knn-only and track_total_hits=false resolve
    under the wave contract against solo execution."""
    engine, idx, svc = served
    bodies = _bodies()
    solo = [_solo(engine, b) for b in bodies]
    entries = [svc.classify("idx", b, {}) for b in bodies]
    assert all(e is not None for e in entries)
    svc.set_enabled(True)
    futs = [svc.submit(e, tenant=f"t{i % 3}") for i, e in enumerate(entries)]
    wait(futs, timeout=120)
    for f, b, s in zip(futs, bodies, solo):
        _check_wave_against_solo(idx, b, f.result(timeout=1), s)
    st = svc.stats()
    assert st["completed"] == len(bodies) and st["errors"] == 0
    assert st["waves"] <= st["dispatched"] and st["term_packed"] >= 1


def test_concurrent_clients_coalesce(served):
    """256 requests from 16 client threads over 4 tenants: every response
    under the wave contract, and far fewer waves than requests."""
    engine, idx, svc = served
    rng = np.random.default_rng(7)
    bodies = []
    for i in range(256):
        if i % 4:
            bodies.append({"query": {"match": {"title": WORDS[int(rng.integers(0, 7))]}},
                           "size": int(rng.integers(1, 8))})
        else:
            bodies.append({"query": {"match_all": {}}, "size": 3, "from": i % 4})
    solo = [_solo(engine, b) for b in bodies]
    entries = [svc.classify("idx", b, {}) for b in bodies]
    svc.set_enabled(True)
    results = [None] * len(bodies)
    it = iter(range(len(bodies)))
    lock = threading.Lock()

    def client(tenant):
        while True:
            with lock:
                i = next(it, None)
            if i is None:
                return
            results[i] = svc.submit(entries[i], tenant=tenant).result(timeout=120)

    threads = [threading.Thread(target=client, args=(f"tenant-{t % 4}",)) for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for b, got, want in zip(bodies, results, solo):
        _check_wave_against_solo(idx, b, got, want)
    assert svc.drain(10.0)
    st = svc.stats()
    assert st["completed"] == len(bodies) and st["waves"] < len(bodies) / 2
    assert st["wave"]["avg_term_occupancy"] is not None


def test_tiered_lane_wave_equals_solo():
    """On an index with tail segments every entry of a wave is
    tier-capable, so the wave rides the tiered lane: each tier plans and
    launches every entry, and each response equals the solo tiered
    `_search` byte for byte."""
    engine = Engine(device="cpu")
    mapping = {"properties": {k: v for k, v in SMALL_MAPPING["properties"].items()
                              if k != "v"}}
    idx = engine.create_index("idx", mapping)
    for i in range(300):
        idx.index_doc(str(i), {"title": f"{WORDS[i % 7]} {WORDS[(i * 3) % 7]} common",
                               "tag": WORDS[i % 3], "n": i})
    idx.refresh()
    for r in range(3):
        for i in range(r, 40, 3):
            idx.index_doc(str(i), {"title": f"{WORDS[(i + r) % 7]} fresh", "tag": "beta",
                                   "n": 1000 + i})
        idx.delete_doc(str(100 + r))
        idx.refresh()
    assert len(idx._tails) == 3 and idx.last_refresh_kind == "incremental"
    bodies = [b for b in _bodies() if "knn" not in b]
    bodies += [{"query": {"match": {"title": "fresh alpha"}}, "size": 7, "from": 1}]
    solo = [_solo(engine, b) for b in bodies]
    entries = [engine.serving.classify("idx", b, {}) for b in bodies]
    svc = engine.serving
    svc.set_enabled(True)
    try:
        futs = [svc.submit(e, tenant=f"t{i % 2}") for i, e in enumerate(entries * 4)]
        wait(futs, timeout=120)
        for j, f in enumerate(futs):
            got, want = f.result(timeout=1), solo[j % len(bodies)]
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), j
        st = svc.stats()
        assert st["tiered_packed"] == len(futs) and st["term_packed"] == 0
        assert st["completed"] == len(futs) and st["waves"] < len(futs)
    finally:
        svc.stop()
    assert len(idx._tails) == 3  # the waves merged nothing
    engine.close()


def test_classifier_rejects_out_of_scope(served):
    engine, _idx, svc = served
    assert svc.classify("idx", {"query": {"match_all": {}}, "sort": ["n"]}, {}) is None
    # an aggs body rides the wave (the reference's coalesce.py:17); `sort`
    # above is what is still refused
    entry = svc.classify("idx", {"aggs": {"t": {"terms": {"field": "tag"}}}}, {})
    assert entry is not None and entry["kwargs"]["aggs"] == {"t": {"terms": {"field": "tag"}}}
    assert svc.classify("idx", {"query": {"match_all": {}}}, {"scroll": "1m"}) is None
    assert svc.classify("missing*,other*", {}, {}) is None
    assert svc.classify("nope", {}, {}) is None
    assert svc.classify("idx", "not-a-dict", {}) is None
    assert svc.classify("idx", {"query": {"match_all": {}}, "_source": False}, {}) is not None
    assert svc.classify("idx", {}, {"size": "x"}) is None  # never raises


# ---- backpressure, deadlines, lifecycle ----------------------------------


class _GatedPool:
    """A one-worker engine pool whose next task waits behind an event: it
    freezes the wave pipeline mid-flight."""

    def __init__(self):
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="test-engine")
        self.gate = threading.Event()

    def block(self):
        self.gate.clear()
        self.pool.submit(self.gate.wait)

    def release(self):
        self.gate.set()

    def shutdown(self):
        self.gate.set()
        self.pool.shutdown(wait=True)


def _wait_until(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.005)
    return False


@pytest.fixture
def gated(served):
    engine, idx, svc = served
    g = _GatedPool()
    svc.bind_executor(g.pool.submit)
    yield engine, idx, svc, g
    g.release()
    svc.stop()
    g.shutdown()


def test_queue_full_sheds_with_retry_after(gated):
    engine, _idx, svc, g = gated
    svc.set_queue_depth(1)
    g.block()
    entry = svc.classify("idx", {"query": {"match_all": {}}}, {})
    f1 = svc.submit(entry, tenant="a")  # claimed into the frozen wave
    assert _wait_until(lambda: svc._tenants.depth == 0)
    f2 = svc.submit(dict(entry), tenant="a")  # queued: depth 1 = the cap
    with pytest.raises(ServingRejectedError) as ei:
        svc.submit(dict(entry), tenant="b")
    assert ei.value.status == 429 and ei.value.retry_after_s >= 1.0
    assert svc.stats()["shed"] == 1
    assert svc._reserved_bytes == 2 * 4096  # the shed request charged nothing
    g.release()
    assert f1.result(timeout=60)["hits"]["total"]["value"] == 60
    f2.result(timeout=60)
    assert _wait_until(lambda: svc._reserved_bytes == 0)


def test_breaker_trip_sheds_before_any_device_work(served):
    engine, _idx, svc = served
    entry = svc.classify("idx", {"query": {"match_all": {}}}, {})
    engine.breakers.children["in_flight_requests"].limit = 100  # < est_bytes
    try:
        with pytest.raises(CircuitBreakingError) as ei:
            svc.submit(entry)
        assert ei.value.status == 429 and ei.value.retry_after_s >= 1.0
        st = svc.stats()
        assert st["shed"] == 1 and st["dispatched"] == 0 and st["admitted"] == 0
        assert svc._reserved_bytes == 0
        assert engine.breakers.children["in_flight_requests"].used == 0
    finally:
        engine.breakers.children["in_flight_requests"].limit = engine.breakers.total


def test_breaker_released_on_every_exit_path(served):
    """A completed search, a search that fails in the engine, and one whose
    index vanished before dispatch all return their reservation."""
    engine, _idx, svc = served
    ok = svc.classify("idx", {"query": {"match": {"title": "alpha"}}}, {})
    bad = svc.classify("idx", {"query": {"match": {"title": "alpha"}}}, {})
    bad["kwargs"]["query"] = {"no_such_query": {}}
    gone = svc.classify("idx", {}, {})
    gone["index"] = gone["expression"] = "vanished"
    futs = [svc.submit(e) for e in (ok, bad, gone)]
    wait(futs, timeout=60)
    assert futs[0].result()["hits"]["total"]["value"] > 0
    assert futs[1].exception().status == 400
    assert futs[2].exception().status == 404
    st = svc.stats()
    assert st["completed"] == 1 and st["errors"] == 2 and st["fallback_solo"] == 1
    assert _wait_until(lambda: svc._reserved_bytes == 0)
    assert engine.breakers.children["in_flight_requests"].used == 0


def test_deadline_expired_before_dispatch(gated):
    engine, _idx, svc, g = gated
    g.block()
    entry = svc.classify("idx", {"query": {"match_all": {}}}, {})
    f1 = svc.submit(entry, tenant="a")  # occupies the frozen pipeline
    assert _wait_until(lambda: svc.stats()["dispatched"] == 1)
    f2 = svc.submit(dict(entry), tenant="a", timeout_s=0.02)
    time.sleep(0.1)  # the deadline lapses while it is queued
    g.release()
    res2 = f2.result(timeout=60)
    assert res2["timed_out"] is True and res2["hits"]["hits"] == []
    f1.result(timeout=60)
    st = svc.stats()
    assert st["expired"] == 1 and st["dispatched"] == 1  # f2 never reached the device
    assert _wait_until(lambda: svc._reserved_bytes == 0)


def test_stop_resolves_queued_entries(gated):
    engine, _idx, svc, g = gated
    g.block()
    entry = svc.classify("idx", {"query": {"match_all": {}}}, {})
    f1 = svc.submit(entry)
    assert _wait_until(lambda: svc._tenants.depth == 0)
    f2 = svc.submit(dict(entry))
    g.release()
    svc.stop()
    for f in (f1, f2):  # completed in flight, or refused at shutdown
        try:
            f.result(timeout=10)
        except ServingRejectedError:
            pass
    assert svc._reserved_bytes == 0
    svc.bind_executor(None)  # restartable, on a pool of its own
    f3 = svc.submit(svc.classify("idx", {"query": {"match_all": {}}}, {}))
    assert f3.result(timeout=60)["hits"]["total"]["value"] == 60


# ---- tenant fairness -----------------------------------------------------


def _pending(tenant):
    return PendingSearch(entry={"index": "i", "kwargs": {}}, tenant=tenant)


def test_starvation_heavy_tenant_cannot_block_light():
    q = TenantQueues()
    for _ in range(100):
        q.push(_pending("heavy"))
    for _ in range(2):
        q.push(_pending("light"))
    by_tenant = {}
    for ps in q.pop_wave(8):
        by_tenant[ps.tenant] = by_tenant.get(ps.tenant, 0) + 1
    assert by_tenant.get("light", 0) >= 1 and by_tenant["heavy"] >= 1


def test_weighted_budgets_respected():
    q = TenantQueues()
    q.set_weights(parse_tenant_weights("gold:3,bronze:1"))
    for _ in range(20):
        q.push(_pending("gold"))
        q.push(_pending("bronze"))
    wave = q.pop_wave(8)
    assert sum(ps.tenant == "gold" for ps in wave) == 6
    assert sum(ps.tenant == "bronze" for ps in wave) == 2
    assert q.depth == 32 and q.stats()["tenants"] == {"gold": 14, "bronze": 18}


@pytest.mark.parametrize("raw,want", [("a:4, b:1.5", {"a": 4.0, "b": 1.5}), ("", {}),
                                      ("bad", {}), ("x:y,z:2", {"z": 2.0})])
def test_parse_tenant_weights(raw, want):
    assert parse_tenant_weights(raw) == want


def test_tenant_keys_normalize(served):
    """X-Opaque-Id becomes one queue key through the shared normalizer, and
    weights set through the settings address the same key."""
    engine, _idx, svc = served
    engine.settings.update({"persistent": {"serving.tenant.weights": "team a!:3"}})
    # the `_merge` internal tenant rides the table at serving.merge.weight
    assert svc._tenants.weights == {"team_a_": 3.0, "_merge": 1.0}
    q = TenantQueues()
    ps = _pending(" team a! ")
    q.push(ps)
    assert ps.tenant == "team_a_" and _pending(None).tenant is None
    q.push(_pending(""))
    assert set(q.stats()["tenants"]) == {"team_a_", "_anonymous"}


def test_serving_settings_apply_and_validate(served):
    engine, _idx, svc = served
    engine.settings.update({"transient": {"serving.max_wave": 8,
                                          "serving.coalesce.max_wait": "5ms",
                                          "serving.queue.max_depth": 3}})
    assert (svc.max_wave, svc.max_wait_s, svc.queue_cap) == (8, 0.005, 3)
    from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

    for bad in ({"serving.coalesce.max_wait": "soon"}, {"serving.max_wave": -1},
                {"indices.breaker.request.limit": "lots"}):
        with pytest.raises(IllegalArgumentError):
            engine.settings.update({"persistent": bad})
    with pytest.raises(IllegalArgumentError, match="not yet ported"):
        engine.settings.update({"persistent": {"serving.flight_recorder.size": 8}})
    with pytest.raises(IllegalArgumentError, match="not recognized"):
        engine.settings.update({"persistent": {"no.such": 1}})
    assert engine.serving_if_enabled() is None
    engine.settings.update({"persistent": {"serving.enabled": "true"}})
    assert engine.serving_if_enabled() is svc and svc.enabled
