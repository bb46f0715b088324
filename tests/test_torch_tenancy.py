"""Tenant superpacks of the port (`elasticsearch_tpu_torch/tenancy/`), against
the JAX package's superpacks and against the port's own per-index exact arm.

Mirrors the cases of tests/test_superpack.py whose dependencies are ported:
size classes, adoption (folding an LSM tail), the max_docs bound, solo and
wave rows, claims, stale lanes, the shape-key count, lane growth, eviction
on delete, an atomic fold under a failure (a monkeypatched stage: the
fault registry is not ported), and the serving wave with its `_merge`
lane. The contract held:
  - the port's superpack rows (scores, ids, totals on finite lanes) are
    byte-equal to the port's per-index exact arm (`BatchTermSearcher.run`
    on the member's searcher);
  - they equal the JAX package's superpack rows (its engine with
    `superpack.enabled`; its impact gate is off on the CPU) within 1e-6
    relative, ids up to fp-ties (1e-5 relative).
Waits on a background fold poll to a bounded deadline or drain the queue.
"""

import time

import numpy as np
import pytest

from elasticsearch_tpu.engine.engine import Engine as RefEngine
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.ops.batched import BatchTermSearcher, fetch
from elasticsearch_tpu_torch.tenancy import size_class_of, superpack_enabled
from elasticsearch_tpu_torch.tenancy.superpack import MIN_BLOCK_CLASS, MIN_DOC_CLASS, Superpack

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"]
QUERIES = [[("alpha", 1.0), ("common", 1.0)], [("gamma", 2.0)],
           [("common", 1.0), ("zeta", 1.0), ("beta", 0.5)], [("nothing", 1.0)]]


@pytest.fixture
def engine():
    e = Engine(device="cpu")
    e.settings.update({"persistent": {"superpack.enabled": True}})
    yield e
    e.close()


@pytest.fixture
def ref_engine(tmp_path):
    e = RefEngine(str(tmp_path / "data"))
    e.settings.update({"persistent": {"superpack.enabled": True}})
    yield e
    e.close()


def _docs(n, seed):
    return [(str(i), {"body": f"{WORDS[(i + seed) % 7]} {WORDS[(i + seed + 2) % 7]} common"})
            for i in range(n)]


def _tenant(engine, name, n=6, seed=0, docs=None):
    idx = engine.create_index(name, {"properties": {"body": {"type": "text"}}})
    for i, src in docs or _docs(n, seed):
        idx.index_doc(i, src)
    idx.refresh()
    return idx


def _entry(name, query=None, size=5, **kw):
    return {"index": name, "kwargs": {"query": query or {"match": {"body": "alpha common"}},
                                      "size": size, **kw}, "expression": name}


def _run_wave(mgr, entries):
    job = mgr.search_wave_begin(entries)
    mgr.search_wave_fetch(job)
    return job, mgr.search_wave_finish(job)


def _exact_rows(ss, fld, queries, k):
    """The member's own exact arm -> (scores, docids, totals)."""
    bts = BatchTermSearcher(ss)
    return fetch([bts.run(fld, bts.plan(fld, queries, k))])[0]


def _byte_equal_rows(got, want, what):
    gv, gi, gt = got
    wv, wi, wt = want
    assert np.array_equal(np.asarray(gt), np.asarray(wt)), what
    for q in range(len(gv)):
        n = int(np.isfinite(wv[q]).sum())
        assert int(np.isfinite(gv[q]).sum()) == n, (what, q)
        assert np.array_equal(gv[q][:n].view(np.uint32), wv[q][:n].view(np.uint32)), (what, q)
        assert np.array_equal(np.asarray(gi[q][:n]), np.asarray(wi[q][:n])), (what, q)


def _close_rows(got, want, what, rtol=1e-6, tie=1e-5):
    """Scores within rtol; ids equal but for swaps among scores tied within
    `tie` relative; totals equal."""
    gv, gi, gt = got
    wv, wi, wt = want
    assert np.array_equal(np.asarray(gt), np.asarray(wt)), what
    for q in range(len(gv)):
        n = int(np.isfinite(wv[q]).sum())
        assert int(np.isfinite(gv[q]).sum()) == n, (what, q)
        np.testing.assert_allclose(gv[q][:n], wv[q][:n], rtol=rtol, atol=0, err_msg=what)
        for j in range(n):
            if int(gi[q][j]) != int(wi[q][j]):
                tied = np.isclose(wv[q][:n], wv[q][j], rtol=tie, atol=0)
                assert int(gi[q][j]) in {int(x) for x in np.asarray(wi[q][:n])[tied]}, \
                    (what, q, j)


# ---------------------------------------------------------------------------
# size classes and membership
# ---------------------------------------------------------------------------

def test_size_class_bucketing():
    from elasticsearch_tpu.tenancy import size_class_of as ref_size_class_of

    assert size_class_of(1, 1) == (MIN_DOC_CLASS, MIN_BLOCK_CLASS)
    assert size_class_of(MIN_DOC_CLASS + 1, 1) == (2 * MIN_DOC_CLASS, MIN_BLOCK_CLASS)
    assert size_class_of(1000, 40) == (1024, 64)
    assert size_class_of(70, 3) == size_class_of(100, 5)
    for n, nb in ((1, 1), (24, 21), (24, 41), (129, 8), (8192, 300), (5, 1000)):
        assert size_class_of(n, nb) == ref_size_class_of(n, nb)


def test_superpack_enabled_reads_the_setting_only(engine, monkeypatch):
    monkeypatch.setenv("ES_TPU_SUPERPACK", "0")  # no environment switch
    assert superpack_enabled(engine.settings)
    assert engine.superpacks_if_enabled() is engine.superpacks
    engine.settings.update({"persistent": {"superpack.enabled": False}})
    monkeypatch.setenv("ES_TPU_SUPERPACK", "1")
    assert not superpack_enabled(engine.settings)
    assert engine.superpacks_if_enabled() is None
    assert not superpack_enabled(None)


def test_adopt_folds_lsm_tail_and_registers_lane(engine):
    idx = _tenant(engine, "ta")
    idx.index_doc("6", {"body": "alpha tail"})
    idx.refresh()
    assert idx._tails  # the refresh left a tail segment
    mgr = engine.superpacks
    assert mgr.adopt(idx)
    member = mgr.member_of("ta")
    assert member is not None and member.num_docs == 7
    assert not idx._tails and member.ss is idx._searcher
    assert mgr.adopt(idx)  # idempotent while current
    assert mgr.member_count() == 1 and member.epoch == 0


def test_oversize_tenant_not_adopted(engine):
    engine.settings.update({"persistent": {"superpack.max_docs": 4}})
    idx = _tenant(engine, "big", n=9)
    assert not engine.superpacks.adopt(idx)
    assert engine.superpacks.member_of("big") is None
    # an empty index is not a member either
    empty = engine.create_index("empty", {"properties": {"body": {"type": "text"}}})
    assert not engine.superpacks.adopt(empty)


# ---------------------------------------------------------------------------
# rows: the per-index exact arm and the JAX package
# ---------------------------------------------------------------------------

def test_solo_rows_byte_equal_exact_arm_and_close_to_reference(engine, ref_engine):
    mgr, rmgr = engine.superpacks, ref_engine.superpacks
    for i in range(4):
        docs = _docs(4 + i, i)
        idx = _tenant(engine, f"t{i}", docs=docs)
        ridx = _tenant(ref_engine, f"t{i}", docs=docs)
        assert mgr.adopt(idx) and rmgr.adopt(ridx)
    for i in range(4):
        name = f"t{i}"
        v, sh, ids, t = mgr.msearch(name, "body", QUERIES, k=5)
        assert not sh.any()
        _byte_equal_rows((v, ids, t), _exact_rows(engine.indices[name]._searcher, "body",
                                                  QUERIES, 5), name)
        rv, _rs, ri, rt = rmgr.msearch(name, "body", QUERIES, k=5)
        _close_rows((v, ids, t), (rv, ri, rt), name)


def test_two_size_classes_in_one_wave(engine, ref_engine):
    """bench.py C8's tenants at a small count: vocabularies of 20 and 40
    terms alternate, so the wave mixes two block size classes."""
    mgr, rmgr = engine.superpacks, ref_engine.superpacks
    names = []
    for t in range(8):
        trng = np.random.default_rng(10_000 + t)
        vocab = 40 if t % 2 else 20
        docs = [(str(j), {"body": " ".join(f"w{int(x)}" for x in trng.integers(0, vocab, 6))})
                for j in range(24)]
        name = f"tenant{t:04d}"
        assert mgr.adopt(_tenant(engine, name, docs=docs))
        assert rmgr.adopt(_tenant(ref_engine, name, docs=docs))
        names.append(name)
    assert len(mgr.packs) == 2 == len(rmgr.packs)
    assert set(mgr.packs) == set(rmgr.packs)
    entries, rentries, bodies = [], [], []
    for i in range(32):
        name = names[i % len(names)]
        body = {"match": {"body": f"w{i % 20} w{(i * 7) % 20}"}}
        e, re_ = _entry(name, query=body, size=10), _entry(name, query=body, size=10)
        assert mgr.wave_claim(e) and rmgr.wave_claim(re_)
        entries.append(e)
        rentries.append(re_)
        bodies.append((name, body))
    job, out = _run_wave(mgr, entries)
    _rjob, rout = _run_wave(rmgr, rentries)
    assert job["meta"]["term_packed"] == 32 and len(job["groups"]) == 2
    assert job["index_names"] == names
    for (name, body), resp, rresp in zip(bodies, out, rout):
        idx = engine.indices[name]
        terms = [(tok, 1.0) for tok in body["match"]["body"].split()]
        v, ids, t = _exact_rows(idx._searcher, "body", [terms], 10)
        want = idx._term_hits(v[0], np.zeros(10, np.int32), ids[0], int(t[0]), 10, 10, 0)
        assert resp == want, name
        assert resp["hits"]["total"] == rresp["hits"]["total"]
        got = [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
        ref = [(h["_id"], h["_score"]) for h in rresp["hits"]["hits"]]
        assert len(got) == len(ref)
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], rtol=1e-6)
    # shape keys, not tenants: the reference's count on the same traffic
    assert mgr.compiled_program_count() == rmgr.compiled_program_count()
    assert mgr.compiled_program_count() <= len(mgr.packs) * 8


def test_wave_claim_rejects_ineligible_entries(engine):
    mgr = engine.superpacks
    idx = _tenant(engine, "ta")
    assert mgr.adopt(idx)
    assert not mgr.wave_claim(_entry("ta", query={"range": {"body": {"gte": "a"}}}))
    assert not mgr.wave_claim(_entry("ta", aggs={"t": {"terms": {"field": "body"}}}))
    assert not mgr.wave_claim(_entry("ta", script_fields={"x": {"script": "1"}}))
    assert not mgr.wave_claim(_entry("nope"))
    assert not mgr.wave_claim({"index": "ta", "internal": lambda: None, "kwargs": {}})
    idx.index_doc("99", {"body": "late write"})
    assert not mgr.wave_claim(_entry("ta"))  # stale: pending writes


def test_stale_lane_refolds_and_serves_new_docs(engine):
    mgr = engine.superpacks
    idx = _tenant(engine, "ta", n=5)
    assert mgr.adopt(idx)
    old = mgr.member_of("ta")
    idx.index_doc("9", {"body": "alpha common fresh"})
    idx.refresh()
    assert not mgr.wave_claim(_entry("ta"))  # stale against the new tiers
    assert mgr.refold("ta")
    member = mgr.member_of("ta")
    assert member.epoch == old.epoch + 1 and member.num_docs == 6 and member.lane == old.lane
    e = _entry("ta", query={"match": {"body": "fresh"}})
    assert mgr.wave_claim(e)
    _job, out = _run_wave(mgr, [e])
    assert [h["_id"] for h in out[0]["hits"]["hits"]] == ["9"]


def test_compiled_program_count_bounded_by_size_class(engine):
    mgr = engine.superpacks
    names = [f"t{i}" for i in range(12)]
    for i, name in enumerate(names):
        assert mgr.adopt(_tenant(engine, name, n=5 + (i % 2), seed=i))
    assert len(mgr.packs) == 1
    entries = []
    for name in names:
        e = _entry(name, query={"match": {"body": "common"}}, size=3)
        assert mgr.wave_claim(e)
        entries.append(e)
    _run_wave(mgr, entries)
    for name in names:
        mgr.msearch(name, "body", [[("common", 1.0)]], k=3)
    assert mgr.compiled_program_count() <= 4
    assert mgr.member_count() == 12


def test_lane_growth_preserves_existing_lanes(engine):
    mgr = engine.superpacks
    names = [f"g{i}" for i in range(11)]
    for i, name in enumerate(names):
        assert mgr.adopt(_tenant(engine, name, n=5 + (i % 2), seed=i))
    assert len(mgr.packs) == 1
    pack = next(iter(mgr.packs.values()))
    assert pack.capacity > 8
    lanes = [pack.lanes[n].lane for n in names]
    assert len(set(lanes)) == len(names)
    queries = [[("common", 1.0)], [("alpha", 1.0), ("beta", 1.0)]]
    for name in names:
        v, _sh, i, t = mgr.msearch(name, "body", queries, k=5)
        _byte_equal_rows((v, i, t), _exact_rows(engine.indices[name]._searcher, "body",
                                                queries, 5), name)


def test_delete_index_evicts_lane(engine):
    mgr = engine.superpacks
    assert mgr.adopt(_tenant(engine, "ta", n=5, seed=0))
    assert mgr.adopt(_tenant(engine, "tb", n=5, seed=3))
    pack = next(iter(mgr.packs.values()))
    lane_b = mgr.member_of("tb").lane
    engine.delete_index("tb")
    assert mgr.member_of("tb") is None and lane_b in pack.free
    assert not pack.dev["live"][lane_b].any()
    # the freed slot is leased again by the next tenant
    assert mgr.adopt(_tenant(engine, "tc", n=5, seed=4))
    assert mgr.member_of("tc").lane == lane_b
    e = _entry("ta")
    assert mgr.wave_claim(e)
    _job, out = _run_wave(mgr, [e])
    assert out[0]["hits"]["total"]["value"] >= 1


def _lane_snapshot(pack):
    return {k: v.clone() for k, v in pack.dev.items()}


def test_failed_fold_leaves_every_lane_then_retry_lands(engine, monkeypatch):
    mgr = engine.superpacks
    a = _tenant(engine, "ta", n=5, seed=0)
    b = _tenant(engine, "tb", n=5, seed=2)
    assert mgr.adopt(a) and mgr.adopt(b)
    pack = next(iter(mgr.packs.values()))
    snap = _lane_snapshot(pack)
    old_b = mgr.member_of("tb")
    before = mgr.msearch("ta", "body", [[("common", 1.0)]], k=4)
    b.index_doc("9", {"body": "common churn"})
    b.refresh()

    def fail(self, ss):
        raise MemoryError("device out of memory while staging the lane")

    monkeypatch.setattr(Superpack, "stage_lane", fail)
    with pytest.raises(MemoryError):
        mgr.refold("tb")
    for k, v in pack.dev.items():
        assert np.array_equal(v.numpy(), snap[k].numpy()), k
    assert mgr.member_of("tb") is old_b
    assert pack.fold_failures == 1 and mgr.stats()["fold_failures"] == 1
    after = mgr.msearch("ta", "body", [[("common", 1.0)]], k=4)
    for x, y in zip(before, after):
        assert np.array_equal(x, y)
    monkeypatch.undo()
    assert mgr.refold("tb")
    member = mgr.member_of("tb")
    assert member is not old_b and member.num_docs == 6
    e = _entry("tb", query={"match": {"body": "churn"}})
    assert mgr.wave_claim(e)
    _job, out = _run_wave(mgr, [e])
    assert [h["_id"] for h in out[0]["hits"]["hits"]] == ["9"]


# ---------------------------------------------------------------------------
# the serving wave
# ---------------------------------------------------------------------------

def test_serving_wave_mixes_tenants_with_exact_arm_rows(engine):
    mgr = engine.superpacks
    tenants = {f"t{i}": _tenant(engine, f"t{i}", n=4 + i, seed=i) for i in range(5)}
    for idx in tenants.values():
        assert mgr.adopt(idx)
    engine.settings.update({"persistent": {"serving.enabled": True}})
    svc = engine.serving
    try:
        body = {"query": {"match": {"body": "alpha common"}}, "size": 4}
        want = {}
        for n, idx in tenants.items():
            v, ids, t = _exact_rows(idx._searcher, "body", [[("alpha", 1.0), ("common", 1.0)]], 4)
            want[n] = idx._term_hits(v[0], np.zeros(4, np.int32), ids[0], int(t[0]), 4, 4, 0)
        futs = [(n, svc.submit(svc.classify(n, dict(body), {}), tenant=n))
                for n in tenants for _ in range(2)]
        for n, f in futs:
            assert f.result(timeout=60) == want[n]
        assert svc.drain(60.0)
        assert svc.counters["superpack_packed"] == len(futs)
        assert svc.counters["term_packed"] >= len(futs)
    finally:
        svc.stop()


def test_serving_schedules_background_fold_for_stale_member(engine):
    mgr = engine.superpacks
    idx = _tenant(engine, "ta", n=4)
    assert mgr.adopt(idx)
    engine.settings.update({"persistent": {"serving.enabled": True}})
    svc = engine.serving
    try:
        idx.index_doc("9", {"body": "alpha common fresh"})
        idx.refresh()
        old = mgr.member_of("ta")
        body = {"query": {"match": {"body": "fresh"}}, "size": 3}
        # the stale claim serves per index and queues the `_merge` refold
        res = svc.submit(svc.classify("ta", dict(body), {})).result(timeout=60)
        assert [h["_id"] for h in res["hits"]["hits"]] == ["9"]
        deadline = time.monotonic() + 30.0
        while mgr.member_of("ta") is old and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mgr.member_of("ta") is not old, "background refold missed"
        assert mgr.member_of("ta").num_docs == 5
        assert svc.counters["merges"] >= 1
        e = _entry("ta", query=body["query"], size=3)
        assert mgr.wave_claim(e)
    finally:
        svc.stop()


def test_tail_fold_rides_the_queue_as_the_merge_tenant(engine):
    """With serving on, an LSM tail fold past indexing.tiers.max_segments is
    a `_merge` tenant entry of the queue; with serving off it folds inline."""
    engine.settings.update({"persistent": {"indexing.tiers.max_segments": 1}})
    idx = _tenant(engine, "w", n=300)
    for r in range(2):
        idx.index_doc(f"n{r}", {"body": f"alpha round{r}"})
        idx.refresh()
    assert len(idx._tails) == 1 and engine.serving_if_enabled() is None  # folded inline
    engine.settings.update({"persistent": {"serving.enabled": True}})
    svc = engine.serving
    try:
        merges = svc.counters["merges"]
        idx.index_doc("n2", {"body": "alpha round2"})
        idx.refresh()
        deadline = time.monotonic() + 30.0
        while svc.counters["merges"] == merges and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.drain(60.0)
        assert svc.counters["merges"] == merges + 1
        assert len(idx._tails) == 1 and not idx._merge_inflight
        assert engine.metering.rows()["_merge"]["requests"] == 1  # metered as its own tenant
        assert idx.search({"match": {"body": "round2"}})["hits"]["total"]["value"] == 1
    finally:
        svc.stop()


def test_manager_stats(engine):
    mgr = engine.superpacks
    for i in range(3):
        assert mgr.adopt(_tenant(engine, f"t{i}", n=5 + (i % 2), seed=i))
    st = mgr.stats()
    assert st["enabled"] and st["members"] == 3 and st["size_classes"] == 1
    assert st["hbm_bytes"] > 0 and st["hbm_bytes_per_tenant"] == st["hbm_bytes"] // 3
    assert 0.0 < st["padded_waste_pct"] <= 100.0
    cls = next(iter(st["classes"].values()))
    assert cls["members"] == 3 and cls["lanes"] == 8
    ms = mgr.member_stats("t0")
    key = next(iter(mgr.packs))
    assert ms["size_class"] == f"{key[0]}x{key[1]}" and ms["lane"] == mgr.member_of("t0").lane
    assert mgr.member_stats("absent") is None
    rows = engine.tenant_stats()
    assert rows["superpack"]["members"] == 3
