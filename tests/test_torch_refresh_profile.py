"""The port's refresh stage profile (`monitoring/refresh_profile.py`): the
flat-sum stage clock, the collector scoping, the RefreshProfile records of
each refresh kind, the bounded ring behind `indexing.profile.size`,
`GET /_refresh/profile`, the `build.*` cost entries (equal to the JAX
package's), and the stacked build's analysis overlap (the same packs with
and without it, worker spans recorded, a worker's exception raised).
"""

import json
import math
import threading
import time

import numpy as np
import pytest

from elasticsearch_tpu.monitoring import costmodel as ref_costmodel
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.monitoring import costmodel
from elasticsearch_tpu_torch.monitoring.refresh_profile import (
    OTHER_STAGE, RefreshRecorder, StageCollector, active_collector, build_stage,
    collect_build_stages, default_recorder, refresh_stage)
from elasticsearch_tpu_torch.parallel import stacked as stacked_mod
from elasticsearch_tpu_torch.parallel.stacked import (StackedPack, _ingest_shard,
                                                      build_stacked_pack_routed, route_docs)
from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset
from elasticsearch_tpu_torch.rest import make_app

BUILD_NAMES = ["build.kmeans", "build.impact_quantize", "build.csr_assemble", "build.norms",
               "build.ann_tiles", "build.device_put", "build.merge", "build.segment_merge",
               "build.analyze"]
MAPPING = {"properties": {"body": {"type": "text"}, "n": {"type": "long"}}}


@pytest.fixture(autouse=True)
def _fresh_planner():
    planner_reset()
    yield
    planner_reset()


def test_stage_collector_sums_exactly_to_wall():
    c = StageCollector()
    with c.stage("a"):
        time.sleep(0.002)
        with c.stage("b", basis="host"):
            time.sleep(0.001)
        with c.stage("b", basis="device"):
            pass
    time.sleep(0.001)
    wall, stages = c.finish()
    assert set(stages) == {OTHER_STAGE, "a", "b"}
    assert math.isclose(sum(stages.values()), wall, rel_tol=1e-12, abs_tol=1e-12)
    assert stages["a"] >= 0.0015 and stages["b"] >= 0.0009
    assert c.bases == {"b": "mixed"}
    assert [e[0] for e in c.events] == ["b", "b", "a"]


def test_only_the_active_collector_is_charged():
    assert active_collector() is None
    with refresh_stage("outside"):  # no collector: nothing recorded, no error
        pass
    with collect_build_stages() as outer:
        with refresh_stage("x"):
            with collect_build_stages() as inner:
                assert active_collector() is inner
                with build_stage("build.norms", num_docs=10, nfields=1, basis="host"):
                    pass
            assert active_collector() is outer
        seen = []
        th = threading.Thread(target=lambda: seen.append(active_collector()))
        th.start()
        th.join()
        assert seen == [None]  # a new thread charges nothing
        t0 = time.perf_counter()
        outer.note_span("build.analyze", t0, t0 + 0.5)
    assert active_collector() is None
    _, st_in = inner.finish()
    _, st_out = outer.finish()
    assert "build.norms" in st_in and "build.norms" not in st_out
    assert "x" in st_out and "x" not in st_in
    assert "build.analyze" not in st_out
    assert math.isclose(outer.async_stages["build.analyze"], 0.5, rel_tol=1e-9)


def _profiles(eng):
    return eng.refresh_recorder.profiles()["profiles"]


def _write(idx, lo, hi, tag="v"):
    for i in range(lo, hi):
        idx.index_doc(f"d{i}", {"body": f"hello {tag}{i % 17} world", "n": i})


@pytest.mark.parametrize("shards", [1, 2])
def test_refresh_kinds_recorded_with_stages_summing_to_wall(shards):
    eng = Engine(device="cpu")
    idx = eng.create_index("x", MAPPING, {"number_of_shards": shards})
    _write(idx, 0, 900)
    idx.refresh()  # the 256-doc rule: a full rebuild
    for r in range(6):  # incremental tails, then a fold past 4 segments
        _write(idx, 900 + 20 * r, 920 + 20 * r, tag=f"r{r}")
        idx.refresh()
    idx.searcher  # the major merge
    profs = _profiles(eng)
    kinds = [p["kind"] for p in profs]
    assert kinds[0] == "full" and "incremental" in kinds
    assert "segment_merge" in kinds and kinds[-1] == "merge"
    for p in profs:
        assert abs(sum(p["stages_ms"].values()) - p["wall_ms"]) <= 1e-3 * len(p["stages_ms"])
        assert p["index"] == "x" and p["docs"] >= 0
        assert {"build.norms", "build.csr_assemble", "build.device_put"} <= set(p["stages_ms"])
        assert p["basis"]["build.csr_assemble"] == "host"  # the CPU is the host route
    full = profs[0]
    assert full["docs"] == 900 and full["tiers"]["segments"] == 0
    assert {"analyze", "build.analyze", "flat_csr", "docvalues", "positions"} <= \
        set(full["stages_ms"])
    if shards > 1:
        assert {"route", "stack"} <= set(full["stages_ms"])
    seg = next(p for p in profs if p["kind"] == "segment_merge")
    assert "build.segment_merge" in seg["stages_ms"] and seg["tiers"]["segments"] == 1
    assert "build.merge" in profs[-1]["stages_ms"]
    stats = eng.refresh_recorder.indexing_stats()
    assert stats["refresh_total"] == len(profs) and stats["merge_total"] >= 2


def test_ring_is_bounded_by_the_setting():
    eng = Engine(device="cpu")
    assert eng.refresh_recorder.profiles()["capacity"] == 256
    eng.settings.update({"transient": {"indexing.profile.size": 3}})
    idx = eng.create_index("x", MAPPING)
    for r in range(4):  # four incremental refreshes, within the segment bound
        _write(idx, 10 * r, 10 * r + 10)
        idx.refresh()
    out = eng.refresh_recorder.profiles()
    assert out["capacity"] == 3 and out["retained"] == 3 and out["recorded_total"] == 4
    assert [p["refresh"] for p in out["profiles"]] == [2, 3, 4]
    assert eng.refresh_recorder.profiles(2)["retained"] == 2
    assert eng.refresh_recorder.profiles(0)["profiles"] == []
    with pytest.raises(Exception):
        eng.settings.update({"transient": {"indexing.profile.size": -1}})


def test_standalone_index_records_to_the_default_recorder():
    from elasticsearch_tpu_torch.engine import EsIndex

    before = default_recorder().profiles()["recorded_total"]
    idx = EsIndex("solo", MAPPING, device="cpu")
    _write(idx, 0, 5)
    idx.refresh()
    assert default_recorder().profiles()["recorded_total"] == before + 2


def test_rest_refresh_profile():
    app = make_app(device="cpu")
    try:
        body = b'{"mappings": {"properties": {"body": {"type": "text"}}}}'
        assert app.handle("PUT", "/r", body=body)[0] == 200
        for i in range(3):
            app.handle("PUT", f"/r/_doc/{i}", {"refresh": "true"},
                       body=json.dumps({"body": f"hello {i}"}).encode())
        st, _h, raw = app.handle("GET", "/_refresh/profile")
        out = json.loads(raw)
        assert st == 200 and out["recorded_total"] == 3 and out["capacity"] == 256
        assert all("stages_ms" in p and "basis" in p for p in out["profiles"])
        st, _h, raw = app.handle("GET", "/_refresh/profile", {"n": "1"})
        assert st == 200 and json.loads(raw)["retained"] == 1
        assert app.handle("GET", "/_refresh/profile", {"n": "x"})[0] == 400
        st, _h, raw = app.handle("PUT", "/_cluster/settings",
                                 body=b'{"transient": {"indexing.profile.size": 2}}')
        assert st == 200
        assert json.loads(app.handle("GET", "/_refresh/profile")[2])["retained"] == 2
    finally:
        app.close()


@pytest.mark.parametrize("name", BUILD_NAMES)
def test_build_names_resolve_in_kernel_costs(name):
    fields = {"n": 10_000, "dims": 64, "nlist": 100, "iters": 8, "rows": 4096,
              "code_bytes": 2, "postings": 1_000_000, "num_docs": 50_000, "nfields": 2,
              "tile": 256, "nbytes": 1 << 20, "docs": 50_000}
    assert costmodel.KERNEL_COSTS.get(name) is not None
    got = costmodel.kernel_cost(name, fields)
    assert got is not None and got == ref_costmodel.kernel_cost(name, fields)
    assert costmodel.kernel_cost(name, {}) is None


def _routed(n: int, shards: int):
    rng = np.random.default_rng(2)
    docs = [(f"d{i}", {"body": " ".join(f"t{j}" for j in rng.integers(0, 50, 12)), "n": i})
            for i in range(n)]
    return route_docs(docs, shards)


def test_overlap_gives_the_same_packs_and_records_worker_spans():
    m = Mappings(MAPPING)
    routed = _routed(600, 3)
    with collect_build_stages() as c:
        a = build_stacked_pack_routed(routed, m, device="cpu")
    serial = [_ingest_shard(d, m, False, "cpu").build(dense_min_df=1 << 62) for d in routed]
    b = StackedPack(serial, m)
    for name in ("post_docids", "post_tfs", "post_dls", "pos_keys", "live"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes(), name
    assert a.global_df == b.global_df and a.field_stats == b.field_stats
    assert c.async_stages["build.analyze"] > 0  # shards 1 and 2 on the worker
    assert len(c.async_events) == 2
    _, stages = c.finish()
    assert {"analyze", "stack", "flat_csr"} <= set(stages)


def test_overlap_worker_exception_is_raised(monkeypatch):
    m = Mappings(MAPPING)
    routed = _routed(300, 3)
    real = stacked_mod._ingest_shard
    calls = []

    def flaky(docs, mappings, parsed, device=None):
        calls.append(1)
        if len(calls) == 2:  # shard 1, on the worker thread
            raise RuntimeError("worker boom")
        return real(docs, mappings, parsed, device)

    monkeypatch.setattr(stacked_mod, "_ingest_shard", flaky)
    with pytest.raises(RuntimeError, match="worker boom"):
        build_stacked_pack_routed(routed, m, device="cpu")


def test_recorder_counts_kinds_and_stage_totals():
    rec = RefreshRecorder(4)
    for k in ("full", "incremental", "segment_merge", "merge"):
        rec.record({"kind": k, "docs": 10, "stages_ms": {"a": 1.0},
                    "async_stages_ms": {"build.analyze": 2.0}})
    st = rec.indexing_stats()
    assert st["refresh_kinds"] == {"full": 1, "incremental": 1, "segment_merge": 1, "merge": 1}
    assert st["merge_total"] == 2 and st["stage_ms"] == {"a": 4.0, "build.analyze": 8.0}
    rec.set_size(2)
    assert rec.profiles()["retained"] == 2
