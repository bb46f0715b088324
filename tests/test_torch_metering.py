"""Per-tenant metering of the port (`elasticsearch_tpu_torch/tenancy/metering.py`
and its consumers), against the JAX package's `tenancy/metering.py`.

Mirrors the pure and the service cases of tests/test_tenant_metering.py:
the shared normalizer at every layer (queue key, weight table, meter row,
REST), `apportion` and `fairshare_weights` equal to the reference's outputs
on the same inputs, the bounded ledger, every serving wave's tenant shares
summing exactly (`==`) to its device segment (superpack waves included),
the fair-share closed loop and its kill switch, `_tenants/stats` and
`_cat/tenants` with `_bulk` ingest metering, and ES|QL query walls metered
per tenant. No case waits on wall-clock timing: each drains the serving
queue before it reads the ledger.
"""

import json
import math
import random
from concurrent.futures import wait

import pytest

from elasticsearch_tpu.tenancy import metering as ref_metering
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.tenancy.metering import (
    DEFAULT_TENANT, OTHER_TENANT, TenantMeter, apportion, fairshare_weights,
    normalize_tenant, shares_sum,
)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"]


@pytest.fixture
def engine():
    e = Engine(device="cpu")
    yield e
    e.close()


@pytest.fixture
def served(engine):
    idx = engine.create_index("idx", {"properties": {
        "title": {"type": "text"}, "tag": {"type": "keyword"}}})
    for i in range(60):
        idx.index_doc(str(i), {"title": f"{WORDS[i % 7]} {WORDS[(i + 2) % 7]} common",
                               "tag": WORDS[i % 3]})
    idx.refresh()
    svc = engine.serving
    yield engine, idx, svc
    svc.stop()


def _bodies():
    return [
        {"query": {"match": {"title": "alpha"}}, "size": 5},
        {"query": {"term": {"tag": "beta"}}, "size": 4},
        {"query": {"match": {"title": "common"}}, "size": 10,
         "aggs": {"t": {"terms": {"field": "tag"}}}},
    ]


def _run_wave(svc, bodies, tenants=None, index="idx"):
    entries = [svc.classify(index, b, {}) for b in bodies]
    assert all(e is not None for e in entries)
    futs = [svc.submit(e, tenant=(tenants[i % len(tenants)] if tenants else None))
            for i, e in enumerate(entries)]
    wait(futs, timeout=120)
    out = [f.result(timeout=1) for f in futs]
    assert svc.drain(60.0)  # the wave's meter record lands before the drain ends
    return out


# ---------------------------------------------------------------------------
# the pure functions, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [None, "", "   ", "team a!/x", "ok-id_7", "x" * 500, 123,
                                 "ünïcode tenant", "a.b.c"])
def test_normalize_tenant_equals_reference(raw):
    assert normalize_tenant(raw) == ref_metering.normalize_tenant(raw)
    assert len(normalize_tenant(raw)) <= 64
    assert DEFAULT_TENANT == ref_metering.DEFAULT_TENANT
    assert OTHER_TENANT == ref_metering.OTHER_TENANT


def test_normalizer_is_one_function_at_every_layer():
    from elasticsearch_tpu_torch.rest import app
    from elasticsearch_tpu_torch.serving import queue, service

    assert queue.normalize_tenant is normalize_tenant
    assert service.normalize_tenant is normalize_tenant
    assert app.normalize_tenant is normalize_tenant


@pytest.mark.parametrize("seed", [19, 20, 21])
def test_apportion_equals_reference_and_sums_exactly(seed):
    rng = random.Random(seed)
    for _ in range(300):
        n = rng.randint(1, 9)
        total = rng.uniform(0.0001, 5000.0)
        weights = {f"t{i}": rng.uniform(0.0, 10.0) for i in range(n)}
        if rng.random() < 0.2:
            weights["t0"] = 0.0
        shares = apportion(total, weights)
        assert shares == ref_metering.apportion(total, weights)
        assert set(shares) == set(weights)
        assert shares_sum(shares) == total
        assert all(v >= 0.0 for v in shares.values())


def test_apportion_zero_weight_edge_cases():
    for total, w in ((10.0, {}), (9.0, {"a": 0.0, "b": 0.0, "c": 0.0}),
                     (7.5, {"a": 3.0, "b": 0.0}), (100.0, {"a": 3.0, "b": 1.0}),
                     (1.0, {"a": float("nan")}), (0.0, {"a": 1.0, "b": 2.0})):
        got = apportion(total, w)
        assert got == ref_metering.apportion(total, w)
        if w:
            assert shares_sum(got) == total
    mix = apportion(7.5, {"a": 3.0, "b": 0.0})
    assert mix == {"a": 7.5, "b": 0.0}


@pytest.mark.parametrize("case", [
    ({"a": 4.0, "b": 1.0}, {"a": 20.0, "b": 1.0}, 10.0, 0.25),
    ({"a": 4.0, "b": 1.0}, {"a": 1e9}, 10.0, 0.25),
    ({}, {"new": 40.0}, 10.0, 0.25),
    ({"a": 4.0}, {"a": 99.0}, 0.0, 0.25),
    ({"a": 4.0}, {}, 10.0, 0.25),
    ({"a": 4.0, "b": 1.0}, {"a": 5.0, "b": 1.0}, 10.0, 0.25),
    ({"a": 2.0, "_merge": 1.0}, {"a": 30.0, "b": 12.0}, 3.0, 0.001),
    ({"a": 2.0}, {"a": 30.0}, 3.0, 7.0),
])
def test_fairshare_weights_equal_reference(case):
    static, burn, budget, mf = case
    got = fairshare_weights(static, burn, budget, mf)
    assert got == ref_metering.fairshare_weights(static, burn, budget, mf)
    # cold state: the static table itself
    if budget <= 0.0 or not burn or all(r <= budget for r in burn.values()):
        assert got is static
    assert static == case[0]  # never mutated


def test_meter_folds_cold_rows_into_other_and_conserves_totals():
    meter, ref = TenantMeter(top_k=3), ref_metering.TenantMeter(top_k=3)
    fed = 0.0
    for i in range(8):
        ms = float(10 * (i + 1))
        for m in (meter, ref):
            m.record_wave({f"tenant{i}": ms}, {f"tenant{i}": 1})
        fed += ms
    rows = meter.rows()
    assert set(rows) == set(ref.rows())
    assert len(rows) <= 3 + 1 and OTHER_TENANT in rows
    assert "tenant7" in rows and "tenant6" in rows
    assert math.fsum(r["device_ms"] for r in rows.values()) == pytest.approx(fed, abs=1e-6)
    assert sum(r["requests"] for r in rows.values()) == 8
    assert {t: r["device_ms"] for t, r in rows.items()} == \
        {t: r["device_ms"] for t, r in ref.rows().items()}


def test_meter_never_evicts_anonymous_or_other():
    meter = TenantMeter(top_k=2)
    meter.record_wave({DEFAULT_TENANT: 1.0}, {DEFAULT_TENANT: 1})
    for i in range(6):
        meter.record_wave({f"hot{i}": 100.0 + i}, {f"hot{i}": 1})
    rows = meter.rows()
    assert DEFAULT_TENANT in rows and OTHER_TENANT in rows
    meter.set_top_k(1)  # clamped to 2
    assert meter.top_k == 2


def test_meter_counters_kernels_and_dominant_kernel():
    meter = TenantMeter()
    meter.note("sheds", "greedy", 3)
    meter.note("requests", "greedy", 1)
    meter.note_queue_wait("greedy", 12.0)
    meter.note_ingest("greedy", 4096, docs=7)
    meter.record_wave({"greedy": 10.0}, {"greedy": 2},
                      {"greedy": {"weight": 1.0, "flops": 2e9, "bytes": 1e6,
                                  "kernels": {"batched.disjunction": 0.75,
                                              "superpack.tenant_gather": 0.25}}})
    r = meter.rows()["greedy"]
    assert r["sheds"] == 3 and r["shed_rate"] == pytest.approx(0.5)
    assert r["queue_wait_ms"] == pytest.approx(12.0)
    assert r["ingest_bytes"] == 4096 and r["ingest_docs"] == 7
    assert r["flops"] == 2e9
    assert r["kernels"]["batched.disjunction"] == pytest.approx(7.5)
    assert meter.dominant_kernel("greedy") == "batched.disjunction"
    assert meter.dominant_kernel("nobody") is None


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

def test_normalizer_is_shared_by_queue_weights_and_meter(served):
    engine, _idx, svc = served
    engine.settings.update({"persistent": {"serving.tenant.weights": "team a!:4"}})
    assert svc._static_weights.get("team_a_") == 4.0
    _run_wave(svc, _bodies(), tenants=["team a!"])
    rows = engine.metering.rows()
    assert "team_a_" in rows and "team a!" not in rows
    _run_wave(svc, _bodies()[:1])
    assert DEFAULT_TENANT in engine.metering.rows()


def test_wave_tenant_shares_partition_device_segment_exactly(served):
    engine, _idx, svc = served
    for _ in range(3):
        _run_wave(svc, _bodies(), tenants=["tA", "tB", "tC"])
    waves = svc.tenant_waves()
    assert [w for w in waves if len(w["tenants"]) >= 2], "no mixed-tenant wave"
    for w in waves:
        mix = w["tenants"]
        assert shares_sum(v["device_ms"] for v in mix.values()) == w["device_ms"]
        if w["device_ms"] > 0:
            assert math.fsum(v["share"] for v in mix.values()) == pytest.approx(1.0, abs=1e-9)
    rows = engine.metering.rows()
    assert {"tA", "tB", "tC"} <= set(rows)
    ledger = math.fsum(rows[t]["device_ms"] for t in ("tA", "tB", "tC"))
    recorded = math.fsum(v["device_ms"] for w in waves for v in w["tenants"].values())
    assert ledger == pytest.approx(recorded, abs=0.01)
    assert rows["tA"]["waves"] >= 1 and rows["tA"]["queue_wait_ms"] >= 0.0
    assert rows["tA"]["kernels"]


def test_superpack_wave_shares_sum_exactly(engine):
    engine.settings.update({"persistent": {"superpack.enabled": True}})
    names = [f"sp-tenant-{i}" for i in range(4)]
    for j, name in enumerate(names):
        idx = engine.create_index(name, {"properties": {"body": {"type": "text"}}})
        for i in range(5 + j):
            idx.index_doc(str(i), {"body": f"{WORDS[(i + j) % 7]} common"})
        idx.refresh()
        assert engine.superpacks.adopt(idx)
    svc = engine.serving
    try:
        futs = [svc.submit(svc.classify(n, {"query": {"match": {"body": "common alpha"}},
                                            "size": 3}, {}), tenant=n)
                for n in names for _ in range(2)]
        wait(futs, timeout=120)
        for f in futs:
            assert f.result(timeout=1)["hits"]["total"]["value"] >= 5
        assert svc.drain(60.0)
        assert svc.stats()["superpack_packed"] == len(futs)
        for w in svc.tenant_waves():
            assert shares_sum(v["device_ms"] for v in w["tenants"].values()) == w["device_ms"]
        rows = engine.metering.rows()
        for n in names:
            assert rows[normalize_tenant(n)]["kernels"] == {
                "superpack.tenant_gather": rows[normalize_tenant(n)]["device_ms"]} or \
                rows[normalize_tenant(n)]["device_ms"] == 0.0
    finally:
        svc.stop()


def test_sheds_and_expiries_are_metered(served):
    engine, _idx, svc = served
    engine.settings.update({"persistent": {"serving.queue.max_depth": 1}})
    svc.stop()  # nothing drains: the queue fills
    svc._ensure_threads = lambda: None
    e = svc.classify("idx", _bodies()[0], {})
    fut = svc.submit(dict(e), tenant="slow", timeout_s=1e-9)
    from elasticsearch_tpu_torch.serving import ServingRejectedError

    with pytest.raises(ServingRejectedError):
        svc.submit(dict(e), tenant="shed-me")
    assert engine.metering.rows()["shed-me"]["sheds"] == 1
    del svc._ensure_threads
    svc.set_queue_depth(10)
    svc._ensure_threads()
    # the scheduler pops the entry, finds it expired and resolves it: the
    # future resolves after the meter's note
    assert fut.result(timeout=60)["timed_out"] is True
    assert engine.metering.rows()["slow"]["expired"] == 1


def test_settings_are_accepted_and_take_effect(engine):
    engine.settings.update({"transient": {
        "superpack.enabled": True, "superpack.max_docs": 5, "metering.tenant.top_k": 3,
        "planner.tenant.fairshare": True, "planner.tenant.fairshare.min_factor": 0.5,
        "slo.tenant.device_ms_per_s": 2.5, "serving.merge.weight": 3.0}})
    assert engine.superpacks_if_enabled() is engine.superpacks
    assert engine.superpacks._max_docs() == 5 and engine.metering.top_k == 3
    fs = engine.serving.stats()["fairshare"]
    assert fs["enabled"] and fs["min_factor"] == 0.5 and fs["budget_device_ms_per_s"] == 2.5
    assert fs["static_weights"]["_merge"] == 3.0
    engine.settings.update({"transient": {"superpack.enabled": False}})
    assert engine.superpacks_if_enabled() is None


def test_service_fairshare_closed_loop_and_kill_switch(served):
    engine, _idx, svc = served
    engine.settings.update({"persistent": {"serving.tenant.weights": "tA:4,tB:2"}})
    st = svc.stats()["fairshare"]
    assert st["enabled"] is False and st["effective_weights"] == st["static_weights"]
    for _ in range(2):
        _run_wave(svc, _bodies(), tenants=["tA"])
    engine.settings.update({"persistent": {
        "planner.tenant.fairshare": True, "slo.tenant.device_ms_per_s": 1e-6,
        "planner.tenant.fairshare.min_factor": 0.25}})
    st = svc.stats()["fairshare"]
    eff, static = st["effective_weights"], st["static_weights"]
    assert st["enabled"] is True
    assert eff["tA"] < static["tA"] and eff["tA"] >= static["tA"] * 0.25 - 1e-9
    assert eff.get(svc.MERGE_TENANT) == static.get(svc.MERGE_TENANT)
    engine.settings.update({"persistent": {"planner.tenant.fairshare": False}})
    st = svc.stats()["fairshare"]
    assert st["effective_weights"] == st["static_weights"]


def test_rest_tenants_stats_and_cat_tenants():
    app = make_app(device="cpu")
    try:
        h = app.handle
        h("PUT", "/_cluster/settings", {}, {},
          json.dumps({"persistent": {"serving.enabled": True}}).encode())
        h("PUT", "/tlogs", {}, {},
          json.dumps({"mappings": {"properties": {"x": {"type": "text"}}}}).encode())
        nd = ('{"index":{"_index":"tlogs","_id":"1"}}\n{"x":"alpha common"}\n'
              '{"index":{"_index":"tlogs","_id":"2"}}\n{"x":"beta common"}\n')
        status, _, _ = h("POST", "/_bulk", {"refresh": "true"}, {"X-Opaque-Id": "writer-1"},
                         nd.encode())
        assert status == 200
        for _ in range(3):
            status, _, _ = h("POST", "/tlogs/_search", {}, {"X-Opaque-Id": "reader-1"},
                             json.dumps({"query": {"match": {"x": "common"}},
                                         "size": 2}).encode())
            assert status == 200
        assert app.engine.serving.drain(60.0)
        status, _, raw = h("GET", "/_tenants/stats", {}, {}, b"")
        rows = json.loads(raw)["tenants"]["tenants"]
        assert rows["writer-1"]["ingest_bytes"] == len(nd.encode())
        assert rows["writer-1"]["ingest_docs"] == 2
        assert rows["reader-1"]["requests"] == 3 and rows["reader-1"]["device_ms"] >= 0.0
        status, _, raw = h("GET", "/_cat/tenants", {"v": "true", "format": "json"}, {}, b"")
        cat = json.loads(raw)
        assert {"reader-1", "writer-1"} <= {r["tenant"] for r in cat}
        assert set(cat[0]) == {"tenant", "requests", "waves", "device_ms", "device_ms_per_s",
                               "queue_p99_ms", "sheds", "shed_rate", "cache.hits",
                               "cache.misses", "ingest.bytes", "dominant_kernel"}
        status, _, raw = h("GET", "/_cat/tenants", {"v": "true", "h": "tenant,sheds"}, {}, b"")
        text = raw.decode()
        assert text.splitlines()[0].split() == ["tenant", "sheds"] and "reader-1" in text
    finally:
        app.close()


def test_esql_query_walls_are_metered_per_tenant():
    app = make_app(device="cpu")
    try:
        h = app.handle
        h("PUT", "/logs", {}, {},
          json.dumps({"mappings": {"properties": {"n": {"type": "long"}}}}).encode())
        nd = "".join(f'{{"index":{{"_index":"logs","_id":"{i}"}}}}\n{{"n":{i}}}\n'
                     for i in range(20))
        h("POST", "/_bulk", {"refresh": "true"}, {}, nd.encode())
        status, _, _ = h("POST", "/_query", {}, {"X-Opaque-Id": "analyst"},
                         json.dumps({"query": "FROM logs | STATS s = SUM(n)"}).encode())
        assert status == 200
        row = app.engine.metering.rows()["analyst"]
        assert row["requests"] == 1 and row["waves"] == 1 and row["device_ms"] > 0.0
        assert all(k.startswith("esql.") for k in row["kernels"])
    finally:
        app.close()
