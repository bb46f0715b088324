"""The port's execution planner, cost model and kernel timing against the
JAX package's.

The cases of the reference's tests/test_planner.py that the port's planner
can run (cold start is static, partially cold is static, disabled, warm
argmin, the wall-only feed, scoped, standing and total repricing, the
nprobe / wave-close / cache knobs' bounds, the residual export, the
decision latency, the settings), the lints over the port's sources (the
`choose_arm` sites equal `ARM_SITES`; every priced kernel and every
`time_kernel` name has a `KERNEL_COSTS` entry), and three cross-checks:
both planners fed the same observations give the same arm, prediction and
residual; the port's `kernel_cost` equals the reference's on every shared
key; a cold planner routes `_msearch` byte for byte as the static order
fused > impact > exact did before the planner.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from elasticsearch_tpu.monitoring import costmodel as ref_costmodel
from elasticsearch_tpu.planner import ExecutionPlanner as RefExecutionPlanner
from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
from elasticsearch_tpu_torch.corpus import corpus_docs, make_corpus, sample_queries
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.pack import BLOCK, PackBuilder
from elasticsearch_tpu_torch.monitoring import costmodel
from elasticsearch_tpu_torch.monitoring.costmodel import KERNEL_COSTS
from elasticsearch_tpu_torch.ops.batched import fetch
from elasticsearch_tpu_torch.planner import ARM_SITES, ExecutionPlanner, execution_planner
from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset
from elasticsearch_tpu_torch.query.executor import ShardSearcher
from elasticsearch_tpu_torch.telemetry import (collect_profile_events, device_window, metrics,
                                               time_kernel)
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

SRC = Path(__file__).resolve().parents[1] / "elasticsearch_tpu_torch"

# one batched-site candidate list (static priority order, exact last)
CANDS = [
    ("fused", "fused.pallas_scan", {"queries": 8, "k": 8, "v": 4, "num_docs": 4096}),
    ("impact", "sparse.impact_sum", {"queries": 8, "k": 8, "num_docs": 4096, "rows": 2048}),
    ("exact", "batched.disjunction", {"queries": 8, "k": 8, "num_docs": 4096, "rows": 2048}),
]
ANN_FIELDS = {"queries": 1, "dims": 16, "tile": 64, "nprobe": 8}


@pytest.fixture(autouse=True)
def _cold_planners():
    """Both packages' execution planners start each test cold."""
    planner_reset()
    ref_planner_reset()
    metrics.reset()
    yield
    planner_reset()
    ref_planner_reset()


def _warm(pl, eff_by_kernel):
    """Seed each kernel's efficiency EMA with one crafted observation."""
    for _arm, kernel, fields in CANDS:
        eff = eff_by_kernel.get(kernel)
        if eff is not None:
            pl.observe(kernel, fields, 1e-3, {"mfu": eff})


# ---------------------------------------------------------------------------
# cold start = static priority, warm = model argmin
# ---------------------------------------------------------------------------

def test_cold_start_falls_back_to_static_priority():
    pl = execution_planner()
    assert pl.stats()["kernels"] == {}
    for _ in range(5):
        assert pl.choose_arm("batched.msearch", CANDS) == "fused"
    st = pl.stats()
    assert st["decisions"] == {"fused": 5}
    assert st["decision_modes"] == {"model": 0, "static": 5, "repriced": 0}


def test_partially_cold_state_is_still_static():
    pl = execution_planner()
    _warm(pl, {"sparse.impact_sum": 0.9})
    assert pl.choose_arm("batched.msearch", CANDS) == "fused"
    assert pl.stats()["decision_modes"]["model"] == 0


def test_disabled_planner_matches_cold_routing():
    pl = execution_planner()
    _warm(pl, {"fused.pallas_scan": 0.01, "sparse.impact_sum": 0.9,
               "batched.disjunction": 0.9})
    pl.configure(enabled=False)
    assert pl.choose_arm("batched.msearch", CANDS) == "fused"
    assert pl.stats()["decision_modes"]["model"] == 0


def test_no_environment_switch(monkeypatch):
    """The reference's ES_TPU_PLANNER=0 is not carried over: only the
    planner.enabled setting turns the port's planner off."""
    pl = execution_planner()
    _warm(pl, {"fused.pallas_scan": 0.001, "sparse.impact_sum": 0.9,
               "batched.disjunction": 0.2})
    monkeypatch.setenv("ES_TPU_PLANNER", "0")
    assert pl.enabled
    assert pl.choose_arm("batched.msearch", CANDS) == "impact"
    assert pl.stats()["decision_modes"]["model"] == 1


def test_warm_model_picks_argmin_deterministically():
    pl = execution_planner()
    _warm(pl, {"fused.pallas_scan": 0.001, "sparse.impact_sum": 0.9,
               "batched.disjunction": 0.2})
    assert {pl.choose_arm("batched.msearch", CANDS) for _ in range(50)} == {"impact"}
    st = pl.stats()
    assert st["decisions"]["impact"] == 50
    assert st["decision_modes"]["model"] == 50


def test_observe_wall_warms_model():
    pl = execution_planner()
    for _, kernel, fields in CANDS:
        assert pl.predict_ms(kernel, fields) is None
        pl.observe_wall(kernel, fields, 5e-3)
        assert pl.predict_ms(kernel, fields) is not None
    assert pl.choose_arm("batched.msearch", CANDS) in {"fused", "impact", "exact"}
    assert pl.stats()["decision_modes"]["model"] == 1
    # non-positive walls and kernels without a cost model are ignored
    pl.observe_wall("batched.disjunction", CANDS[2][2], 0.0)
    pl.observe_wall("sharded.wand_pass1", {"queries": 1}, 1e-3)
    assert "sharded.wand_pass1" not in pl.stats()["kernels"]


def test_predict_ms_none_while_cold():
    pl = execution_planner()
    assert pl.predict_ms("fused.pallas_scan", CANDS[0][2]) is None
    _warm(pl, {"fused.pallas_scan": 0.5})
    assert pl.predict_ms("fused.pallas_scan", CANDS[0][2]) > 0


# ---------------------------------------------------------------------------
# repricing
# ---------------------------------------------------------------------------

def test_scoped_reprice_filters_candidates_and_lifts():
    pl = execution_planner()
    with pl.reprice(("fused",), reason="test"):
        assert pl.choose_arm("batched.msearch", CANDS) == "impact"
        assert pl.repriced_arms() == ["fused"]
        with pl.reprice(("impact",)):
            assert pl.choose_arm("batched.msearch", CANDS) == "exact"
            assert pl.stats()["decision_modes"]["repriced"] >= 1
    assert pl.repriced_arms() == []
    assert pl.choose_arm("batched.msearch", CANDS) == "fused"
    assert metrics.snapshot()["counters"]["es.planner.repriced.fused"] == 1


def test_all_arms_repriced_falls_back_to_exact():
    pl = execution_planner()
    with pl.reprice(("fused", "impact", "exact")):
        assert pl.choose_arm("batched.msearch", CANDS) == "exact"
        assert pl.stats()["decision_modes"]["repriced"] == 1


def test_standing_repricer_follows_predicate():
    pl = execution_planner()
    state = {"degraded": True}
    pl.add_repricer("fused", "t", lambda: state["degraded"])
    assert pl.choose_arm("batched.msearch", CANDS) == "impact"
    state["degraded"] = False
    assert pl.choose_arm("batched.msearch", CANDS) == "fused"
    pl.remove_repricer("fused", "t")
    assert pl.repriced_arms() == []


# ---------------------------------------------------------------------------
# knob bounds
# ---------------------------------------------------------------------------

def test_advise_nprobe_cold_or_untargeted_is_identity():
    pl = execution_planner()
    assert pl.advise_nprobe(7, 32, ANN_FIELDS) == 7
    pl.configure(knn_target_ms=5.0)
    assert pl.advise_nprobe(7, 32, ANN_FIELDS) == 7


def test_advise_nprobe_bounds():
    pl = execution_planner()
    pl.observe("ann.gather_scan", ANN_FIELDS, 1e-3, {"mfu": 0.5})
    pl.configure(knn_target_ms=60_000.0)
    assert pl.advise_nprobe(7, 32, ANN_FIELDS) == 32
    pl.configure(knn_target_ms=1e-9)
    assert pl.advise_nprobe(7, 32, ANN_FIELDS) == 1
    assert pl.stats()["knobs"]["nprobe_adjustments"] >= 2
    # a target between: the largest nprobe whose prediction meets it
    pl.configure(knn_target_ms=pl.predict_ms("ann.gather_scan", {**ANN_FIELDS, "nprobe": 9}))
    assert pl.advise_nprobe(7, 32, ANN_FIELDS) == 9


def test_advise_wave_close_bounds():
    pl = execution_planner()
    assert pl.advise_wave_close(256, 0.002, 3, None, None) == (256, 0.002)
    assert pl.advise_wave_close(256, 0.002, 3, 5.0, None) == (256, 0.002)
    for depth, drain, rate in ((0, 1.0, 10.0), (3, 5.0, 1000.0), (300, 50.0, 1e6),
                               (1, 1e-3, 1e-3)):
        w, t = pl.advise_wave_close(256, 0.002, depth, drain, rate)
        assert 1 <= w <= 256, (depth, drain, rate, w)
        assert 0.0 <= t <= 0.002, (depth, drain, rate, t)
    pl.configure(enabled=False)
    assert pl.advise_wave_close(256, 0.002, 3, 5.0, 10.0) == (256, 0.002)


def test_cache_admission_floor():
    pl = execution_planner()
    assert pl.admit_cache(0.0001)
    assert pl.admit_cache(None)
    pl.configure(cache_min_recompute_us=100.0)
    assert not pl.admit_cache(0.05)
    assert pl.admit_cache(1.0)
    assert pl.admit_cache(None)
    knobs = pl.stats()["knobs"]
    assert knobs["cache_rejections"] == 1 and knobs["cache_admissions"] == 1


# ---------------------------------------------------------------------------
# residual feedback and decision latency
# ---------------------------------------------------------------------------

def test_residual_exported_as_gauge_and_histogram():
    pl = execution_planner()
    fields = CANDS[2][2]
    pl.observe("batched.disjunction", fields, 1e-3, {"mfu": 0.5})
    pl.observe("batched.disjunction", fields, 2e-3, {"mfu": 0.25})
    st = pl.stats()["kernels"]["batched.disjunction"]
    assert st["predictions"] >= 1 and st["residual_abs_ema"] > 0
    snap = metrics.snapshot()
    assert "es.planner.residual.batched.disjunction" in snap["gauges"]
    assert snap["histograms"]["es.planner.residual"]["count"] >= 1
    worst, worst_val = pl.worst_kernel()
    assert worst == "batched.disjunction" and worst_val > 0


def test_decision_latency_under_budget():
    pl = execution_planner()
    _warm(pl, {"fused.pallas_scan": 0.5, "sparse.impact_sum": 0.5,
               "batched.disjunction": 0.5})
    for _ in range(100):
        pl.choose_arm("batched.msearch", CANDS)
    h = metrics.snapshot()["histograms"]["es.planner.decision_us"]
    assert h["count"] >= 100
    assert h["p50"] < 100.0, f"median decision latency {h['p50']} us"


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------

def test_engine_settings_drive_planner_config():
    from elasticsearch_tpu_torch.engine import Engine

    e = Engine(device="cpu")
    pl = execution_planner()
    try:
        assert pl.enabled
        assert pl.stats()["config"] == {"ema_alpha": 0.2, "knn_target_ms": 0.0,
                                        "cache_min_recompute_us": 0.0}
        e.settings.update({"transient": {
            "planner.enabled": False, "planner.ema.alpha": 0.5,
            "planner.knn.target_ms": 7.5}})
        st = pl.stats()
        assert st["enabled"] is False
        assert st["config"] == {"ema_alpha": 0.5, "knn_target_ms": 7.5,
                                "cache_min_recompute_us": 0.0}
        e.settings.update({"transient": {"planner.enabled": True}})
        assert pl.enabled
        with pytest.raises(IllegalArgumentError, match="failed to parse"):
            e.settings.update({"transient": {"planner.ema.alpha": "fast"}})
        with pytest.raises(IllegalArgumentError, match="cannot parse boolean"):
            e.settings.update({"persistent": {"planner.enabled": "maybe"}})
        # the request cache, its consumer, is not ported; tenant fair share is
        with pytest.raises(IllegalArgumentError, match="not yet ported"):
            e.settings.update({"transient": {"planner.cache.min_recompute_us": 25.0}})
        e.settings.update({"transient": {"planner.tenant.fairshare": True}})
        assert e.serving.stats()["fairshare"]["enabled"]
        assert pl.stats()["config"]["ema_alpha"] == 0.5  # a refused update applies nothing
    finally:
        e.close()


# ---------------------------------------------------------------------------
# lints over the port's sources
# ---------------------------------------------------------------------------

def _source_texts():
    return {p: p.read_text() for p in SRC.rglob("*.py")}


def test_lint_choose_arm_sites_match_registry():
    sites = set()
    for text in _source_texts().values():
        sites.update(re.findall(r'choose_arm\(\s*"([^"]+)"', text))
    assert sites == set(ARM_SITES)
    assert set(ARM_SITES) == {"batched.msearch", "sharded.msearch_partials"}


def test_lint_registry_kernels_are_costed():
    for site, arms in ARM_SITES.items():
        assert list(arms)[-1] == "exact", site
        for arm, kernel in arms.items():
            assert KERNEL_COSTS.get(kernel) is not None, (site, arm, kernel)


def test_lint_time_kernel_names_match_kernel_costs():
    """Every time_kernel, device_window or build_stage name at a dispatch
    site of the port (a literal, or either literal of a conditional) has a
    KERNEL_COSTS entry, and every entry is timed somewhere."""
    names = set()
    for text in _source_texts().values():
        for a, b in re.findall(r'(?:time_kernel|device_window|build_stage)\(\s*"([^"]+)"'
                               r'(?:\s+if [^\n]*?else\s+"([^"]+)")?', text):
            names.update(x for x in (a, b) if x)
    assert names == set(KERNEL_COSTS)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_kernel_cost_matches_reference():
    fields = {"queries": 512, "k": 25, "v": 896, "num_docs": 1_000_000, "rows": 65_536,
              "code_bytes": 2, "cands": 2048, "shards": 8, "dims": 384, "nlist": 750,
              "nprobe": 2, "tile": 1664, "kb": 100, "scan_tier": "int8"}
    shared = set(KERNEL_COSTS) & set(ref_costmodel.KERNEL_COSTS)
    assert shared == set(KERNEL_COSTS)
    for name in sorted(shared):
        for f in (fields, {**fields, "scan_tier": "bf16", "code_bytes": 1}, {"queries": 3},
                  {k: v for k, v in fields.items() if k != "rows"}):
            assert costmodel.kernel_cost(name, f) == ref_costmodel.kernel_cost(name, f), name
        assert costmodel.utilization(name, fields, 2e-3) == \
            ref_costmodel.utilization(name, fields, 2e-3), name
    assert costmodel.device_peaks(torch.device("cpu"))[:2] == \
        (ref_costmodel.CPU_PEAK_FLOPS, ref_costmodel.CPU_PEAK_BW)


def test_h100_peaks_match_the_data_sheet(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(costmodel, "_peaks_cache", {})
    assert costmodel.device_peaks(torch.device("cuda", 0)) == (989e12, 3.35e12,
                                                                 "NVIDIA H100 80GB HBM3")
    assert costmodel.device_peaks(torch.device("cpu"))[2] == "cpu"


def test_same_observations_same_decisions_in_both_planners():
    """One stream of observations into both planners: the same efficiency
    EMAs, arm, predictions and residuals (the cost keys are shared)."""
    rng = np.random.default_rng(3)
    port, ref = ExecutionPlanner(), RefExecutionPlanner()
    for _ in range(40):
        arm, kernel, fields = CANDS[int(rng.integers(0, 3))]
        fields = {**fields, "queries": int(rng.integers(1, 4096))}
        sec = float(rng.uniform(1e-4, 5e-2))
        util = ref_costmodel.utilization(kernel, fields, sec)
        assert util == costmodel.utilization(kernel, fields, sec)
        port.observe(kernel, fields, sec, util)
        ref.observe(kernel, fields, sec, util)
        assert port.choose_arm("batched.msearch", CANDS) == ref.choose_arm("batched.msearch",
                                                                           CANDS)
        for _, k, f in CANDS:
            assert port.predict_ms(k, f) == ref.predict_ms(k, f)
    ps, rs = port.stats(), ref.stats()
    assert ps["kernels"] == rs["kernels"]
    assert ps["decisions"] == rs["decisions"] and ps["decision_modes"] == rs["decision_modes"]
    assert port.worst_kernel() == ref.worst_kernel()


def test_time_kernel_feeds_the_planner_and_never_syncs_on_the_cpu(monkeypatch):
    def no_sync(*a, **k):
        raise AssertionError("synchronized a CPU window")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    cpu = torch.device("cpu")
    fields = CANDS[2][2]
    with collect_profile_events() as events:
        with time_kernel("batched.disjunction", cpu, sync=True, tier="exact", **fields):
            torch.ones(1000).sum()
        with time_kernel("fused.msearch", cpu, queries=8):
            pass
        window = device_window("sparse.impact_gather", cpu, queries=8, rows=64)
        with window:
            torch.ones(1000).sum()
        assert len(events) == 2  # a device window is accounted at close()
        window.close()
    assert [e["kernel"] for e in events] == ["batched.disjunction", "fused.msearch",
                                             "sparse.impact_gather"]
    assert events[0]["mfu"] > 0 and events[0]["flops"] > 0 and "mfu" not in events[1]
    st = execution_planner().stats()["kernels"]
    assert set(st) == {"batched.disjunction", "sparse.impact_gather"}
    assert st["batched.disjunction"]["observations"] == 1
    snap = metrics.snapshot()
    assert snap["histograms"]["es.kernel.batched.disjunction.ms"]["count"] == 1
    assert snap["counters"]["es.kernel.batched.disjunction.flops"] > 0


# ---------------------------------------------------------------------------
# a cold planner routes as the static order
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def searcher():
    rng = np.random.default_rng(11)
    lens, tok, nums = make_corpus(rng, 3000, vocab=400, mean_len=12)
    docs = corpus_docs(lens, tok, nums, vocab=400)
    queries = sample_queries(rng, lens, tok, 48) + [[], [("zzz", 1.0)]]
    pm = Mappings({"properties": {"body": {"type": "text"}, "n": {"type": "long"}}})
    pb = PackBuilder(pm)
    pb.add_documents_batch([pm.parse_document(d) for d in docs])
    return ShardSearcher(pb.build(dense_min_df=100), device="cpu", mappings=pm), queries


def _static_msearch(bs, fld, queries, k, track_total_hits=10_000):
    """The static route as `BatchTermSearcher.msearch` ran it before the
    planner (a pack without the fused arm): per shape group impact > fast,
    tiered or dense for dense-only groups, one copy back, then the rerun
    loop with a 4x wider candidate budget per round."""
    Q = len(queries)
    scores = np.full((Q, k), -np.inf, np.float32)
    ids = np.zeros((Q, k), np.int64)
    totals = np.zeros((Q,), np.int64)
    exact = np.ones((Q,), bool)

    def first(plan, M=None):
        if plan.dense_only or plan.impact_w is None or not bs.impact_usable():
            return bs.run_fast(fld, plan, M=M)
        return bs.run_impact(fld, plan, M=M)

    groups = [(idxs, first(plan)) for idxs, plan in bs.plan_bucketed(fld, queries, k)]
    pending = []
    for (idxs, _), out in zip(groups, fetch([g for _, g in groups])):
        kk = out[0].shape[1]
        scores[idxs, :kk], ids[idxs, :kk], totals[idxs] = out[0], out[1], out[2]
        ok = out[3] & ((out[4] == 0) | (out[2] >= track_total_hits))
        exact[idxs] = ok
        if not ok.all():
            pending.append(idxs[~ok])
    m = 4 * bs.FAST_M
    while pending:
        redo = np.concatenate(pending)
        pending = []
        for idxs, plan in bs.plan_bucketed(fld, [queries[i] for i in redo], k):
            if plan.dense_only:
                out, uncut = fetch([bs.run(fld, plan)])[0], True
            else:
                C = plan.sparse_rows.shape[1] * plan.sparse_rows.shape[2] * BLOCK
                out, uncut = fetch([first(plan, min(m, C))])[0], min(m, C) >= C
            ok = np.ones(len(idxs), bool)
            if len(out) > 3 and not uncut:
                ok = out[3] & ((out[4] == 0) | (out[2] >= track_total_hits))
            done = redo[idxs[ok]]
            kk = out[0].shape[1]
            scores[done, :kk], ids[done, :kk], totals[done] = out[0][ok], out[1][ok], out[2][ok]
            if not ok.all():
                pending.append(redo[idxs[~ok]])
        m *= 4
    return scores, ids, totals, exact


@pytest.mark.parametrize("k,fast_m", [(10, None), (25, None), (10, 8)],
                         ids=["k10", "k25", "k10_reruns"])
def test_cold_planner_routes_byte_equal_to_the_static_route(searcher, monkeypatch, k, fast_m):
    ss, queries = searcher
    bs = ss.batched()
    if fast_m:
        monkeypatch.setattr(bs, "FAST_M", fast_m)
    want = _static_msearch(bs, "body", queries, k)
    planner_reset()
    got = ss.msearch("body", queries, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert execution_planner().stats()["decision_modes"] == {"model": 0, "static": 1,
                                                             "repriced": 0}
    assert set(bs.last_stats["queries"]) == {"impact", "tiered"}
    if fast_m:
        assert bs.last_stats["rounds"] >= 1


def test_warm_planner_routes_the_batch_to_its_argmin(searcher):
    """Warm both arms' EMAs with crafted efficiencies: the planner routes
    the whole batch to the cheaper prediction, and `last_stats` reports the
    groups' arms (a warm impact arm keeps the impact rows; a warm exact arm
    takes the fast arm, whose scores are exact BM25)."""
    ss, queries = searcher
    bs = ss.batched()
    pl = execution_planner()
    n = ss.pack.num_docs
    f = {"queries": len(queries), "k": 10, "num_docs": n}
    pl.observe("sparse.impact_sum", f, 1e-3, {"mfu": 1e-6})
    pl.observe("batched.disjunction", f, 1e-3, {"mfu": 0.5})
    got = ss.msearch("body", queries, 10)
    assert set(bs.last_stats["queries"]) == {"fast", "tiered"}
    assert pl.stats()["decisions"] == {"exact": 1}
    with pl.reprice(["exact"]):
        imp = ss.msearch("body", queries, 10)
    assert set(bs.last_stats["queries"]) == {"impact", "tiered"}
    np.testing.assert_array_equal(got[2], imp[2])  # the same totals
    fin = np.isfinite(got[0])
    assert not np.array_equal(got[0][fin], imp[0][fin])  # other score functions
