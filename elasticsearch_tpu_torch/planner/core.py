"""The adaptive execution planner (the JAX package's `planner/core.py`).

One process-wide `ExecutionPlanner` closes the loop between the analytic
cost model and the measured runtime:

- **Predict**: an arm's wall time is its kernel's roofline-ideal time (the
  larger of flops / peak_flops and bytes / peak_bw, from
  `monitoring.costmodel`) divided by that kernel's *measured*
  achieved-roofline EMA. Every `telemetry.time_kernel` window on the card
  feeds the EMA, so the planner prices each arm at the efficiency the card
  achieves, not the data sheet's.
- **Choose**: each arm dispatch site routes through
  `choose_arm(site, candidates)` with its eligible arms in the static
  priority order (fused > impact > exact). Cold state (any candidate
  unpredictable) falls back to the first candidate: the static routing,
  byte for byte. Warm state picks the argmin of the predictions.
  `ARM_SITES` registers the sites (tests/test_torch_planner.py checks that
  the port's `choose_arm` calls name exactly these).
- **Feed back**: at each observation the planner recomputes the prediction
  it would have made (pre-update state) and exports the relative residual
  (actual - predicted) / predicted as the `es.planner.residual` histogram
  and a per-kernel gauge.
- **Reprice**: an arm priced at infinity is filtered from the candidates,
  in a scope (`reprice`) or while a predicate holds (`add_repricer`).
- **Knobs**: the same predictor advises `knn.nprobe` from a latency target
  (`planner.knn.target_ms`), the serving wave close (wave size and
  coalesce window from the queue depth and the drain and arrival EMAs),
  and request-cache admission by predicted recompute cost
  (`planner.cache.min_recompute_us`). Each knob is clamped to its static
  bounds and passes through untouched when cold or disabled.

Differences from the reference: the cluster setting `planner.enabled` turns
the planner off, and no environment variable does (the reference also
reads ES_TPU_PLANNER=0); `ARM_SITES` has no `sharded.msearch_merged` site,
the reference's one-program route over a device mesh.

State is a few dicts of floats under one lock: a decision is dict and
float arithmetic.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

# site -> arm -> the kernel whose cost model prices that arm. Keys are the
# literal choose_arm(...) site names at the dispatch call sites.
ARM_SITES: dict[str, dict[str, str]] = {
    "batched.msearch": {
        "fused": "fused.pallas_scan",
        "impact": "sparse.impact_sum",
        "exact": "batched.disjunction",
    },
    "sharded.msearch_partials": {
        "fused": "sharded.fused_pipeline",
        "impact": "sharded.impact_disjunction",
        "exact": "sharded.exact_disjunction",
    },
}

_DEFAULTS = {
    "enabled": True,
    "alpha": 0.2,  # planner.ema.alpha
    "knn_target_ms": 0.0,  # planner.knn.target_ms (0 = advisory off)
    "cache_min_recompute_us": 0.0,  # planner.cache.min_recompute_us
}


class ExecutionPlanner:
    """Per-process planner state: kernel efficiency EMAs, residual tracking,
    arm repricing, decision accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cfg = dict(_DEFAULTS)
        # kernel -> EMA of the achieved roofline fraction (max of mfu and
        # bw_util), seeded by the first observation; no entry = cold
        self._eff: dict[str, float] = {}
        self._obs: dict[str, int] = {}
        # kernel -> EMA of posting rows per query from observed fields:
        # prices rows-dependent cost functions before planning
        self._rows_per_q: dict[str, float] = {}
        # kernel -> residual state (last, EMA of |residual|, count)
        self._residual: dict[str, dict] = {}
        # arm -> active scoped repricings; arm -> {key: predicate}
        self._repriced_scoped: dict[str, int] = {}
        self._repricers: dict[str, dict] = {}
        self._decisions: dict[str, int] = {}
        self._modes = {"model": 0, "static": 0, "repriced": 0}
        self._knobs = {"nprobe_adjustments": 0, "wave_adjustments": 0,
                       "cache_rejections": 0, "cache_admissions": 0}

    # -- configuration ------------------------------------------------------

    def configure(self, **kw) -> None:
        with self._lock:
            for key, val in kw.items():
                if key in self._cfg and val is not None:
                    self._cfg[key] = val

    @property
    def enabled(self) -> bool:
        return bool(self._cfg["enabled"])

    # -- the measurement feed (telemetry.time_kernel) -----------------------

    def observe(self, kernel: str, fields: dict, seconds: float, util: dict) -> None:
        """Fold one timed dispatch into the kernel's efficiency EMA and
        export the predicted-against-actual residual."""
        achieved = max(util.get("mfu", 0.0), util.get("bw_util", 0.0))
        if achieved <= 0 or seconds <= 0:
            return
        from ..telemetry import metrics

        with self._lock:
            # the prediction this dispatch would have got (pre-update state)
            predicted_s = self._predict_seconds_locked(kernel, fields)
            alpha = float(self._cfg["alpha"])
            prev = self._eff.get(kernel)
            self._eff[kernel] = achieved if prev is None else (1 - alpha) * prev + alpha * achieved
            self._obs[kernel] = self._obs.get(kernel, 0) + 1
            rows, q = fields.get("rows"), fields.get("queries")
            if rows and q:
                rq = float(rows) / max(int(q), 1)
                prev_rq = self._rows_per_q.get(kernel)
                self._rows_per_q[kernel] = (rq if prev_rq is None
                                            else (1 - alpha) * prev_rq + alpha * rq)
            residual = None
            if predicted_s is not None and predicted_s > 0:
                residual = (seconds - predicted_s) / predicted_s
                st = self._residual.setdefault(kernel, {"last": 0.0, "abs_ema": None, "count": 0})
                st["last"] = residual
                st["abs_ema"] = (abs(residual) if st["abs_ema"] is None
                                 else (1 - alpha) * st["abs_ema"] + alpha * abs(residual))
                st["count"] += 1
        if residual is not None:
            metrics.histogram_record("es.planner.residual", residual)
            metrics.gauge_set(f"es.planner.residual.{kernel}", round(residual, 6))

    def observe_wall(self, kernel: str, fields: dict, seconds: float) -> None:
        """A wall-only feed (no utilization record): the achieved-roofline
        fraction is recovered from the analytic ideal."""
        if seconds <= 0:
            return
        with self._lock:
            ideal = self._ideal_seconds(kernel, fields)
        if ideal is None or ideal <= 0:
            return
        self.observe(kernel, fields, seconds, {"mfu": min(ideal / seconds, 1.0)})

    # -- prediction ---------------------------------------------------------

    def _ideal_seconds(self, kernel: str, fields: dict) -> float | None:
        """Roofline-ideal wall of one dispatch: the larger of the compute
        and memory terms over the process accelerator's peaks."""
        from ..monitoring.costmodel import device_peaks, kernel_cost

        cost = kernel_cost(kernel, fields)
        if cost is None and "rows" not in fields:
            # a rows-dependent cost function before planning: price it with
            # the measured rows-per-query EMA when one exists
            rq = self._rows_per_q.get(kernel)
            q = fields.get("queries")
            if rq is not None and q:
                cost = kernel_cost(kernel, {**fields, "rows": int(rq * int(q))})
        if cost is None:
            return None
        peak_f, peak_b, _kind = device_peaks()
        return max(cost["flops"] / peak_f, cost["bytes"] / peak_b)

    def _predict_seconds_locked(self, kernel: str, fields: dict) -> float | None:
        eff = self._eff.get(kernel)
        if eff is None or eff <= 0:
            return None
        t = self._ideal_seconds(kernel, fields)
        if t is None:
            return None
        return t / eff

    def predict_ms(self, kernel: str, fields: dict) -> float | None:
        """Predicted wall ms of one dispatch, or None while cold."""
        with self._lock:
            sec = self._predict_seconds_locked(kernel, fields)
        return None if sec is None else sec * 1000.0

    # -- repricing ----------------------------------------------------------

    def repriced(self, arm: str) -> bool:
        """An arm priced at infinity: filtered from every candidate list."""
        with self._lock:
            if self._repriced_scoped.get(arm, 0) > 0:
                return True
            preds = list(self._repricers.get(arm, {}).values())
        for fn in preds:
            try:
                if fn():
                    return True
            except Exception:  # noqa: BLE001 - a dead predicate never pins
                continue
        return False

    def repriced_arms(self) -> list[str]:
        arms = set(self._repriced_scoped) | set(self._repricers)
        return sorted(a for a in arms if self.repriced(a))

    @contextmanager
    def reprice(self, arms, reason: str = ""):
        """Scope in which `arms` cost infinity (filtered from the candidates;
        the last candidate serves when every arm is repriced)."""
        from ..telemetry import metrics

        arms = tuple(arms)
        with self._lock:
            for a in arms:
                self._repriced_scoped[a] = self._repriced_scoped.get(a, 0) + 1
        for a in arms:
            metrics.counter_inc(f"es.planner.repriced.{a}")
        try:
            yield
        finally:
            with self._lock:
                for a in arms:
                    n = self._repriced_scoped.get(a, 1) - 1
                    if n <= 0:
                        self._repriced_scoped.pop(a, None)
                    else:
                        self._repriced_scoped[a] = n

    def add_repricer(self, arm: str, key, predicate) -> None:
        """Standing repricer: the arm stays at infinity while the predicate
        holds."""
        with self._lock:
            self._repricers.setdefault(arm, {})[key] = predicate

    def remove_repricer(self, arm: str, key) -> None:
        with self._lock:
            self._repricers.get(arm, {}).pop(key, None)

    # -- arm choice ---------------------------------------------------------

    def choose_arm(self, site: str, candidates) -> str:
        """Pick one arm for a dispatch. `candidates` is a list of (arm,
        kernel, fields) in the static priority order; the last entry is the
        always-correct exact arm. Cold (any surviving candidate
        unpredictable) -> the first survivor, so an empty-EMA planner routes
        as the static order does."""
        t0 = time.perf_counter()
        alive = [c for c in candidates if not self.repriced(c[0])]
        mode = "static"
        if not alive:
            # everything repriced: the last candidate is the exact arm
            alive = [candidates[-1]]
            mode = "repriced"
        chosen = alive[0]
        predicted: dict[str, float] = {}
        if self.enabled and len(alive) > 1:
            with self._lock:
                preds = [self._predict_seconds_locked(kernel, fields)
                         for _arm, kernel, fields in alive]
            if all(p is not None for p in preds):
                mode = "model"
                chosen = alive[min(range(len(preds)), key=lambda j: preds[j])]
            predicted = {alive[j][0]: round(preds[j] * 1000.0, 4)
                         for j in range(len(alive)) if preds[j] is not None}
        if len(alive) < len(candidates) and mode == "static":
            mode = "repriced"  # the filtering, not the model, routed this
        decision_us = (time.perf_counter() - t0) * 1e6
        arm = chosen[0]
        with self._lock:
            self._decisions[arm] = self._decisions.get(arm, 0) + 1
            self._modes[mode] = self._modes.get(mode, 0) + 1
        from ..telemetry import metrics, profile_event

        metrics.counter_inc(f"es.planner.decisions.{arm}")
        metrics.histogram_record("es.planner.decision_us", decision_us)
        # `priced_kernel`, not `kernel`: a `kernel` key marks a utilization
        # record to profile-event consumers
        profile_event("planner", site=site, arm=arm, mode=mode, priced_kernel=chosen[1],
                      fields=dict(chosen[2]), predicted_ms=predicted,
                      decision_us=round(decision_us, 2))
        return arm

    # -- knobs --------------------------------------------------------------

    def advise_nprobe(self, default_nprobe: int, nlist: int, fields: dict) -> int:
        """The largest nprobe in [1, nlist] whose predicted ann.gather_scan
        wall stays under planner.knn.target_ms (binary search over the
        monotone cost). Cold, disabled or no target -> the default."""
        target_ms = float(self._cfg["knn_target_ms"])
        if not self.enabled or target_ms <= 0:
            return default_nprobe
        kernel = "ann.gather_scan"
        with self._lock:
            if self._eff.get(kernel) is None:
                return default_nprobe
            lo, hi = 1, max(int(nlist), 1)
            best = 1
            while lo <= hi:
                mid = (lo + hi) // 2
                sec = self._predict_seconds_locked(kernel, {**fields, "nprobe": mid})
                if sec is None:
                    return default_nprobe
                if sec * 1000.0 <= target_ms:
                    best = mid
                    lo = mid + 1
                else:
                    hi = mid - 1
            advised = max(1, min(best, int(nlist)))
            if advised != default_nprobe:
                self._knobs["nprobe_adjustments"] += 1
        return advised

    def advise_wave_close(self, max_wave: int, max_wait_s: float, depth: int,
                          drain_ms_ema: float | None, arrivals_per_s_ema: float | None):
        """Effective (wave size, coalesce window) for one wave close. Warm:
        the wave target becomes depth + the arrivals one drain period is
        expected to deliver (clamped to [1, max_wave]) and the window the
        time to accumulate it (clamped to [0, max_wait_s]). Cold or
        disabled: the configured values."""
        if (not self.enabled or not drain_ms_ema or drain_ms_ema <= 0
                or not arrivals_per_s_ema or arrivals_per_s_ema <= 0):
            return max_wave, max_wait_s
        expect = arrivals_per_s_ema * (drain_ms_ema / 1000.0)
        eff_wave = int(min(max_wave, max(1, depth + expect)))
        need = max(eff_wave - depth, 0)
        eff_wait = min(max_wait_s, max(0.0, need / arrivals_per_s_ema))
        if eff_wave != max_wave or eff_wait != max_wait_s:
            with self._lock:
                self._knobs["wave_adjustments"] += 1
        return eff_wave, eff_wait

    def admit_cache(self, recompute_ms: float | None) -> bool:
        """Request-cache admission by predicted recompute cost: an entry
        cheaper to recompute than planner.cache.min_recompute_us is not
        worth its residency. Floor 0 (the default) admits everything."""
        floor_us = float(self._cfg["cache_min_recompute_us"])
        if not self.enabled or floor_us <= 0 or recompute_ms is None:
            return True
        ok = recompute_ms * 1000.0 >= floor_us
        with self._lock:
            self._knobs["cache_admissions" if ok else "cache_rejections"] += 1
        return ok

    # -- introspection ------------------------------------------------------

    def worst_kernel(self) -> tuple[str | None, float | None]:
        """(kernel, |residual| EMA) of the worst-predicted kernel."""
        with self._lock:
            worst, worst_val = None, None
            for k, st in self._residual.items():
                v = st.get("abs_ema")
                if v is not None and (worst_val is None or v > worst_val):
                    worst, worst_val = k, v
        return worst, worst_val

    def stats(self) -> dict:
        worst, worst_val = self.worst_kernel()
        with self._lock:
            kernels = {}
            for k in sorted(self._eff):
                entry = {"efficiency_ema": round(self._eff[k], 6),
                         "observations": self._obs.get(k, 0)}
                st = self._residual.get(k)
                if st is not None and st["abs_ema"] is not None:
                    entry.update(residual_last=round(st["last"], 6),
                                 residual_abs_ema=round(st["abs_ema"], 6),
                                 predictions=st["count"])
                kernels[k] = entry
            out = {
                "enabled": self.enabled,
                "config": {"ema_alpha": self._cfg["alpha"],
                           "knn_target_ms": self._cfg["knn_target_ms"],
                           "cache_min_recompute_us": self._cfg["cache_min_recompute_us"]},
                "decisions": dict(sorted(self._decisions.items())),
                "decision_modes": dict(self._modes),
                "knobs": dict(self._knobs),
                "kernels": kernels,
                "sites": sorted(ARM_SITES),
            }
        out["repriced"] = self.repriced_arms()
        out["worst_kernel"] = worst
        out["worst_abs_residual_ema"] = round(worst_val, 6) if worst_val is not None else None
        return out

    def reset(self) -> None:
        with self._lock:
            self._cfg = dict(_DEFAULTS)
            self._eff.clear()
            self._obs.clear()
            self._rows_per_q.clear()
            self._residual.clear()
            self._repriced_scoped.clear()
            self._repricers.clear()
            self._decisions.clear()
            self._modes = {"model": 0, "static": 0, "repriced": 0}
            for k in self._knobs:
                self._knobs[k] = 0


_singleton: ExecutionPlanner | None = None
_singleton_lock = threading.Lock()


def execution_planner() -> ExecutionPlanner:
    """The process-wide planner every dispatch site consults. An Engine
    pushes its planner.* settings into it."""
    global _singleton
    if _singleton is None:
        with _singleton_lock:
            if _singleton is None:
                _singleton = ExecutionPlanner()
    return _singleton


def reset_for_tests() -> None:
    execution_planner().reset()
