"""The continuous-batching wave scheduler of the serving front end.

A cut of the reference's `serving/service.py:102-1184`:

    REST handler --submit--> per-tenant queues --pop_wave--> scheduler
        ^  future                                  | weighted RR + deadlines
        |                                          v
        |                     engine thread: search_wave_begin (plan, launch)
        |                                          | depth-1 handoff
        |                                          v
        |                     completer thread: search_wave_fetch (copy to host)
        |                                          |
        +------ resolve <-- engine thread: search_wave_finish <--+

The depth-1 handoff is a double buffer: while the completer copies wave k
to the host, the engine thread may begin wave k+1. A wave closes when the
pipeline is idle (a lone request dispatches at once), when it is full
(`serving.max_wave`), or when its oldest entry has waited
`serving.coalesce.max_wait`. Backpressure: a bounded queue sheds with 429
+ Retry-After (`serving.queue.max_depth`), and admission charges the
`in_flight_requests` breaker, which every exit path releases.

Tensor work runs on the engine thread only (the REST app's one worker);
the completer only copies finished outputs to the host.

Tenancy (reference `serving/service.py:111-271`, `:680-733`, `:987-1010`):
  - the `_merge` internal tenant: `submit_merge` queues a device fold (an
    LSM tail fold, a superpack refold) under the weight
    `serving.merge.weight`; the wave runs it inline on the engine thread
    and packs the searches around it;
  - the superpack lane: with `superpack.enabled`, entries whose tenant is
    a current superpack member (`SuperpackManager.wave_claim`) run as one
    tenant-gather job; a failed claim serves per index, and a job whose
    planning fails answers each of its entries on the solo path;
  - the weighted round-robin table is the static `serving.tenant.weights`
    plus `_merge`, and with `planner.tenant.fairshare` a tenant burning
    over `slo.tenant.device_ms_per_s` has its weight scaled by
    budget/burn, clamped to [`planner.tenant.fairshare.min_factor`, 1];
  - metering (`engine.metering`, a `TenantMeter`): sheds, expiries and
    queue waits per tenant, and each wave's device segment (from the
    dispatch to the fetch done) apportioned over its tenants by each
    entry's analytic cost, the shares summing exactly to the segment
    (`tenancy.metering.apportion`; `tenant_waves()` keeps the recent
    waves' records).

Not ported: the flight recorder (beyond `tenant_waves`), and task
registration and cancellation (so the meter's `cancelled` column stays 0).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque

from ..common.breaker import CircuitBreakingError
from ..tenancy import SuperpackManager, size_class_of
from ..tenancy.metering import apportion, fairshare_weights, normalize_tenant
from ..utils.durations import parse_duration_seconds
from ..utils.errors import ElasticsearchTpuError
from .coalesce import classify_request
from .queue import PendingSearch, ServingRejectedError, TenantQueues, parse_tenant_weights

# per-wave tenant records kept for `tenant_waves()`
TENANT_WAVES_KEPT = 256

def _timed_out_response() -> dict:
    """A search whose queue wait passed its deadline answers as a shard
    timeout does in the reference: timed_out, with the empty partial
    result of a search never dispatched."""
    return {"timed_out": True,
            "hits": {"total": {"value": 0, "relation": "eq"}, "max_score": None, "hits": []}}


class ServingService:
    """Admission, coalescing into waves, deadlines, tenant fairness and
    backpressure between REST and the engine."""

    # the internal background-merge tenant: device folds ride the same
    # weighted round-robin as the searches, at their own weight
    MERGE_TENANT = "_merge"

    def __init__(self, engine):
        self.engine = engine
        s = engine.settings
        self.enabled = False
        self.max_wave = max(1, int(s.get("serving.max_wave")))
        self.max_wait_s = parse_duration_seconds(s.get("serving.coalesce.max_wait"), 0.002) or 0.0
        self.queue_cap = max(1, int(s.get("serving.queue.max_depth")))
        self._tenants = TenantQueues()
        self._merge_weight = max(float(s.get("serving.merge.weight")), 0.0)
        self._static_weights: dict[str, float] = {}
        self._fairshare_on = bool(s.get("planner.tenant.fairshare"))
        self._fairshare_min = float(s.get("planner.tenant.fairshare.min_factor"))
        self._fairshare_budget = float(s.get("slo.tenant.device_ms_per_s"))
        self.set_tenant_weights(s.get("serving.tenant.weights"))
        self._tenant_waves: deque = deque(maxlen=TENANT_WAVES_KEPT)
        self._cv = threading.Condition()
        self._lock = threading.Lock()
        self._inflight: _queue.Queue = _queue.Queue(maxsize=1)
        self._inflight_count = 0
        self._threads: list[threading.Thread] = []
        self._stop = False
        self._own_pool = None
        self._submit_engine = None
        self.counters = {"admitted": 0, "dispatched": 0, "completed": 0, "errors": 0,
                         "shed": 0, "expired": 0, "waves": 0, "coalesced": 0,
                         "term_packed": 0, "tiered_packed": 0, "fallback_solo": 0,
                         "merges": 0, "superpack_packed": 0}
        self._occ_sum = 0.0
        self._occ_n = 0
        self._size_sum = 0
        self._wave_ms_ema: float | None = None
        # inter-arrival EMA: with the drain EMA above, the inputs of the
        # execution planner's wave-close advice
        self._arrival_rate_ema: float | None = None
        self._last_arrival: float | None = None
        # summed ms of the wave stages: begin and finish on the engine
        # thread, fetch on the completer, and each wave from claim to finish
        self._stage_ms = {"begin": 0.0, "fetch": 0.0, "finish": 0.0, "wave": 0.0}
        # in_flight_requests bytes charged and not yet released
        self._reserved_bytes = 0

    # ---- settings consumers --------------------------------------------------

    def set_enabled(self, v: bool):
        self.enabled = bool(v)
        if self.enabled:
            self._ensure_threads()

    def set_max_wave(self, v):
        self.max_wave = max(1, int(v))

    def set_max_wait(self, v):
        self.max_wait_s = parse_duration_seconds(v, 0.002) or 0.0

    def set_queue_depth(self, v):
        self.queue_cap = max(1, int(v))

    def set_tenant_weights(self, raw):
        """The static weight table: `serving.tenant.weights` through the
        shared normalizer, and the `_merge` tenant at serving.merge.weight."""
        w = {normalize_tenant(t): v for t, v in parse_tenant_weights(raw).items()}
        w.setdefault(self.MERGE_TENANT, self._merge_weight)
        self._static_weights = w
        self._apply_fairshare()

    def set_merge_weight(self, v):
        self._merge_weight = max(float(v), 0.0)
        self._static_weights = {**self._static_weights, self.MERGE_TENANT: self._merge_weight}
        self._apply_fairshare()

    def configure_fairshare(self, enabled=None, budget_ms_per_s=None, min_factor=None):
        """The consumer of `planner.tenant.fairshare`, its `.min_factor` and
        `slo.tenant.device_ms_per_s`. Turning it off restores the static
        table at once."""
        if enabled is not None:
            self._fairshare_on = bool(enabled)
        if budget_ms_per_s is not None:
            self._fairshare_budget = float(budget_ms_per_s)
        if min_factor is not None:
            self._fairshare_min = float(min_factor)
        self._apply_fairshare()

    def _meter(self):
        return self.engine.metering

    def _apply_fairshare(self):
        """Recompute the effective weighted round-robin table: the static
        table itself with fair share off, no budget or no burn; else each
        tenant over the device-ms/s budget scaled by budget/burn, clamped to
        [min_factor, 1] (slowed, never starved)."""
        eff = self._static_weights
        if self._fairshare_on and self._fairshare_budget > 0.0:
            burn = {t: r for t, r in self._meter().burn_rates().items()
                    if t != self.MERGE_TENANT}
            eff = fairshare_weights(self._static_weights, burn, self._fairshare_budget,
                                    self._fairshare_min)
        if eff is not self._tenants.weights and eff != self._tenants.weights:
            self._tenants.set_weights(eff)

    def bind_executor(self, submit):
        """Run the engine-touching wave stages through the caller's single
        engine thread (the REST app's worker); unbound, the service owns
        one."""
        self._submit_engine = submit

    def _engine_submit(self, fn):
        if self._submit_engine is not None:
            return self._submit_engine(fn)
        if self._own_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._own_pool = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="serving-engine")
        return self._own_pool.submit(fn)

    # ---- admission -----------------------------------------------------------

    def classify(self, expression, body, query_params):
        return classify_request(self.engine, expression, body, query_params)

    def _retry_after_s(self) -> float:
        ema = self._wave_ms_ema or 50.0
        return min(30.0, max(1.0, self._tenants.depth * (ema / 1000.0) / self.max_wave))

    def submit(self, entry: dict, tenant: str = "_anonymous", timeout_s: float | None = None,
               est_bytes: int = 4096):
        """Admit one classified search -> a Future of its response dict.
        Sheds (429 + Retry-After) on a full queue or an in_flight_requests
        breaker trip, before any device work is queued."""
        tenant = normalize_tenant(tenant)
        if self._tenants.depth >= self.queue_cap:
            with self._lock:
                self.counters["shed"] += 1
            self._meter().note("sheds", tenant)
            raise ServingRejectedError(
                f"serving queue full [{self.queue_cap}], node saturated, retry after backoff",
                self._retry_after_s())
        try:
            self.engine.breakers.add_estimate("in_flight_requests", est_bytes,
                                              "serving_admission")
        except CircuitBreakingError as ex:
            with self._lock:
                self.counters["shed"] += 1
            self._meter().note("sheds", tenant)
            ex.retry_after_s = self._retry_after_s()
            raise
        with self._lock:
            self._reserved_bytes += est_bytes
        # the breaker is charged: every exit path from here releases it
        try:
            now = time.monotonic()
            ps = PendingSearch(entry=entry, tenant=tenant,
                               deadline=(now + timeout_s) if timeout_s else None,
                               est_bytes=est_bytes)
            with self._cv:
                self._tenants.push(ps)
                self.counters["admitted"] += 1
                if self._last_arrival is not None:
                    inst = 1.0 / max(now - self._last_arrival, 1e-6)
                    self._arrival_rate_ema = (inst if self._arrival_rate_ema is None
                                              else 0.8 * self._arrival_rate_ema + 0.2 * inst)
                self._last_arrival = now
                self._cv.notify_all()
        except BaseException:
            self._release(est_bytes)
            raise
        self._ensure_threads()
        return ps.future

    def submit_merge(self, fn, *, index: str = "", est_bytes: int = 1024):
        """Admit one background device fold as the `_merge` internal tenant:
        `fn` runs on the engine thread inside a wave slot, scheduled by the
        same weighted round-robin as the searches. -> a Future of
        {"merged": bool(fn())} (or a 429 shed under saturation: the caller
        tries again at a later refresh)."""
        entry = {"internal": fn, "index": index, "kind": "merge"}
        return self.submit(entry, tenant=self.MERGE_TENANT, est_bytes=est_bytes)

    # ---- terminal paths ------------------------------------------------------

    def _release(self, est_bytes: int):
        self.engine.breakers.release("in_flight_requests", est_bytes)
        with self._lock:
            self._reserved_bytes -= est_bytes

    def _finish_entry(self, ps: PendingSearch, result=None, error=None):
        self._release(ps.est_bytes)
        with self._lock:
            self.counters["errors" if error is not None else "completed"] += 1
        if ps.future.done():
            return
        if error is not None:
            ps.future.set_exception(error)
        else:
            ps.future.set_result(result)

    def _resolve_expired(self, ps: PendingSearch):
        with self._lock:
            self.counters["expired"] += 1
        self._meter().note("expired", ps.tenant)
        self._release(ps.est_bytes)
        ps.future.set_result(_timed_out_response())

    # ---- scheduler -----------------------------------------------------------

    def _ensure_threads(self):
        with self._lock:
            if self._threads and all(t.is_alive() for t in self._threads):
                return
            self._stop = False
            self._threads = [
                threading.Thread(target=self._scheduler_loop, name="serving-scheduler",
                                 daemon=True),
                threading.Thread(target=self._completer_loop, name="serving-completer",
                                 daemon=True),
            ]
            for t in self._threads:
                t.start()

    def _close_wave(self) -> list[PendingSearch]:
        """Block until a wave should dispatch, then claim it: at once on an
        idle pipeline, else when full or when the oldest entry has waited
        the coalesce window. The execution planner sizes the wave to the
        depth plus the arrivals one measured drain period delivers, and the
        window to the time they need (cold or disabled: the configured
        max_wave and max_wait, unchanged)."""
        from ..planner import execution_planner

        deadline = None
        eff_wave = self.max_wave
        while not self._stop:
            with self._cv:
                depth = self._tenants.depth
                if depth == 0:
                    deadline = None
                    self._cv.wait(0.05)
                    continue
                eff_wave, eff_wait = execution_planner().advise_wave_close(
                    self.max_wave, self.max_wait_s, depth, self._wave_ms_ema,
                    self._arrival_rate_ema)
                if depth >= eff_wave or self._inflight_count == 0:
                    break
                if deadline is None:
                    deadline = time.monotonic() + eff_wait
                if time.monotonic() >= deadline:
                    break
                self._cv.wait(max(min(eff_wait, 0.005), 0.0005))
        if self._stop:
            return []
        return self._tenants.pop_wave(eff_wave)

    def _scheduler_loop(self):
        while not self._stop:
            try:
                wave = self._close_wave()
                if self._stop:
                    # claimed but never dispatched: resolve, or callers hang
                    for ps in wave:
                        self._finish_entry(ps, error=ServingRejectedError(
                            "serving front end stopped"))
                    break
                now = time.monotonic()
                ready = []
                meter = self._meter()
                for ps in wave:
                    if ps.expired(now):
                        self._resolve_expired(ps)
                    else:
                        meter.note_queue_wait(ps.tenant, (now - ps.enqueue_t) * 1000)
                        ready.append(ps)
                if not ready:
                    continue
                with self._lock:
                    self._inflight_count += 1
                    self.counters["dispatched"] += len(ready)
                try:
                    state = self._engine_submit(lambda: self._wave_begin(ready)).result()
                except Exception as ex:  # noqa: BLE001 - resolve, don't die
                    for ps in ready:
                        self._finish_entry(ps, error=ex)
                    with self._lock:
                        self._inflight_count -= 1
                    continue
                # the device segment starts once every lane is launched
                state["t_dispatched"] = time.monotonic()
                handed = False
                while not self._stop:
                    try:
                        self._inflight.put(state, timeout=0.1)
                        handed = True
                        break
                    except _queue.Full:
                        continue
                if not handed:
                    for _idx, members, _job in state["jobs"]:
                        for ps in members:
                            self._finish_entry(ps, error=ServingRejectedError(
                                "serving front end stopped"))
                    with self._lock:
                        self._inflight_count -= 1
            except Exception:  # noqa: BLE001 - the scheduler must survive
                time.sleep(0.01)

    def _completer_loop(self):
        while True:
            try:
                state = self._inflight.get(timeout=0.1)
            except _queue.Empty:
                if self._stop:
                    return
                continue
            if state is None:
                return
            t0 = time.monotonic()
            try:
                for idx, _members, job in state["jobs"]:
                    idx.search_wave_fetch(job)  # a copy to the host, no engine state
            except Exception as ex:  # noqa: BLE001
                state["fetch_error"] = ex
            state["t_fetched"] = time.monotonic()
            state["fetch_ms"] = (state["t_fetched"] - t0) * 1000
            try:
                self._engine_submit(lambda: self._wave_finish(state)).result()
            except Exception as ex:  # noqa: BLE001
                for _idx, members, _job in state["jobs"]:
                    for ps in members:
                        if not ps.future.done():
                            self._finish_entry(ps, error=ex)
            with self._lock:
                self._inflight_count -= 1

    # ---- wave stages (engine thread) -----------------------------------------

    def _solo(self, ps: PendingSearch):
        """The classic per-request path for one entry -> response or error."""
        e = ps.entry
        try:
            return self.engine.search_multi(
                e.get("expression"), ignore_unavailable=e.get("iu", False),
                allow_no_indices=e.get("ani", True), **e["kwargs"]), None
        except Exception as ex:  # noqa: BLE001 - a per-entry envelope
            return None, ex

    def _entry_cost(self, ps: PendingSearch, idx=None) -> dict:
        """The analytic roofline weight of one wave entry (reference
        `service.py:615-658`): a superpack entry priced as the tenant-gather
        shape over its size class, any other as the batched disjunction
        over its index's docs. The wave's device segment is apportioned by
        these weights. -> {"weight", "flops", "bytes", "kernel"}; weight 0
        when the cost model does not price the shape (apportion then splits
        equally)."""
        from ..monitoring.costmodel import device_peaks, kernel_cost

        sp = ps.entry.get("_superpack")
        if sp is not None:
            member = sp["member"]
            n_pad, nb_pad = size_class_of(member.num_docs, member.num_blocks)
            kernel = "superpack.tenant_gather"
            fields = {"queries": 1, "num_docs": n_pad, "rows": len(sp["terms"]) * nb_pad}
        else:
            kernel = "batched.disjunction"
            fields = {"queries": 1, "num_docs": len(getattr(idx, "_docs", ())) or 1}
        cost = kernel_cost(kernel, fields)
        if cost is None:
            return {"weight": 0.0, "flops": 0.0, "bytes": 0.0, "kernel": None}
        peak_f, peak_b, _kind = device_peaks(self.engine.device)
        flops, nbytes = float(cost.get("flops", 0.0)), float(cost.get("bytes", 0.0))
        return {"weight": max(flops / peak_f, nbytes / peak_b), "flops": flops,
                "bytes": nbytes, "kernel": kernel}

    @staticmethod
    def _add_cost(tenant_cost: dict, tenant: str, c: dict) -> None:
        tc = tenant_cost.setdefault(tenant, {"weight": 0.0, "flops": 0.0, "bytes": 0.0,
                                             "kernels": {}})
        tc["weight"] += c["weight"]
        tc["flops"] += c["flops"]
        tc["bytes"] += c["bytes"]
        if c["kernel"] is not None:
            tc["kernels"][c["kernel"]] = tc["kernels"].get(c["kernel"], 0.0) + (c["weight"] or 1.0)

    def _wave_begin(self, ready: list[PendingSearch]) -> dict:
        tenants: dict[str, int] = {}
        for ps in ready:
            tenants[ps.tenant] = tenants.get(ps.tenant, 0) + 1
        state = {"t0": time.monotonic(), "jobs": [], "n": len(ready), "fallback_solo": 0,
                 "tenants": tenants, "tenant_cost": {}}
        # the internal lane: folds claimed into this wave run here, on the
        # engine thread, and resolve at once; the searches pack around them
        searches = []
        for ps in ready:
            fn = ps.entry.get("internal")
            if not callable(fn):
                searches.append(ps)
                continue
            with self._lock:
                self.counters["merges"] += 1
            try:
                self._finish_entry(ps, result={"merged": bool(fn())})
            except Exception as ex:  # noqa: BLE001 - a per-entry envelope
                self._finish_entry(ps, error=ex)
        ready = searches
        # the superpack lane: entries of current members run as one
        # tenant-gather job; a failed claim serves per index
        mgr = self.engine.superpacks_if_enabled()
        if mgr is not None:
            claimed, rest = [], []
            for ps in ready:
                (claimed if mgr.wave_claim(ps.entry) else rest).append(ps)
            ready = rest
            if claimed:
                costs = [self._entry_cost(ps) for ps in claimed]
                try:
                    job = mgr.search_wave_begin([ps.entry for ps in claimed])
                except ElasticsearchTpuError:
                    # a member failed to plan: each entry answers solo, with
                    # its own answer or error
                    for ps in claimed:
                        state["fallback_solo"] += 1
                        self._finish_entry(ps, *self._solo(ps))
                else:
                    state["jobs"].append((mgr, claimed, job))
                    for ps, c in zip(claimed, costs):
                        self._add_cost(state["tenant_cost"], ps.tenant, c)
        by_index: dict[str, list[PendingSearch]] = {}
        for ps in ready:
            by_index.setdefault(ps.entry["index"], []).append(ps)
        for name, members in by_index.items():
            idx = self.engine.indices.get(name)
            if idx is None:
                # deleted between classify and dispatch: the solo path
                # answers (404 or empty)
                for ps in members:
                    state["fallback_solo"] += 1
                    self._finish_entry(ps, *self._solo(ps))
                continue
            job = idx.search_wave_begin([ps.entry["kwargs"] for ps in members])
            state["jobs"].append((idx, members, job))
            for ps in members:
                self._add_cost(state["tenant_cost"], ps.tenant, self._entry_cost(ps, idx))
        state["begin_ms"] = (time.monotonic() - state["t0"]) * 1000
        return state

    def _wave_finish(self, state: dict):
        t_finish = time.monotonic()
        err = state.get("fetch_error")
        occ = []
        fallback = state["fallback_solo"]
        for idx, members, job in state["jobs"]:
            if err is not None:
                # the copy failed: each member reruns solo
                results = [res if ex is None else ex
                           for res, ex in (self._solo(ps) for ps in members)]
            else:
                results = idx.search_wave_finish(job)
            for ps, res in zip(members, results):
                if isinstance(res, Exception):
                    self._finish_entry(ps, error=res)
                else:
                    self._finish_entry(ps, result=res)
            meta = job["meta"]
            fallback += meta["fallback_solo"]
            occ += [q / max(tier, 1) for q, tier in meta["term_waves"]]
            with self._lock:
                self.counters["term_packed"] += meta["term_packed"]
                self.counters["tiered_packed"] += meta["tiered_packed"]
                if isinstance(idx, SuperpackManager):
                    self.counters["superpack_packed"] += meta["term_packed"]
        t_end = time.monotonic()
        wave_ms = (t_end - state["t0"]) * 1000
        with self._lock:
            for stage, ms in (("begin", state["begin_ms"]), ("fetch", state.get("fetch_ms", 0.0)),
                              ("finish", (t_end - t_finish) * 1000), ("wave", wave_ms)):
                self._stage_ms[stage] += ms
            self.counters["waves"] += 1
            self.counters["fallback_solo"] += fallback
            if state["n"] > 1:
                self.counters["coalesced"] += state["n"]
            self._size_sum += state["n"]
            self._occ_sum += sum(occ)
            self._occ_n += len(occ)
            self._wave_ms_ema = (wave_ms if self._wave_ms_ema is None
                                 else 0.8 * self._wave_ms_ema + 0.2 * wave_ms)
        self._meter_wave(state)

    def _meter_wave(self, state: dict) -> None:
        """Apportion the wave's device segment (from the dispatch to the
        fetch done, as the reference's flight recorder measures it) over its
        tenants by each entry's analytic cost: the shares sum exactly to
        the segment (`apportion`). Tenants with no device work in the wave
        (inline merges, solo fallbacks) carry weight 0 and a 0.0 share.
        Then the fair-share table follows the new burn rates."""
        t_disp = state.get("t_dispatched", state["t0"])
        device_ms = (state.get("t_fetched", t_disp) - t_disp) * 1000
        req = dict(state["tenants"])
        tcost = state["tenant_cost"]
        shares = apportion(device_ms, {t: (tcost.get(t) or {}).get("weight", 0.0)
                                       for t in req}) if req else {}
        self._meter().record_wave(shares, req, tcost)
        with self._lock:
            self._tenant_waves.append({
                "size": state["n"], "device_ms": device_ms,
                "tenants": {t: {"requests": req[t], "device_ms": shares.get(t, 0.0),
                                "share": shares.get(t, 0.0) / device_ms if device_ms else 0.0}
                            for t in req}})
        self._apply_fairshare()

    def tenant_waves(self, n: int | None = None) -> list[dict]:
        """The recent waves' tenant records, oldest first: each wave's
        device segment in ms and every tenant's requests, share of it
        (device_ms) and fraction."""
        with self._lock:
            waves = list(self._tenant_waves)
        return waves if n is None else waves[-max(int(n), 0):]

    # ---- introspection and lifecycle -----------------------------------------

    def stats(self) -> dict:
        with self._lock:
            waves = max(self.counters["waves"], 1)
            return {
                "enabled": self.enabled,
                "queue": {**self._tenants.stats(), "max_depth": self.queue_cap},
                "wave": {
                    "max_wave": self.max_wave,
                    "max_wait_ms": self.max_wait_s * 1000,
                    "in_flight": self._inflight_count,
                    "avg_size": self._size_sum / waves,
                    "avg_term_occupancy": (self._occ_sum / self._occ_n
                                           if self._occ_n else None),
                    "service_ms_ema": self._wave_ms_ema,
                    "arrival_rate_ema": self._arrival_rate_ema,
                    "stage_ms_total": dict(self._stage_ms),
                },
                "fairshare": {"enabled": self._fairshare_on,
                              "budget_device_ms_per_s": self._fairshare_budget,
                              "min_factor": self._fairshare_min,
                              "static_weights": dict(self._static_weights),
                              "effective_weights": dict(self._tenants.weights)},
                **self.counters,
            }

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait until the queue and the in-flight waves are empty."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self._lock:
                if self._tenants.depth == 0 and self._inflight_count == 0:
                    return True
            time.sleep(0.002)
        return False

    def stop(self):
        """Stop the scheduler threads; queued entries resolve as shed."""
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        try:
            self._inflight.put_nowait(None)
        except _queue.Full:
            pass
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        try:
            while True:  # a sentinel left behind would stop a restart
                self._inflight.get_nowait()
        except _queue.Empty:
            pass
        self._inflight_count = 0
        for ps in self._tenants.drain():
            self._finish_entry(ps, error=ServingRejectedError("serving front end stopped"))
        if self._own_pool is not None:
            self._own_pool.shutdown(wait=True)
            self._own_pool = None
