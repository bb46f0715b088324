"""Per-tenant resource metering: exact apportionment of shared device
waves, the bounded tenant ledger and budget-fed fair-share weights.

A copy of the JAX package's `tenancy/metering.py`. The serving front end
coalesces many tenants' requests into one device wave, and a superpack
stacks many tenant indices into one layout, so no single launch belongs to
one tenant. Each wave's measured device segment (from dispatch to the
fetch done) is split across its tenants in proportion to each entry's
analytic cost (`monitoring/costmodel.py`), with shares that sum exactly to
the segment (`apportion`).

  - `normalize_tenant`: the one tenant-identity helper. The serving queue,
    the weight table, the meter and REST all pass `X-Opaque-Id` through
    it, so "tenant" means the same string at every layer.
  - `apportion`: split a total across keys in proportion to weights with
    `math.fsum(shares.values()) == total` exactly (a residual correction
    on the largest share, and a one-ulp nudge of the second-largest when
    the sum deadlocks on a rounding tie).
  - `TenantMeter`: the bounded per-tenant ledger (device ms, analytic
    flops and bytes, queue waits and their p99, requests and waves, sheds,
    expiries and cancels, ingest bytes and docs, the per-kernel device-ms
    split). Rows beyond the top-K budget fold into `_other`; a sliding
    window gives each tenant's device-ms/s burn.
  - `fairshare_weights`: a tenant burning over the device-ms/s budget has
    its static weight scaled by budget/burn, clamped to [min_factor, 1].

The request-cache hit and miss columns stay 0 until the request cache is
ported.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque

# the default tenant: requests with no X-Opaque-Id. A constant (not the
# empty string) so the anonymous bucket is visible, queryable, and
# weight-addressable like any other tenant.
DEFAULT_TENANT = "_anonymous"
# overflow row: evicted ledger rows and beyond-top-K surfaces aggregate
# here — the hard cardinality bound for Prometheus label sets
OTHER_TENANT = "_other"
TENANT_MAX_LEN = 64
# Prometheus label values take any UTF-8, but tenant strings become
# metric label values AND TSDB field keys (dots would nest) — clamp to
# the safe charset; everything else maps to "_"
_UNSAFE = re.compile(r"[^A-Za-z0-9_\-]")


def normalize_tenant(raw) -> str:
    """The shared tenant-identity helper: X-Opaque-Id (or any caller
    string) -> the canonical tenant key used by the serving queue, the
    cache accounting join, and the meter. None/empty -> the explicit
    default-tenant constant; long ids clamp; unsafe chars sanitize."""
    if raw is None:
        return DEFAULT_TENANT
    s = str(raw).strip()
    if not s:
        return DEFAULT_TENANT
    s = _UNSAFE.sub("_", s)
    if len(s) > TENANT_MAX_LEN:
        s = s[:TENANT_MAX_LEN]
    return s or DEFAULT_TENANT


def shares_sum(shares) -> float:
    """The canonical sum for share vectors: `math.fsum` (exact for the
    correction loop in `apportion`). Tests and the bench records judge
    the sums-to-wall invariant through THIS function, not sum()."""
    vals = shares.values() if isinstance(shares, dict) else shares
    return math.fsum(vals)


def apportion(total: float, weights: dict[str, float]) -> dict[str, float]:
    """Split `total` across keys proportional to `weights`, exactly:
    `shares_sum(result) == total` (bit-for-bit). Non-positive or missing
    weights degrade to an equal split — attribution must never lose
    wall time because a cost shape was unavailable."""
    keys = sorted(weights)
    if not keys:
        return {}
    w = {k: float(weights[k]) for k in keys}
    tot_w = math.fsum(v for v in w.values() if v > 0.0)
    if tot_w <= 0.0 or not math.isfinite(tot_w):
        w = {k: 1.0 for k in keys}
        tot_w = float(len(keys))
    out = {k: total * max(w[k], 0.0) / tot_w for k in keys}
    # residual correction, two moves (deterministic tie-breaks):
    #   1. the LARGEST share absorbs outright: total - fsum(others);
    #   2. if the fsum still misses `total` (a round-half-to-even parity
    #      deadlock — reachable sums step by ulp(total) and both
    #      neighbors of the half-ulp target round away), nudge the
    #      SECOND-largest share one ulp. It is <= total/2, so its ulp is
    #      a strictly finer quantum that shifts the reachable lattice
    #      off the halfway point; then move 1 re-absorbs exactly.
    k = max(out, key=lambda t: (out[t], t))
    for _ in range(32):
        out[k] = total - math.fsum(v for t, v in out.items() if t != k)
        r = total - math.fsum(out.values())
        if r == 0.0:
            break
        cands = [t for t in out if t != k and out[t] > 0.0]
        if not cands:
            out[k] = total  # every other share is 0.0: exact by itself
            break
        j = max(cands, key=lambda t: (out[t], t))
        out[j] = math.nextafter(out[j],
                                math.inf if r > 0.0 else -math.inf)
    return out


# sliding burn window (seconds): device-ms/s over this lookback feeds
# the slo.tenant.device_ms_per_s objective and the fair-share weights
BURN_WINDOW_S = 30.0


class _Row:
    """One tenant's ledger row. Plain counters under the meter's lock."""

    __slots__ = ("requests", "waves", "device_ms", "flops", "bytes",
                 "queue_wait_ms", "queue_hist", "sheds", "expired",
                 "cancelled", "cache_hits", "cache_misses", "ingest_bytes",
                 "ingest_docs", "kernel_ms", "burn_samples", "first_seen")

    def __init__(self):
        self.requests = 0
        self.waves = 0
        self.device_ms = 0.0
        self.flops = 0.0
        self.bytes = 0.0
        self.queue_wait_ms = 0.0
        from ..telemetry import _Histogram

        self.queue_hist = _Histogram()
        self.sheds = 0
        self.expired = 0
        self.cancelled = 0
        self.cache_hits = 0.0
        self.cache_misses = 0.0
        self.ingest_bytes = 0
        self.ingest_docs = 0
        self.kernel_ms: dict[str, float] = {}
        # (monotonic_t, device_ms) samples inside BURN_WINDOW_S
        self.burn_samples: deque = deque(maxlen=512)
        self.first_seen = time.monotonic()

    def absorb(self, other: "_Row") -> None:
        """Fold an evicted row into this one (the `_other` aggregate).
        The histogram merges bucket-wise; burn samples concatenate."""
        self.requests += other.requests
        self.waves += other.waves
        self.device_ms += other.device_ms
        self.flops += other.flops
        self.bytes += other.bytes
        self.queue_wait_ms += other.queue_wait_ms
        h, o = self.queue_hist, other.queue_hist
        h.count += o.count
        h.sum += o.sum
        h.min = min(h.min, o.min)
        h.max = max(h.max, o.max)
        h.zero_count += o.zero_count
        for b, n in o.buckets.items():
            h.buckets[b] = h.buckets.get(b, 0) + n
        self.sheds += other.sheds
        self.expired += other.expired
        self.cancelled += other.cancelled
        self.cache_hits += other.cache_hits
        self.cache_misses += other.cache_misses
        self.ingest_bytes += other.ingest_bytes
        self.ingest_docs += other.ingest_docs
        for k, v in other.kernel_ms.items():
            self.kernel_ms[k] = self.kernel_ms.get(k, 0.0) + v
        for s in other.burn_samples:
            self.burn_samples.append(s)
        self.first_seen = min(self.first_seen, other.first_seen)


class TenantMeter:
    """Bounded per-tenant ledger. Per-engine (like the refresh recorder:
    in-process multi-node fixtures must never mix nodes' tenants).

    The top-K bound is structural, not cosmetic: tenant strings come
    from the network (X-Opaque-Id), so without it the ledger — and
    every Prometheus label set derived from it — grows without bound.
    When a (K+1)-th tenant appears, the coldest row (least device_ms,
    then oldest) folds into `_other`; the default tenant and `_other`
    itself are never evicted."""

    def __init__(self, top_k: int = 16):
        self.top_k = max(2, int(top_k))
        self._lock = threading.Lock()
        self._rows: dict[str, _Row] = {}

    def set_top_k(self, v) -> None:
        try:
            self.top_k = max(2, int(v))
        except (TypeError, ValueError):
            return
        with self._lock:
            self._shrink_locked()

    # ---- writers ---------------------------------------------------------

    def _row_locked(self, tenant: str) -> _Row:
        row = self._rows.get(tenant)
        if row is None:
            row = self._rows[tenant] = _Row()
            # the row we just made current is shielded from its own
            # insertion's eviction pass — a colder EXISTING row folds
            # into _other instead (new rows start at 0 device_ms and
            # would otherwise always be their own victim)
            self._shrink_locked(keep=tenant)
        return row

    def _shrink_locked(self, keep: str | None = None) -> None:
        protected = {OTHER_TENANT, DEFAULT_TENANT}
        if keep is not None:
            protected.add(keep)
        while len([t for t in self._rows if t != OTHER_TENANT]) > self.top_k:
            victims = [t for t in self._rows if t not in protected]
            if not victims:
                return
            cold = min(victims, key=lambda t: (self._rows[t].device_ms,
                                               -self._rows[t].first_seen, t))
            row = self._rows.pop(cold)
            other = self._rows.get(OTHER_TENANT)
            if other is None:
                other = self._rows[OTHER_TENANT] = _Row()
            other.absorb(row)

    def note(self, kind: str, tenant, n: int = 1) -> None:
        """Bump one terminal counter: kind in {"requests", "sheds",
        "expired", "cancelled"}."""
        tenant = normalize_tenant(tenant)
        with self._lock:
            row = self._row_locked(tenant)
            setattr(row, kind, getattr(row, kind) + n)

    def note_queue_wait(self, tenant, ms: float) -> None:
        tenant = normalize_tenant(tenant)
        with self._lock:
            row = self._row_locked(tenant)
            row.queue_wait_ms += float(ms)
            row.queue_hist.record(float(ms))

    def note_ingest(self, tenant, nbytes: int, docs: int = 0) -> None:
        tenant = normalize_tenant(tenant)
        with self._lock:
            row = self._row_locked(tenant)
            row.ingest_bytes += int(nbytes)
            row.ingest_docs += int(docs)

    def record_wave(self, shares: dict[str, float],
                    requests: dict[str, int] | None = None,
                    cost: dict[str, dict] | None = None,
                    cache_hits: float = 0.0,
                    cache_misses: float = 0.0) -> None:
        """Feed one wave's apportioned share vector into the ledger.
        `shares`: tenant -> device ms (already exact, from `apportion`).
        `cost`: tenant -> {"flops", "bytes", "kernels": {name: weight}}
        analytic attributions computed at dispatch. Cache traffic is
        split by request count, an estimate (a wave's cache events carry
        no tenant)."""
        now = time.monotonic()
        req = requests or {}
        n_req = sum(req.values()) or len(shares) or 1
        with self._lock:
            for tenant, ms in shares.items():
                tenant = normalize_tenant(tenant)
                row = self._row_locked(tenant)
                row.waves += 1
                row.requests += int(req.get(tenant, 0))
                row.device_ms += float(ms)
                row.burn_samples.append((now, float(ms)))
                frac = req.get(tenant, 1) / n_req
                row.cache_hits += cache_hits * frac
                row.cache_misses += cache_misses * frac
                tc = (cost or {}).get(tenant) or {}
                row.flops += float(tc.get("flops", 0.0))
                row.bytes += float(tc.get("bytes", 0.0))
                kern = tc.get("kernels") or {}
                k_tot = math.fsum(kern.values())
                if k_tot > 0.0 and ms:
                    # the tenant's share, split again over ITS kernels
                    for name, w in kern.items():
                        row.kernel_ms[name] = (row.kernel_ms.get(name, 0.0)
                                               + float(ms) * w / k_tot)

    # ---- readers ---------------------------------------------------------

    def _burn_locked(self, row: _Row, now: float) -> float:
        """Device-ms/s over the sliding window (device-time budget burn
        rate, the slo.tenant.device_ms_per_s measurement)."""
        while row.burn_samples and now - row.burn_samples[0][0] \
                > BURN_WINDOW_S:
            row.burn_samples.popleft()
        if not row.burn_samples:
            return 0.0
        span = max(now - row.burn_samples[0][0],
                   min(now - row.first_seen, BURN_WINDOW_S), 1e-3)
        return math.fsum(ms for _, ms in row.burn_samples) / span

    def dominant_kernel(self, tenant) -> str | None:
        tenant = normalize_tenant(tenant)
        with self._lock:
            row = self._rows.get(tenant)
            if row is None or not row.kernel_ms:
                return None
            return max(row.kernel_ms, key=lambda k: (row.kernel_ms[k], k))

    def rows(self) -> dict[str, dict]:
        """tenant -> ledger snapshot, device_ms-descending insertion
        order (the `_cat/tenants` and `_tenants/stats` body)."""
        now = time.monotonic()
        with self._lock:
            out = {}
            order = sorted(self._rows,
                           key=lambda t: (-self._rows[t].device_ms, t))
            for tenant in order:
                row = self._rows[tenant]
                total = row.requests + row.sheds
                out[tenant] = {
                    "requests": row.requests,
                    "waves": row.waves,
                    "device_ms": round(row.device_ms, 4),
                    "device_ms_per_s": round(self._burn_locked(row, now), 4),
                    "flops": row.flops,
                    "bytes": row.bytes,
                    "queue_wait_ms": round(row.queue_wait_ms, 4),
                    "queue_p99_ms": round(row.queue_hist.percentile(0.99), 4),
                    "sheds": row.sheds,
                    "shed_rate": round(row.sheds / total, 6) if total else 0.0,
                    "expired": row.expired,
                    "cancelled": row.cancelled,
                    "cache": {"hits": round(row.cache_hits, 2),
                              "misses": round(row.cache_misses, 2)},
                    "ingest_bytes": row.ingest_bytes,
                    "ingest_docs": row.ingest_docs,
                    "kernels": {k: round(v, 4)
                                for k, v in sorted(
                                    row.kernel_ms.items(),
                                    key=lambda kv: -kv[1])},
                }
            return out

    def burn_rates(self) -> dict[str, float]:
        """tenant -> device-ms/s over the sliding window (the fair-share
        weight derivation input; `_other` excluded — it is an aggregate,
        not a schedulable tenant)."""
        now = time.monotonic()
        with self._lock:
            return {t: self._burn_locked(r, now)
                    for t, r in self._rows.items() if t != OTHER_TENANT}

    def stats(self) -> dict:
        """The `GET /_tenants/stats` body."""
        rows = self.rows()
        return {
            "top_k": self.top_k,
            "tenant_count": len(rows),
            "tenants": rows,
        }

    def reset_for_tests(self) -> None:
        with self._lock:
            self._rows.clear()


def fairshare_weights(static: dict[str, float],
                      burn: dict[str, float],
                      budget_ms_per_s: float,
                      min_factor: float = 0.25) -> dict[str, float]:
    """Derive effective weighted-RR tenant weights from budget burn
    (`planner.tenant.fairshare`): a tenant burning over the
    device-ms/s budget has its static weight scaled by budget/burn,
    clamped to [min_factor, 1.0] — slowed, never starved (the weight
    never reaches zero, so pop_wave still visits every tenant each
    round). Tenants at/below budget, unknown tenants, and a budget <= 0
    pass through UNCHANGED — with no budget set the result is the
    `static` dict itself (cold-state byte-identical, the PR-18 parity
    discipline)."""
    if budget_ms_per_s <= 0.0 or not burn:
        return static
    min_factor = min(max(float(min_factor), 0.01), 1.0)
    out = dict(static)
    changed = False
    for tenant, rate in burn.items():
        if rate <= budget_ms_per_s:
            continue
        base = float(out.get(tenant, 1.0))
        factor = max(min_factor, budget_ms_per_s / rate)
        out[tenant] = base * factor
        changed = True
    return out if changed else static
