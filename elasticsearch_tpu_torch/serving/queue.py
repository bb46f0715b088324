"""Admission queue of the serving front end: a copy of the JAX package's
`serving/queue.py`.

The reference bounds search concurrency with a fixed thread pool and a
bounded queue (reference behavior: threadpool/ThreadPool.java `search`
pool, queue_size 1000; overflow raises EsRejectedExecutionException
rendered as HTTP 429). The device analog keeps ONE device pipeline and
bounds the admitted-but-undispatched requests instead: entries wait in
per-tenant queues, a weighted round-robin scheduler drains them into device
waves, and overflow sheds load with 429 + Retry-After before any memory is
committed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

from ..tenancy.metering import normalize_tenant
from ..utils.errors import ElasticsearchTpuError

class ServingRejectedError(ElasticsearchTpuError):
    """Load shed at admission: queue full or front end stopped. 429 with a
    Retry-After from the queue's drain rate."""

    status = 429
    type = "es_rejected_execution_exception"

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(reason)
        self.retry_after_s = max(1.0, float(retry_after_s))


@dataclass
class PendingSearch:
    """One admitted-but-undispatched search. The future resolves with the
    engine's response dict (or an exception); `claim()` settles the
    dispatch-vs-expiry race exactly once."""

    entry: dict
    tenant: str
    future: Future = field(default_factory=Future)
    enqueue_t: float = field(default_factory=time.monotonic)
    deadline: float | None = None  # monotonic; None = no timeout
    est_bytes: int = 4096  # in_flight_requests breaker charge
    _claimed: bool = False

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class TenantQueues:
    """Per-tenant FIFO queues drained by weighted round-robin: every wave
    visits every non-empty tenant, taking up to max(1, round(weight))
    entries per visit, so a heavy tenant can slow a light one but never
    block it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._q: dict[str, deque] = {}
        self._ring: list[str] = []
        self._rr = 0
        self._depth = 0
        self.weights: dict[str, float] = {}

    def set_weights(self, weights: dict[str, float]):
        with self._lock:
            self.weights = dict(weights)

    @property
    def depth(self) -> int:
        return self._depth

    def push(self, ps: PendingSearch) -> int:
        """-> queue depth after the push."""
        with self._lock:
            ps.tenant = normalize_tenant(ps.tenant)
            dq = self._q.get(ps.tenant)
            if dq is None:
                dq = self._q[ps.tenant] = deque()
                self._ring.append(ps.tenant)
            dq.append(ps)
            self._depth += 1
            return self._depth

    def claim(self, ps: PendingSearch) -> bool:
        """Take ownership of an entry; exactly one caller wins. The entry
        stays in its deque and `pop_wave` skips it."""
        with self._lock:
            if ps._claimed:
                return False
            ps._claimed = True
            self._depth -= 1
            return True

    def pop_wave(self, max_n: int) -> list[PendingSearch]:
        """Claim up to max_n entries by weighted round-robin."""
        out: list[PendingSearch] = []
        with self._lock:
            if not self._ring:
                return out
            idle_passes = 0
            while len(out) < max_n and idle_passes < len(self._ring):
                tenant = self._ring[self._rr % len(self._ring)]
                self._rr += 1
                dq = self._q.get(tenant)
                budget = max(1, round(self.weights.get(tenant, 1.0)))
                took = 0
                while dq and took < budget and len(out) < max_n:
                    ps = dq.popleft()
                    if ps._claimed:
                        continue  # expired while queued
                    ps._claimed = True
                    self._depth -= 1
                    out.append(ps)
                    took += 1
                idle_passes = 0 if took else idle_passes + 1
            return out

    def drain(self) -> list[PendingSearch]:
        """Claim everything still queued (shutdown)."""
        out = []
        with self._lock:
            for dq in self._q.values():
                while dq:
                    ps = dq.popleft()
                    if not ps._claimed:
                        ps._claimed = True
                        self._depth -= 1
                        out.append(ps)
            self._q.clear()
            self._ring.clear()
            self._rr = 0
        return out

    def stats(self) -> dict:
        with self._lock:
            per_tenant = {t: sum(1 for ps in dq if not ps._claimed)
                          for t, dq in self._q.items()}
            return {"depth": self._depth,
                    "tenants": {t: n for t, n in per_tenant.items() if n}}


def parse_tenant_weights(raw: str) -> dict[str, float]:
    """'tenantA:4,tenantB:1' -> {'tenantA': 4.0, 'tenantB': 1.0}."""
    out: dict[str, float] = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.rpartition(":")
        try:
            out[name] = float(w)
        except ValueError:
            continue
    return out
