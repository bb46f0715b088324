"""Hierarchical circuit breakers: the budgeter of the card's memory.

A copy of the JAX package's `common/breaker.py` (reference behavior:
indices/breaker/HierarchyCircuitBreakerService.java: child breakers, each
with its own limit, under a parent that bounds their sum; overflow raises
CircuitBreakingException, rendered as HTTP 429). "fielddata" accounts the
device-resident index packs, "request" transient per-search scratch and
"in_flight_requests" the serving front end's admitted requests and
"esql.materialization" the live tables of an ES|QL query. The budget
is the card's memory (`torch.cuda.mem_get_info`); 4 GB "host mode" only
when the caller asks for device="cpu".
"""

from __future__ import annotations

import threading

import torch

from ..utils.errors import ElasticsearchTpuError
from .settings import parse_bytes

HOST_MODE_BYTES = 4 << 30


class CircuitBreakingError(ElasticsearchTpuError):
    status = 429
    type = "circuit_breaking_exception"

    def __init__(self, reason, bytes_wanted=0, bytes_limit=0, durability="PERMANENT"):
        super().__init__(reason)
        self.bytes_wanted = bytes_wanted
        self.bytes_limit = bytes_limit
        self.durability = durability

    def to_dict(self):
        d = super().to_dict()
        d["error"]["bytes_wanted"] = self.bytes_wanted
        d["error"]["bytes_limit"] = self.bytes_limit
        d["error"]["durability"] = self.durability
        return d


def detect_device_memory_bytes(device) -> int:
    """The card's total memory; HOST_MODE_BYTES for device="cpu". Raises
    when the card cannot be read: there is no quiet fallback."""
    device = torch.device(device)
    if device.type == "cpu":
        return HOST_MODE_BYTES
    if device.type != "cuda":
        raise ValueError(f"unsupported device [{device}]")
    return int(torch.cuda.mem_get_info(device)[1])


class ChildBreaker:
    def __init__(self, name: str, limit_bytes: int, overhead: float = 1.0):
        self.name = name
        self.limit = limit_bytes
        self.overhead = overhead
        self.used = 0
        self.trip_count = 0


class CircuitBreakerService:
    """Thread-safe accounting: `add_estimate(child, bytes, label)` admits or
    raises, `release` returns bytes, and `set_steady` replaces the
    steady-state usage of a key (one index's packs) instead of adding to
    it."""

    def __init__(self, device, limits: dict[str, str] | None = None,
                 total_bytes: int | None = None):
        self.total = total_bytes or detect_device_memory_bytes(device)
        limits = limits or {}
        self.parent_limit = parse_bytes(limits.get("total", "95%"), self.total)
        self.children: dict[str, ChildBreaker] = {
            "fielddata": ChildBreaker(
                "fielddata", parse_bytes(limits.get("fielddata", "40%"), self.total)),
            "request": ChildBreaker(
                "request", parse_bytes(limits.get("request", "60%"), self.total)),
            "in_flight_requests": ChildBreaker("in_flight_requests", self.total),
            # transient ESQL whole-column materializations (esql/profile.py):
            # each pipe stage's live table bytes are charged here as a
            # running delta, so an oversized FROM|STATS trips a 429 naming
            # the dominant operator
            "esql.materialization": ChildBreaker(
                "esql.materialization",
                parse_bytes(limits.get("esql.materialization", "40%"), self.total)),
        }
        self.parent_trip_count = 0
        self._steady: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()

    def set_limit(self, child: str, raw):
        with self._lock:
            if child == "total":
                self.parent_limit = parse_bytes(raw, self.total)
            else:
                self.children[child].limit = parse_bytes(raw, self.total)

    def _parent_used(self) -> int:
        return sum(c.used for c in self.children.values())

    def add_estimate(self, child: str, n_bytes: int, label: str = "<unknown>"):
        with self._lock:
            cb = self.children[child]
            new_used = cb.used + n_bytes
            if n_bytes > 0 and new_used * cb.overhead > cb.limit:
                cb.trip_count += 1
                raise CircuitBreakingError(
                    f"[{child}] Data too large, data for [{label}] would be "
                    f"[{new_used}/{new_used}b], which is larger than the limit of "
                    f"[{cb.limit}/{cb.limit}b]",
                    bytes_wanted=new_used, bytes_limit=cb.limit,
                    durability=("TRANSIENT" if child in ("request", "esql.materialization")
                                else "PERMANENT"))
            parent_new = self._parent_used() + max(n_bytes, 0)
            if n_bytes > 0 and parent_new > self.parent_limit:
                self.parent_trip_count += 1
                raise CircuitBreakingError(
                    f"[parent] Data too large, data for [{label}] would be "
                    f"[{parent_new}/{parent_new}b], which is larger than the limit of "
                    f"[{self.parent_limit}/{self.parent_limit}b]",
                    bytes_wanted=parent_new, bytes_limit=self.parent_limit)
            cb.used = new_used

    def release(self, child: str, n_bytes: int):
        with self._lock:
            cb = self.children[child]
            cb.used = max(0, cb.used - n_bytes)

    def set_steady(self, child: str, key: str, n_bytes: int, label: str | None = None):
        """Replace the steady usage attributed to `key`: admission-checks
        only the delta."""
        prev = self._steady.get((child, key), 0)
        delta = n_bytes - prev
        if delta > 0:
            self.add_estimate(child, delta, label or key)
        elif delta < 0:
            self.release(child, -delta)
        if n_bytes == 0:
            self._steady.pop((child, key), None)
        else:
            self._steady[(child, key)] = n_bytes

    def stats(self) -> dict:
        with self._lock:
            out = {name: {"limit_size_in_bytes": cb.limit,
                          "estimated_size_in_bytes": cb.used,
                          "overhead": cb.overhead, "tripped": cb.trip_count}
                   for name, cb in self.children.items()}
            out["parent"] = {"limit_size_in_bytes": self.parent_limit,
                             "estimated_size_in_bytes": self._parent_used(),
                             "overhead": 1.0, "tripped": self.parent_trip_count}
            return out
