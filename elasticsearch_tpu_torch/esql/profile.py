"""ESQL per-operator profiling and materialization accounting.

A copy of the JAX package's `esql/profile.py` (reference behavior: the ESQL
compute engine's `"profile": true` driver profiles, x-pack/plugin/esql/
compute/.../Driver.java, DriverProfile / OperatorStatus). The port
materializes whole columns per pipe, as the reference does:

  - `OperatorProfile` wraps one `esql.engine.execute()` drive: every pipe
    stage cuts ONE contiguous clock at its boundary, so operator walls sum
    to the query wall exactly (`==`, asserted: the query wall is DEFINED as
    the fsum of the boundary segments, never a second clock that could
    drift);
  - every operator records rows/pages in/out and the bytes it left
    materialized per column (`Table` is one page per operator here);
  - the host-side live-table bytes are charged against the
    `esql.materialization` breaker child as a running delta, labeled with
    the DOMINANT operator (largest materialization so far), so an oversized
    FROM|STATS trips a 429 naming the stage that owns the bytes instead of
    exhausting the host's memory; reservations release in `finish()`
    unconditionally;
  - `peak_live_bytes` is the high-water of host table bytes plus the
    device's allocated bytes (`torch.cuda.memory_allocated`; 0 on the CPU)
    observed at operator boundaries;
  - `EsqlRecorder` keeps a bounded ring of finished query profiles plus the
    cumulative per-operator accounting behind `GET /_esql/profile`.

Bytes convention: a numeric column costs `values.nbytes + null.nbytes`; an
object (keyword) column costs the null mask plus 8 bytes of reference per
row plus the UTF-8 payload of each non-null value. Deterministic and
hand-computable: tests grade against exact expected sizes.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

# the breaker child (common/breaker.py) transient ESQL materializations
# charge into; limit set by indices.breaker.esql.materialization.limit
BREAKER_CHILD = "esql.materialization"

# the residual operator: wall time outside any pipe stage (parse,
# serialization bookkeeping between stages). Named explicitly, so
# untagged time grows a visible bucket instead of silently missing from
# the sum.
DRIVER_OPERATOR = "driver"

# live profiles holding an un-released breaker reservation, keyed by
# id(profile): drains to zero once every drive finished (a leak here
# would pin esql.materialization budget)
_OUTSTANDING: dict[int, "OperatorProfile"] = {}
_OUT_LOCK = threading.Lock()


def reservation_leaks() -> list[tuple[str, int]]:
    """(query, charged_bytes) for profiles still holding breaker bytes."""
    with _OUT_LOCK:
        return [(p.query, p._charged) for p in _OUTSTANDING.values()
                if p._charged > 0]


def column_nbytes(col) -> int:
    """Materialized bytes of one esql.engine.Column (see module doc for
    the object-column convention)."""
    values = col.values
    n = int(values.nbytes) + int(col.null.nbytes)
    if values.dtype == object:
        # numpy's nbytes for object arrays counts only the 8-byte refs;
        # add the string payloads actually held live. UTF-8 encodes each
        # code point alone, so the joined payload's length is their sum,
        # and an ASCII payload's is its length in characters.
        held = values[values != None].tolist()  # noqa: E711 (elementwise)
        try:
            payload = "".join(held)
        except TypeError:  # a non-str value (an aggregate's number)
            payload = "".join(map(str, held))
        n += len(payload) if payload.isascii() else len(payload.encode("utf-8", "ignore"))
    return n


def table_nbytes(table) -> tuple[int, dict[str, int]]:
    """-> (total_bytes, {column: bytes}) for one esql.engine.Table."""
    per: dict[str, int] = {}
    for name, col in table.columns.items():
        try:
            per[name] = column_nbytes(col)
        except Exception:  # noqa: BLE001 - accounting never fails a query
            per[name] = 0
    return sum(per.values()), per


def _device_live_bytes(device) -> int:
    """The device's allocated bytes right now: torch.cuda.memory_allocated
    on a CUDA device, 0 on the CPU (its tables are the host bytes)."""
    if device is None or device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.memory_allocated(device))


class OperatorProfile:
    """Contiguous per-operator clock for one ESQL query drive.

    `note(name, rows_in, table)` is called by `execute()` after each
    pipe stage: it cuts the single clock (charging the segment since
    the previous boundary to this operator), accounts the bytes the
    stage left materialized, advances the breaker reservation to the
    new live-table size, and bumps the peak-live high-water. `finish()`
    cuts the trailing residual into the `driver` operator, releases the
    reservation, and returns the profile body."""

    def __init__(self, query: str, breakers=None, device=None):
        self.query = query
        self._device = device
        self._t0 = time.perf_counter()
        self._last = self._t0
        self.operators: list[dict] = []
        self._bounds: list[tuple[float, float]] = []  # raw (start, end) s
        self.peak_live_bytes = 0
        self.dominant_operator: str | None = None
        self._dominant_bytes = -1
        self._breakers = breakers
        self._charged = 0
        self._finished = None

    def _cut(self) -> float:
        now = time.perf_counter()
        seg = (self._last - self._t0, now - self._t0)
        self._bounds.append(seg)
        self._last = now
        return seg[1] - seg[0]

    def note(self, name: str, rows_in: int, table) -> None:
        """One finished operator: the segment since the last boundary
        belongs to it; `table` is what it left materialized (None only
        before FROM/ROW produced anything)."""
        sec = self._cut()
        if table is None:
            total, per = 0, {}
            rows_out = 0
        else:
            total, per = table_nbytes(table)
            rows_out = int(table.nrows)
        rec = {
            "operator": name,
            "took_ms": sec * 1000.0,
            "rows_in": int(rows_in),
            "rows_out": rows_out,
            # whole columns: each operator consumes/produces one page; a
            # paged engine raises these with bounded rows per page
            "pages_in": 1 if rows_in else 0,
            "pages_out": 1 if table is not None else 0,
            "bytes_materialized": int(total),
            "columns": {k: int(v) for k, v in sorted(per.items())},
        }
        self.operators.append(rec)
        if total > self._dominant_bytes:
            self._dominant_bytes = total
            self.dominant_operator = name
        live = total + _device_live_bytes(self._device)
        if live > self.peak_live_bytes:
            self.peak_live_bytes = int(live)
        self._reserve(total)

    def _reserve(self, live_bytes: int) -> None:
        """Advance the esql.materialization reservation to the current
        live-table size (delta accounting, the set_steady idiom). A trip
        raises CircuitBreakingError out of the query with the dominant
        operator in the label; the partial reservation stays registered
        until finish() releases it."""
        if self._breakers is None:
            return
        delta = int(live_bytes) - self._charged
        if delta == 0:
            return
        with _OUT_LOCK:
            _OUTSTANDING[id(self)] = self
        if delta > 0:
            label = f"esql operator [{self.dominant_operator}]"
            self._breakers.add_estimate(BREAKER_CHILD, delta, label)
        else:
            self._breakers.release(BREAKER_CHILD, -delta)
        self._charged = int(live_bytes)

    def finish(self) -> dict:
        """Release reservations and assemble the profile body. Safe to
        call exactly once per drive, error or not; idempotent."""
        if self._finished is not None:
            return self._finished
        sec = self._cut()
        self.operators.append({
            "operator": DRIVER_OPERATOR,
            "took_ms": sec * 1000.0,
            "rows_in": 0, "rows_out": 0, "pages_in": 0, "pages_out": 0,
            "bytes_materialized": 0, "columns": {},
        })
        if self._breakers is not None and self._charged > 0:
            try:
                self._breakers.release(BREAKER_CHILD, self._charged)
            finally:
                self._charged = 0
        with _OUT_LOCK:
            _OUTSTANDING.pop(id(self), None)
        # contiguity: every segment starts where the previous ended —
        # the one-clock discipline that MAKES the sum exact
        for (a, b), (c, _d) in zip(self._bounds, self._bounds[1:]):
            assert b == c, "esql profile boundary discontinuity"
        wall_ms = math.fsum(o["took_ms"] for o in self.operators)
        assert wall_ms == math.fsum(o["took_ms"] for o in self.operators)
        rows = 0
        for o in reversed(self.operators):
            if o["operator"] != DRIVER_OPERATOR:
                rows = o["rows_out"]
                break
        self._finished = {
            "query": self.query,
            "wall_ms": wall_ms,
            "rows": rows,
            "peak_live_bytes": int(self.peak_live_bytes),
            "dominant_operator": self.dominant_operator,
            # reference driver-profile shape: drivers[] each carrying an
            # operators[] list; the whole-column port is one driver
            "drivers": [{
                "description": "esql_driver",
                "took_ms": wall_ms,
                "operators": list(self.operators),
            }],
        }
        return self._finished


def _iso_utc(ts: float | None = None) -> str:
    t = time.time() if ts is None else ts
    ms = int(t * 1000) % 1000
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + f".{ms:03d}Z"


class EsqlRecorder:
    """Bounded ring of finished query profiles plus the cumulative
    per-operator accounting (`GET /_esql/profile`)."""

    def __init__(self, size: int = 128):
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(int(size), 1))
        self._seq = 0
        self._rows_total = 0
        self._operator_ms: dict[str, float] = {}
        self._peak_hwm = 0
        self._peak_last = 0
        self._breaker_trips = 0

    def record(self, profile: dict, tripped: bool = False) -> dict:
        with self._lock:
            self._seq += 1
            profile = {"seq": self._seq, "@timestamp": _iso_utc(), **profile}
            self._ring.append(profile)
            self._rows_total += int(profile.get("rows", 0))
            for d in profile.get("drivers") or []:
                for o in d.get("operators") or []:
                    name = o["operator"]
                    self._operator_ms[name] = (
                        self._operator_ms.get(name, 0.0) + o["took_ms"])
            peak = int(profile.get("peak_live_bytes", 0))
            self._peak_last = peak
            if peak > self._peak_hwm:
                self._peak_hwm = peak
            if tripped:
                self._breaker_trips += 1
        return profile

    def profiles(self, n: int | None = None) -> dict:
        """Recorded queries, oldest first (GET /_esql/profile)."""
        with self._lock:
            profs = list(self._ring)
            total = self._seq
        if n is not None:
            profs = profs[-max(int(n), 0):]
        return {
            "capacity": self._ring.maxlen,
            "recorded_total": total,
            "retained": len(profs),
            "profiles": profs,
        }

    def stats(self) -> dict:
        with self._lock:
            op_ms = {k: round(v, 4)
                     for k, v in sorted(self._operator_ms.items())}
            named = {k: v for k, v in self._operator_ms.items()
                     if k != DRIVER_OPERATOR}
            dominant = (max(named, key=lambda k: (named[k], k))
                        if named else None)
            return {
                "queries": self._seq,
                "rows_total": self._rows_total,
                "operator_ms": op_ms,
                "dominant_operator": dominant,
                "peak_bytes_hwm": self._peak_hwm,
                "peak_bytes_last": self._peak_last,
                "breaker_trips": self._breaker_trips,
            }

    def reset_for_tests(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._rows_total = 0
            self._operator_ms.clear()
            self._peak_hwm = 0
            self._peak_last = 0
            self._breaker_trips = 0


# engine-less callers record here; Engine-owned queries record into
# engine.esql_recorder, so two engines in one process never mix their
# query streams
_default_recorder = EsqlRecorder()


def default_recorder() -> EsqlRecorder:
    return _default_recorder


def recorder_for(engine) -> EsqlRecorder:
    rec = getattr(engine, "esql_recorder", None)
    return rec if rec is not None else _default_recorder
