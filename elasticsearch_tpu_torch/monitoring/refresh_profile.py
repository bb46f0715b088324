"""Where a refresh spends its time: the write path's stage profile.

This package's copy of the JAX package's `monitoring/refresh_profile.py`:

- `build_stage(name, device, **fields)` wraps one build stage (a
  `build.*` name) in a `telemetry.time_kernel` window (`monitoring.costmodel.KERNEL_COSTS`
  prices every `build.*` name) and, while a refresh is profiled, charges
  the stage's wall time to the active collector. On a CUDA device the
  window synchronizes before it closes, so a stage's seconds include its
  device work;
- `refresh_stage(name, device)` marks a collector-only phase (routing,
  analysis, the flat CSR, the dense tier, positions, docvalues, stacking),
  visible in the profile instead of hiding in the residual, and
  synchronizes a CUDA device on exit as `build_stage` does;
- every stage mark may carry `basis` ("host" or "device": which route ran
  it); the profile reports the basis of each stage that set one;
- a `RefreshProfile` cuts its stage times from ONE sequence of boundary
  timestamps, so they sum to the refresh's wall time by construction. It
  carries the docs processed, the kind (full, incremental, merge,
  segment_merge) and the tiers after it;
- `RefreshRecorder` is a bounded ring of them per engine (the dynamic
  setting `indexing.profile.size`), read by `GET /_refresh/profile`.

Work on another thread (the stacked build's analysis of shard k+1 while
shard k builds) is not on the flat-sum clock: the worker reports it with
`note_span`, an async span beside the main thread's stages.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from contextlib import contextmanager

# the residual: wall time inside no named stage (bookkeeping, breaker
# admission), named so an untagged loop shows up as a growing host_other
OTHER_STAGE = "host_other"


class StageCollector:
    """Flat-sum stage clock: each stage enter and exit cuts the clock at one
    timestamp and charges the segment to the stage on top of the stack, so
    sum(stages) == wall exactly (before rounding)."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._stack: list[str] = [OTHER_STAGE]
        self.stages: dict[str, float] = {}  # name -> seconds
        self.bases: dict[str, str] = {}  # name -> "host" | "device" | "mixed"
        # (name, start_s, end_s) relative to t0: the main thread's stage
        # windows, and the worker spans reported through note_span
        self.events: list[tuple[str, float, float]] = []
        self.async_events: list[tuple[str, float, float]] = []
        # seconds of worker-thread work per stage, outside `stages`
        self.async_stages: dict[str, float] = {}
        self._elock = threading.Lock()

    def _cut(self) -> None:
        now = time.perf_counter()
        name = self._stack[-1]
        self.stages[name] = self.stages.get(name, 0.0) + (now - self._last)
        self._last = now

    def note_basis(self, name: str, basis: str) -> None:
        with self._elock:
            prev = self.bases.get(name)
            self.bases[name] = basis if prev in (None, basis) else "mixed"

    @contextmanager
    def stage(self, name: str, basis: str | None = None):
        self._cut()
        t_en = self._last
        self._stack.append(name)
        if basis is not None:
            self.note_basis(name, basis)
        try:
            yield
        finally:
            self._cut()
            self._stack.pop()
            with self._elock:
                self.events.append((name, t_en - self._t0, self._last - self._t0))

    def note_span(self, name: str, t_start: float, t_end: float) -> None:
        """Record work done on another thread (perf_counter timestamps): an
        event span and an async stage charge. Thread-safe; never touches the
        flat-sum clock."""
        with self._elock:
            self.async_events.append((name, t_start - self._t0, t_end - self._t0))
            self.async_stages[name] = self.async_stages.get(name, 0.0) + (t_end - t_start)

    def finish(self) -> tuple[float, dict[str, float]]:
        """-> (wall seconds, {stage: seconds}); wall is the last boundary
        minus the first, i.e. exactly the stage sum."""
        self._cut()
        return self._last - self._t0, dict(self.stages)


_collector: contextvars.ContextVar[StageCollector | None] = contextvars.ContextVar(
    "refresh_stage_collector", default=None)


def active_collector() -> StageCollector | None:
    """The collector of the refresh profiled on this thread, if any (a new
    thread's context sees None: workers report through note_span)."""
    return _collector.get()


@contextmanager
def collect_build_stages():
    """Activate a StageCollector for one refresh or build; stage marks inside
    charge to it. Yields the collector."""
    c = StageCollector()
    token = _collector.set(c)
    try:
        yield c
    finally:
        _collector.reset(token)


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


@contextmanager
def refresh_stage(name: str, device=None, basis: str | None = None):
    """A collector-only stage mark; on a CUDA `device` the stage synchronizes
    before it closes, so its seconds include its device work."""
    c = _collector.get()
    if c is None:
        yield
        _sync(device)
        return
    with c.stage(name, basis):
        yield
        _sync(device)


@contextmanager
def build_stage(name: str, device=None, **fields):
    """One build stage: a `telemetry.time_kernel(name, device, sync=True)`
    window (the name must have a KERNEL_COSTS entry), plus a collector
    charge while a refresh is profiled. `fields` are the cost model's shape
    fields and `basis`."""
    from ..telemetry import time_kernel

    c = _collector.get()
    if c is None:
        with time_kernel(name, device, sync=True, **fields):
            yield
        return
    with c.stage(name, fields.get("basis")):
        with time_kernel(name, device, sync=True, **fields):
            yield


# ---------------------------------------------------------------------------
# the per-refresh record and its bounded ring
# ---------------------------------------------------------------------------

def _iso_utc(ts: float | None = None) -> str:
    t = time.time() if ts is None else ts
    ms = int(t * 1000) % 1000
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + f".{ms:03d}Z"


class RefreshRecorder:
    """Bounded ring of RefreshProfile records, with the cumulative counts by
    kind, per-stage milliseconds and a docs/s ingest EMA."""

    EMA_ALPHA = 0.3

    def __init__(self, size: int = 256):
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=max(int(size), 1))
        self._seq = 0
        self._counts: dict[str, int] = {}
        self._stage_ms: dict[str, float] = {}
        self._docs_total = 0
        self._last_record_t: float | None = None
        self._docs_per_s_ema: float | None = None
        self._last_tail_fraction = 0.0

    def set_size(self, size) -> None:
        size = max(int(size), 1)
        with self._lock:
            if size != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=size)

    def record(self, profile: dict) -> dict:
        """Append one finished RefreshProfile; -> it with its sequence
        number."""
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            profile = {"refresh": self._seq, **profile}
            self._ring.append(profile)
            kind = profile.get("kind", "full")
            self._counts[kind] = self._counts.get(kind, 0) + 1
            for key in ("stages_ms", "async_stages_ms"):
                for stage, ms in (profile.get(key) or {}).items():
                    self._stage_ms[stage] = self._stage_ms.get(stage, 0.0) + ms
            docs = int(profile.get("docs", 0))
            self._docs_total += docs
            if profile.get("tail_fraction") is not None:
                self._last_tail_fraction = profile["tail_fraction"]
            if self._last_record_t is not None and docs:
                rate = docs / max(now - self._last_record_t, 1e-6)
                self._docs_per_s_ema = (
                    rate if self._docs_per_s_ema is None
                    else self.EMA_ALPHA * rate + (1.0 - self.EMA_ALPHA) * self._docs_per_s_ema)
            self._last_record_t = now
        from ..telemetry import metrics

        metrics.counter_inc(f"es.indexing.refresh.{kind}")
        return profile

    def profiles(self, n: int | None = None) -> dict:
        """The recorded refreshes, oldest first (GET /_refresh/profile)."""
        with self._lock:
            profs = list(self._ring)
            total = self._seq
            cap = self._ring.maxlen
        if n is not None:
            profs = profs[len(profs) - min(max(int(n), 0), len(profs)):]
        return {"capacity": cap, "recorded_total": total, "retained": len(profs),
                "profiles": profs}

    def indexing_stats(self) -> dict:
        with self._lock:
            return {
                "refresh_total": sum(self._counts.values()),
                "refresh_kinds": dict(self._counts),
                "merge_total": self._counts.get("merge", 0) + self._counts.get("segment_merge", 0),
                "stage_ms": {k: round(v, 3) for k, v in sorted(self._stage_ms.items())},
                "docs_refreshed_total": self._docs_total,
                "docs_per_s_ema": (round(self._docs_per_s_ema, 3)
                                   if self._docs_per_s_ema is not None else None),
                "tail_fraction": self._last_tail_fraction,
            }


# an EsIndex outside an Engine records here; an Engine's indices record into
# the engine's own ring
_default_recorder = RefreshRecorder()


def default_recorder() -> RefreshRecorder:
    return _default_recorder


def recorder_for(index) -> RefreshRecorder:
    eng = getattr(index, "engine", None)
    return eng.refresh_recorder if eng is not None else _default_recorder


def _overlap_ms(events, async_events) -> float:
    """Worker span time that ran while a main-thread stage was open (the
    main spans merged first, so nesting is not counted twice)."""
    merged: list[list[float]] = []
    for s, e in sorted((s, e) for _n, s, e in events):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    ov = 0.0
    for _n, a0, a1 in async_events:
        for m0, m1 in merged:
            ov += max(0.0, min(a1, m1) - max(a0, m0))
    return ov * 1000


@contextmanager
def profile_refresh(index, kind: str):
    """Profile one refresh or merge of `index`: activate a collector and, on
    a normal exit, record the RefreshProfile (stages sum to the wall) with
    the tiers after it. A refresh that raises records nothing."""
    with collect_build_stages() as c:
        yield c
    wall_s, stages = c.finish()
    tiers = index.tier_stats()
    if kind in ("incremental", "segment_merge"):
        docs = tiers["tail_docs"]  # the new docs, or the tails a fold repacks
    else:  # a full rebuild or a major merge packs every visible doc
        docs = tiers["base_docs"] + tiers["tail_docs"]
    with c._elock:
        events = list(c.events)
        async_events = list(c.async_events)
        async_stages = dict(c.async_stages)
        bases = dict(c.bases)
    profile = {
        "@timestamp": _iso_utc(),
        "index": index.name,
        "kind": kind,
        "docs": int(docs),
        "bytes": int(getattr(index, "_base_nbytes", 0)),
        "stages_ms": {k: round(v * 1000, 4) for k, v in stages.items()},
        "wall_ms": round(wall_s * 1000, 4),
        "basis": bases,
        "tail_fraction": tiers["tail_fraction"],
        "tiers": {"base_docs": tiers["base_docs"], "tail_docs": tiers["tail_docs"],
                  "segments": tiers.get("segments", 0)},
        "stage_events_ms": (
            [[n, round(s * 1000, 3), round(e * 1000, 3), "main"] for n, s, e in events]
            + [[n, round(s * 1000, 3), round(e * 1000, 3), "worker"]
               for n, s, e in async_events]),
    }
    if async_stages:
        profile["async_stages_ms"] = {k: round(v * 1000, 4) for k, v in async_stages.items()}
        profile["analyze_overlap_ms"] = round(_overlap_ms(events, async_events), 4)
    recorder_for(index).record(profile)
