"""Telemetry: the metrics registry, per-request profile events and kernel
timing windows.

The part of the JAX package's `telemetry.py` that the execution planner
and its callers use:

- `MetricsRegistry` (the `metrics` singleton): named counters, gauges and
  exponential-bucket histograms (4 buckets per octave, the OTel
  exponential histogram with scale 2), with a snapshot;
- `collect_profile_events` / `profile_event`: a per-request collector that
  dispatch sites append events to while it is active;
- `time_kernel`: the wall time of one device dispatch, its cost-model
  utilization (`monitoring.costmodel`) and the execution planner's
  efficiency feed (`planner.ExecutionPlanner.observe`).

PyTorch returns before the card finishes, so a window closes only after
the card's work is done: where the timed block ends in a device-to-host
copy, that copy has waited for the stream; otherwise the caller passes
`sync=True` and the window calls `torch.cuda.synchronize(device)` on a
CUDA device. It never synchronizes on the CPU. A stage inside a path that
must not gain a synchronization (the serving wave's begin) is timed by
`device_window` instead: CUDA events around its launches, read once the
path's own copy back has waited for the stream.

Tracing spans, slow logs, deprecation warnings and hot threads are not
ported.
"""

from __future__ import annotations

import contextvars
import math
import threading
import time
from contextlib import contextmanager

# ---------------------------------------------------------------------------
# device-cost profiling ("profile": true collectors)
# ---------------------------------------------------------------------------

_profile_events: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "profile_events", default=None)


@contextmanager
def collect_profile_events():
    """Activate the per-request collector: dispatch sites append events
    while it is active. The yielded list is shared by reference."""
    events: list[dict] = []
    token = _profile_events.set(events)
    try:
        yield events
    finally:
        _profile_events.reset(token)


def profiling_active() -> bool:
    """A collector is active in this context."""
    return _profile_events.get() is not None


def profile_event(kind: str, **fields) -> None:
    """Record one profiling event (kind: kernel | tier | planner) when a
    collector is active; free otherwise."""
    bucket = _profile_events.get()
    if bucket is not None:
        bucket.append({"kind": kind, **fields})


@contextmanager
def time_kernel(name: str, device=None, *, sync: bool = False, **fields):
    """Wall-time one device dispatch (the block). Feeds the kernel's latency
    histogram and, when `monitoring.costmodel.KERNEL_COSTS` prices `name`
    from the shape fields, its FLOPs and bytes, the achieved MFU and
    bandwidth utilization, and the execution planner's efficiency EMA;
    records a profile event when a collector is active.

    device: the torch device the dispatch ran on (None: the process's
    accelerator, `costmodel.default_device_type`). Only dispatches on the
    process's accelerator feed the planner: a `device="cpu"` run on a
    machine with a card is measured against the CPU's peaks, which the
    planner's predictions (priced on the card's) cannot use.
    sync: the block does not end in a device-to-host copy, so the window
    synchronizes a CUDA device before it closes."""
    t0 = time.perf_counter()
    ok = False
    try:
        yield
        ok = True
    finally:
        if ok and sync and device is not None and device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        _account(name, device, time.perf_counter() - t0, fields)


def _account(name: str, device, sec: float, fields: dict) -> None:
    """One timed dispatch into the metrics, the planner and the collector."""
    ms = sec * 1000
    metrics.histogram_record(f"es.kernel.{name}.ms", ms)
    from .monitoring.costmodel import default_device_type, utilization

    util = utilization(name, fields, sec, device)
    if util is not None:
        if device is None or device.type == default_device_type():
            from .planner import execution_planner

            execution_planner().observe(name, fields, sec, util)
        metrics.counter_inc(f"es.kernel.{name}.flops", util["flops"])
        metrics.counter_inc(f"es.kernel.{name}.bytes", util["bytes"])
        metrics.histogram_record(f"es.kernel.{name}.mfu_pct", util["mfu"] * 100.0)
        metrics.histogram_record(f"es.kernel.{name}.bw_pct", util["bw_util"] * 100.0)
        fields = {**fields, "flops": util["flops"], "bytes": util["bytes"],
                  "mfu": round(util["mfu"], 6), "bw_util": round(util["bw_util"], 6)}
    profile_event("kernel", kernel=name, ms=round(ms, 4), **fields)


class device_window:
    """The time of the launches in a `with` block, accounted as
    `time_kernel` accounts a window but with no synchronization: on a CUDA
    device, CUDA events around the launches, read by `close()` once the
    caller's own device-to-host copy has waited for the stream; on the CPU,
    the block's wall time. A window never closed is never accounted."""

    def __init__(self, name: str, device, **fields):
        self.name, self.device, self.fields = name, device, fields
        self._events = None
        self._sec = 0.0

    def __enter__(self):
        if self.device.type == "cuda":
            import torch

            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        else:
            self._sec = time.perf_counter() - self._t0
        return False

    def close(self) -> None:
        sec = (self._sec if self._events is None
               else self._events[0].elapsed_time(self._events[1]) / 1e3)
        _account(self.name, self.device, sec, self.fields)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

# exponential histogram buckets: 4 per octave (factor 2^(1/4) ~ 1.19), so
# percentile estimates carry <~19% relative error
_HIST_SCALE = 4
_HIST_LOG_BASE = math.log(2.0) / _HIST_SCALE


def _bucket_index(value: float) -> int:
    # smallest i with 2^(i/4) >= value  (value > 0)
    return math.ceil(math.log(value) / _HIST_LOG_BASE - 1e-9)


def _bucket_upper(idx: int) -> float:
    return 2.0 ** (idx / _HIST_SCALE)


class _Histogram:
    """Exponential-bucket histogram: count/sum/min/max plus sparse bucket
    counts keyed by exponent index; <= 0 values land in a zero bucket."""

    __slots__ = ("count", "sum", "min", "max", "zero_count", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.zero_count = 0
        self.buckets: dict[int, int] = {}

    def record(self, value: float) -> None:
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if value <= 0.0:
            self.zero_count += 1
            return
        i = _bucket_index(value)
        self.buckets[i] = self.buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (0..1): the geometric midpoint of the bucket
        holding the q*count-th sample, clamped to the observed min/max."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = self.zero_count
        if rank <= seen:
            return max(self.min, 0.0) if self.zero_count else 0.0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank <= seen:
                mid = math.sqrt(_bucket_upper(i - 1) * _bucket_upper(i))
                return min(max(mid, self.min), self.max)
        return self.max

    def snapshot(self) -> dict:
        c = self.count
        return {
            "count": c,
            "sum": self.sum,
            "min": (self.min if c else 0.0),
            "max": (self.max if c else 0.0),
            "avg": (self.sum / c if c else 0.0),
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Named counters, gauges and histograms with a snapshot (reference
    behavior: telemetry/metric/MeterRegistry). Every read-modify-write holds
    the registry's lock: the REST threads, the engine worker and the
    serving threads record into one registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, object] = {}  # name -> callable or value
        self._histograms: dict[str, _Histogram] = {}

    def counter_inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value) -> None:
        """value: a number, or a zero-argument callable sampled at snapshot."""
        with self._lock:
            self._gauges[name] = value

    def histogram_record(self, name: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = _Histogram()
            h.record(value)

    def reset(self) -> None:
        """Drop every instrument."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges_raw = dict(self._gauges)
            hists = {name: h.snapshot() for name, h in self._histograms.items()}
        gauges = {}
        for name, v in gauges_raw.items():
            try:
                gauges[name] = v() if callable(v) else v
            except Exception:  # noqa: BLE001 - a failing gauge must not break stats
                gauges[name] = None
        return {"counters": counters, "gauges": gauges, "histograms": hists}


metrics = MetricsRegistry()
