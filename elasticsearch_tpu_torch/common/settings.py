"""Typed, dynamically updatable cluster settings: the ones the port reads.

A copy of the JAX package's `common/settings.py` (reference behavior:
common/settings/Setting.java typed parsers and validators,
ClusterSettings.java registry, update consumers, persistent vs transient),
cut to the settings the REST layer, the serving front end, the circuit
breakers and the execution planner read. A setting the reference knows but the port does not read
yet is refused with a 400 "not yet ported"; an unknown one is refused as
the reference refuses it. Settings live in memory only (the port has no
data path).
"""

from __future__ import annotations

import re
from typing import Callable

from ..utils.durations import parse_duration_seconds
from ..utils.errors import IllegalArgumentError, not_yet_ported

_SIZE_RE = re.compile(r"^(\d+(?:\.\d+)?)\s*(b|kb|mb|gb|tb|pb|%)?$", re.I)
_SIZE_MULT = {"b": 1, "kb": 1 << 10, "mb": 1 << 20, "gb": 1 << 30,
              "tb": 1 << 40, "pb": 1 << 50}

# cluster settings of the reference that no port module reads yet
NOT_YET_PORTED = frozenset({
    "cluster.name", "indices.requests.cache.enable", "indices.requests.cache.size",
    "search.default_allow_partial_results", "search.max_buckets",
    "action.auto_create_index", "cluster.max_shards_per_node", "logger.*",
    "xpack.security.enabled", "xpack.ml.enabled", "xpack.ml.max_open_jobs",
    "xpack.ml.state_repository_path", "indices.breaker.model_inference.limit",
    "cluster.remote.*",
    "xpack.monitoring.collection.enabled", "xpack.monitoring.collection.interval",
    "xpack.monitoring.history.duration", "xpack.watcher.enabled",
    "xpack.watcher.tick.interval", "slo.enabled", "slo.search.p99_ms",
    "slo.shard.p99_ms", "slo.kernel.floors", "slo.kernel.min_calls",
    "slo.serving.queue_fraction", "slo.serving.shed_rate", "slo.breaker.trip_budget",
    "slo.hbm.headroom_fraction", "slo.write.tail_fraction", "slo.write.refresh_lag_ms",
    "slo.write.analyze_fraction", "slo.planner.residual",
    "slo.tenant.queue_p99_ms", "slo.tenant.shed_rate", "slo.esql.p99_ms",
    "slo.esql.peak_bytes", "slo.custom", "planner.cache.min_recompute_us",
    "serving.flight_recorder.size",
    "xpack.profiling.enabled", "xpack.profiling.trace_dir",
    "xpack.profiling.max_duration", "xpack.profiling.retention",
})


def parse_bytes(v, total_for_percent: int | None = None) -> int:
    """'512mb', '85%', 1024 -> bytes (reference: ByteSizeValue +
    MemorySizeValue percentage parsing)."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return int(v)
    m = _SIZE_RE.match(str(v).strip())
    if not m:
        raise IllegalArgumentError(f"failed to parse byte size [{v}]")
    num, unit = float(m.group(1)), (m.group(2) or "b").lower()
    if unit == "%":
        if total_for_percent is None:
            raise IllegalArgumentError(f"percentage not allowed here [{v}]")
        return int(total_for_percent * num / 100.0)
    return int(num * _SIZE_MULT[unit])


class Setting:
    """One typed setting: key, default, parser, dynamic flag, validator."""

    def __init__(self, key: str, default, parser: Callable = str, *,
                 dynamic: bool = False, validator: Callable | None = None):
        self.key = key
        self.default = default
        self.parser = parser
        self.dynamic = dynamic
        self.validator = validator

    def parse(self, raw):
        try:
            v = self.parser(raw)
        except IllegalArgumentError:
            raise
        except Exception as ex:
            raise IllegalArgumentError(
                f"failed to parse value [{raw}] for setting [{self.key}]: {ex}")
        if self.validator is not None:
            self.validator(v)
        return v

    @staticmethod
    def bool_(raw):
        if isinstance(raw, bool):
            return raw
        if str(raw).lower() in ("true", "1"):
            return True
        if str(raw).lower() in ("false", "0"):
            return False
        raise IllegalArgumentError(f"cannot parse boolean [{raw}]")

    @staticmethod
    def float_(raw):
        return float(raw)

    @staticmethod
    def positive_int(raw):
        v = int(raw)
        if v < 0:
            raise IllegalArgumentError(f"must be >= 0, got [{raw}]")
        return v


def _validate_duration(v):
    parse_duration_seconds(v, None)  # raises IllegalArgumentError when bad


def _validate_bytes(v):
    parse_bytes(v, 1)  # a size or a percentage


def default_cluster_settings() -> list[Setting]:
    """The reference's defaults and validation of the settings read here."""
    return [
        Setting("indices.breaker.total.limit", "95%", str, dynamic=True,
                validator=_validate_bytes),
        Setting("indices.breaker.fielddata.limit", "40%", str, dynamic=True,
                validator=_validate_bytes),
        Setting("indices.breaker.request.limit", "60%", str, dynamic=True,
                validator=_validate_bytes),
        Setting("indices.breaker.esql.materialization.limit", "40%", str, dynamic=True,
                validator=_validate_bytes),
        Setting("search.default_search_timeout", "-1", str, dynamic=True,
                validator=_validate_duration),
        Setting("serving.enabled", False, Setting.bool_, dynamic=True),
        Setting("serving.max_wave", 256, Setting.positive_int, dynamic=True),
        Setting("serving.coalesce.max_wait", "2ms", str, dynamic=True,
                validator=_validate_duration),
        Setting("serving.queue.max_depth", 1000, Setting.positive_int, dynamic=True),
        # "tenantA:4,tenantB:1" (X-Opaque-Id is the tenant; unlisted weigh 1)
        Setting("serving.tenant.weights", "", str, dynamic=True),
        # the tail-segment bound: past it, an incremental refresh folds the
        # segments into one (the Lucene merge policy's analog)
        Setting("indexing.tiers.max_segments", 4, Setting.positive_int, dynamic=True),
        # records kept by each engine's RefreshProfile ring
        Setting("indexing.profile.size", 256, Setting.positive_int, dynamic=True),
        # the execution planner (planner/): arm choice by predicted wall
        # (cost model over measured efficiency EMAs); knn.target_ms > 0
        # lets it set nprobe to the largest value meeting the target
        Setting("planner.enabled", True, Setting.bool_, dynamic=True),
        Setting("planner.ema.alpha", 0.2, Setting.float_, dynamic=True),
        Setting("planner.knn.target_ms", 0.0, Setting.float_, dynamic=True),
        # tenancy: the superpack lane and its size bound, the meter's ledger
        # rows, the `_merge` tenant's weight, and the fair-share weights fed
        # by each tenant's device-ms/s burn against its budget (0: off)
        Setting("superpack.enabled", False, Setting.bool_, dynamic=True),
        Setting("superpack.max_docs", 8192, Setting.positive_int, dynamic=True),
        Setting("metering.tenant.top_k", 16, Setting.positive_int, dynamic=True),
        Setting("serving.merge.weight", 1.0, Setting.float_, dynamic=True),
        Setting("planner.tenant.fairshare", False, Setting.bool_, dynamic=True),
        Setting("planner.tenant.fairshare.min_factor", 0.25, Setting.float_, dynamic=True),
        Setting("slo.tenant.device_ms_per_s", 0.0, Setting.float_, dynamic=True),
    ]


class ClusterSettings:
    """Registry, live values and update consumers. `update({persistent:
    {...}, transient: {...}})` validates every key first, then applies them
    and notifies the consumers: one bad key rejects the whole request (the
    reference applies settings as one cluster-state update)."""

    def __init__(self, registry: list[Setting]):
        self.registry = {s.key: s for s in registry}
        self.persistent: dict = {}
        self.transient: dict = {}
        self._consumers: dict[str, list[Callable]] = {}

    def _lookup(self, key: str) -> Setting:
        s = self.registry.get(key)
        if s is not None:
            return s
        if key in NOT_YET_PORTED or any(
                p.endswith(".*") and key.startswith(p[:-1]) for p in NOT_YET_PORTED):
            raise not_yet_ported(f"setting [{key}]")
        raise IllegalArgumentError(f"transient setting [{key}], not recognized")

    def get(self, key: str):
        if key in self.transient:
            return self._lookup(key).parse(self.transient[key])
        if key in self.persistent:
            return self._lookup(key).parse(self.persistent[key])
        s = self.registry.get(key)
        if s is None:
            raise IllegalArgumentError(f"setting [{key}] not recognized")
        return s.default

    def add_consumer(self, key: str, fn: Callable):
        self._consumers.setdefault(key, []).append(fn)

    def update(self, body: dict) -> dict:
        changes = []
        for scope in ("persistent", "transient"):
            for key, raw in (body.get(scope) or {}).items():
                s = self._lookup(key)
                if raw is not None:
                    if not s.dynamic:
                        raise IllegalArgumentError(
                            f"final cluster setting [{key}], not updateable")
                    s.parse(raw)  # validate before applying anything
                changes.append((scope, key, raw))
        for scope, key, raw in changes:
            store = self.persistent if scope == "persistent" else self.transient
            if raw is None:
                store.pop(key, None)
            else:
                store[key] = raw
            for fn in self._consumers.get(key, []):
                fn(self.get(key) if raw is not None else self._lookup(key).default)
        return {"acknowledged": True, "persistent": dict(self.persistent),
                "transient": dict(self.transient)}
