"""Pipeline aggregations: post-reduction transforms over finalized buckets.

This package's copy of the JAX package's `aggs/pipeline.py` (host-side
Python and numpy; `bucket_script` / `bucket_selector` evaluate through this
package's `script.expression`).

The reference evaluates pipeline aggs at coordinator reduce time over the
already-reduced bucket tree (reference behavior:
search/aggregations/pipeline/*, e.g. AvgBucketPipelineAggregator,
DerivativePipelineAggregator, BucketScriptPipelineAggregator; sibling vs
parent placement rules in PipelineAggregationBuilder). Identical placement
here: these run host-side on the finalized aggregation dicts, after the
device scan + shard merge.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from ..utils.errors import IllegalArgumentError

SIBLING_TYPES = {
    "avg_bucket", "sum_bucket", "min_bucket", "max_bucket", "stats_bucket",
    "extended_stats_bucket", "percentiles_bucket",
}
PARENT_TYPES = {
    "derivative", "cumulative_sum", "bucket_script", "bucket_selector",
    "bucket_sort", "serial_diff", "moving_fn",
}
PIPELINE_TYPES = SIBLING_TYPES | PARENT_TYPES


def _spec_type(spec: dict) -> str | None:
    for k in spec:
        if k not in ("aggs", "aggregations", "meta"):
            return k
    return None


def strip_pipeline_aggs(aggs: dict | None) -> tuple[dict | None, bool]:
    """Remove pipeline-agg specs (they are host-side) from the request tree
    before device compilation. Returns (cleaned, had_any)."""
    if not aggs:
        return aggs, False
    out = {}
    had = False
    for name, spec in aggs.items():
        t = _spec_type(spec)
        if t in PIPELINE_TYPES:
            had = True
            continue
        sub = spec.get("aggs") or spec.get("aggregations")
        if sub:
            cleaned, sub_had = strip_pipeline_aggs(sub)
            had = had or sub_had
            spec = {k: v for k, v in spec.items() if k not in ("aggs", "aggregations")}
            if cleaned:
                spec["aggs"] = cleaned
        out[name] = spec
    return out, had


def _bucket_value(bucket: dict, path: str):
    """Resolve 'metric', 'stats.avg', or '_count' within one bucket."""
    if path == "_count":
        return bucket.get("doc_count")
    cur: Any = bucket
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, dict):
        cur = cur.get("value")
    return cur


def _series(buckets: list[dict], path: str, gap_policy: str):
    vals = []
    for b in buckets:
        v = _bucket_value(b, path)
        if v is None:
            v = 0.0 if gap_policy == "insert_zeros" else None
        vals.append(v)
    return vals


def _buckets_of(result: dict):
    """-> ([(key_or_None, bucket)], keyed). Keyed form (filters agg with
    keyed buckets) keeps the user's bucket names attached so filtering and
    sorting pipelines preserve them."""
    b = result.get("buckets")
    if isinstance(b, dict):  # keyed filters agg
        return list(b.items()), True
    if b is None:
        return None, False
    return [(None, x) for x in b], False


def apply_pipeline_aggs(request: dict | None, results: dict | None):
    """Walk the ORIGINAL aggs request tree alongside the finalized results,
    computing parent pipelines inside multi-bucket aggs and sibling pipelines
    at each level. Mutates `results` in place."""
    if not request or results is None:
        return
    # recurse into real aggs first (deepest pipelines see final values)
    for name, spec in request.items():
        t = _spec_type(spec)
        if t in PIPELINE_TYPES:
            continue
        sub = spec.get("aggs") or spec.get("aggregations")
        if not sub or name not in results:
            continue
        res = results[name]
        items, _ = _buckets_of(res)
        if items is not None:
            for _, b in items:
                apply_pipeline_aggs(sub, b)
            _apply_parent_pipelines(sub, res)
        else:
            # single-bucket agg (filter/global/missing): its sub-agg results
            # sit directly on the result dict
            apply_pipeline_aggs(sub, res)
    # sibling pipelines at this level
    for name, spec in request.items():
        t = _spec_type(spec)
        if t in SIBLING_TYPES:
            results[name] = _compute_sibling(t, spec[t], results)


def _apply_parent_pipelines(sub_request: dict, parent_result: dict):
    items, keyed = _buckets_of(parent_result)
    if items is None:
        return
    for name, spec in sub_request.items():
        t = _spec_type(spec)
        if t not in PARENT_TYPES:
            continue
        body = spec[t]
        gap = body.get("gap_policy", "skip")
        if t == "bucket_sort":
            _bucket_sort(parent_result, body)
            items, keyed = _buckets_of(parent_result)
            continue
        if t == "bucket_selector":
            keep = []
            for kb in items:
                v = _eval_bucket_script(body, kb[1], gap)
                if v is not None and bool(v):
                    keep.append(kb)
            _set_buckets(parent_result, keep, keyed)
            items = keep
            continue
        if t == "bucket_script":
            for _, b in items:
                v = _eval_bucket_script(body, b, gap)
                if v is not None:
                    b[name] = {"value": float(v)}
            continue
        path = (body.get("buckets_path") or "_count")
        buckets = [b for _, b in items]
        series = _series(buckets, path, gap)
        if t == "cumulative_sum":
            total = 0.0
            for b, v in zip(buckets, series):
                total += v or 0.0
                b[name] = {"value": total}
        elif t == "derivative":
            prev = None
            for b, v in zip(buckets, series):
                if prev is not None and v is not None:
                    b[name] = {"value": v - prev}
                if v is not None:
                    prev = v
        elif t == "serial_diff":
            lag = int(body.get("lag", 1))
            for i, b in enumerate(buckets):
                if i >= lag and series[i] is not None and series[i - lag] is not None:
                    b[name] = {"value": series[i] - series[i - lag]}
        elif t == "moving_fn":
            # window covers the `window` buckets BEFORE the current one at
            # shift=0 (reference behavior: MovFnPipelineAggregator — shift
            # moves the window right, shift=window/2 centers it)
            window = int(body.get("window", 1))
            shift = int(body.get("shift", 0))
            for i, b in enumerate(buckets):
                lo = i - window + shift
                hi = i + shift
                win = [v for v in series[max(lo, 0):max(hi, 0)] if v is not None]
                b[name] = {"value": float(np.mean(win)) if win else None}


def _set_buckets(parent_result: dict, items: list, keyed: bool):
    if keyed:
        parent_result["buckets"] = {k: b for k, b in items}
    else:
        parent_result["buckets"] = [b for _, b in items]


def _bucket_sort(parent_result: dict, body: dict):
    items, keyed = _buckets_of(parent_result)
    sort_specs = body.get("sort") or []
    from_ = int(body.get("from", 0))
    size = body.get("size")

    def norm(s):
        if isinstance(s, str):
            return s, "asc"
        (path, conf), = s.items()
        order = conf.get("order", "asc") if isinstance(conf, dict) else conf
        return path, order

    specs = [norm(s) for s in sort_specs]

    def sort_key(kb):
        out = []
        for path, order in specs:
            v = _bucket_value(kb[1], path)
            v = float("-inf") if v is None else v
            out.append(-v if order == "desc" else v)
        return out

    if specs:
        items = sorted(items, key=sort_key)
    end = from_ + int(size) if size is not None else None
    items = items[from_:end]
    _set_buckets(parent_result, items, keyed)


def _eval_bucket_script(body: dict, bucket: dict, gap: str):
    from ..script.expression import compile_script

    paths = body.get("buckets_path") or {}
    if not isinstance(paths, dict):
        raise IllegalArgumentError("[buckets_path] must be an object for bucket_script")
    script = body.get("script")
    src = script.get("source") if isinstance(script, dict) else script
    env = {}
    for var, path in paths.items():
        v = _bucket_value(bucket, path)
        if v is None:
            if gap == "insert_zeros":
                v = 0.0
            else:
                return None
        env[var] = v
    cs = compile_script({"source": src, "params": env})
    # vars are also usable bare; bind them as 0-d arrays
    arr_env = {k: np.float32(v) for k, v in env.items()}
    try:
        out = cs.evaluate(arr_env)
    except Exception as ex:
        raise IllegalArgumentError(f"bucket_script failed: {ex}")
    return float(np.asarray(out))


def _compute_sibling(t: str, body: dict, results: dict):
    path = body.get("buckets_path")
    if not isinstance(path, str) or ">" not in path and path not in results:
        raise IllegalArgumentError(f"[buckets_path] invalid for [{t}]: {path!r}")
    first, _, rest = path.partition(">")
    target = results.get(first)
    if target is None:
        raise IllegalArgumentError(f"No aggregation found for path [{path}]")
    items, _ = _buckets_of(target)
    if items is None:
        raise IllegalArgumentError(f"[{first}] is not a multi-bucket aggregation")
    gap = body.get("gap_policy", "skip")
    buckets = [b for _, b in items]
    series = [v for v in _series(buckets, rest or "_count", gap) if v is not None]
    if t == "avg_bucket":
        return {"value": float(np.mean(series)) if series else None}
    if t == "sum_bucket":
        return {"value": float(np.sum(series)) if series else 0.0}
    if t == "min_bucket":
        return {"value": float(np.min(series)) if series else None}
    if t == "max_bucket":
        return {"value": float(np.max(series)) if series else None}
    if t == "stats_bucket":
        if not series:
            return {"count": 0, "min": None, "max": None, "avg": None, "sum": 0.0}
        return {
            "count": len(series),
            "min": float(np.min(series)),
            "max": float(np.max(series)),
            "avg": float(np.mean(series)),
            "sum": float(np.sum(series)),
        }
    if t == "extended_stats_bucket":
        if not series:
            return {"count": 0}
        a = np.asarray(series, np.float64)
        var = float(a.var())
        sigma = float(body.get("sigma", 2.0))
        avg = float(a.mean())
        std = math.sqrt(var)
        return {
            "count": len(series), "min": float(a.min()), "max": float(a.max()),
            "avg": avg, "sum": float(a.sum()),
            "sum_of_squares": float((a * a).sum()),
            "variance": var, "std_deviation": std,
            "std_deviation_bounds": {"upper": avg + sigma * std,
                                     "lower": avg - sigma * std},
        }
    if t == "percentiles_bucket":
        pcts = body.get("percents") or [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0]
        if not series:
            return {"values": {str(p): None for p in pcts}}
        a = np.asarray(series, np.float64)
        return {"values": {
            ("%g" % p if float(p) != int(p) else "%.1f" % p):
                float(np.percentile(a, p)) for p in pcts
        }}
    raise IllegalArgumentError(f"unknown pipeline aggregation [{t}]")
