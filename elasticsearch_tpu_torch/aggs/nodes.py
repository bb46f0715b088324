"""Aggregation framework: masked, segmented columnar scans in PyTorch.

This package's copy of the JAX package's `aggs/nodes.py`. The reference
evaluates aggregations as a per-doc collector tree over DocValues
(reference behavior: search/aggregations/AggregatorBase.java,
bucket/terms/GlobalOrdinalsStringTermsAggregator.java,
bucket/histogram/DateHistogramAggregator.java); here every aggregation is
a vectorized scan over whole columns, filtered by the query's dense match
mask.

Uniform segmented protocol: every node evaluates under a parent
segmentation, and nesting is multiplicative composition, so one code path
serves top-level and nested aggs:

    device_eval_segmented(dev, params, seg[N] int64, nseg, valid[N], ctx)

`seg[i]` in [0, nseg) is doc i's parent bucket, `valid` its liveness under
the query and the parent. A bucket agg computes its own per-doc bucket `b`
in [0, nb) and recurses with seg' = seg * nb + b, nseg' = nseg * nb. Metric
aggs are segmented reductions keyed by seg. The total segment product is
bounded (ES's search.max_buckets guard, reference behavior:
MultiBucketConsumerService): the limits below are the JAX package's, so
the same requests answer the same 400s.

Bucket counts come from the pack on the host (the vocabulary size for
terms, the column's min/max over the interval for histograms), as there;
empty buckets are trimmed on the host in `finalize`.

The segmented reductions (`_seg_scatter`) keep every result independent of
the order in which the card adds:
  - integer sums (counts, the exact long halves) and min/max run as
    `index_add_` / `scatter_reduce_`, whose integer or extreme results do
    not depend on order;
  - float sums never use float atomics (`ops.scoring.segment_sum_f32`):
    the values are sorted by segment (a stable sort), cast to f64, each
    segment added by one fixed pairwise tree of elementwise adds (a
    top-level metric's one segment too), then rounded to f32 once, so the
    card and the CPU give the same bits. The JAX package sums in f32
    through a blocked one-hot product; the f64 sum is the correctly rounded
    f32 result up to ties, within the reference's f32 error of it.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np
import torch

from ..ops.datetime import millis_of_month_index, month_index_from_millis
from ..ops.scoring import segment_sum_f32
from ..utils.errors import IllegalArgumentError
from .intervals import parse_calendar_interval, parse_fixed_interval

MAX_BUCKETS = 65536
MAX_SEGMENT_PRODUCT = 1 << 21
# counting-only scans (two-pass terms pass 1) may use a larger space: one
# int32 array, no child composition
COUNT_BUDGET = 1 << 24
# vocab size above which a terms agg with sub-aggs switches to the two-pass
# candidate scheme (pass 1 counts, pass 2 children on candidates)
TWO_PASS_MIN_V = 1 << 16

_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min
_I32_MAX = 2**31 - 1


def _col_arrays(dev, fld):
    """-> (values, has, kind) from the device store, or None."""
    for kind, store in (("int", "dv_int"), ("float", "dv_float"), ("ord", "dv_ord")):
        if fld in dev[store]:
            v, h = dev[store][fld]
            return v, h, kind
    return None


def _numeric_values(dev, fld, ctx):
    got = _col_arrays(dev, fld)
    if got is None or got[2] == "ord":
        return None
    return got


def _ones(seg: torch.Tensor) -> torch.Tensor:
    return torch.ones(seg.shape, dtype=torch.int32, device=seg.device)


def _full(n, value, dtype, device) -> torch.Tensor:
    return torch.full(n if isinstance(n, tuple) else (n,), value, dtype=dtype, device=device)


class AggNode:
    """Base: named agg with children. Subclasses set their plan in
    prepare() (bucket counts, keys) and evaluate eagerly."""

    def __init__(self, name: str, children: dict[str, "AggNode"] | None = None):
        self.name = name
        self.children = children or {}

    def prepare(self, pack, mappings):
        """-> (params, key); key names the plan (the JAX package's compile
        key, kept for its shape checks)."""
        raise NotImplementedError

    def _prepare_children(self, pack, mappings):
        parts = {n: c.prepare(pack, mappings) for n, c in self.children.items()}
        params = {n: p for n, (p, _) in parts.items()}
        key = tuple((n, k) for n, (_, k) in sorted(parts.items()))
        return params, key

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        raise NotImplementedError

    def _eval_children(self, dev, params, seg, nseg, valid, ctx):
        return {
            n: c.device_eval_segmented(dev, params["children"][n], seg, nseg, valid, ctx)
            for n, c in self.children.items()
        }

    # finalize: host arrays -> list over nseg of ES-shaped fragments
    def finalize(self, out, nseg: int) -> list[dict]:
        raise NotImplementedError

    def _finalize_children(self, out, nseg) -> list[dict]:
        per_seg = [dict() for _ in range(nseg)]
        for n, c in self.children.items():
            frags = c.finalize(out["children"][n], nseg)
            for i in range(nseg):
                per_seg[i][n] = frags[i]
        return per_seg

    # ---- shard merge: host-side reduction of stacked per-shard partials ----
    # `stacked` mirrors the device output tree with a leading shard axis on
    # every array (the analog of the reference's coordinator-side
    # InternalAggregations.reduce). _MERGE_RULES maps output keys to
    # reduction ops; children recurse.

    _MERGE_RULES: dict[str, str] = {}

    def merge_partials(self, stacked: dict) -> dict:
        out = {}
        for key, rule in self._MERGE_RULES.items():
            if key not in stacked:
                continue
            arr = np.asarray(stacked[key])
            if rule == "sum":
                out[key] = arr.sum(axis=0)
            elif rule == "min":
                out[key] = arr.min(axis=0)
            elif rule == "max":
                out[key] = arr.max(axis=0)
            elif rule == "any":
                out[key] = arr.any(axis=0)
            elif rule == "concat_sorted":
                out[key] = np.sort(arr.reshape(-1))
            elif rule == "sum_exact":
                # exact-i64 partials reduce in Python ints, so the shard
                # merge cannot round what the device kept exact
                out[key] = np.array(
                    [sum(int(x) for x in arr[:, i]) for i in range(arr.shape[1])],
                    dtype=object,
                )
        if "children" in stacked:
            # a bucket agg over an absent field emits children={} (nothing
            # was evaluated); keep it empty rather than recursing
            present = stacked["children"]
            out["children"] = {
                n: c.merge_partials(present[n]) for n, c in self.children.items() if n in present
            }
        return out


# ---------------------------------------------------------------------------
# segmented reductions
# ---------------------------------------------------------------------------


def _seg_scatter(seg, nseg, valid, values, init, op):
    """Segmented reduce of values into [nseg]; invalid docs go to the dead
    slot nseg, which is dropped. op: add | min | max."""
    tgt = torch.where(valid, seg, nseg)
    init_t = _full((), init, values.dtype, values.device)
    vals = torch.where(valid, values, init_t)
    if op == "add":
        if values.dtype.is_floating_point:
            if values.shape[0] == 0:
                return _full(nseg, 0, values.dtype, values.device)
            return segment_sum_f32(tgt, vals, nseg).to(values.dtype)
        acc = torch.zeros(nseg + 1, dtype=values.dtype, device=values.device)
        return acc.index_add_(0, tgt, vals)[:nseg]
    acc = _full(nseg + 1, init, values.dtype, values.device)
    return acc.scatter_reduce_(0, tgt, vals, reduce="amin" if op == "min" else "amax",
                               include_self=True)[:nseg]


# ---- exact i64 metric path -------------------------------------------------
# `long`-mapped columns are int64 on the device; the f32 cast of the float
# path rounds values above 2^24. As in the JAX package, a sum splits
# hi = v >> 32 (arithmetic) and lo = v & 0xFFFFFFFF: each half summed per
# segment is an integer below 2^53 while the shard has <= 2^20 rows, so it
# is exact in f64; larger shards sum v itself in int64 (exact mod 2^64,
# the wrap the host oracle's int64 arithmetic has) and split after. Here
# both halves sum in int64 (`index_add_`) and convert to f64, the same
# numbers the reference's f64 sums hold. The cross-shard merge rebuilds
# with Python ints ("sum_exact").

_I64_LO_MASK = (1 << 32) - 1


def _seg_sum_long_exact(seg, nseg, ok, v):
    """-> (sum_hi [nseg] f64, sum_lo [nseg] f64): exact int64 segmented sum,
    split so that total = (int(hi) << 32) + int(lo) per segment."""
    if v.shape[0] <= (1 << 20):
        hi = _seg_scatter(seg, nseg, ok, v >> 32, 0, "add")
        lo = _seg_scatter(seg, nseg, ok, v & _I64_LO_MASK, 0, "add")
        return hi.to(torch.float64), lo.to(torch.float64)
    s = _seg_scatter(seg, nseg, ok, v, 0, "add")
    return (s >> 32).to(torch.float64), (s & _I64_LO_MASK).to(torch.float64)


def _exact_int(x) -> int:
    """Partial -> Python int. Device partials are integral f64 (< 2^53 by
    construction); merged partials are already arbitrary-precision ints."""
    return int(x)


# ---------------------------------------------------------------------------
# metric aggs
# ---------------------------------------------------------------------------


class _FieldMetricAgg(AggNode):
    def __init__(self, name, fld, children=None):
        super().__init__(name, children)
        if children:
            raise IllegalArgumentError(f"metric agg [{name}] cannot have sub-aggregations")
        self.fld = fld

    def prepare(self, pack, mappings):
        col = pack.docvalues.get(self.fld)
        kind = None if col is None else col.kind
        return {}, (type(self).__name__, self.fld, col is None, kind)


class SumAgg(_FieldMetricAgg):
    _MERGE_RULES = {"sum": "sum", "count": "sum",
                    "sum_hi": "sum_exact", "sum_lo": "sum_exact"}

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = _numeric_values(dev, self.fld, ctx)
        if got is None:
            return {"sum": _full(nseg, 0, torch.float32, seg.device),
                    "count": _full(nseg, 0, torch.int32, seg.device)}
        v, h, kind = got
        ok = valid & h
        count = _seg_scatter(seg, nseg, ok, _ones(seg), 0, "add")
        if kind == "int":
            hi, lo = _seg_sum_long_exact(seg, nseg, ok, v)
            return {"sum_hi": hi, "sum_lo": lo, "count": count}
        return {"sum": _seg_scatter(seg, nseg, ok, v.to(torch.float32), 0.0, "add"),
                "count": count}

    def _sum_of(self, out, i):
        if "sum_hi" in out:
            return (_exact_int(out["sum_hi"][i]) << 32) + _exact_int(out["sum_lo"][i])
        return float(out["sum"][i])

    def finalize(self, out, nseg):
        return [{"value": self._sum_of(out, i)} for i in range(nseg)]


class MinAgg(_FieldMetricAgg):
    op, init = "min", np.inf
    _MERGE_RULES = {"v": "min", "v_i64": "min"}

    @property
    def _i64_sentinel(self):
        return _I64_MAX if self.op == "min" else _I64_MIN

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = _numeric_values(dev, self.fld, ctx)
        if got is None:
            return {"v": _full(nseg, self.init, torch.float32, seg.device)}
        v, h, kind = got
        if kind == "int":
            # int64 end to end: no f32 rounding above 2^24 (an empty
            # segment holds the opposing int64 extreme)
            return {"v_i64": _seg_scatter(seg, nseg, valid & h, v, self._i64_sentinel,
                                          self.op)}
        return {"v": _seg_scatter(seg, nseg, valid & h, v.to(torch.float32), self.init,
                                  self.op)}

    def finalize(self, out, nseg):
        res = []
        for i in range(nseg):
            if "v_i64" in out:
                x = int(out["v_i64"][i])
                res.append({"value": None if x == self._i64_sentinel else x})
                continue
            x = float(out["v"][i])
            res.append({"value": None if not np.isfinite(x) else x})
        return res


class MaxAgg(MinAgg):
    op, init = "max", -np.inf
    _MERGE_RULES = {"v": "max", "v_i64": "max"}


class ValueCountAgg(_FieldMetricAgg):
    _MERGE_RULES = {"count": "sum"}

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = _col_arrays(dev, self.fld)
        if got is None:
            return {"count": _full(nseg, 0, torch.int32, seg.device)}
        _, h, _ = got
        return {"count": _seg_scatter(seg, nseg, valid & h, _ones(seg), 0, "add")}

    def finalize(self, out, nseg):
        return [{"value": int(out["count"][i])} for i in range(nseg)]


class AvgAgg(SumAgg):
    def finalize(self, out, nseg):
        res = []
        for i in range(nseg):
            c = int(out["count"][i])
            # exact-i64 sums divide as Python int / int: the correctly
            # rounded double
            res.append({"value": self._sum_of(out, i) / c if c else None})
        return res


class StatsAgg(_FieldMetricAgg):
    _MERGE_RULES = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = _numeric_values(dev, self.fld, ctx)
        if got is None:
            z = _full(nseg, 0, torch.float32, seg.device)
            return {"sum": z, "count": _full(nseg, 0, torch.int32, seg.device),
                    "min": z + np.inf, "max": z - np.inf}
        v, h, kind = got
        ok = valid & h
        vf = v.to(torch.float32)
        return {
            "sum": _seg_scatter(seg, nseg, ok, vf, 0.0, "add"),
            "count": _seg_scatter(seg, nseg, ok, _ones(seg), 0, "add"),
            "min": _seg_scatter(seg, nseg, ok, vf, np.inf, "min"),
            "max": _seg_scatter(seg, nseg, ok, vf, -np.inf, "max"),
        }

    def finalize(self, out, nseg):
        res = []
        for i in range(nseg):
            c = int(out["count"][i])
            s = float(out["sum"][i])
            res.append({
                "count": c,
                "min": float(out["min"][i]) if c else None,
                "max": float(out["max"][i]) if c else None,
                "avg": s / c if c else None,
                "sum": s,
            })
        return res


class CardinalityAgg(_FieldMetricAgg):
    """Exact distinct count over the column's ordinal space (the reference
    uses approximate HLL, search/aggregations/metrics/CardinalityAggregator;
    exact here, as in the JAX package)."""

    _MERGE_RULES = {"present": "any"}

    def prepare(self, pack, mappings):
        col = pack.docvalues.get(self.fld)
        V = 0
        if col is not None:
            if col.kind == "ord":
                V = len(col.ord_terms or [])
            elif col.uniq_values is not None:
                V = len(col.uniq_values)
            elif col.kind == "float":
                raise IllegalArgumentError(
                    f"cardinality agg on float field [{self.fld}] is not supported")
        self.V = V
        return {}, ("card", self.fld, V)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        V = self.V
        if V == 0:
            if ctx.sharded:
                return {"present": _full((nseg, 1), False, torch.bool, seg.device)}
            return {"card": _full(nseg, 0, torch.int32, seg.device)}
        if nseg * V > MAX_SEGMENT_PRODUCT:
            raise IllegalArgumentError(
                f"cardinality[{self.fld}] under {nseg} buckets exceeds bucket budget")
        ords, h = _ordinal_column(dev, self.fld)
        ok = valid & h & (ords >= 0)
        flat = torch.where(ok, seg * V + ords, nseg * V)
        present = torch.zeros(nseg * V + 1, dtype=torch.bool, device=seg.device)
        present[flat] = True
        present = present[: nseg * V].reshape(nseg, V)
        if ctx.sharded:
            # a bitmap (not a count), so shard partials union with OR; with
            # shared global ordinals the union is exact across shards
            return {"present": present}
        return {"card": present.sum(dim=1, dtype=torch.int32)}

    def finalize(self, out, nseg):
        if "card" in out:
            card = np.asarray(out["card"])
        else:
            card = np.asarray(out["present"]).sum(axis=1)
        return [{"value": int(card[i])} for i in range(nseg)]


def _pct_key(p: float) -> str:
    return f"{p:g}" if p != int(p) else f"{p:.1f}"


class PercentilesAgg(_FieldMetricAgg):
    """Exact percentiles by a device sort (the reference uses t-digest
    sketches; exact here, as in the JAX package). Top level only."""

    DEFAULT_PCTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)
    _MERGE_RULES = {"sorted": "concat_sorted", "n": "sum"}

    def __init__(self, name, fld, percents=None, children=None):
        super().__init__(name, fld, children)
        self.percents = tuple(percents) if percents else self.DEFAULT_PCTS

    def prepare(self, pack, mappings):
        col = pack.docvalues.get(self.fld)
        return {}, ("pct", self.fld, self.percents, col is None)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        if nseg != 1:
            raise IllegalArgumentError("percentiles under bucket aggs is not yet supported")
        device = seg.device
        got = _numeric_values(dev, self.fld, ctx)
        if got is None:
            if ctx.sharded:
                return {"sorted": _full(1, np.inf, torch.float32, device),
                        "n": _full((), 0, torch.int32, device)}
            return {"q": _full(len(self.percents), np.nan, torch.float32, device),
                    "n": _full((), 0, torch.int32, device)}
        v, h, kind = got
        ok = valid & h
        n = ok.sum().to(torch.int32)
        # invalid slots float to the tail as +inf
        s = torch.sort(torch.where(ok, v.to(torch.float32), np.inf), stable=True).values
        if ctx.sharded:
            # per-shard sorted partials merge by concatenation + resort
            return {"sorted": s, "n": n}
        # one shard: interpolate on the device, ship len(percents) floats
        qs = []
        for p in self.percents:
            pos = torch.clamp(n - 1, min=0).to(torch.float32) * (p / 100.0)
            lo = torch.floor(pos).to(torch.int64)
            hi = torch.ceil(pos).to(torch.int64)
            frac = pos - lo.to(torch.float32)
            qs.append(s[lo] * (1 - frac) + s[hi] * frac)
        return {"q": torch.stack(qs), "n": n}

    def finalize(self, out, nseg):
        n = int(np.asarray(out["n"]))
        if "q" in out:
            qvals = np.asarray(out["q"])
            return [{"values": {_pct_key(p): (float(q) if n else None)
                                for p, q in zip(self.percents, qvals)}}]
        s = np.asarray(out["sorted"])[:n]
        return [{"values": {_pct_key(p): (float(np.percentile(s, p)) if n else None)
                            for p in self.percents}}]


# ---------------------------------------------------------------------------
# bucket aggs
# ---------------------------------------------------------------------------


def _ordinal_column(dev, fld):
    """ordinals [N] int64 (-1 missing) + has mask, for ord or int columns."""
    if fld in dev["dv_ord"]:
        v, h = dev["dv_ord"][fld]
        return v.to(torch.int64), h
    if fld in dev["dv_int_ord"]:
        return dev["dv_int_ord"][fld].to(torch.int64), dev["dv_int"][fld][1]
    return None, None


def _vocab_keys(col) -> list | None:
    """A terms source's bucket keys: a keyword's sorted terms, an int
    column's sorted unique values; None for a float column."""
    if col.kind == "ord":
        return list(col.ord_terms or [])
    if col.uniq_values is not None:
        return [int(x) for x in col.uniq_values]
    if col.kind == "float":
        return None
    return []


class TermsAgg(AggNode):
    """Terms bucketing over ordinals (reference behavior:
    GlobalOrdinalsStringTermsAggregator — ordinal counting then ordinal ->
    term resolution; default order _count desc, _key asc tiebreak, which
    top-index selection reproduces since ordinals sort lexicographically)."""

    _MERGE_RULES = {"counts": "sum"}

    def __init__(self, name, fld, size=10, order=None, children=None, missing=None):
        super().__init__(name, children)
        self.fld = fld
        self.size = size
        self.order = order or {"_count": "desc"}

    def prepare(self, pack, mappings):
        col = pack.docvalues.get(self.fld)
        self.keys: list = []
        if col is not None:
            keys = _vocab_keys(col)
            if keys is None:
                raise IllegalArgumentError(f"terms agg on float field [{self.fld}] is not supported")
            self.keys = keys
        V = len(self.keys)
        self.V = V
        # high cardinality + sub-aggs: the two-pass candidate scheme (the
        # reference's deferred "breadth first" sub-agg collection, exact
        # here since pass-1 counts are global before candidate selection)
        self.two_pass = (bool(self.children) and V > TWO_PASS_MIN_V
                         and not getattr(self, "force_single_pass", False))
        cparams, ckey = self._prepare_children(pack, mappings)
        return {"children": cparams, "cand": None}, (
            "terms", self.fld, V, self.size, self.two_pass, ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        V = self.V
        device = seg.device
        if V == 0:
            return {"counts": _full((nseg, 1), 0, torch.int32, device), "children": {}}
        cand = params.get("cand") if isinstance(params, dict) else None
        if self.two_pass and cand is None:
            # pass 1: exact counts over the full vocab, children deferred
            # until the candidate set is known
            if nseg * V > COUNT_BUDGET:
                raise IllegalArgumentError(
                    f"terms[{self.fld}]: {nseg}x{V} buckets exceeds the counting budget")
            ords, h = _ordinal_column(dev, self.fld)
            ok = valid & h & (ords >= 0)
            counts = _seg_scatter(seg * V + ords, nseg * V, ok, _ones(seg), 0,
                                  "add").reshape(nseg, V)
            return {"counts": counts, "children": {}}
        if self.two_pass:
            # pass 2: children only, over the candidate slots
            C = self._C
            if nseg * C > MAX_SEGMENT_PRODUCT:
                raise IllegalArgumentError(
                    f"terms[{self.fld}]: {nseg}x{C} candidate buckets exceeds bucket budget")
            ords, h = _ordinal_column(dev, self.fld)
            ok = valid & h & (ords >= 0)
            slots = cand[torch.where(ok, ords, 0)].to(torch.int64)
            ok2 = ok & (slots >= 0)
            sub = seg * C + torch.where(slots >= 0, slots, 0)
            return {"children": self._eval_children(
                dev, {"children": params["children"]}, sub, nseg * C, ok2, ctx)}
        if nseg * V > MAX_SEGMENT_PRODUCT:
            raise IllegalArgumentError(
                f"terms[{self.fld}]: {nseg}x{V} buckets exceeds bucket budget")
        if self.fld in dev["dv_mv"] and not self.children:
            # multi-valued keyword: one bucket entry per (doc, value) pair
            # (reference behavior: SortedSetDocValues iterate all ords).
            # Sub-aggs keep the single-value path: the per-doc segment
            # protocol cannot express multi-bucket membership
            pdocs, pords = dev["dv_mv"][self.fld]
            pdocs = pdocs.to(torch.int64)
            safe = torch.where(pdocs >= 0, pdocs, 0)
            pvalid = (pdocs >= 0) & valid[safe]
            psub = seg[safe] * V + pords.to(torch.int64)
            counts = _seg_scatter(psub, nseg * V, pvalid, _ones(psub), 0,
                                  "add").reshape(nseg, V)
            return {"counts": counts, "children": {}}
        ords, h = _ordinal_column(dev, self.fld)
        ok = valid & h & (ords >= 0)
        sub = seg * V + ords
        counts = _seg_scatter(sub, nseg * V, ok, _ones(seg), 0, "add").reshape(nseg, V)
        return {
            "counts": counts,
            "children": self._eval_children(dev, {"children": params["children"]}, sub,
                                            nseg * V, ok, ctx),
        }

    def _top_indices(self, c: np.ndarray) -> np.ndarray:
        """Bucket selection for one parent segment (also the candidate
        chooser of the two-pass scheme: exact, the counts are global)."""
        (order_key, order_dir), = self.order.items()
        if order_key == "_key":
            idx = np.arange(len(c)) if order_dir == "asc" else np.arange(len(c))[::-1]
            return idx[c[idx] > 0][: self.size]
        # _count desc with _key asc tiebreak: stable sort on -count
        idx = np.argsort(-c, kind="stable")[: self.size]
        return idx[c[idx] > 0]

    def select_candidates(self, merged: dict) -> np.ndarray:
        """From merged pass-1 counts, pick every parent segment's top
        ordinals and build the [V] ordinal -> candidate-slot map for pass 2
        (-1 = not a candidate)."""
        counts = np.asarray(merged["counts"]).reshape(-1, self.V)
        chosen = sorted({int(j) for i in range(counts.shape[0])
                         for j in self._top_indices(counts[i])})
        self._C = 1 << max(len(chosen) - 1, 0).bit_length()
        self._cand_slot = {j: s for s, j in enumerate(chosen)}
        cand_map = np.full(self.V, -1, np.int32)
        if chosen:
            cand_map[chosen] = np.arange(len(chosen), dtype=np.int32)
        return cand_map

    def finalize(self, out, nseg):
        V = self.V
        counts = np.asarray(out["counts"])
        two = self.two_pass and V > 0
        if two and out.get("children"):
            C = self._C
            child_frags = self._finalize_children({"children": out["children"]}, nseg * C)
        elif self.children and V > 0 and not two:
            child_frags = self._finalize_children(out, nseg * V)
        else:
            child_frags = None
        res = []
        for i in range(nseg):
            c = counts[i]
            if V == 0:
                res.append({"doc_count_error_upper_bound": 0, "sum_other_doc_count": 0,
                            "buckets": []})
                continue
            idx = self._top_indices(c)
            buckets = []
            for j in idx:
                b = {"key": self.keys[j], "doc_count": int(c[j])}
                if child_frags is not None:
                    if two:
                        slot = self._cand_slot.get(int(j))
                        if slot is not None:
                            b.update(child_frags[i * C + slot])
                    else:
                        b.update(child_frags[i * V + j])
                buckets.append(b)
            res.append({
                "doc_count_error_upper_bound": 0,
                "sum_other_doc_count": int(c.sum() - c[idx].sum()),
                "buckets": buckets,
            })
        return res


class _BaseHistogramAgg(AggNode):
    """Shared fixed-interval bucketing: bucket = (v - offset)//interval,
    rebased by the column-min bucket; nb from the pack's min/max."""

    _MERGE_RULES = {"counts": "sum"}

    def __init__(self, name, fld, children=None, min_doc_count=None):
        super().__init__(name, children)
        self.fld = fld
        self.min_doc_count = min_doc_count

    def _plan(self, vmin, vmax, interval, offset):
        if isinstance(interval, int):
            first = (vmin - offset) // interval
            last = (vmax - offset) // interval
        else:
            first = np.floor((vmin - offset) / interval)
            last = np.floor((vmax - offset) / interval)
        nb = int(last - first) + 1
        if nb > MAX_BUCKETS:
            raise IllegalArgumentError(
                f"histogram[{self.fld}]: {nb} buckets exceeds max_buckets [{MAX_BUCKETS}]")
        return first, max(nb, 1)

    def _empty_eval(self, dev, params, seg, nseg, valid, ctx):
        return {
            "counts": _full((nseg, self.nb), 0, torch.int32, seg.device),
            "children": self._eval_children(dev, {"children": params["children"]},
                                            seg * self.nb, nseg * self.nb,
                                            torch.zeros_like(valid), ctx),
        }

    def _eval_with_bucket(self, dev, params, b, has, seg, nseg, valid, ctx):
        nb = self.nb
        if nseg * nb > MAX_SEGMENT_PRODUCT:
            raise IllegalArgumentError(f"histogram[{self.fld}] bucket budget exceeded")
        ok = valid & has & (b >= 0) & (b < nb)
        sub = seg * nb + torch.clamp(b, 0, nb - 1)
        counts = _seg_scatter(sub, nseg * nb, ok, _ones(seg), 0, "add").reshape(nseg, nb)
        return {
            "counts": counts,
            "children": self._eval_children(dev, {"children": params["children"]}, sub,
                                            nseg * nb, ok, ctx),
        }

    def _key_of(self, j):  # bucket index -> response key
        raise NotImplementedError

    def _key_as_string(self, key):
        return None

    def finalize(self, out, nseg):
        nb = self.nb
        counts = np.asarray(out["counts"])
        child_frags = self._finalize_children(out, nseg * nb) if self.children else None
        mdc = self.min_doc_count if self.min_doc_count is not None else 0
        res = []
        for i in range(nseg):
            c = counts[i]
            nz = np.nonzero(c)[0]
            buckets = []
            if len(nz):
                lo, hi = (int(nz[0]), int(nz[-1])) if mdc == 0 else (0, nb - 1)
                for j in range(lo, hi + 1):
                    if c[j] < mdc:
                        continue
                    key = self._key_of(j)
                    b = {"key": key, "doc_count": int(c[j])}
                    ks = self._key_as_string(key)
                    if ks is not None:
                        b = {"key_as_string": ks, **b}
                    if child_frags is not None:
                        b.update(child_frags[i * nb + j])
                    buckets.append(b)
            res.append({"buckets": buckets})
        return res


class HistogramAgg(_BaseHistogramAgg):
    def __init__(self, name, fld, interval, offset=0.0, children=None, min_doc_count=None):
        super().__init__(name, fld, children, min_doc_count)
        self.interval = float(interval)
        self.offset = float(offset)
        if self.interval <= 0:
            raise IllegalArgumentError("[interval] must be > 0")

    def prepare(self, pack, mappings):
        col = pack.docvalues.get(self.fld)
        if col is None or not col.has_value.any():
            self.first, self.nb = 0, 1
        else:
            self.first, self.nb = self._plan(float(col.vmin), float(col.vmax), self.interval,
                                             self.offset)
        cparams, ckey = self._prepare_children(pack, mappings)
        return {"children": cparams}, ("hist", self.fld, self.nb, self.interval, self.offset,
                                       ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = _numeric_values(dev, self.fld, ctx)
        if got is None:
            return self._empty_eval(dev, params, seg, nseg, valid, ctx)
        v, h, kind = got
        # f32 bucket arithmetic, as the reference's: its compiler turns the
        # division by the constant interval into a multiply by the f32
        # reciprocal, and so does this (on the CPU and on the card alike);
        # the rebase by the first bucket (a float64 numpy scalar there) in f64
        recip = float(np.float32(1.0) / np.float32(self.interval))
        fb = torch.floor((v.to(torch.float32) - self.offset) * recip)
        b = (fb.to(torch.float64) - float(self.first)).to(torch.int64)
        return self._eval_with_bucket(dev, params, b, h, seg, nseg, valid, ctx)

    def _key_of(self, j):
        return (self.first + j) * self.interval + self.offset


class DateHistogramAgg(_BaseHistogramAgg):
    def __init__(self, name, fld, fixed_interval=None, calendar_interval=None, offset=0,
                 children=None, min_doc_count=None, format=None):
        super().__init__(name, fld, children, min_doc_count)
        if (fixed_interval is None) == (calendar_interval is None):
            raise IllegalArgumentError(
                "date_histogram requires exactly one of [fixed_interval, calendar_interval]")
        self.mode = "fixed"
        self.months = 0
        if fixed_interval is not None:
            self.interval = parse_fixed_interval(fixed_interval)
        else:
            kind, n = parse_calendar_interval(calendar_interval)
            if kind == "fixed":
                self.interval = n
            else:
                self.mode = "months"
                self.months = n
                self.interval = None
        self.offset = (parse_fixed_interval(offset) if isinstance(offset, str) and offset
                       else int(offset or 0))

    def prepare(self, pack, mappings):
        col = pack.docvalues.get(self.fld)
        if col is None or not col.has_value.any():
            self.first, self.nb = 0, 1
        elif self.mode == "fixed":
            self.first, self.nb = self._plan(int(col.vmin), int(col.vmax), self.interval,
                                             self.offset)
        else:
            # the device buckets month_index(v - offset); plan in that space
            lo = _month_index_host(int(col.vmin) - self.offset) // self.months
            hi = _month_index_host(int(col.vmax) - self.offset) // self.months
            self.first, self.nb = lo, int(hi - lo) + 1
            if self.nb > MAX_BUCKETS:
                raise IllegalArgumentError("too many calendar buckets")
        cparams, ckey = self._prepare_children(pack, mappings)
        return {"children": cparams}, (
            "dhist", self.fld, self.nb, self.mode, self.interval, self.months, self.offset,
            ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        if self.fld not in dev["dv_int"]:
            return self._empty_eval(dev, params, seg, nseg, valid, ctx)
        v, h = dev["dv_int"][self.fld]
        if self.mode == "fixed":
            b = torch.div(v - self.offset, self.interval, rounding_mode="floor") - self.first
        else:
            b = torch.div(month_index_from_millis(v - self.offset), self.months,
                          rounding_mode="floor") - self.first
        return self._eval_with_bucket(dev, params, b, h, seg, nseg, valid, ctx)

    def _key_of(self, j):
        if self.mode == "fixed":
            return int((self.first + j) * self.interval + self.offset)
        return millis_of_month_index((self.first + j) * self.months) + self.offset

    def _key_as_string(self, key):
        dt = _dt.datetime.fromtimestamp(key / 1000.0, tz=_dt.timezone.utc)
        return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


def _month_index_host(ms: int) -> int:
    dt = _dt.datetime.fromtimestamp(ms / 1000.0, tz=_dt.timezone.utc)
    return dt.year * 12 + (dt.month - 1)


class RangeAgg(AggNode):
    """Numeric range buckets; ranges may overlap, so each is an independent
    mask (reference behavior: bucket/range/RangeAggregator.java)."""

    def __init__(self, name, fld, ranges, keyed=False, children=None):
        super().__init__(name, children)
        self.fld = fld
        self.ranges = ranges
        self.keyed = keyed

    def prepare(self, pack, mappings):
        cparams, ckey = self._prepare_children(pack, mappings)
        col = pack.docvalues.get(self.fld)
        bounds = tuple((r.get("from"), r.get("to")) for r in self.ranges)
        return {"children": cparams}, ("rangeagg", self.fld, bounds, col is None, ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = _numeric_values(dev, self.fld, ctx)
        outs = []
        for r in self.ranges:
            if got is None:
                ok = torch.zeros_like(valid)
            else:
                v, h, kind = got
                vf = v.to(torch.float32)
                ok = valid & h
                if r.get("from") is not None:
                    ok = ok & (vf >= float(r["from"]))
                if r.get("to") is not None:
                    ok = ok & (vf < float(r["to"]))
            outs.append({
                "count": _seg_scatter(seg, nseg, ok, _ones(seg), 0, "add"),
                "children": self._eval_children(dev, {"children": params["children"]}, seg,
                                                nseg, ok, ctx),
            })
        return {"ranges": outs}

    def merge_partials(self, stacked):
        return {"ranges": [
            {"count": np.asarray(o["count"]).sum(axis=0),
             "children": {n: c.merge_partials(o["children"][n])
                          for n, c in self.children.items()}}
            for o in stacked["ranges"]]}

    def finalize(self, out, nseg):
        res = [{"buckets": {} if self.keyed else []} for _ in range(nseg)]
        for r, o in zip(self.ranges, out["ranges"]):
            child_frags = self._finalize_children(o, nseg) if self.children else None
            for i in range(nseg):
                b = {}
                key = r.get("key")
                if key is None:
                    f = r.get("from")
                    t = r.get("to")
                    key = f"{f if f is not None else '*'}-{t if t is not None else '*'}"
                if not self.keyed:
                    b["key"] = key
                if r.get("from") is not None:
                    b["from"] = float(r["from"])
                if r.get("to") is not None:
                    b["to"] = float(r["to"])
                b["doc_count"] = int(o["count"][i])
                if child_frags is not None:
                    b.update(child_frags[i])
                if self.keyed:
                    res[i]["buckets"][key] = b
                else:
                    res[i]["buckets"].append(b)
        return res


class FilterAgg(AggNode):
    """Single-filter bucket (reference behavior: bucket/filter/FilterAggregator)."""

    _MERGE_RULES = {"count": "sum"}

    def __init__(self, name, query_node, children=None):
        super().__init__(name, children)
        self.qnode = query_node

    def prepare(self, pack, mappings):
        qp = self.qnode.prepare(pack)
        cparams, ckey = self._prepare_children(pack, mappings)
        return {"q": qp, "children": cparams}, ("filteragg", ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        _, m = self.qnode.device_eval(dev, params["q"], ctx)
        ok = valid & m[: ctx.num_docs]
        return {
            "count": _seg_scatter(seg, nseg, ok, _ones(seg), 0, "add"),
            "children": self._eval_children(dev, {"children": params["children"]}, seg, nseg,
                                            ok, ctx),
        }

    def finalize(self, out, nseg):
        child_frags = self._finalize_children(out, nseg) if self.children else None
        res = []
        for i in range(nseg):
            d = {"doc_count": int(out["count"][i])}
            if child_frags is not None:
                d.update(child_frags[i])
            res.append(d)
        return res


class FiltersAgg(AggNode):
    def __init__(self, name, named_filters: dict, children=None):
        super().__init__(name, children)
        self.named = named_filters  # name -> QueryNode

    def prepare(self, pack, mappings):
        self._subs = {n: FilterAgg(n, q, self.children) for n, q in self.named.items()}
        parts = {n: s.prepare(pack, mappings) for n, s in self._subs.items()}
        return {n: p for n, (p, _) in parts.items()}, (
            "filtersagg", tuple((n, k) for n, (_, k) in sorted(parts.items())))

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        return {n: s.device_eval_segmented(dev, params[n], seg, nseg, valid, ctx)
                for n, s in self._subs.items()}

    def merge_partials(self, stacked):
        return {n: s.merge_partials(stacked[n]) for n, s in self._subs.items()}

    def finalize(self, out, nseg):
        res = [{"buckets": {}} for _ in range(nseg)]
        for n, s in self._subs.items():
            frags = s.finalize(out[n], nseg)
            for i in range(nseg):
                res[i]["buckets"][n] = frags[i]
        return res


class MissingAgg(AggNode):
    _MERGE_RULES = {"count": "sum"}

    def __init__(self, name, fld, children=None):
        super().__init__(name, children)
        self.fld = fld

    def prepare(self, pack, mappings):
        cparams, ckey = self._prepare_children(pack, mappings)
        col = pack.docvalues.get(self.fld)
        return {"children": cparams}, ("missingagg", self.fld, col is None, ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = _col_arrays(dev, self.fld)
        ok = valid if got is None else valid & ~got[1]
        return {
            "count": _seg_scatter(seg, nseg, ok, _ones(seg), 0, "add"),
            "children": self._eval_children(dev, {"children": params["children"]}, seg, nseg,
                                            ok, ctx),
        }

    finalize = FilterAgg.finalize


class GlobalAgg(AggNode):
    """Ignores the query: buckets over all live docs (reference behavior:
    bucket/global/GlobalAggregator — only legal at top level)."""

    _MERGE_RULES = {"count": "sum"}

    def prepare(self, pack, mappings):
        cparams, ckey = self._prepare_children(pack, mappings)
        return {"children": cparams}, ("globalagg", ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        if nseg != 1:
            raise IllegalArgumentError("global agg must be at top level")
        ok = dev["live"]
        z = torch.zeros(ctx.num_docs, dtype=torch.int64, device=seg.device)
        return {
            "count": _seg_scatter(z, 1, ok, _ones(z), 0, "add"),
            "children": self._eval_children(dev, {"children": params["children"]}, z, 1, ok,
                                            ctx),
        }

    finalize = FilterAgg.finalize


class ExtendedStatsAgg(_FieldMetricAgg):
    """stats + sum_of_squares/variance/std_deviation (+bounds), the
    reference's population statistics (reference behavior:
    search/aggregations/metrics/ExtendedStatsAggregator.java)."""

    _MERGE_RULES = {"sum": "sum", "count": "sum", "min": "min", "max": "max", "sumsq": "sum"}

    def __init__(self, name, fld, sigma=2.0, children=None):
        super().__init__(name, fld, children)
        self.sigma = float(sigma)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = _numeric_values(dev, self.fld, ctx)
        if got is None:
            z = _full(nseg, 0, torch.float32, seg.device)
            return {"sum": z, "count": _full(nseg, 0, torch.int32, seg.device),
                    "min": z + np.inf, "max": z - np.inf, "sumsq": z}
        v, h, kind = got
        ok = valid & h
        vf = v.to(torch.float32)
        return {
            "sum": _seg_scatter(seg, nseg, ok, vf, 0.0, "add"),
            "sumsq": _seg_scatter(seg, nseg, ok, vf * vf, 0.0, "add"),
            "count": _seg_scatter(seg, nseg, ok, _ones(seg), 0, "add"),
            "min": _seg_scatter(seg, nseg, ok, vf, np.inf, "min"),
            "max": _seg_scatter(seg, nseg, ok, vf, -np.inf, "max"),
        }

    def finalize(self, out, nseg):
        res = []
        for i in range(nseg):
            c = int(out["count"][i])
            s = float(out["sum"][i])
            sq = float(out["sumsq"][i])
            if c:
                avg = s / c
                var = max(sq / c - avg * avg, 0.0)
                std = var ** 0.5
            else:
                avg = var = std = None
            entry = {
                "count": c,
                "min": float(out["min"][i]) if c else None,
                "max": float(out["max"][i]) if c else None,
                "avg": avg, "sum": s,
                "sum_of_squares": sq if c else None,
                "variance": var,
                "variance_population": var,
                "std_deviation": std,
                "std_deviation_population": std,
            }
            if c:
                entry["std_deviation_bounds"] = {"upper": avg + self.sigma * std,
                                                 "lower": avg - self.sigma * std}
            res.append(entry)
        return res


class WeightedAvgAgg(AggNode):
    """weighted_avg {value: {field}, weight: {field}} (reference behavior:
    search/aggregations/metrics/WeightedAvgAggregator.java — docs missing
    either side are skipped)."""

    _MERGE_RULES = {"vw": "sum", "w": "sum"}

    def __init__(self, name, value_field, weight_field, children=None):
        super().__init__(name, children)
        if children:
            raise IllegalArgumentError("weighted_avg cannot have sub-aggregations")
        self.vf = value_field
        self.wf = weight_field

    def prepare(self, pack, mappings):
        return {}, ("weighted_avg", self.vf, self.wf, pack.docvalues.get(self.vf) is None,
                    pack.docvalues.get(self.wf) is None)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        gv = _numeric_values(dev, self.vf, ctx)
        gw = _numeric_values(dev, self.wf, ctx)
        z = _full(nseg, 0, torch.float32, seg.device)
        if gv is None or gw is None:
            return {"vw": z, "w": z}
        v, hv, _ = gv
        w, hw, _ = gw
        ok = valid & hv & hw
        vf = v.to(torch.float32)
        wf = w.to(torch.float32)
        return {"vw": _seg_scatter(seg, nseg, ok, vf * wf, 0.0, "add"),
                "w": _seg_scatter(seg, nseg, ok, wf, 0.0, "add")}

    def finalize(self, out, nseg):
        res = []
        for i in range(nseg):
            w = float(out["w"][i])
            res.append({"value": float(out["vw"][i]) / w if w else None})
        return res


class RareTermsAgg(TermsAgg):
    """rare_terms: buckets whose doc_count <= max_doc_count, ordered by count
    asc then key asc (reference behavior: bucket/terms/RareTermsAggregator —
    exact here, no CuckooFilter)."""

    def __init__(self, name, fld, max_doc_count=1, children=None, missing=None):
        super().__init__(name, fld, size=MAX_BUCKETS, children=children)
        self.max_doc_count = int(max_doc_count)

    def prepare(self, pack, mappings):
        params, key = super().prepare(pack, mappings)
        return params, ("rare",) + key[1:] + (self.max_doc_count,)

    def finalize(self, out, nseg):
        V = self.V
        counts = np.asarray(out["counts"])
        child_frags = (self._finalize_children(out, nseg * V) if (self.children and V > 0)
                       else None)
        res = []
        for i in range(nseg):
            if V == 0:
                res.append({"buckets": []})
                continue
            c = counts[i]
            sel = np.flatnonzero((c > 0) & (c <= self.max_doc_count))
            sel = sel[np.argsort(c[sel], kind="stable")]
            buckets = []
            for j in sel:
                b = {"key": self.keys[j], "doc_count": int(c[j])}
                if child_frags is not None:
                    b.update(child_frags[i * V + j])
                buckets.append(b)
            res.append({"buckets": buckets})
        return res


class MultiTermsAgg(AggNode):
    """multi_terms: compound keys over 2+ ordinal fields (reference behavior:
    bucket/terms/MultiTermsAggregator.java). The bucket space is the product
    of the per-field vocabularies; empty combinations trim on the host."""

    _MERGE_RULES = {"counts": "sum"}

    def __init__(self, name, fields, size=10, order=None, children=None):
        super().__init__(name, children)
        if len(fields) < 2:
            raise IllegalArgumentError("multi_terms requires at least 2 terms sources")
        self.flds = fields
        self.size = size
        self.order = order or {"_count": "desc"}

    def prepare(self, pack, mappings):
        self.keys_per = []
        for f in self.flds:
            col = pack.docvalues.get(f)
            if col is None:
                self.keys_per.append([])
                continue
            keys = _vocab_keys(col)
            if keys is None:
                raise IllegalArgumentError(f"multi_terms on float field [{f}] is not supported")
            self.keys_per.append(keys)
        self.Vs = [len(k) for k in self.keys_per]
        V = 1
        for v in self.Vs:
            V *= v
        self.V = V
        cparams, ckey = self._prepare_children(pack, mappings)
        return {"children": cparams}, ("multi_terms", tuple(self.flds), tuple(self.Vs),
                                       self.size, ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        V = self.V
        if V == 0:
            return {"counts": _full((nseg, 1), 0, torch.int32, seg.device), "children": {}}
        if nseg * V > MAX_SEGMENT_PRODUCT:
            raise IllegalArgumentError(
                f"multi_terms{self.flds}: {nseg}x{V} buckets exceeds bucket budget")
        sub = seg
        ok = valid
        for f, vsize in zip(self.flds, self.Vs):
            ords, h = _ordinal_column(dev, f)
            ok = ok & h & (ords >= 0)
            sub = sub * vsize + torch.where(ords >= 0, ords, 0)
        counts = _seg_scatter(sub, nseg * V, ok, _ones(seg), 0, "add").reshape(nseg, V)
        return {
            "counts": counts,
            "children": self._eval_children(dev, {"children": params["children"]}, sub,
                                            nseg * V, ok, ctx),
        }

    def finalize(self, out, nseg):
        V = self.V
        counts = np.asarray(out["counts"])
        child_frags = (self._finalize_children(out, nseg * V) if (self.children and V > 0)
                       else None)
        (order_key, order_dir), = self.order.items()
        res = []
        for i in range(nseg):
            if V == 0:
                res.append({"buckets": []})
                continue
            c = counts[i]
            if order_key == "_key":
                idx = np.arange(V) if order_dir == "asc" else np.arange(V)[::-1]
                idx = idx[c[idx] > 0][: self.size]
            else:
                idx = np.argsort(-c, kind="stable")[: self.size]
                idx = idx[c[idx] > 0]
            buckets = []
            for j in idx:
                parts = []
                rem = int(j)
                for vsize in reversed(self.Vs):
                    parts.append(rem % vsize)
                    rem //= vsize
                key = [self.keys_per[d][p] for d, p in enumerate(reversed(parts))]
                b = {"key": key, "key_as_string": "|".join(str(k) for k in key),
                     "doc_count": int(c[j])}
                if child_frags is not None:
                    b.update(child_frags[i * V + j])
                buckets.append(b)
            res.append({"doc_count_error_upper_bound": 0,
                        "sum_other_doc_count": int(c.sum() - sum(b["doc_count"]
                                                                 for b in buckets)),
                        "buckets": buckets})
        return res


class SignificantTermsAgg(AggNode):
    """significant_terms via JLH scoring of foreground (query matches) vs
    background (whole index) frequencies (reference behavior:
    bucket/terms/SignificantTermsAggregatorFactory.java + JLHScore.java)."""

    _MERGE_RULES = {"fg": "sum", "bg": "sum", "fg_total": "sum", "bg_total": "sum"}

    def __init__(self, name, fld, size=10, min_doc_count=3, children=None):
        super().__init__(name, children)
        self.fld = fld
        self.size = size
        self.min_doc_count = int(min_doc_count)

    def prepare(self, pack, mappings):
        col = pack.docvalues.get(self.fld)
        self.keys = []
        if col is not None:
            if col.kind == "ord":
                self.keys = list(col.ord_terms or [])
            elif col.uniq_values is not None:
                self.keys = [int(x) for x in col.uniq_values]
        self.V = len(self.keys)
        cparams, ckey = self._prepare_children(pack, mappings)
        return {"children": cparams}, ("sig_terms", self.fld, self.V, self.size,
                                       self.min_doc_count, ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        V = self.V
        device = seg.device
        if V == 0:
            return {"fg": _full((nseg, 1), 0, torch.int32, device),
                    "bg": _full(1, 0, torch.int32, device),
                    "fg_total": _full(nseg, 0, torch.int32, device),
                    "bg_total": _full((), 0, torch.int32, device), "children": {}}
        if nseg * V > MAX_SEGMENT_PRODUCT:
            raise IllegalArgumentError(f"significant_terms[{self.fld}]: bucket budget exceeded")
        ords, h = _ordinal_column(dev, self.fld)
        live = dev["live"]
        ok = valid & h & (ords >= 0)
        bg_ok = live & h & (ords >= 0)
        sub = seg * V + ords
        fg = _seg_scatter(sub, nseg * V, ok, _ones(seg), 0, "add").reshape(nseg, V)
        bg = _seg_scatter(torch.where(ords >= 0, ords, 0), V, bg_ok, _ones(seg), 0, "add")
        return {
            "fg": fg,
            "bg": bg,
            "fg_total": _seg_scatter(seg, nseg, valid, _ones(seg), 0, "add"),
            "bg_total": live.sum(dtype=torch.int32),
            "children": self._eval_children(dev, {"children": params["children"]}, sub,
                                            nseg * V, ok, ctx),
        }

    def finalize(self, out, nseg):
        V = self.V
        if V == 0:
            return [{"doc_count": 0, "bg_count": 0, "buckets": []} for _ in range(nseg)]
        fg = np.asarray(out["fg"], np.float64)
        bg = np.asarray(out["bg"], np.float64)
        fg_total = np.asarray(out["fg_total"], np.float64).reshape(nseg)
        bg_total = float(np.asarray(out["bg_total"]).reshape(-1)[0])
        child_frags = self._finalize_children(out, nseg * V) if self.children else None
        res = []
        for i in range(nseg):
            ft = fg_total[i]
            buckets = []
            if ft > 0 and bg_total > 0:
                fr = fg[i] / ft
                br = np.where(bg > 0, bg / bg_total, 0.0)
                # JLH: (fg% - bg%) * (fg% / bg%), only when fg% > bg%
                with np.errstate(divide="ignore", invalid="ignore"):
                    score = np.where((fr > br) & (br > 0), (fr - br) * (fr / br), 0.0)
                sel = np.flatnonzero((score > 0) & (fg[i] >= self.min_doc_count))
                sel = sel[np.argsort(-score[sel], kind="stable")][: self.size]
                for j in sel:
                    b = {"key": self.keys[j], "doc_count": int(fg[i][j]),
                         "score": float(score[j]), "bg_count": int(bg[j])}
                    if child_frags is not None:
                        b.update(child_frags[i * V + j])
                    buckets.append(b)
            res.append({"doc_count": int(ft), "bg_count": int(bg_total), "buckets": buckets})
        return res


class DateRangeAgg(RangeAgg):
    """date_range: range agg with date-expression bounds resolved to epoch
    millis at parse time (reference behavior:
    bucket/range/DateRangeAggregationBuilder.java)."""

    def __init__(self, name, fld, ranges, keyed=False, children=None, format=None):
        from ..index.mappings import parse_date_to_millis

        resolved = []
        self._raw = ranges
        for r in ranges:
            rr = dict(r)
            for side in ("from", "to"):
                if rr.get(side) is not None and not isinstance(rr[side], (int, float)):
                    rr[side] = parse_date_to_millis(rr[side])
            resolved.append(rr)
        super().__init__(name, fld, resolved, keyed, children)


class TopHitsAgg(AggNode):
    """top_hits: per-bucket top-k docs by query score, docid-asc tie-break
    (reference behavior: search/aggregations/metrics/TopHitsAggregator.java).
    The device emits (score, local docid) pairs; the engine resolves them to
    _id/_source on the host (`EsIndex._resolve_top_hits`), the analog of the
    reference's fetch-phase sub-search."""

    def __init__(self, name, size=3, children=None):
        super().__init__(name, children)
        if children:
            raise IllegalArgumentError("top_hits cannot have sub-aggregations")
        self.size = max(1, int(size))

    def prepare(self, pack, mappings):
        return {}, ("top_hits", self.size)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        scores = dev.get("_query_scores")
        n = seg.shape[0]
        device = seg.device
        if scores is None:  # no scores: doc order
            scores = torch.zeros(n, dtype=torch.float32, device=device)
        else:
            scores = scores[:n]
        docids = torch.arange(n, dtype=torch.int32, device=device)
        remaining = valid
        seg_c = torch.clamp(seg, 0, nseg - 1)
        out_s, out_d = [], []
        for _ in range(self.size):
            m = _seg_scatter(seg, nseg, remaining, scores, -np.inf, "max")
            ismax = remaining & (scores == m[seg_c])
            dmin = _seg_scatter(seg, nseg, ismax, docids, _I32_MAX, "min")
            out_s.append(m)
            out_d.append(dmin)
            remaining = remaining & ~(ismax & (docids == dmin[seg_c]))
        return {
            "scores": torch.stack(out_s, dim=1),  # [nseg, k]
            "ids": torch.stack(out_d, dim=1),
            "count": _seg_scatter(seg, nseg, valid, _ones(seg), 0, "add"),
        }

    def merge_partials(self, stacked):
        # keep the per-shard candidates; finalize picks the global top and
        # tags each hit with its shard
        return {
            "scores": np.asarray(stacked["scores"]),  # [S, nseg, k]
            "ids": np.asarray(stacked["ids"]),
            "count": np.asarray(stacked["count"]).sum(axis=0),
            "_sharded": True,
        }

    def finalize(self, out, nseg):
        scores = np.asarray(out["scores"])
        ids = np.asarray(out["ids"])
        counts = np.asarray(out["count"]).reshape(nseg)
        if not out.get("_sharded"):
            scores = scores[None, :]  # [1, nseg, k]
            ids = ids[None, :]
        S, _, k = scores.shape
        res = []
        for i in range(nseg):
            cands = []
            for s in range(S):
                for j in range(k):
                    sc = float(scores[s, i, j])
                    d = int(ids[s, i, j])
                    if np.isfinite(sc) and d != _I32_MAX:
                        cands.append((-sc, s, d))
            cands.sort()
            hits = [{"_shard": s, "_doc": d, "_score": -negs, "_resolve_top_hit": True}
                    for negs, s, d in cands[: self.size]]
            res.append({"hits": {
                "total": {"value": int(counts[i]), "relation": "eq"},
                "max_score": hits[0]["_score"] if hits else None,
                "hits": hits,
            }})
        return res


# ES auto_date_histogram rounding ladder (reference behavior:
# bucket/histogram/AutoDateHistogramAggregationBuilder.java RoundingInfos):
# (fixed millis, label) tiers below month; month/year tiers via month index.
_AUTO_DH_FIXED = [
    (1000, "1s"), (5000, "5s"), (10000, "10s"), (30000, "30s"),
    (60000, "1m"), (300000, "5m"), (600000, "10m"), (1800000, "30m"),
    (3600000, "1h"), (10800000, "3h"), (43200000, "12h"),
    (86400000, "1d"), (604800000, "7d"),
]
_AUTO_DH_MONTHS = [(1, "1M"), (3, "3M"), (12, "1y"), (60, "5y"),
                   (120, "10y"), (240, "20y"), (600, "50y"), (1200, "100y")]


class AutoDateHistogramAgg(AggNode):
    """auto_date_histogram: the smallest rounding that keeps the bucket count
    under `buckets`, from the column's min/max, then a DateHistogramAgg."""

    def __init__(self, name, fld, buckets=10, children=None, format=None):
        super().__init__(name, children)
        self.fld = fld
        self.target = max(1, int(buckets))

    def _choose(self, vmin: int, vmax: int) -> tuple[str, str]:
        span = max(vmax - vmin, 0)
        for ms, label in _AUTO_DH_FIXED:
            if span // ms + 1 <= self.target:
                return "fixed", label
        lo, hi = _month_index_host(vmin), _month_index_host(vmax)
        for months, label in _AUTO_DH_MONTHS:
            if (hi - lo) // months + 1 <= self.target:
                return "calendar", label
        return "calendar", _AUTO_DH_MONTHS[-1][1]

    def prepare(self, pack, mappings):
        col = pack.docvalues.get(self.fld)
        if col is None or not col.has_value.any():
            mode, label = "fixed", "1s"
        else:
            mode, label = self._choose(int(col.vmin), int(col.vmax))
        self.interval_label = label
        self._delegate = DateHistogramAgg(
            self.name, self.fld,
            fixed_interval=label if mode == "fixed" else None,
            calendar_interval=label if mode == "calendar" else None,
            children=self.children, min_doc_count=1,
        )
        params, key = self._delegate.prepare(pack, mappings)
        return params, ("auto_dh", label) + key

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        return self._delegate.device_eval_segmented(dev, params, seg, nseg, valid, ctx)

    def merge_partials(self, stacked):
        return self._delegate.merge_partials(stacked)

    def finalize(self, out, nseg):
        frags = self._delegate.finalize(out, nseg)
        for f in frags:
            f["interval"] = self.interval_label
        return frags


class CompositeAgg(AggNode):
    """composite: paginated compound buckets over terms / (date_)histogram
    sources (reference behavior: bucket/composite/CompositeAggregator.java).
    Buckets order by the key tuple (per-source asc/desc); `after` resumes.
    Top level only, like the reference. A small bucket product is counted
    whole on the device and paginated on the host; a large one runs the
    paged two-pass scheme (pass 1 the page's rank keys, pass 2 counts and
    children over the page only)."""

    _MERGE_RULES = {"counts": "sum", "ranks": "concat_sorted"}
    PAGE_RANK_INF = 1 << 62

    def __init__(self, name, sources, size=10, after=None, children=None):
        super().__init__(name, children)
        # sources: [(src_name, type, field, opts)] in request order
        self.sources = sources
        self.size = int(size)
        self.after = after

    def prepare(self, pack, mappings):
        self.plans = []  # per source: kind, V, keys | first + interval, order
        for (sname, styp, fld, opts) in self.sources:
            col = pack.docvalues.get(fld)
            if styp == "terms":
                keys = [] if col is None else _vocab_keys(col)
                if keys is None:
                    raise IllegalArgumentError(f"composite terms source on float field [{fld}]")
                self.plans.append({"kind": "terms", "V": len(keys), "keys": keys,
                                   "order": opts.get("order", "asc")})
            else:  # histogram / date_histogram (fixed interval)
                if styp == "histogram":
                    interval = float(opts["interval"])
                else:
                    interval = float(parse_fixed_interval(
                        opts.get("fixed_interval") or opts.get("calendar_interval")
                        or opts.get("interval")))
                if col is None or not col.has_value.any():
                    first, nb = 0, 1
                else:
                    first = int(np.floor(float(col.vmin) / interval))
                    last = int(np.floor(float(col.vmax) / interval))
                    nb = last - first + 1
                self.plans.append({"kind": styp, "V": nb, "first": first,
                                   "interval": interval, "order": opts.get("order", "asc")})
        cparams, ckey = self._prepare_children(pack, mappings)
        shape_key = tuple((p["kind"], p["V"], p.get("interval"), p.get("first"))
                          for p in self.plans)
        vtot = 1
        for p in self.plans:
            vtot *= max(p["V"], 1)
            if vtot >= self.PAGE_RANK_INF:
                raise IllegalArgumentError(f"composite [{self.name}]: source product overflows")
        self.two_pass = (vtot > TWO_PASS_MIN_V
                         and not getattr(self, "force_single_pass", False))
        self._P = _bucket_pow2(self.size)
        self._after_rank = self._compute_after_rank() if self.two_pass else None
        V = 1
        for p in self.plans:
            V *= max(p["V"], 1)
        self.V = V
        return {"children": cparams, "cand": None}, (
            "composite", tuple(s[2] for s in self.sources), shape_key, self.size,
            self.two_pass, self._after_rank if self.two_pass else None, ckey)

    def _compute_after_rank(self) -> int:
        """Linearized EXCLUSIVE lower bound from the `after` key. Ranks are
        lexicographic over order-adjusted coordinates, so `key > after` ==
        `rank > after_rank`. An after value absent from a terms vocabulary
        makes the bound inclusive from its insertion position."""
        if self.after is None:
            return -1
        rank = 0
        consumed = 0
        inclusive = False
        for (sname, styp, fld, opts), p in zip(self.sources, self.plans):
            v = self.after.get(sname)
            if p["kind"] == "terms":
                if p["order"] == "desc":
                    keys_adj = list(reversed(p["keys"]))
                    pos = next((i for i, kk in enumerate(keys_adj) if kk <= v), p["V"])
                    hit = pos < p["V"] and keys_adj[pos] == v
                else:
                    pos = int(np.searchsorted(np.asarray(p["keys"], dtype=object), v))
                    hit = pos < p["V"] and p["keys"][pos] == v
            else:
                raw = int(np.floor(float(v) / p["interval"])) - p["first"]
                pos = p["V"] - 1 - raw if p["order"] == "desc" else raw
                hit = 0 <= pos < p["V"]
                pos = max(pos, 0)
            if pos >= p["V"]:
                # the after key sorts past this source's whole vocab: advance
                # the prefix itself (inclusive bound at prefix+1, rest zero)
                rank += 1
                inclusive = True
                break
            rank = rank * p["V"] + pos
            consumed += 1
            if not hit:
                inclusive = True
                break
        for p in self.plans[consumed:]:
            rank *= p["V"]
        return int(rank) - 1 if inclusive else int(rank)

    def _doc_buckets(self, dev, seg, valid, ctx, adjusted: bool):
        """Per-doc linearized bucket id (and validity). `adjusted` flips desc
        sources so the id IS the composite order rank."""
        sub = seg
        ok = valid
        for (sname, styp, fld, opts), p in zip(self.sources, self.plans):
            if p["kind"] == "terms":
                ords, h = _ordinal_column(dev, fld)
                if ords is None:
                    ok = torch.zeros_like(ok)
                    b = torch.zeros_like(seg)
                else:
                    ok = ok & h & (ords >= 0)
                    b = torch.where(ords >= 0, ords, 0)
            else:
                got = _numeric_values(dev, fld, ctx)
                if got is None:
                    ok = torch.zeros_like(ok)
                    b = torch.zeros_like(seg)
                else:
                    v, h, kind = got
                    ok = ok & h
                    # f64, times the reciprocal of the interval (the
                    # reference's compiled division by a constant)
                    b = (torch.floor(v.to(torch.float64) * (1.0 / p["interval"]))
                         .to(torch.int64) - p["first"])
                    b = torch.clamp(b, 0, p["V"] - 1)
            if adjusted and p["order"] == "desc":
                b = p["V"] - 1 - b
            sub = sub * p["V"] + b
        return sub, ok

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        V = self.V
        device = seg.device
        if any(p["V"] == 0 for p in self.plans):
            return {"counts": _full((nseg, 1), 0, torch.int32, device), "children": {}}
        cand = params.get("cand") if isinstance(params, dict) else None
        if self.two_pass and cand is None:
            # paged pass 1: the page is the `size` smallest distinct
            # order-adjusted rank keys past `after`, found by sorting the
            # per-doc ranks; nothing vocab-sized materializes
            rank, ok = self._doc_buckets(dev, seg * 0, valid, ctx, adjusted=True)
            r = torch.where(ok & (rank > self._after_rank), rank, self.PAGE_RANK_INF)
            s = torch.sort(r).values
            firsts = torch.cat([torch.ones(1, dtype=torch.bool, device=device), s[1:] != s[:-1]])
            page = torch.sort(torch.where(firsts, s, self.PAGE_RANK_INF)).values[: self._P]
            return {"ranks": page, "children": {}}
        if self.two_pass:
            # paged pass 2: counts + children over the page slots only
            P = self._P
            rank, ok = self._doc_buckets(dev, seg * 0, valid, ctx, adjusted=True)
            idx = torch.clamp(torch.searchsorted(cand, rank), 0, P - 1)
            on_page = ok & (cand[idx] == rank) & (rank < self.PAGE_RANK_INF)
            sub = seg * P + idx
            counts = _seg_scatter(sub, nseg * P, on_page, _ones(seg), 0, "add").reshape(nseg, P)
            return {
                "counts": counts,
                "children": self._eval_children(dev, {"children": params["children"]}, sub,
                                                nseg * P, on_page, ctx),
            }
        if nseg * V > MAX_SEGMENT_PRODUCT:
            raise IllegalArgumentError(f"composite [{self.name}]: {V} buckets exceeds bucket budget")
        sub, ok = self._doc_buckets(dev, seg, valid, ctx, adjusted=False)
        counts = _seg_scatter(sub, nseg * V, ok, _ones(seg), 0, "add").reshape(nseg, V)
        return {
            "counts": counts,
            "children": self._eval_children(dev, {"children": params["children"]}, sub,
                                            nseg * V, ok, ctx),
        }

    def _key_tuple(self, j):
        parts = []
        rem = int(j)
        for p in reversed(self.plans):
            parts.append(rem % p["V"])
            rem //= p["V"]
        parts.reverse()
        return tuple(self._key_part(p, o) for p, o in zip(self.plans, parts))

    @staticmethod
    def _key_part(p, o):
        if p["kind"] == "terms":
            return p["keys"][o]
        if p["kind"] == "histogram":
            return (p["first"] + o) * p["interval"]
        return int((p["first"] + o) * p["interval"])

    def select_candidates(self, merged: dict) -> np.ndarray:
        """From merged pass-1 rank keys: the `size` smallest distinct ranks
        form the page; returns the sorted padded [P] rank array pass 2
        searches against."""
        ranks = np.asarray(merged["ranks"]).reshape(-1)
        ranks = np.unique(ranks[ranks < self.PAGE_RANK_INF])[: self.size]
        page = np.full(self._P, self.PAGE_RANK_INF, np.int64)
        page[: len(ranks)] = ranks
        self._page_ranks = [int(x) for x in ranks]
        self._C = self._P
        return page

    def _key_from_rank(self, rank: int) -> tuple:
        parts_adj = []
        rem = int(rank)
        for p in reversed(self.plans):
            parts_adj.append(rem % p["V"])
            rem //= p["V"]
        parts_adj.reverse()
        return tuple(self._key_part(p, (p["V"] - 1 - adj) if p["order"] == "desc" else adj)
                     for p, adj in zip(self.plans, parts_adj))

    def _finalize_paged(self, out, nseg):
        P = self._P
        counts = np.asarray(out["counts"]).reshape(nseg, P)
        child_frags = (self._finalize_children(out, nseg * P)
                       if (self.children and out.get("children")) else None)
        res = []
        for i in range(nseg):
            buckets = []
            for slot, rank in enumerate(self._page_ranks):
                c = int(counts[i, slot])
                if c <= 0:
                    continue
                kt = self._key_from_rank(rank)
                b = {"key": {s[0]: k for s, k in zip(self.sources, kt)}, "doc_count": c}
                if child_frags is not None:
                    b.update(child_frags[i * P + slot])
                buckets.append(b)
            frag = {"buckets": buckets}
            if buckets:
                frag["after_key"] = buckets[-1]["key"]
            res.append(frag)
        return res

    def finalize(self, out, nseg):
        if self.two_pass:
            return self._finalize_paged(out, nseg)
        V = self.V
        counts = np.asarray(out["counts"]).reshape(nseg, -1)
        child_frags = (self._finalize_children(out, nseg * V)
                       if (self.children and counts.shape[1] == V) else None)
        res = []
        for i in range(nseg):
            c = counts[i]
            keyed = []
            for j in np.flatnonzero(c > 0):
                kt = self._key_tuple(j)
                # per-source sort rank honoring the order direction
                rank = tuple((_neg_rank(k) if p["order"] == "desc" else _pos_rank(k))
                             for k, p in zip(kt, self.plans))
                keyed.append((rank, kt, int(j)))
            keyed.sort(key=lambda x: x[0])
            if self.after is not None:
                after_vals = tuple(self.after[s[0]] for s in self.sources)
                after_rank = tuple((_neg_rank(k) if p["order"] == "desc" else _pos_rank(k))
                                   for k, p in zip(after_vals, self.plans))
                keyed = [x for x in keyed if x[0] > after_rank]
            page = keyed[: self.size]
            buckets = []
            for _, kt, j in page:
                b = {"key": {s[0]: k for s, k in zip(self.sources, kt)},
                     "doc_count": int(c[j])}
                if child_frags is not None:
                    b.update(child_frags[i * V + j])
                buckets.append(b)
            frag = {"buckets": buckets}
            if page:
                frag["after_key"] = buckets[-1]["key"]
            res.append(frag)
        return res


# ---------------------------------------------------------------------------
# geo aggs (reference `aggs/nodes.py:1904-2093`)
# ---------------------------------------------------------------------------


class GeoBoundsAgg(AggNode):
    """geo_bounds: the bounding box of the matching points (reference
    behavior: search/aggregations/metrics/GeoBoundsAggregator.java). Min and
    max per segment: the same floats in any order of reduction."""

    _MERGE_RULES = {"top": "max", "bottom": "min", "left": "min", "right": "max",
                    "count": "sum"}

    def __init__(self, name, fld, children=None):
        super().__init__(name, children)
        if children:
            raise IllegalArgumentError("geo_bounds cannot have sub-aggregations")
        self.fld = fld

    def prepare(self, pack, mappings):
        return {}, (type(self).__name__, self.fld,
                    pack.docvalues.get(f"{self.fld}#lat") is None)

    def _cols(self, dev):
        from ..query.geo import geo_cols

        return geo_cols(dev, self.fld)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = self._cols(dev)
        d = seg.device
        if got is None:
            return {"top": _full(nseg, -np.inf, torch.float32, d),
                    "bottom": _full(nseg, np.inf, torch.float32, d),
                    "left": _full(nseg, np.inf, torch.float32, d),
                    "right": _full(nseg, -np.inf, torch.float32, d),
                    "count": _full(nseg, 0, torch.int32, d)}
        lat, has, lon = got
        ok = valid & has
        return {
            "top": _seg_scatter(seg, nseg, ok, lat, -np.inf, "max"),
            "bottom": _seg_scatter(seg, nseg, ok, lat, np.inf, "min"),
            "left": _seg_scatter(seg, nseg, ok, lon, np.inf, "min"),
            "right": _seg_scatter(seg, nseg, ok, lon, -np.inf, "max"),
            "count": _seg_scatter(seg, nseg, ok, _ones(seg), 0, "add"),
        }

    def finalize(self, out, nseg):
        res = []
        for i in range(nseg):
            if int(out["count"][i]) == 0:
                res.append({})
                continue
            res.append({"bounds": {
                "top_left": {"lat": float(out["top"][i]), "lon": float(out["left"][i])},
                "bottom_right": {"lat": float(out["bottom"][i]), "lon": float(out["right"][i])},
            }})
        return res


class GeoCentroidAgg(GeoBoundsAgg):
    """geo_centroid: the arithmetic mean of lat and of lon (reference
    behavior: GeoCentroidAggregator.java). The sums go through
    `segment_sum_f32` (f64 after a stable sort, rounded to f32 once: no
    float atomics), so the card and the CPU agree bit for bit; the JAX
    package sums in f32, so the two centroids differ within the f32 error
    of a sum of N values (ROADMAP queue C)."""

    _MERGE_RULES = {"lat_sum": "sum", "lon_sum": "sum", "count": "sum"}

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        got = self._cols(dev)
        d = seg.device
        if got is None:
            z = _full(nseg, 0, torch.float32, d)
            return {"lat_sum": z, "lon_sum": z, "count": _full(nseg, 0, torch.int32, d)}
        lat, has, lon = got
        ok = valid & has
        return {
            "lat_sum": _seg_scatter(seg, nseg, ok, lat, 0.0, "add"),
            "lon_sum": _seg_scatter(seg, nseg, ok, lon, 0.0, "add"),
            "count": _seg_scatter(seg, nseg, ok, _ones(seg), 0, "add"),
        }

    def finalize(self, out, nseg):
        res = []
        for i in range(nseg):
            c = int(out["count"][i])
            if c == 0:
                res.append({"count": 0})
                continue
            res.append({"location": {"lat": float(out["lat_sum"][i]) / c,
                                     "lon": float(out["lon_sum"][i]) / c},
                        "count": c})
        return res


_MERC_LAT = 85.05112878


def _tile_of(lat, lon, precision):
    """Web-mercator tile (x, y) of points in float64 on the host: the
    plan's tile-id box (reference `aggs/nodes.py:_tile_of`)."""
    n = 1 << precision
    latc = np.clip(lat, -_MERC_LAT, _MERC_LAT)
    x = np.clip(((lon + 180.0) / 360.0 * n).astype(np.int64), 0, n - 1)
    lat_rad = np.deg2rad(latc)
    yf = (1.0 - np.log(np.tan(lat_rad) + 1.0 / np.cos(lat_rad)) / np.pi) / 2.0
    y = np.clip((yf * n).astype(np.int64), 0, n - 1)
    return x, y


def tile_of_device(latv: torch.Tensor, lonv: torch.Tensor, precision: int):
    """The same tile per doc in float32 on the device, in the JAX package's
    operations and order (`log(tan + 1/cos)`)."""
    n_tiles = 1 << precision
    latc = torch.clamp(latv, -_MERC_LAT, _MERC_LAT)
    x = torch.clamp(((lonv + 180.0) / 360.0 * n_tiles).to(torch.int32), 0, n_tiles - 1)
    lat_rad = torch.deg2rad(latc)
    yf = (1.0 - torch.log(torch.tan(lat_rad) + 1.0 / torch.cos(lat_rad)) / np.pi) / 2.0
    y = torch.clamp((yf * n_tiles).to(torch.int32), 0, n_tiles - 1)
    return x, y


class GeotileGridAgg(AggNode):
    """geotile_grid: web-mercator tile buckets at a zoom level (reference
    behavior: bucket/geogrid/GeoTileGridAggregator.java, keys "z/x/y").

    As in the JAX package, the plan's tile-id box is computed on the host in
    float64 from the column's present points (`_tile_of`), while each doc's
    tile is computed on the device in float32 (`tile_of_device`): a doc whose
    float32 tile falls outside the float64 box is not counted. That is the
    reference's behavior, reproduced here. A point on a tile edge may fall
    in the neighbouring tile on the card (its `log`, `tan` and `cos` may
    differ from the CPU's by an ulp)."""

    _MERGE_RULES = {"counts": "sum"}

    def __init__(self, name, fld, precision=7, size=10000, children=None):
        super().__init__(name, children)
        self.fld = fld
        self.precision = int(precision)
        self.size = int(size)
        if not (0 <= self.precision <= 29):
            raise IllegalArgumentError("geotile_grid precision must be in [0, 29]")

    def prepare(self, pack, mappings):
        latc = pack.docvalues.get(f"{self.fld}#lat")
        lonc = pack.docvalues.get(f"{self.fld}#lon")
        self.x0, self.y0, self.nx, self.ny = 0, 0, 1, 1
        if latc is not None and latc.has_value.any():
            xs, ys = _tile_of(np.asarray(latc.values, np.float64),
                              np.asarray(lonc.values, np.float64), self.precision)
            sel = latc.has_value & lonc.has_value
            if sel.any():
                self.x0, self.y0 = int(xs[sel].min()), int(ys[sel].min())
                self.nx = int(xs[sel].max()) - self.x0 + 1
                self.ny = int(ys[sel].max()) - self.y0 + 1
        cparams, ckey = self._prepare_children(pack, mappings)
        return {"children": cparams}, ("geotile", self.fld, self.precision, self.x0,
                                       self.y0, self.nx, self.ny, ckey)

    def device_eval_segmented(self, dev, params, seg, nseg, valid, ctx):
        V = self.nx * self.ny
        if nseg * V > MAX_SEGMENT_PRODUCT:
            raise IllegalArgumentError("geotile_grid bucket budget exceeded")
        lat = dev["dv_float"].get(f"{self.fld}#lat")
        lon = dev["dv_float"].get(f"{self.fld}#lon")
        if lat is None or lon is None:
            return {"counts": _full((nseg, V), 0, torch.int32, seg.device), "children": {}}
        (latv, lath), (lonv, lonh) = lat, lon
        x, y = tile_of_device(latv, lonv, self.precision)
        bx = torch.clamp(x - self.x0, 0, self.nx - 1)
        by = torch.clamp(y - self.y0, 0, self.ny - 1)
        b = (by * self.nx + bx).to(torch.int64)
        ok = (valid & lath & lonh & (x >= self.x0) & (x < self.x0 + self.nx)
              & (y >= self.y0) & (y < self.y0 + self.ny))
        sub = seg * V + b
        counts = _seg_scatter(sub, nseg * V, ok, _ones(seg), 0, "add").reshape(nseg, V)
        return {"counts": counts,
                "children": self._eval_children(dev, {"children": params["children"]}, sub,
                                                nseg * V, ok, ctx)}

    def finalize(self, out, nseg):
        V = self.nx * self.ny
        counts = np.asarray(out["counts"]).reshape(nseg, -1)
        child_frags = self._finalize_children(out, nseg * V) if self.children else None
        res = []
        for i in range(nseg):
            c = counts[i]
            idx = np.argsort(-c, kind="stable")
            idx = idx[c[idx] > 0][: self.size]
            buckets = []
            for j in idx:
                x = self.x0 + int(j) % self.nx
                y = self.y0 + int(j) // self.nx
                bucket = {"key": f"{self.precision}/{x}/{y}", "doc_count": int(c[j])}
                if child_frags is not None:
                    bucket.update(child_frags[i * V + j])
                buckets.append(bucket)
            res.append({"buckets": buckets})
        return res


def _bucket_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _pos_rank(k):
    """Sortable rank for a composite key part (str or number)."""
    return (0, k)


def _neg_rank(k):
    if isinstance(k, str):
        # inverted byte order + a high terminator so prefixes order AFTER
        # their extensions, the mirror of ascending prefix-first order
        return (1, tuple(255 - b for b in k.encode("utf-8")) + (256,))
    return (1, -k)


# ---------------------------------------------------------------------------
# output trees: the nested dicts and lists of tensors that evaluation emits
# ---------------------------------------------------------------------------


def flatten_outputs(tree) -> tuple[list, object]:
    """An output tree -> (its tensors, each at least 1-d, in a fixed order;
    a spec that `unflatten_outputs` rebuilds the tree from)."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x.reshape(-1) if x.dim() == 0 else x)
            return ("t", tuple(x.shape))
        if isinstance(x, dict):
            return ("d", [(k, walk(v)) for k, v in x.items()])
        if isinstance(x, (list, tuple)):
            return ("l", [walk(v) for v in x])
        return ("v", x)

    return leaves, walk(tree)


def unflatten_outputs(spec, arrays) -> object:
    """(spec, host arrays in `flatten_outputs` order) -> the tree of numpy
    arrays."""
    it = iter(arrays)

    def build(s):
        kind, body = s
        if kind == "t":
            return np.asarray(next(it)).reshape(body)
        if kind == "d":
            return {k: build(v) for k, v in body}
        if kind == "l":
            return [build(v) for v in body]
        return body

    return build(spec)


def stack_outputs(trees: list) -> object:
    """Per-shard output trees of one shape -> one tree whose tensors carry a
    leading shard axis (what `merge_partials` reduces)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: stack_outputs([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_outputs([t[i] for t in trees]) for i in range(len(first))]
    return first
