"""ESQL exchange: per-shard STATS partials and their merge over the shards,
as one torch program on the index's device.

The reference's compute engine splits an ESQL plan into per-shard Driver
pipelines producing Pages, with ExchangeService shuffling partial pages
between drivers and nodes for the final reduce (reference:
x-pack/plugin/esql/compute/.../operator/Driver.java:44,
operator/exchange/ExchangeService.java:49, and the partial->final
aggregation split in AggregatorMode). The JAX package's `esql/exchange.py`
computes each shard's [G] partials with a one-hot [R, G] f64 matmul and
merges them with psum/pmin/pmax. Here:

  - group keys become GLOBAL ordinals on the host (the dictionary union the
    reference builds with global ordinals, `engine.group_keys`);
  - each row's segment is (shard, group); every partial is a segmented
    reduction over those segments, with no [R, G] tensor (at 1M rows and
    60,000 groups an f64 one-hot would be ~480 GB) and no float atomics:
    counts, long min/max and the long hi/lo sums as int64 `index_add_` /
    `scatter_reduce_` (exact); double sums in f64 after a stable sort by
    segment, added pairwise within each segment by a fixed tree of
    elementwise adds (`ops.scoring.segment_sum_pairwise`, the tree every
    float sum of the port takes), so the card and the CPU give the same
    bits; double min/max with `scatter_reduce_` from
    +-inf;
  - the merge adds, mins and maxes the [S, G] partials shard by shard, in
    shard order (the psum/pmin/pmax);
  - long sums are rebuilt from the hi/lo sums in Python ints, so the only
    overflow is the final long value's.

STATS on count/sum/avg/min/max over numeric columns takes this path; the
host evaluator (engine._run_stats) stays the reference semantics for
everything else (median, values(), keyword aggs, ...).
"""

from __future__ import annotations

import numpy as np

from ..ops.scoring import segment_sum_pairwise
from .engine import Column, Table

SUPPORTED = {"count", "sum", "avg", "min", "max"}

_I64_MIN = np.iinfo(np.int64).min
_I64_MAX = np.iinfo(np.int64).max


def _plain_col(args):
    """The column name when the agg argument is a bare column ref (the
    exchange path's supported shape), else None."""
    if args and isinstance(args[0], tuple) and args[0][0] == "col":
        return args[0][1]
    return None


def supported_stats(payload, t: "Table") -> bool:
    """True when every aggregate takes the device partial+exchange path:
    count(*)/count(col), or sum/avg/min/max over a DOUBLE or LONG plain
    column. The routing predicate is the reference's, bounds included, so
    profiles name the same operators on the same input: its long sums split
    each int64 value into hi = v >> 32 (signed) and lo = v & 0xFFFFFFFF
    and sum them in f64, exact while nrows <= 2^20. Here the hi/lo sums are
    int64 and exact either way."""
    if t.nrows >= (1 << 53):  # count exactness bound in f64
        return False
    for _name, call in payload["aggs"]:
        fn, args = call[1], call[2]
        if fn not in SUPPORTED:
            return False
        if fn == "count" and (not args or args[0][0] == "star"):
            continue
        col = _plain_col(args)
        if col is None or col not in t.columns:
            return False
        ty = t.columns[col].type
        if ty == "long":
            # the reference's exactness bound of its f64 hi/lo sums
            if t.nrows > (1 << 20):
                return False
        elif ty != "double":
            return False
    for b in payload["by"]:
        if b not in t.columns:
            return False
    return True


def _numeric(col: Column) -> np.ndarray:
    vals = np.zeros(len(col.null), np.float64)
    ok = ~col.null
    if ok.any():
        src = np.asarray(col.values)
        if src.dtype == object:  # mixed/nullable columns only
            vals[ok] = np.asarray(
                [float(v) for v in src[ok]], np.float64)
        else:
            vals[ok] = src[ok].astype(np.float64)
    return vals


def _long_values(col: Column) -> np.ndarray:
    """The int64 values of a long column, 0 where null."""
    src = np.asarray(col.values)
    if src.dtype.kind not in "iu":  # object/nullable columns
        src = np.array([0 if x is None else int(x) for x in col.values], np.int64)
    return np.where(np.asarray(col.null), 0, src.astype(np.int64))


def _merge(parts, op):
    """[S, ...] partials -> [...], combined shard by shard in shard order."""
    acc = parts[0]
    for s in range(1, parts.shape[0]):
        acc = op(acc, parts[s])
    return acc


def stats_exchange(
    t: Table,
    shard_of: np.ndarray,  # [nrows] shard owning each row
    aggs,  # [(out_name, ("call", fn, args))]
    by: list[str],
    device,
) -> Table:
    """STATS ... BY ... via per-shard partials and their merge."""
    import torch

    from ..telemetry import time_kernel

    S = int(shard_of.max()) + 1 if len(shard_of) else 1

    # ---- global group ordinals (host): the dictionary union --------------
    if by:
        from .engine import group_keys

        keys, uniq = group_keys(t, by)
        gid_of = {k: g for g, k in enumerate(uniq)}
        gids = np.array([gid_of[k] for k in keys], np.int64)
        G = max(len(uniq), 1)
    else:
        uniq = [()]
        gids = np.zeros(t.nrows, np.int64)
        G = 1

    # ---- inputs: one value lane per used column ---------------------------
    val_names = []
    for name, call in aggs:
        args = call[2]
        if call[1] == "count" and (not args or args[0][0] == "star"):
            val_names.append(None)
        else:
            val_names.append(_plain_col(args))
    used = sorted({v for v in val_names if v is not None})
    dbl_cols = [c for c in used if t.columns[c].type != "long"]
    long_cols = [c for c in used if t.columns[c].type == "long"]
    seg_h = shard_of.astype(np.int64) * G + gids  # the row's (shard, group)
    dvals = np.stack([_numeric(t.columns[c]) for c in dbl_cols]) if dbl_cols else None
    lvals = np.stack([_long_values(t.columns[c]) for c in long_cols]) if long_cols else None
    oks = np.stack([~np.asarray(t.columns[c].null) for c in used]) if used else None

    device = torch.device(device)
    nseg = S * G
    R = t.nrows
    with time_kernel("esql.stats_exchange", device, shards=S, rows=R, groups=G,
                     dbl_cols=len(dbl_cols), long_cols=len(long_cols)):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        seg = put(seg_h)
        i64 = dict(dtype=torch.int64, device=device)
        f64 = dict(dtype=torch.float64, device=device)
        rows = torch.zeros(nseg, **i64).index_add_(0, seg, torch.ones(R, **i64))
        ok_d = put(oks) if used else None
        dropped = torch.full_like(seg, nseg)  # a null value's target: dropped
        out_d, out_l = [], []
        if dbl_cols:
            v = put(dvals)
            # one stable sort by segment: each segment's values then add
            # pairwise in row order
            seg_sorted, order = torch.sort(seg, stable=True)
            lengths = torch.bincount(seg, minlength=nseg)
            for ci, c in enumerate(dbl_cols):
                ok = ok_d[used.index(c)]
                tgt = torch.where(ok, seg, dropped)
                cnt = torch.zeros(nseg + 1, **i64).index_add_(0, tgt, ok.to(torch.int64))
                vz = torch.where(ok, v[ci], 0.0)
                ssum = segment_sum_pairwise(vz[order], seg_sorted, lengths)
                vmin = torch.full((nseg + 1,), float("inf"), **f64).scatter_reduce_(
                    0, tgt, v[ci], "amin")
                vmax = torch.full((nseg + 1,), float("-inf"), **f64).scatter_reduce_(
                    0, tgt, v[ci], "amax")
                out_d.append((cnt[:nseg], ssum, vmin[:nseg], vmax[:nseg]))
        if long_cols:
            lv = put(lvals)
            for ci, c in enumerate(long_cols):
                ok = ok_d[used.index(c)]
                tgt = torch.where(ok, seg, dropped)
                z = torch.zeros(nseg + 1, **i64)
                cnt = z.clone().index_add_(0, tgt, ok.to(torch.int64))
                # hi/lo halves: each sum stays far inside int64
                hisum = z.clone().index_add_(0, tgt, torch.bitwise_right_shift(lv[ci], 32))
                losum = z.clone().index_add_(0, tgt, torch.bitwise_and(lv[ci], 0xFFFFFFFF))
                lmin = torch.full((nseg + 1,), _I64_MAX, **i64).scatter_reduce_(
                    0, tgt, lv[ci], "amin")
                lmax = torch.full((nseg + 1,), _I64_MIN, **i64).scatter_reduce_(
                    0, tgt, lv[ci], "amax")
                out_l.append((cnt[:nseg], hisum[:nseg], losum[:nseg], lmin[:nseg],
                              lmax[:nseg]))

        # ---- the exchange: [S, G] partials merged in shard order ------------
        def merged(x, op=torch.add):
            return _merge(x.reshape(S, G), op)

        row_cnt = merged(rows)
        pd = [torch.stack([merged(cnt).to(torch.float64), merged(ssum),
                           merged(vmin, torch.minimum), merged(vmax, torch.maximum)])
              for cnt, ssum, vmin, vmax in out_d]
        pl = [torch.stack([merged(cnt), merged(hs), merged(ls), merged(mn, torch.minimum),
                           merged(mx, torch.maximum)])
              for cnt, hs, ls, mn, mx in out_l]
        row_cnt = row_cnt.cpu().numpy()
        pc = torch.stack(pd).cpu().numpy() if pd else np.zeros((0, 4, G))  # [Cd, 4, G]
        li = torch.stack(pl).cpu().numpy() if pl else np.zeros((0, 5, G), np.int64)

    # ---- finalize --------------------------------------------------------
    dcol_of = {c: i for i, c in enumerate(dbl_cols)}
    lcol_of = {c: i for i, c in enumerate(long_cols)}
    out_cols: dict[str, Column] = {}
    for (name, call), vcol in zip(aggs, val_names):
        fn_name = call[1]
        if fn_name == "count" and vcol is None:
            out_cols[name] = Column(row_cnt.astype(np.int64), np.zeros(G, bool), "long")
            continue
        if vcol in lcol_of:
            cnt, hisum, losum, lmin, lmax = li[lcol_of[vcol]]
            empty = cnt == 0
            if fn_name == "count":
                out_cols[name] = Column(cnt.astype(np.int64), np.zeros(G, bool), "long")
                continue
            if fn_name in ("sum", "avg"):
                # exact reconstruction in Python ints: the only overflow
                # is the FINAL long value, reported like the reference's
                # exact long addition (ESQL SumLongAggregator / Math.addExact)
                sums = [int(h) * (1 << 32) + int(lo)
                        for h, lo in zip(hisum.tolist(), losum.tolist())]
                if fn_name == "sum":
                    if any(not (-(1 << 63) <= v < (1 << 63)) for v in sums):
                        from ..utils.errors import IllegalArgumentError

                        raise IllegalArgumentError("long overflow")
                    out_cols[name] = Column(np.array(sums, np.int64), empty, "long")
                else:
                    avg = np.array([s / max(c, 1) for s, c in zip(sums, cnt.tolist())],
                                   np.float64)
                    out_cols[name] = Column(avg, empty, "double")
                continue
            mm = lmin if fn_name == "min" else lmax
            out_cols[name] = Column(mm.astype(np.int64), empty, "long")
            continue
        cnt, ssum, vmin, vmax = pc[dcol_of[vcol]]
        empty = cnt == 0
        if fn_name == "count":
            out_cols[name] = Column(cnt.astype(np.int64), np.zeros(G, bool), "long")
        elif fn_name == "sum":
            out_cols[name] = Column(ssum.astype(np.float64), empty, "double")
        elif fn_name == "avg":
            avg = np.divide(ssum, np.maximum(cnt, 1))
            out_cols[name] = Column(avg.astype(np.float64), empty, "double")
        elif fn_name == "min":
            out_cols[name] = Column(vmin.astype(np.float64), empty, "double")
        elif fn_name == "max":
            out_cols[name] = Column(vmax.astype(np.float64), empty, "double")
    for bi, b in enumerate(by):
        kv = [k[bi] for k in uniq]
        out_cols[b] = Column(
            np.array(kv, object),
            np.array([v is None for v in kv]),
            t.columns[b].type,
        )
    return Table(out_cols, G)
