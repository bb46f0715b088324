"""ES|QL columnar execution over the port's packs.

A copy of the JAX package's `esql/engine.py` (reference behavior: the ESQL
compute engine's Page/Block batches through Driver pipelines with exchange
operators, x-pack/plugin/esql/compute/.../operator/Driver.java:44,
data/Block.java:38). FROM collects every doc-values column of the matched
indices into one host table of numpy columns; each pipe stage is a
whole-column transform on the host. Two stages run as torch programs on
the index's device when the rows still map to shards: SORT | LIMIT as the
sharded top-n exchange (`topn.py`) and STATS over count/sum/avg/min/max of
numeric columns as the per-shard partials and their merge (`exchange.py`).

Result shape matches the ESQL REST contract:
{"columns": [{"name", "type"}], "values": [[row], ...]}.

Not ported yet: ENRICH (a 400; it needs the enrich policies of `xpack`),
the `esql.<operator>` trace spans (the port has no tracer), and the `mesh`
argument: the S shards of one
index live on one device, which is the reference's `mesh=None` path.
"""

from __future__ import annotations

import fnmatch
import math

import numpy as np

from ..utils.errors import IllegalArgumentError, not_yet_ported
from .parser import parse


class Column:
    """values: numpy array (float64 | int64 | object for strings/bools);
    null: bool mask (True = missing)."""

    __slots__ = ("values", "null", "type")

    def __init__(self, values, null, type_):
        self.values = values
        self.null = null
        self.type = type_

    @classmethod
    def of(cls, values, null=None, type_=None):
        values = np.asarray(values)
        if null is None:
            null = np.zeros(len(values), bool)
        return cls(values, null, type_ or _np_type(values))

    def take(self, idx):
        return Column(self.values[idx], self.null[idx], self.type)


def _np_type(arr) -> str:
    if arr.dtype.kind in "iu":
        return "long"
    if arr.dtype.kind == "f":
        return "double"
    if arr.dtype.kind == "b":
        return "boolean"
    return "keyword"


class Table:
    shard_of = None  # [nrows] owning shard when rows still map 1:1 to docs

    def __init__(self, columns: dict[str, Column], nrows: int):
        self.columns = columns
        self.nrows = nrows

    def take(self, idx):
        return Table({n: c.take(idx) for n, c in self.columns.items()}, len(idx))


def _shard_packs(searcher):
    """-> (the per-shard packs, their doc-values column names, sorted as
    the reference's stacked pack lists them) of a base searcher: a
    one-shard index serves through a `ShardSearcher` (`.pack`), several
    shards through a `StackedSearcher` (`.sp.shards`, with the union of
    their columns in `.sp.global_docvalues`). The names enter FROM's column
    set in this order, which its iteration order follows."""
    sp = getattr(searcher, "sp", None)
    if sp is not None:
        return sp.shards, list(sp.global_docvalues)
    return [searcher.pack], sorted(searcher.pack.docvalues)


def _collect_table(engine, index_expr: str, metadata: list[str]) -> Table:
    """Pull every doc-values column of the matched indices into one global
    columnar table (plus _index and requested metadata columns). The
    reference's per-doc loops (`_id`, text fields from the source, keyword
    values from ordinals) are kept as they are: they are its algorithm."""
    targets = engine.resolve_search(index_expr, allow_no_indices=True)
    col_names: set[str] = set()
    text_fields: set[str] = set()
    packs_of = []
    for idx, _ in targets:
        idx._maybe_refresh()
        # the property merges any tail tiers into one base first
        packs, names = _shard_packs(idx.searcher)
        packs_of.append(packs)
        for f in names:
            if f != "_id":
                col_names.add(f)
        for f, ft in idx.mappings.fields.items():
            if ft.type == "text":
                text_fields.add(f)
    text_fields -= col_names
    parts: dict[str, list] = {n: [] for n in col_names}
    index_col = []
    id_col = []
    shard_col = []
    shard_seq = 0
    total = 0
    for (idx, _), packs in zip(targets, packs_of):
        for s, pack in enumerate(packs):
            live = pack.live
            if pack.num_docs == 0:
                continue
            sel = np.flatnonzero(live)
            total += len(sel)
            index_col.extend([idx.name] * len(sel))
            shard_col.extend([shard_seq] * len(sel))
            shard_seq += 1
            for d in sel:
                id_col.append(idx.shard_docs[s][d][0] if s < len(idx.shard_docs) else "")
            for tf_name in text_fields:
                vals = []
                for d in sel:
                    src = (idx.shard_docs[s][d][1]
                           if s < len(idx.shard_docs) else {})
                    cur = src
                    for part in tf_name.split("."):
                        cur = cur.get(part) if isinstance(cur, dict) else None
                    vals.append(None if cur is None
                                else (cur if isinstance(cur, str) else str(cur)))
                parts.setdefault(tf_name, []).append((
                    Column(np.array(vals, object),
                           np.array([v is None for v in vals]), "keyword"),
                    len(sel)))
            for name in col_names:
                col = pack.docvalues.get(name)
                if col is None:
                    parts[name].append((None, len(sel)))
                    continue
                if col.kind == "ord":
                    terms = col.ord_terms or []
                    vals = np.array(
                        [terms[o] if o >= 0 else None for o in col.values[sel]],
                        object,
                    )
                    null = ~col.has_value[sel]
                    parts[name].append((Column(vals, null, "keyword"), len(sel)))
                else:
                    # the pack's float docvalues are f32: widened to f64
                    t = "long" if col.kind == "int" else "double"
                    parts[name].append(
                        (Column(col.values[sel].astype(
                            np.int64 if col.kind == "int" else np.float64),
                            ~col.has_value[sel], t), len(sel))
                    )
    columns: dict[str, Column] = {}
    for name, chunks in parts.items():
        types = {c.type for c, _ in chunks if c is not None}
        t = (types or {"keyword"}).pop()
        vals_list = []
        null_list = []
        for c, n in chunks:
            if c is None:
                vals_list.append(np.array([None] * n, object) if t == "keyword"
                                 else np.zeros(n, np.float64 if t == "double" else np.int64))
                null_list.append(np.ones(n, bool))
            else:
                vals_list.append(c.values)
                null_list.append(c.null)
        if vals_list:
            columns[name] = Column(
                np.concatenate(vals_list), np.concatenate(null_list), t)
        else:
            columns[name] = Column(np.array([], object), np.array([], bool), t)
    columns["_index"] = Column(np.array(index_col, object),
                               np.zeros(total, bool), "keyword")
    if "_id" in metadata:
        columns["_id"] = Column(np.array(id_col, object),
                                np.zeros(total, bool), "keyword")
    out = Table(columns, total)
    # row -> owning shard, threaded through row-preserving stages so STATS
    # can run the per-shard partial + exchange path (esql/exchange.py)
    out.shard_of = np.asarray(shard_col, np.int32)
    return out


# ---- expression evaluation ------------------------------------------------

def _eval_expr(ast, t: Table):
    """-> Column over t.nrows."""
    kind = ast[0]
    n = t.nrows
    if kind == "lit":
        v = ast[1]
        if v is None:
            return Column(np.zeros(n, np.float64), np.ones(n, bool), "double")
        if isinstance(v, bool):
            return Column.of(np.full(n, v), type_="boolean")
        if isinstance(v, str):
            return Column(np.array([v] * n, object), np.zeros(n, bool), "keyword")
        if isinstance(v, int):
            return Column.of(np.full(n, v, np.int64))
        return Column.of(np.full(n, float(v), np.float64))
    if kind == "col":
        c = t.columns.get(ast[1])
        if c is None:
            raise IllegalArgumentError(f"Unknown column [{ast[1]}]")
        return c
    if kind == "neg":
        c = _eval_expr(ast[1], t)
        return Column(-c.values, c.null, c.type)
    if kind == "bin":
        op, a, b = ast[1], _eval_expr(ast[2], t), _eval_expr(ast[3], t)
        null = a.null | b.null
        av, bv = a.values, b.values
        if a.type == "keyword" or b.type == "keyword":
            if op != "+":
                raise IllegalArgumentError(f"operator [{op}] not valid on text")
            out = np.array([f"{x}{y}" for x, y in zip(av, bv)], object)
            return Column(out, null, "keyword")
        with np.errstate(divide="ignore", invalid="ignore"):
            if op == "+":
                out = av + bv
            elif op == "-":
                out = av - bv
            elif op == "*":
                out = av * bv
            elif op == "/":
                out = np.asarray(av, np.float64) / bv
            else:
                out = np.mod(av, bv)
        bad = ~np.isfinite(np.asarray(out, np.float64))
        return Column(np.where(bad, 0, out), null | bad, _np_type(np.asarray(out)))
    if kind == "cmp":
        op, a, b = ast[1], _eval_expr(ast[2], t), _eval_expr(ast[3], t)
        null = a.null | b.null
        av, bv = a.values, b.values
        if a.type == "keyword" or b.type == "keyword":
            sa = np.array([None if x is None else str(x) for x in av], object)
            sb = np.array([None if x is None else str(x) for x in bv], object)
            eq = np.array([x == y for x, y in zip(sa, sb)], bool)
            if op == "==":
                out = eq
            elif op == "!=":
                out = ~eq
            else:
                out = np.array(
                    [(x is not None and y is not None) and _str_cmp(op, x, y)
                     for x, y in zip(sa, sb)], bool)
        else:
            out = {"==": np.equal, "!=": np.not_equal, "<": np.less,
                   "<=": np.less_equal, ">": np.greater,
                   ">=": np.greater_equal}[op](av, bv)
        return Column(np.where(null, False, out), np.zeros(len(out), bool), "boolean")
    if kind == "and":
        a, b = _eval_expr(ast[1], t), _eval_expr(ast[2], t)
        return Column(a.values.astype(bool) & b.values.astype(bool),
                      np.zeros(t.nrows, bool), "boolean")
    if kind == "or":
        a, b = _eval_expr(ast[1], t), _eval_expr(ast[2], t)
        return Column(a.values.astype(bool) | b.values.astype(bool),
                      np.zeros(t.nrows, bool), "boolean")
    if kind == "not":
        a = _eval_expr(ast[1], t)
        return Column(~a.values.astype(bool), np.zeros(t.nrows, bool), "boolean")
    if kind == "in":
        a = _eval_expr(ast[1], t)
        hits = np.zeros(t.nrows, bool)
        for item in ast[2]:
            hits |= _eval_expr(("cmp", "==", ast[1], item), t).values.astype(bool)
        return Column(hits, np.zeros(t.nrows, bool), "boolean")
    if kind == "like":
        a = _eval_expr(ast[1], t)
        pat = ast[2]
        out = np.array(
            [x is not None and fnmatch.fnmatchcase(str(x), pat) for x in a.values],
            bool)
        return Column(out & ~a.null, np.zeros(t.nrows, bool), "boolean")
    if kind == "isnull":
        a = _eval_expr(ast[1], t)
        neg = ast[2]
        out = ~a.null if neg else a.null
        return Column(out, np.zeros(t.nrows, bool), "boolean")
    if kind == "call":
        return _eval_call(ast[1], ast[2], t)
    raise IllegalArgumentError(f"cannot evaluate ES|QL expression [{kind}]")


def _str_cmp(op, x, y):
    return {"<": x < y, "<=": x <= y, ">": x > y, ">=": x >= y}[op]


def _eval_call(fn, args, t: Table):
    if fn in ("abs", "round", "floor", "ceil", "sqrt", "log10", "to_long",
              "to_double", "to_integer"):
        a = _eval_expr(args[0], t)
        v = np.asarray(a.values, np.float64)
        if fn == "abs":
            out, ty = np.abs(a.values), a.type
        elif fn == "round":
            digits = 0
            if len(args) > 1:
                digits = int(args[1][1])
            out, ty = np.round(v, digits), "double" if digits else "long"
            out = out.astype(np.int64) if not digits else out
        elif fn == "floor":
            out, ty = np.floor(v).astype(np.int64), "long"
        elif fn == "ceil":
            out, ty = np.ceil(v).astype(np.int64), "long"
        elif fn == "sqrt":
            out, ty = np.sqrt(np.maximum(v, 0)), "double"
        elif fn == "log10":
            out, ty = np.log10(np.maximum(v, 1e-300)), "double"
        elif fn in ("to_long", "to_integer"):
            out, ty = v.astype(np.int64), "long"
        else:
            out, ty = v, "double"
        return Column(out, a.null, ty)
    if fn in ("upper", "lower", "trim", "length", "to_string"):
        a = _eval_expr(args[0], t)
        vals = a.values
        if fn == "length":
            out = np.array([len(str(x)) if x is not None else 0 for x in vals], np.int64)
            return Column(out, a.null, "long")
        f = {"upper": lambda s: s.upper(), "lower": lambda s: s.lower(),
             "trim": lambda s: s.strip(), "to_string": str}[fn]
        out = np.array([f(str(x)) if x is not None else None for x in vals], object)
        return Column(out, a.null, "keyword")
    if fn == "concat":
        cols = [_eval_expr(a, t) for a in args]
        null = np.zeros(t.nrows, bool)
        for c in cols:
            null |= c.null
        out = np.array(
            ["".join(str(c.values[i]) for c in cols) for i in range(t.nrows)],
            object)
        return Column(out, null, "keyword")
    if fn == "starts_with":
        a, b = _eval_expr(args[0], t), _eval_expr(args[1], t)
        out = np.array(
            [x is not None and str(x).startswith(str(y))
             for x, y in zip(a.values, b.values)], bool)
        return Column(out, np.zeros(t.nrows, bool), "boolean")
    if fn == "coalesce":
        cols = [_eval_expr(a, t) for a in args]
        out = cols[0]
        vals = out.values.copy()
        null = out.null.copy()
        for c in cols[1:]:
            fill = null & ~c.null
            vals[fill] = c.values[fill]
            null[fill] = False
        return Column(vals, null, out.type)
    if fn == "case":
        # case(cond1, v1, cond2, v2, ..., default?)
        pairs = args
        default = None
        if len(pairs) % 2 == 1:
            default = pairs[-1]
            pairs = pairs[:-1]
        vals = None
        null = np.ones(t.nrows, bool)
        decided = np.zeros(t.nrows, bool)
        ty = "keyword"
        for cond_ast, val_ast in zip(pairs[::2], pairs[1::2]):
            cond = _eval_expr(cond_ast, t).values.astype(bool) & ~decided
            v = _eval_expr(val_ast, t)
            if vals is None:
                vals = v.values.copy()
                ty = v.type
            vals[cond] = v.values[cond]
            null[cond] = v.null[cond]
            decided |= cond
        if default is not None:
            v = _eval_expr(default, t)
            rest = ~decided
            if vals is None:
                vals = v.values.copy()
                ty = v.type
            vals[rest] = v.values[rest]
            null[rest] = v.null[rest]
        return Column(vals if vals is not None else np.zeros(t.nrows), null, ty)
    raise IllegalArgumentError(f"unknown ES|QL function [{fn}]")


# ---- aggregates -----------------------------------------------------------

def _agg_value(fn, args, t: Table, sel: np.ndarray):
    if fn == "count":
        if not args or args[0][0] == "star":
            return int(sel.sum()), "long"
        c = _eval_expr(args[0], t)
        return int((sel & ~c.null).sum()), "long"
    if fn == "count_distinct":
        c = _eval_expr(args[0], t)
        ok = sel & ~c.null
        return int(len(set(c.values[ok].tolist()))), "long"
    c = _eval_expr(args[0], t)
    ok = sel & ~c.null
    if not ok.any():
        return None, "double"
    v = c.values[ok]
    if fn == "sum":
        out = v.sum()
        return (int(out) if c.type == "long" else float(out)), c.type
    if fn == "avg":
        return float(np.asarray(v, np.float64).mean()), "double"
    if fn == "min":
        return (v.min().item() if c.type != "keyword" else sorted(v)[0]), c.type
    if fn == "max":
        return (v.max().item() if c.type != "keyword" else sorted(v)[-1]), c.type
    if fn == "median":
        return float(np.median(np.asarray(v, np.float64))), "double"
    if fn in ("values", "mv_dedupe"):
        return sorted(set(v.tolist())), c.type
    raise IllegalArgumentError(f"unknown ES|QL aggregate [{fn}]")


def group_keys(t: Table, by: list[str]):
    """-> (keys per row, sorted unique keys): THE grouping dictionary,
    shared by the host evaluator and the exchange path so null ordering
    and tie-breaks cannot drift."""
    key_cols = [t.columns[b] for b in by]
    keys = list(zip(*[
        [None if c.null[i] else (c.values[i].item() if hasattr(c.values[i], "item")
                                 else c.values[i]) for i in range(t.nrows)]
        for c in key_cols
    ])) if t.nrows else []
    uniq = sorted(set(keys), key=lambda k: tuple(
        (x is None, x if x is not None else 0) if not isinstance(x, str) else (x is None, x)
        for x in k))
    return keys, uniq


def _run_stats(t: Table, aggs, by: list[str]) -> Table:
    if not by:
        cols = {}
        sel = np.ones(t.nrows, bool)
        for name, call in aggs:
            val, ty = _agg_value(call[1], call[2], t, sel)
            cols[name] = Column(np.array([val], object if ty == "keyword" else None),
                                np.array([val is None]), ty)
        return Table(cols, 1)
    key_cols = []
    for b in by:
        if b not in t.columns:
            raise IllegalArgumentError(f"Unknown column [{b}]")
        key_cols.append(t.columns[b])
    keys, uniq = group_keys(t, by)
    out_cols: dict[str, list] = {b: [] for b in by}
    agg_rows: dict[str, list] = {name: [] for name, _ in aggs}
    agg_types: dict[str, str] = {}
    keys_arr = np.array([hash(k) for k in keys], np.int64) if keys else np.array([], np.int64)
    for k in uniq:
        sel = keys_arr == hash(k)
        # hash collisions: verify exact
        exact = np.array([keys[i] == k for i in np.flatnonzero(sel)])
        idxs = np.flatnonzero(sel)[exact]
        sel2 = np.zeros(t.nrows, bool)
        sel2[idxs] = True
        for b, kv in zip(by, k):
            out_cols[b].append(kv)
        for name, call in aggs:
            val, ty = _agg_value(call[1], call[2], t, sel2)
            agg_rows[name].append(val)
            agg_types[name] = ty
    columns: dict[str, Column] = {}
    for name, _ in aggs:
        vals = agg_rows[name]
        ty = agg_types.get(name, "double")
        columns[name] = Column(np.array(vals, object),
                               np.array([v is None for v in vals]), ty)
    for b, c in zip(by, key_cols):
        vals = out_cols[b]
        columns[b] = Column(np.array(vals, object),
                            np.array([v is None for v in vals]), c.type)
    return Table(columns, len(uniq))


def _run_extract(t: Table, kind: str, payload: dict) -> Table:
    """DISSECT/GROK pipes: per-row pattern extraction into new columns,
    reusing the ingest processors' parsers (reference behavior: ESQL
    Dissect/Grok evals share the grok/dissect libs with ingest)."""
    from ..ingest.processors import (
        DissectProcessor,
        GrokProcessor,
        IngestProcessorError,
    )

    col = t.columns.get(payload["column"])
    if col is None:
        raise IllegalArgumentError(f"Unknown column [{payload['column']}]")
    if kind == "dissect":
        proc = DissectProcessor({"field": "_v", "pattern": payload["pattern"]})
    else:
        proc = GrokProcessor({"field": "_v", "patterns": [payload["pattern"]]})
    rows = []
    new_names: list[str] = []
    for i in range(t.nrows):
        out: dict = {}
        if not col.null[i]:
            ctx = {"_v": str(col.values[i])}
            try:
                proc.process(ctx)
                out = {}

                def _flatten(d, prefix=""):
                    for k2, v2 in d.items():
                        if k2 == "_v" and not prefix:
                            continue
                        if isinstance(v2, dict):
                            _flatten(v2, f"{prefix}{k2}.")
                        else:
                            out[f"{prefix}{k2}"] = v2

                _flatten(ctx)
            except IngestProcessorError:
                out = {}
        rows.append(out)
        for k in out:
            if k not in new_names:
                new_names.append(k)
    for name in new_names:
        vals = [r.get(name) for r in rows]
        is_num = (all(v is None or isinstance(v, (int, float)) for v in vals)
                  and any(v is not None for v in vals))
        if is_num:
            arr = np.array([0 if v is None else v for v in vals], np.float64)
            t.columns[name] = Column(arr, np.array([v is None for v in vals]),
                                     "double")
        else:
            t.columns[name] = Column(
                np.array([None if v is None else str(v) for v in vals], object),
                np.array([v is None for v in vals]), "keyword")
    return t


# ---- driver ---------------------------------------------------------------

def execute(engine, query: str, profile=None, task=None) -> Table:
    """Drive the pipe stages. `profile` is an esql.profile.OperatorProfile
    (always present under esql_query; None for library callers); `task` is
    a cancellable task, checked on every operator boundary so cancellation
    does no further operator work. The exchanges run on `engine.device`."""
    stages = parse(query)
    for kind, _payload in stages:
        if kind == "enrich":
            raise not_yet_ported("ES|QL [ENRICH]")
    t: Table | None = None
    shard_of = None
    si = 0
    while si < len(stages):
        kind, payload = stages[si]
        si += 1
        if task is not None:
            task.ensure_not_cancelled()
        rows_in = 0 if t is None else t.nrows
        # resolve the operator name BEFORE running the stage: the fused
        # SORT|LIMIT and the device-vs-host STATS split are named
        # differently in profiles (reference: TopNOperator vs
        # ValuesSourceReader + exchange operators)
        op = "collect" if kind == "from" else kind
        fused_limit = None
        if kind == "sort" and si < len(stages) and stages[si][0] == "limit":
            # SORT|LIMIT fuses into the sharded top-n exchange when rows
            # still map to shards: per-shard top-n and the merge of the
            # shards' winners on the device (esql/topn.py), equal to the
            # host sort + limit
            from .topn import supported_topn

            if (shard_of is not None and len(shard_of) == t.nrows
                    and t.nrows > 0 and supported_topn(payload, t)):
                fused_limit = stages[si][1]
                si += 1  # the limit stage is consumed by the exchange
                op = "topn_exchange"
        elif kind == "stats":
            from .exchange import supported_stats

            if (shard_of is not None and len(shard_of) == t.nrows
                    and t.nrows > 0 and supported_stats(payload, t)):
                op = "stats_exchange"
        t, shard_of = _run_stage(engine, kind, op, payload, t, shard_of, fused_limit)
        if profile is not None:
            profile.note(op, rows_in, t)
    return t


def _run_stage(engine, kind, op, payload, t, shard_of, fused_limit):
    """One pipe stage -> (table, shard_of)."""
    if op == "topn_exchange":
        from .topn import topn_exchange

        sel = topn_exchange(t, shard_of, payload, fused_limit, engine.device)
        return t.take(sel), shard_of[sel]
    if kind == "from":
        t = _collect_table(engine, ",".join(payload["indices"]),
                           payload["metadata"])
        return t, t.shard_of
    if kind == "row":
        cols = {}
        for name, expr in payload:
            one = Table({}, 1)
            cols[name] = _eval_expr(expr, one)
        return Table(cols, 1), shard_of
    if kind == "where":
        mask = _eval_expr(payload, t).values.astype(bool)
        keep_idx = np.flatnonzero(mask)
        t = t.take(keep_idx)
        if shard_of is not None:
            shard_of = shard_of[keep_idx]
        return t, shard_of
    if kind == "eval":
        for name, expr in payload:
            t.columns[name] = _eval_expr(expr, t)
        return t, shard_of
    if kind == "stats":
        if op == "stats_exchange":
            from .exchange import stats_exchange

            t = stats_exchange(t, shard_of, payload["aggs"],
                               payload["by"], engine.device)
        else:
            t = _run_stats(t, payload["aggs"], payload["by"])
        return t, None
    if kind == "sort":
        order = np.arange(t.nrows)
        for name, desc, nulls_first in reversed(payload):
            c = t.columns.get(name)
            if c is None:
                raise IllegalArgumentError(f"Unknown column [{name}]")
            vals = c.values[order]
            nulls = c.null[order]
            # desc sorts on an inverted key (reversing a stable argsort
            # would flip tie order and break secondary sort keys)
            if c.type == "keyword":
                key = np.array([("" if v is None else str(v)) for v in vals])
                if desc:
                    uniq = np.unique(key)
                    inv = np.searchsorted(uniq, key)
                    rank = np.argsort(-inv, kind="stable")
                else:
                    rank = np.argsort(key, kind="stable")
            elif np.asarray(vals).dtype.kind in "iu":
                # longs sort on exact int64 (a float64 key would merge
                # values above 2^53 into one tie — and diverge from
                # the exact topn exchange); desc via bitwise-not,
                # which reverses int64 order without the overflow of
                # negating INT64_MIN
                ikey = np.asarray(vals, np.int64)
                rank = np.argsort(~ikey if desc else ikey,
                                  kind="stable")
            else:
                nkey = np.asarray(vals, np.float64)
                rank = np.argsort(-nkey if desc else nkey, kind="stable")
            # nulls ordering: default nulls last (asc), first (desc)
            nf = nulls_first if nulls_first is not None else desc
            nn = nulls[rank]
            rank = np.concatenate([rank[nn], rank[~nn]] if nf
                                  else [rank[~nn], rank[nn]])
            order = order[rank]
        t = t.take(order)
        if shard_of is not None:
            shard_of = shard_of[order]
        return t, shard_of
    if kind == "limit":
        t = t.take(np.arange(min(payload, t.nrows)))
        if shard_of is not None:
            shard_of = shard_of[: t.nrows]
        return t, shard_of
    if kind == "keep":
        keep = []
        for pat in payload:
            for name in t.columns:
                if fnmatch.fnmatchcase(name, pat) and name not in keep:
                    keep.append(name)
        return Table({n: t.columns[n] for n in keep}, t.nrows), shard_of
    if kind == "drop":
        for pat in payload:
            for name in [n for n in t.columns if fnmatch.fnmatchcase(n, pat)]:
                del t.columns[name]
        return t, shard_of
    if kind in ("dissect", "grok"):
        return _run_extract(t, kind, payload), shard_of
    if kind == "rename":
        for old, new in payload:
            if old not in t.columns:
                raise IllegalArgumentError(f"Unknown column [{old}]")
            t.columns = {
                (new if n == old else n): c for n, c in t.columns.items()
            }
        return t, shard_of
    return t, shard_of


def esql_query(engine, body: dict, task=None, tenant=None) -> dict:
    """POST /_query: drive the pipe under an OperatorProfile (always: the
    breaker, the metrics and the recorder hold for every query; `"profile":
    true` also returns the profile body), with cancellation checked between
    operators when a task is passed. The query's wall is metered to
    `tenant` (the request's X-Opaque-Id; None: the default tenant)."""
    from .profile import OperatorProfile, recorder_for

    query = (body or {}).get("query")
    if not isinstance(query, str):
        raise IllegalArgumentError("[query] string is required")
    prof = OperatorProfile(query, breakers=getattr(engine, "breakers", None),
                           device=getattr(engine, "device", None))
    rec = recorder_for(engine)
    try:
        t = execute(engine, query, profile=prof, task=task)
    except BaseException as exc:
        from ..common.breaker import CircuitBreakingError

        summary = prof.finish()  # releases reservations; contiguity holds
        rec.record(summary, tripped=isinstance(exc, CircuitBreakingError))
        _note_query_metrics(engine, summary, tenant)
        raise
    summary = prof.finish()
    rec.record(summary)
    _note_query_metrics(engine, summary, tenant)
    columns = [{"name": n, "type": c.type} for n, c in t.columns.items()]
    values = []
    for i in range(t.nrows):
        row = []
        for c in t.columns.values():
            if c.null[i]:
                row.append(None)
            else:
                v = c.values[i]
                if hasattr(v, "item"):
                    v = v.item()
                if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
                    v = None
                row.append(v)
        values.append(row)
    out = {"took": int(summary["wall_ms"]), "columns": columns,
           "values": values}
    if (body or {}).get("profile"):
        out["profile"] = {k: summary[k] for k in
                          ("query", "wall_ms", "rows", "peak_live_bytes",
                           "dominant_operator", "drivers")}
    return out


def _note_query_metrics(engine, summary: dict, tenant=None) -> None:
    """Per-query accounting: the es.esql.* histograms and counters, and the
    query's wall as one metered wave of `tenant` in the engine's
    `TenantMeter` (reference `esql/engine.py:785-800`), its bytes the
    operators' materialized bytes, its kernel split the operators' ms.
    Never fails a query."""
    from ..telemetry import metrics

    try:
        metrics.counter_inc("es.esql.queries")
        metrics.histogram_record("es.esql.query_ms", summary["wall_ms"])
        metrics.histogram_record("es.esql.rows", float(summary["rows"]))
        metrics.histogram_record("es.esql.peak_bytes",
                                 float(summary["peak_live_bytes"]))
        per_op: dict[str, float] = {}
        bytes_total = 0.0
        for d in summary["drivers"]:
            for o in d["operators"]:
                per_op[o["operator"]] = (per_op.get(o["operator"], 0.0)
                                         + o["took_ms"])
                bytes_total += float(o["bytes_materialized"])
        for name, ms in per_op.items():
            metrics.counter_inc(f"es.esql.operator_ms.{name}", ms)
        meter = getattr(engine, "metering", None)
        wall = summary["wall_ms"]
        if meter is not None and wall > 0.0:
            from ..tenancy.metering import normalize_tenant

            t = normalize_tenant(tenant)
            meter.record_wave({t: wall}, requests={t: 1},
                              cost={t: {"flops": 0.0, "bytes": bytes_total,
                                        "kernels": {f"esql.{k}": v for k, v in per_op.items()}}})
    except Exception:  # noqa: BLE001 - accounting never fails a query
        return
