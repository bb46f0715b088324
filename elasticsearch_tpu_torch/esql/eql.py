"""EQL: event query language over timestamp-ordered events.

A copy of the JAX package's `esql/eql.py` (reference behavior:
x-pack/plugin/eql: event queries `category where condition`, sequences
`sequence by field [q1] [q2] ... [until q]` with maxspan; response
hits.events / hits.sequences). Conditions reuse the ES|QL expression
parser and evaluator over the same columnar table; sequence matching is
the host-side state machine the reference runs on the coordinator."""

from __future__ import annotations

import re

import numpy as np

from ..utils.errors import IllegalArgumentError
from .engine import Table, _collect_table, _eval_expr
from .parser import _P, tokenize

_SEQ_RE = re.compile(
    r"^\s*sequence(?:\s+by\s+(?P<by>[\w.@,\s]+?))?"
    r"(?:\s+with\s+maxspan\s*=\s*(?P<span>\w+))?\s*"
    r"(?P<rest>(?:\[[^\]]*\](?:\s+with\s+runs\s*=\s*\d+)?\s*)+?)"
    r"(?:until\s*\[(?P<until>[^\]]*)\])?\s*$",
    re.IGNORECASE | re.DOTALL,
)
_STEP_RE = re.compile(r"\[([^\]]*)\](?:\s+with\s+runs\s*=\s*(\d+))?",
                      re.IGNORECASE)


def _parse_condition(text: str):
    """`category where cond` -> (category|None, cond_ast|None)."""
    m = re.match(r"^\s*(?:(?P<cat>[\w.*]+)\s+)?where\s+(?P<cond>.+)$",
                 text.strip(), re.IGNORECASE | re.DOTALL)
    if m is None:
        raise IllegalArgumentError(f"cannot parse EQL condition [{text}]")
    cat = m.group("cat")
    cond_src = m.group("cond").strip()
    ast = None
    if cond_src.lower() != "true":
        p = _P(tokenize(cond_src))
        ast = p.expr()
        if p.peek()[0] is not None:
            raise IllegalArgumentError(f"trailing input in EQL condition [{cond_src}]")
    return (None if cat in (None, "any", "*") else cat), ast


def _event_mask(t: Table, cat, ast) -> np.ndarray:
    mask = np.ones(t.nrows, bool)
    if cat is not None:
        c = t.columns.get("event.category")
        if c is None:
            return np.zeros(t.nrows, bool)
        mask &= np.array([v == cat for v in c.values], bool) & ~c.null
    if ast is not None:
        mask &= _eval_expr(ast, t).values.astype(bool)
    return mask


def _events_payload(t: Table, idxs) -> list[dict]:
    out = []
    for i in idxs:
        src = {}
        for name, c in t.columns.items():
            if name.startswith("_"):
                continue
            if not c.null[i]:
                v = c.values[i]
                src[name] = v.item() if hasattr(v, "item") else v
        out.append({
            "_index": t.columns["_index"].values[i],
            "_id": t.columns["_id"].values[i] if "_id" in t.columns else str(i),
            "_source": src,
        })
    return out


def eql_search(engine, index_expr: str, body: dict) -> dict:
    query = (body or {}).get("query")
    if not isinstance(query, str):
        raise IllegalArgumentError("[query] string is required")
    ts_field = (body or {}).get("timestamp_field", "@timestamp")
    size = int((body or {}).get("size", 10))
    t = _collect_table(engine, index_expr, ["_id"])
    ts = t.columns.get(ts_field)
    if ts is None:
        raise IllegalArgumentError(
            f"EQL requires the timestamp field [{ts_field}]")
    order = np.argsort(np.asarray(ts.values, np.int64), kind="stable")
    t = t.take(order)

    m = _SEQ_RE.match(query)
    if m is None:
        cat, ast = _parse_condition(query)
        hits = np.flatnonzero(_event_mask(t, cat, ast))[:size]
        return {
            "is_partial": False, "is_running": False, "timed_out": False,
            "hits": {
                "total": {"value": int(_event_mask(t, cat, ast).sum()),
                          "relation": "eq"},
                "events": _events_payload(t, hits),
            },
        }
    # sequence
    by = [b.strip() for b in (m.group("by") or "").split(",") if b.strip()]
    span_ms = None
    if m.group("span"):
        from ..utils.durations import parse_duration_millis

        span_ms = parse_duration_millis(m.group("span"))
    steps = []
    for cond_text, runs in _STEP_RE.findall(m.group("rest")):
        parsed = _parse_condition(cond_text)
        # `with runs=N` repeats the step N times (consecutive matches)
        for _ in range(max(1, int(runs or 1))):
            steps.append(parsed)
    if len(steps) < 2:
        raise IllegalArgumentError("sequence requires at least 2 steps")
    masks = [_event_mask(t, cat, ast) for cat, ast in steps]
    until_mask = None
    if m.group("until"):
        ucat, uast = _parse_condition(m.group("until"))
        until_mask = _event_mask(t, ucat, uast)
    ts_vals = np.asarray(t.columns[ts_field].values, np.int64)

    def key_of(i):
        parts = []
        for b in by:
            c = t.columns.get(b)
            parts.append(None if c is None or c.null[i] else
                         (c.values[i].item() if hasattr(c.values[i], "item")
                          else c.values[i]))
        return tuple(parts)

    # state machine per join key: partial[k] = (next_step, first_ts, events)
    partial: dict = {}
    sequences = []
    for i in range(t.nrows):
        k = key_of(i)
        st = partial.get(k)
        if st is not None:
            step, first_ts, events = st
            if span_ms is not None and ts_vals[i] - first_ts > span_ms:
                partial.pop(k)
                st = None
            elif masks[step][i]:
                # a step match consumes the event even when it also matches
                # `until` (sequence steps take priority)
                events = events + [i]
                if step + 1 == len(steps):
                    sequences.append((k, events))
                    partial.pop(k)
                else:
                    partial[k] = (step + 1, first_ts, events)
                continue
            elif until_mask is not None and until_mask[i]:
                # an `until` event expires the key's in-flight sequence
                partial.pop(k)
                st = None
        if masks[0][i]:
            if len(steps) == 1:
                sequences.append((k, [i]))
            else:
                partial[k] = (1, ts_vals[i], [i])
    out = []
    for k, events in sequences[:size]:
        out.append({
            "join_keys": list(k),
            "events": _events_payload(t, events),
        })
    return {
        "is_partial": False, "is_running": False, "timed_out": False,
        "hits": {
            "total": {"value": len(sequences), "relation": "eq"},
            "sequences": out,
        },
    }
