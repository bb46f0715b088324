"""Plan-shape classification for the serving front end (reference
`serving/coalesce.py`).

A REST search is *wave-eligible* when `EsIndex.search_wave_begin` can serve
it: one concrete target and a request surface the coalescing lanes cover.
Everything else classifies to None and takes the per-request path
unchanged. Classification never raises, so errors (404s, parse errors,
validation) come from the solo path that produces them.
"""

from __future__ import annotations

from ..query.nodes import BoolNode, TermNode
from ..utils.params import bool_param, track_total_hits_param

# body keys that change the engine's execution
_EXEC_KEYS = {"query", "knn", "size", "from", "track_total_hits", "timeout",
              "aggs", "aggregations"}
# applied to the finished response (`search/fetch.py`); their presence does
# not change how the engine executes the search
_FETCH_KEYS = {"_source", "fields", "docvalue_fields", "stored_fields",
               "highlight", "version", "seq_no_primary_term", "explain",
               "indices_boost", "min_score"}
# query params that alter execution in ways the wave path does not replicate
_BLOCKED_PARAMS = {"routing", "scroll", "preference", "q"}


def term_disjunction_of(node):
    """(field, [(term, boost), ...]) when `node` is a pure OR-of-terms the
    batched msearch arms serve exactly (match / term / bool-should-of-terms
    on ONE field, minimum_should_match 1, every boost > 0: the arms'
    'matches == score > 0' contract), else None."""
    if isinstance(node, TermNode):
        if node.boost > 0:
            return node.fld, [(node.term, float(node.boost))]
        return None
    if isinstance(node, BoolNode):
        if node.must or node.filter or node.must_not:
            return None
        if node._msm() != 1 or node.boost != 1.0:
            return None
        fld, terms = None, []
        for c in node.should:
            if not isinstance(c, TermNode) or c.boost <= 0:
                return None
            if fld is None:
                fld = c.fld
            elif c.fld != fld:
                return None
            terms.append((c.term, float(c.boost)))
        if fld is None:
            return None
        return fld, terms
    return None


def classify_request(engine, expression, body, query_params) -> dict | None:
    """-> a serving entry dict, or None when the request must take the
    per-request path. The entry carries what the wave executor needs and
    the fallback context (expression and options) for a solo rerun."""
    try:
        body = body or {}
        if not isinstance(body, dict):
            return None
        if any(k in query_params for k in _BLOCKED_PARAMS):
            return None
        if any(k not in _EXEC_KEYS and k not in _FETCH_KEYS for k in body):
            return None
        if isinstance(expression, str) and ":" in expression:
            return None  # cross-cluster expressions
        iu = bool_param(query_params, "ignore_unavailable")
        ani = bool_param(query_params, "allow_no_indices", True)
        targets = engine.resolve_search(expression, iu, ani)
        if len(targets) != 1:
            return None
        idx, _alias_filter = targets[0]  # aliases are not ported: always None
        return {
            "index": idx.name,
            "kwargs": {
                "query": body.get("query"),
                "knn": body.get("knn"),
                "size": int(query_params.get("size", body.get("size", 10))),
                "from_": int(query_params.get("from", body.get("from", 0))),
                "aggs": body.get("aggs") or body.get("aggregations"),
                "track_total_hits": track_total_hits_param(body, query_params),
            },
            "expression": expression,
            "iu": iu,
            "ani": ani,
        }
    except Exception:  # noqa: BLE001 - never classify by raising
        return None
