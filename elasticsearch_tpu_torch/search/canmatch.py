"""Can-match pre-filter: skip an index whose docs provably match nothing.

Counterpart of the JAX package's `search/canmatch.py` (behavior:
CanMatchPreFilterSearchPhase, field min/max pruning before the query
phase). The unit is the index, as in the reference: its shards run as one
program on the card, so skipping one of them saves nothing. The bounds are
the docvalue columns' `vmin` / `vmax` (`index/pack.py`), computed at pack
build.

Conservative: only a top-level `range` and the ranges a `bool` requires
(must / filter, recursively, and a `constant_score` filter) prune; anything
else can match. A required range on an unmapped field, or on a field with no
value in the index, matches nothing, as in the reference.

Errors: an index with no searchable state yet can match (the search itself
decides), and a bound that does not parse for its field can match, as in
the reference. The reference also answers "can match" to any exception of
its refresh; the port lets a refresh or merge that fails propagate, so a
kernel build or launch error on the card is never taken for a match.
"""

from __future__ import annotations

from ..utils.errors import ElasticsearchTpuError


def _required_ranges(query: dict | None, out: list) -> None:
    """Collect the range clauses every matching doc must satisfy."""
    if not isinstance(query, dict) or len(query) != 1:
        return
    (kind, body), = query.items()
    if kind == "range" and isinstance(body, dict) and len(body) == 1:
        (fld, spec), = body.items()
        if isinstance(spec, dict):
            out.append((fld, spec))
    elif kind == "bool" and isinstance(body, dict):
        for sect in ("must", "filter"):
            clauses = body.get(sect)
            if isinstance(clauses, dict):
                clauses = [clauses]
            for c in clauses or []:
                _required_ranges(c, out)
    elif kind == "constant_score" and isinstance(body, dict):
        _required_ranges(body.get("filter"), out)


def _packs(idx) -> list:
    """The packs of the index's merged searcher (the tiers merge first, as
    the reference's `idx.searcher` does)."""
    searcher = idx.searcher
    sp = getattr(searcher, "sp", None)
    return list(sp.shards) if sp is not None else [searcher.pack]


def can_match(idx, query: dict | None) -> bool:
    """False only when the query provably matches no document of `idx`."""
    ranges: list = []
    _required_ranges(query, ranges)
    if not ranges:
        return True
    idx._maybe_refresh()
    if idx._searcher is None:
        return True  # no searchable state yet: the search itself decides
    packs = _packs(idx)
    from ..query.dsl import _coerce_for_field

    for fld, spec in ranges:
        if idx.mappings.fields.get(fld) is None:
            return False  # unmapped field: a required range matches nothing
        cols = [p.docvalues.get(fld) for p in packs]
        cols = [c for c in cols if c is not None and bool(c.has_value.any())]
        if not cols:
            return False  # the field has no value anywhere in this index
        vmin = min(c.vmin for c in cols)
        vmax = max(c.vmax for c in cols)
        for op in ("gte", "gt", "lte", "lt"):
            if op not in spec:
                continue
            try:
                kind, v = _coerce_for_field(idx.mappings, fld, spec[op])
            except (ElasticsearchTpuError, ValueError, TypeError):
                return True  # an unparseable bound: the search itself decides
            if kind not in ("int", "float"):
                return True  # ordinal and ip bounds are not pruned here
            if op == "gte" and vmax < v:
                return False
            if op == "gt" and vmax <= v:
                return False
            if op == "lte" and vmin > v:
                return False
            if op == "lt" and vmin >= v:
                return False
    return True
