"""The fetch sub-phases (reference `search/fetch.py`), over a page's final
hits on the host:

- `stored_fields` (behavior: StoredFieldsPhase): a list without `_source`
  drops each hit's source unless `_source` is asked for; `_none_` drops it
  and is a 400 beside an explicit `_source`;
- the `fields` option (behavior: FieldFetcher): each matching source
  path's flattened values, a `date` in the requested or the mapping's
  format, a `date_nanos` in its nanosecond ISO form (`epoch_millis` on
  request), any other value as the source holds it (an ip's sort values
  and agg keys are the canonical addresses of its column);
- `docvalue_fields` (behavior: FetchDocValuesPhase): the same paths over
  fields with doc values (no `text`), a `date` as epoch millis unless a
  format is asked, a DecimalFormat-style pattern ("#.0") on numbers;
- `highlight` (`search/highlight.py`);
- `_source` filtering last (behavior: FetchSourcePhase, includes and
  excludes with wildcards).
"""

from __future__ import annotations

import fnmatch

from ..index.mappings import (format_date_millis, format_date_nanos, parse_date_to_millis,
                              parse_date_to_nanos, parse_date_with_formats)
from ..utils.errors import ElasticsearchTpuError, IllegalArgumentError


def _match_path(path: str, pattern: str) -> bool:
    """ES source-filter matching: a bare object name selects its subtree."""
    return fnmatch.fnmatchcase(path, pattern) or fnmatch.fnmatchcase(path, pattern + ".*")


class _Missing:
    __slots__ = ()


_MISSING = _Missing()


def _filter_node(node, path: str, includes, excludes):
    """Filter a source node -> the kept value or the removal sentinel. An
    excluded path drops its subtree; an emptied container is dropped (but
    the root)."""
    if path and excludes and any(_match_path(path, p) for p in excludes):
        return _MISSING
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            kept = _filter_node(v, f"{path}.{k}" if path else k, includes, excludes)
            if kept is not _MISSING:
                out[k] = kept
        if not path:
            return out
        return out if out else _MISSING
    if isinstance(node, list):
        out_l = []
        for v in node:
            kept = _filter_node(v, path, includes, excludes)
            if kept is not _MISSING:
                out_l.append(kept)
        return out_l if out_l else _MISSING
    return node if not includes or any(_match_path(path, p) for p in includes) else _MISSING


def filter_source(src: dict, source_spec) -> dict | None:
    """Apply a `_source` spec: True/False, "pat", ["p1", "p2"] or
    {"includes": [...], "excludes": [...]}. None when _source is off."""
    if source_spec is None or source_spec is True:
        return src
    if source_spec is False:
        return None
    if isinstance(source_spec, str):
        includes, excludes = [source_spec], []
    elif isinstance(source_spec, list):
        includes, excludes = [str(p) for p in source_spec], []
    elif isinstance(source_spec, dict):
        inc = source_spec.get("includes", source_spec.get("include"))
        exc = source_spec.get("excludes", source_spec.get("exclude"))
        includes = [inc] if isinstance(inc, str) else list(inc or [])
        excludes = [exc] if isinstance(exc, str) else list(exc or [])
    else:
        raise IllegalArgumentError(f"unsupported _source spec {source_spec!r}")
    out = _filter_node(src, "", includes, excludes)
    return out if out is not _MISSING else {}


def flatten_source(src: dict, prefix: str = "") -> dict[str, list]:
    """Leaf values by dotted path, lists flattened (reference
    `search/fetch.py:flatten_source`)."""
    out: dict[str, list] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for v in node:
                walk(v, path)
        else:
            out.setdefault(path, []).append(node)

    walk(src, prefix)
    return out


def _norm_field_specs(specs) -> list[tuple[str, str | None]]:
    out = []
    for s in specs:
        if isinstance(s, str):
            out.append((s, None))
        elif isinstance(s, dict) and "field" in s:
            out.append((s["field"], s.get("format")))
        else:
            raise IllegalArgumentError(f"malformed field spec {s!r}")
    return out


def _format_date(v, fmt: str | None, field_format: str | None = None):
    """A date source value parsed with the mapping's format and rendered in
    the requested one, else the mapping's first."""
    try:
        ms = parse_date_with_formats(v, field_format) if field_format else parse_date_to_millis(v)
    except ElasticsearchTpuError:
        return v
    if fmt == "epoch_millis":
        return ms
    return format_date_millis(ms, fmt if fmt is not None else field_format)


def _format_date_nanos(v, fmt: str | None):
    """A date_nanos value in the nanosecond ISO form
    (strict_date_optional_time_nanos), or epoch millis on request."""
    try:
        nanos = parse_date_to_nanos(v)
    except ElasticsearchTpuError:
        return v
    if fmt == "epoch_millis":
        return nanos // 1_000_000
    return format_date_nanos(nanos)


def fields_option(hit_source: dict, specs, mappings) -> dict[str, list]:
    """The `fields` option: the flattened values of every source path that
    matches a (wildcard) pattern."""
    flat = flatten_source(hit_source or {})
    out: dict[str, list] = {}
    for pattern, fmt in _norm_field_specs(specs):
        for path, values in flat.items():
            if not fnmatch.fnmatchcase(path, pattern):
                continue
            ft = mappings.fields.get(path)
            if ft is not None and ft.type == "date":
                values = [_format_date(v, fmt, ft.format) for v in values]
            elif ft is not None and ft.type == "date_nanos":
                values = [_format_date_nanos(v, fmt) for v in values]
            out.setdefault(path, []).extend(values)
    return out


def docvalue_fields_option(hit_source: dict, specs, mappings) -> dict[str, list]:
    """docvalue_fields: the `fields` option over doc_values fields only."""
    flat = flatten_source(hit_source or {})
    out: dict[str, list] = {}
    for pattern, fmt in _norm_field_specs(specs):
        for path, values in flat.items():
            if not fnmatch.fnmatchcase(path, pattern):
                continue
            ft = mappings.fields.get(path)
            if ft is None or not ft.doc_values or ft.type == "text":
                continue
            if ft.type == "date":
                values = [_format_date(v, fmt or "epoch_millis", ft.format) for v in values]
            elif fmt and set(fmt) <= set("#.0,"):
                # a DecimalFormat-style pattern: "#.0" -> 1 decimal
                decimals = len(fmt.split(".", 1)[1]) if "." in fmt else 0
                values = [f"{float(v):.{decimals}f}" for v in values]
            out.setdefault(path, []).extend(values)
    return out


def _suppresses_source(stored_fields, source_spec) -> bool:
    """The stored_fields gate: `_none_` drops `_source` (a 400 beside an
    explicit `_source`); a list of stored fields drops it unless it names
    `_source` or the body asks for `_source` (behavior:
    StoredFieldsContext)."""
    has_none = stored_fields == "_none_" or (
        isinstance(stored_fields, list) and "_none_" in stored_fields)
    if has_none and source_spec not in (None, False):
        raise IllegalArgumentError("[stored_fields] cannot be disabled if [_source] is requested")
    return has_none or (
        stored_fields is not None and source_spec is None
        and ((isinstance(stored_fields, list) and "_source" not in stored_fields)
             or (isinstance(stored_fields, str) and stored_fields != "_source")))


def apply_fetch_phase(hits: list[dict], body: dict, mappings_of) -> None:
    """Run the fetch sub-phases over the final hits in place, in the
    reference's order: the stored_fields gate, `fields`, `docvalue_fields`,
    `highlight`, then `_source` filtering. `mappings_of(index name)` gives
    a hit's index mappings."""
    from .highlight import highlight_hit

    source_spec = body.get("_source")
    fields = body.get("fields")
    docvalue_fields = body.get("docvalue_fields")
    highlight = body.get("highlight")
    suppress = _suppresses_source(body.get("stored_fields"), source_spec)
    for h in hits:
        mappings = mappings_of(h["_index"])
        src = h.get("_source")
        if fields:
            vals = fields_option(src, fields, mappings)
            if vals:
                h.setdefault("fields", {}).update(vals)
        if docvalue_fields:
            vals = docvalue_fields_option(src, docvalue_fields, mappings)
            if vals:
                h.setdefault("fields", {}).update(vals)
        if highlight:
            hl = highlight_hit(src, highlight, body.get("query"), mappings)
            if hl:
                h["highlight"] = hl
        if suppress or source_spec is False:
            h.pop("_source", None)
        elif source_spec is not None and source_spec is not True:
            h["_source"] = filter_source(src or {}, source_spec)
