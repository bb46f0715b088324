"""The fetch phase's `_source` filtering (reference `search/fetch.py:17-77`,
`:189-238`; behavior: search/fetch/subphase/FetchSourcePhase.java, includes
and excludes with wildcards) and the `fields` option (reference
`:79-162`; behavior: FieldFetcher): each matching source path's flattened
values, a `date` in the requested or the mapping's format, a `date_nanos`
in its nanosecond ISO form (`epoch_millis` on request), any other value as
the source holds it (an ip's sort values and agg keys are the canonical
addresses of its column). `stored_fields`, `docvalue_fields` and `highlight` are not
ported yet and are refused.
"""

from __future__ import annotations

import fnmatch

from ..index.mappings import (format_date_millis, format_date_nanos, parse_date_to_millis,
                              parse_date_to_nanos, parse_date_with_formats)
from ..utils.errors import ElasticsearchTpuError, IllegalArgumentError, not_yet_ported

_NOT_PORTED = ("stored_fields", "docvalue_fields", "highlight")


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


def apply_fetch_phase(hits: list[dict], body: dict, mappings_of=None) -> None:
    """The `fields` option (`mappings_of(index name)` gives a hit's index
    mappings), then each hit's `_source` filtered in place by the body's
    `_source` spec."""
    for key in _NOT_PORTED:
        if body.get(key) is not None:
            raise not_yet_ported(f"[{key}]")
    fields = body.get("fields")
    if fields:
        for h in hits:
            vals = fields_option(h.get("_source"), fields, mappings_of(h["_index"]))
            if vals:
                h.setdefault("fields", {}).update(vals)
    spec = body.get("_source")
    if spec is None or spec is True:
        return
    for h in hits:
        if spec is False:
            h.pop("_source", None)
        else:
            h["_source"] = filter_source(h.get("_source") or {}, spec)
