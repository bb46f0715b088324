"""The fetch phase's `_source` filtering (reference `search/fetch.py:17-77`,
`:189-238`; behavior: search/fetch/subphase/FetchSourcePhase.java, includes
and excludes with wildcards). `stored_fields`, `docvalue_fields`, `fields`
and `highlight` are not ported yet and are refused.
"""

from __future__ import annotations

import fnmatch

from ..utils.errors import IllegalArgumentError, not_yet_ported

_NOT_PORTED = ("stored_fields", "docvalue_fields", "fields", "highlight")


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


def apply_fetch_phase(hits: list[dict], body: dict) -> None:
    """Filter each hit's `_source` in place by the body's `_source` spec."""
    for key in _NOT_PORTED:
        if body.get(key) is not None:
            raise not_yet_ported(f"[{key}]")
    spec = body.get("_source")
    if spec is None or spec is True:
        return
    for h in hits:
        if spec is False:
            h.pop("_source", None)
        else:
            h["_source"] = filter_source(h.get("_source") or {}, spec)
