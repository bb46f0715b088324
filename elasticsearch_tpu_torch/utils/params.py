"""Request-parameter helpers shared by the REST layer and the serving
classifier (reference `rest/app.py:31-51`), so both read a parameter the
same way."""

from __future__ import annotations

from .errors import IllegalArgumentError


def track_total_hits_param(body: dict, query_params) -> bool | int | None:
    v = body.get("track_total_hits")
    if v is None:
        raw = query_params.get("track_total_hits")
        if raw is None:
            return None
        v = True if raw in ("", "true") else False if raw == "false" else raw
    if isinstance(v, bool):
        return v
    try:
        return int(v)
    except (TypeError, ValueError):
        raise IllegalArgumentError(
            f"[track_total_hits] must be a boolean or an integer, got [{v}]") from None


def bool_param(query_params, name: str, default: bool = False) -> bool:
    v = query_params.get(name)
    if v is None:
        return default
    return v in ("", "true", "1")
