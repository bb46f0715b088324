"""Search templates: mustache-lite rendering of stored and inline templates.

Counterpart of the JAX package's `search/templates.py` (behavior:
modules/lang-mustache MustacheScriptEngine; rest-api-spec
search_template.json, render_search_template.json). The subset covers what
search templates use: `{{var}}` substitution with dotted paths,
`{{#toJson}}var{{/toJson}}`, and `{{^var}}default{{/var}}` inverted
sections. A stored template is looked up in `Engine.stored_scripts`, which
the port keeps in memory only (the reference saves its metadata store to
its data path).
"""

from __future__ import annotations

import json
import re

from ..utils.errors import IllegalArgumentError, ResourceNotFoundError

_TOJSON = re.compile(r"\{\{#toJson\}\}\s*([\w.]+)\s*\{\{/toJson\}\}")
_INVERTED = re.compile(r"\{\{\^([\w.]+)\}\}(.*?)\{\{/\1\}\}", re.DOTALL)
_VAR = re.compile(r"\{\{([\w.]+)\}\}")


def _lookup(params: dict, path: str):
    cur = params
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def render_template(source, params: dict | None) -> str:
    """-> the rendered JSON text of the search body."""
    params = params or {}
    if isinstance(source, dict):
        source = json.dumps(source)
    if not isinstance(source, str):
        raise IllegalArgumentError("template [source] must be a string or object")

    def sub_tojson(m):
        return json.dumps(_lookup(params, m.group(1)))

    def sub_inverted(m):
        return "" if _lookup(params, m.group(1)) is not None else m.group(2)

    def sub_var(m):
        v = _lookup(params, m.group(1))
        if v is None:
            return ""
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)):
            return json.dumps(v)
        # string content escaped for substitution inside a JSON string
        return json.dumps(str(v))[1:-1]

    out = _TOJSON.sub(sub_tojson, source)
    out = _INVERTED.sub(sub_inverted, out)
    return _VAR.sub(sub_var, out)


def resolve_template(store, body: dict) -> tuple[str, dict]:
    """A search-template request -> (rendered JSON, parsed body). `store`
    holds the stored scripts (`store.stored_scripts`: id -> {"lang",
    "source"})."""
    params = body.get("params") or {}
    if body.get("id"):
        stored = store.stored_scripts.get(body["id"])
        if stored is None:
            raise ResourceNotFoundError(f"stored script [{body['id']}] not found")
        source = stored.get("source")
    else:
        source = body.get("source")
        if source is None:
            raise IllegalArgumentError("search template requires [source] or [id]")
    rendered = render_template(source, params)
    try:
        parsed = json.loads(rendered)
    except json.JSONDecodeError as ex:
        raise IllegalArgumentError(f"rendered template is not valid JSON: {ex}") from None
    return rendered, parsed
