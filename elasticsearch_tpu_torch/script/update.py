"""Update scripts: the `ctx._source` mutation subset of Painless.

A copy of the JAX package's `script/update.py`. The reference runs update
scripts (Painless) against a ctx map on the primary (reference behavior:
action/update/UpdateHelper.java `executeScriptedUpsert`, ctx keys `op`,
`_source`; modules/lang-painless), not in the search loop, so this is
host-side work: statements split on `;`, each an assignment to a
`ctx._source` field (a numeric right-hand side compiled with the
expression language, `ctx._source.x` read as `x`; a string or boolean
literal as is), a compound assignment (+=, -=, *=, /=), a `remove(...)`,
or `ctx.op = 'index' | 'noop' | 'none' | 'delete'`. Anything else is a
400. Loops and objects are out of scope, as in the JAX package.
"""

from __future__ import annotations

import re

import numpy as np

from ..utils.errors import IllegalArgumentError
from .expression import compile_script

_ASSIGN = re.compile(
    r"^ctx\._source\.([A-Za-z_][\w.]*)\s*(=|\+=|-=|\*=|/=)\s*(.+)$", re.S
)
_ASSIGN_IDX = re.compile(
    r"^ctx\._source\[\s*['\"]([^'\"]+)['\"]\s*\]\s*(=|\+=|-=|\*=|/=)\s*(.+)$", re.S
)
_REMOVE = re.compile(r"^ctx\._source\.remove\(\s*['\"]([^'\"]+)['\"]\s*\)$")
_OP = re.compile(r"^ctx\.op\s*=\s*['\"](\w+)['\"]$")
_STR_LIT = re.compile(r"^['\"](.*)['\"]$", re.S)
_BOOL_LIT = {"true": True, "false": False}


def _get_path(src: dict, path: str):
    cur = src
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _set_path(src: dict, path: str, value):
    parts = path.split(".")
    cur = src
    for part in parts[:-1]:
        nxt = cur.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[part] = nxt
        cur = nxt
    cur[parts[-1]] = value


def _del_path(src: dict, path: str):
    parts = path.split(".")
    cur = src
    for part in parts[:-1]:
        cur = cur.get(part)
        if not isinstance(cur, dict):
            return
    cur.pop(parts[-1], None)


class UpdateScript:
    """Compiled update script; `apply(source)` mutates in place and returns
    the resulting op: 'index' | 'noop' | 'delete'."""

    def __init__(self, spec):
        if isinstance(spec, str):
            spec = {"source": spec}
        if not isinstance(spec, dict) or "source" not in spec:
            raise IllegalArgumentError("script requires [source]")
        self.params = spec.get("params") or {}
        src = spec["source"]
        self.statements = [s.strip() for s in src.split(";") if s.strip()]
        if not self.statements:
            raise IllegalArgumentError("empty script")

    def _eval_rhs(self, rhs: str, source: dict):
        rhs = rhs.strip()
        m = _STR_LIT.match(rhs)
        if m is not None and rhs.count("'") <= 2 and rhs.count('"') <= 2:
            return m.group(1)
        if rhs in _BOOL_LIT:
            return _BOOL_LIT[rhs]
        # numeric expression: ctx._source.X references become bare names
        expr = re.sub(r"ctx\._source\.([A-Za-z_][\w.]*)", r"\1", rhs)
        cs = compile_script({"source": expr, "params": self.params})
        env = {}
        for f in cs.fields:
            v = _get_path(source, f)
            if isinstance(v, bool):
                v = float(v)
            if isinstance(v, (int, float)):
                env[f] = np.float64(v)
            else:
                env[f] = np.float64(0.0)
        out = float(np.asarray(cs.evaluate(env)))
        return int(out) if out == int(out) else out

    def apply(self, source: dict) -> str:
        op = "index"
        for st in self.statements:
            m = _OP.match(st)
            if m:
                op = m.group(1)
                if op not in ("index", "noop", "none", "delete"):
                    raise IllegalArgumentError(f"invalid ctx.op [{op}]")
                if op == "none":
                    op = "noop"
                continue
            m = _REMOVE.match(st)
            if m:
                _del_path(source, m.group(1))
                continue
            m = _ASSIGN.match(st) or _ASSIGN_IDX.match(st)
            if m:
                path, aop, rhs = m.groups()
                val = self._eval_rhs(rhs, source)
                if aop != "=":
                    cur = _get_path(source, path)
                    cur = float(cur) if isinstance(cur, (int, float)) else 0.0
                    if not isinstance(val, (int, float)):
                        raise IllegalArgumentError(
                            f"compound assignment needs a numeric value for [{path}]"
                        )
                    val = {
                        "+=": cur + val, "-=": cur - val,
                        "*=": cur * val, "/=": cur / val,
                    }[aop]
                    if val == int(val):
                        val = int(val)
                _set_path(source, path, val)
                continue
            raise IllegalArgumentError(f"unsupported update-script statement [{st}]")
        return op
