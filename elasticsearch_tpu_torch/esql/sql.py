"""SQL endpoint: SELECT subset translated onto the ES|QL columnar engine.

A copy of the JAX package's `esql/sql.py` (reference behavior: x-pack/plugin/sql
SqlParser -> QueryContainer -> search; response {"columns": [...], "rows":
[...]}). Covered: SELECT cols/aggs/*, FROM one table, WHERE, GROUP BY,
HAVING, ORDER BY (names or select ordinals), LIMIT; SHOW TABLES and
DESCRIBE."""

from __future__ import annotations

import re

from ..utils.errors import IllegalArgumentError
from .engine import execute

_SQL_RE = re.compile(
    r"^\s*select\s+(?P<select>.+?)\s+from\s+(?P<table>[\w.*\-]+)"
    r"(?:\s+where\s+(?P<where>.+?))?"
    r"(?:\s+group\s+by\s+(?P<group>.+?))?"
    r"(?:\s+having\s+(?P<having>.+?))?"
    r"(?:\s+order\s+by\s+(?P<order>.+?))?"
    r"(?:\s+limit\s+(?P<limit>\d+))?\s*;?\s*$",
    re.IGNORECASE | re.DOTALL,
)

_AGG_FNS = ("count", "sum", "avg", "min", "max", "median")


def _meta_command(engine, query: str) -> dict | None:
    """SHOW TABLES / DESCRIBE <table> (reference behavior: x-pack sql
    SysTables/SysColumns commands)."""
    q = query.strip().rstrip(";").strip()
    m = re.match(r"^show\s+tables$", q, re.IGNORECASE)
    if m:
        rows = [["elasticsearch-tpu", name, "TABLE", "INDEX"]
                for name in sorted(engine.indices)]
        return {"columns": [
            {"name": "catalog", "type": "keyword"},
            {"name": "name", "type": "keyword"},
            {"name": "type", "type": "keyword"},
            {"name": "kind", "type": "keyword"},
        ], "rows": rows}
    m = re.match(r"^(?:describe|desc)\s+([\w.\-]+)$", q, re.IGNORECASE)
    if m:
        idx = engine.get_index(m.group(1))
        rows = []
        for fname, ft in sorted(idx.mappings.fields.items()):
            sql_type = {
                "text": "TEXT", "keyword": "VARCHAR", "long": "BIGINT",
                "integer": "INTEGER", "short": "SMALLINT", "byte": "TINYINT",
                "double": "DOUBLE", "float": "REAL", "half_float": "REAL",
                "date": "TIMESTAMP", "boolean": "BOOLEAN",
            }.get(ft.type, ft.type.upper())
            rows.append([fname, sql_type, ft.type])
        return {"columns": [
            {"name": "column", "type": "keyword"},
            {"name": "type", "type": "keyword"},
            {"name": "mapping", "type": "keyword"},
        ], "rows": rows}
    return None


def _split_commas(s: str) -> list[str]:
    out, depth, buf = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(buf).strip())
            buf = []
        else:
            buf.append(ch)
    if buf:
        out.append("".join(buf).strip())
    return out


def _norm_expr(e: str) -> str:
    """SQL expression syntax -> ES|QL (=, <>, 'str' quotes)."""
    out = []
    i = 0
    while i < len(e):
        c = e[i]
        if c == "'":
            j = i + 1
            buf = []
            while j < len(e):
                if e[j] == "'" and j + 1 < len(e) and e[j + 1] == "'":
                    buf.append("'")
                    j += 2
                    continue
                if e[j] == "'":
                    break
                buf.append(e[j])
                j += 1
            out.append('"' + "".join(buf).replace('"', '\\"') + '"')
            i = j + 1
            continue
        if c == "<" and i + 1 < len(e) and e[i + 1] == ">":
            out.append("!=")
            i += 2
            continue
        if c == "=" and (i == 0 or e[i - 1] not in "<>!=") and (
                i + 1 >= len(e) or e[i + 1] != "="):
            out.append("==")
            i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def sql_query(engine, body: dict) -> dict:
    query = (body or {}).get("query")
    if not isinstance(query, str):
        raise IllegalArgumentError("[query] string is required")
    meta = _meta_command(engine, query)
    if meta is not None:
        return meta
    m = _SQL_RE.match(query)
    if m is None:
        raise IllegalArgumentError(f"cannot parse SQL [{query}]")
    table = m.group("table")
    select = _split_commas(m.group("select"))
    group = _split_commas(m.group("group")) if m.group("group") else []
    display: dict[str, str] = {}
    pipeline = [f"FROM {table}"]
    if m.group("where"):
        pipeline.append(f"WHERE {_norm_expr(m.group('where'))}")
    sel_names: list[str] = []
    is_agg_query = bool(group) or any(
        re.match(rf"^\s*({'|'.join(_AGG_FNS)})\s*\(", s, re.IGNORECASE)
        for s in select
    )
    if is_agg_query:
        aggs = []
        norm_to_name = {}
        for s in select:
            am = re.match(r"^(.*?)\s+as\s+(\w+)$", s, re.IGNORECASE)
            alias = None
            if am:
                s, alias = am.group(1).strip(), am.group(2)
            if re.match(rf"^\s*({'|'.join(_AGG_FNS)})\s*\(", s, re.IGNORECASE):
                norm = re.sub(r"\s+", "", s.lower())
                # stats names must be plain identifiers; unaliased aggregates
                # get an internal name and keep the SQL text as display label
                name = alias or f"__a{len(norm_to_name)}"
                display[name] = alias or s.strip()
                aggs.append(f"{name} = {_norm_expr(s.lower())}")
                norm_to_name[norm] = name
                sel_names.append(name)
            else:
                if s not in group:
                    raise IllegalArgumentError(
                        f"[{s}] must appear in GROUP BY or be an aggregate")
                sel_names.append(alias or s)
        having = m.group("having")
        if having:
            # unaliased aggregates in HAVING resolve to (or create) stat
            # columns — the ES|QL WHERE stage has no aggregate functions
            def _sub_agg(am2):
                norm = re.sub(r"\s+", "", am2.group(0).lower())
                name = norm_to_name.get(norm)
                if name is None:
                    name = f"__h{len(norm_to_name)}"
                    aggs.append(f"{name} = {_norm_expr(norm)}")
                    norm_to_name[norm] = name
                return name

            having = re.sub(
                rf"({'|'.join(_AGG_FNS)})\s*\(\s*[^)]*\s*\)",
                _sub_agg, having, flags=re.IGNORECASE)
        stats = "STATS " + ", ".join(aggs)
        if group:
            stats += " BY " + ", ".join(group)
        pipeline.append(stats)
        if having:
            pipeline.append(f"WHERE {_norm_expr(having)}")
    else:
        if select == ["*"]:
            sel_names = []
        else:
            for s in select:
                am = re.match(r"^(.*?)\s+as\s+(\w+)$", s, re.IGNORECASE)
                if am:
                    expr, alias = am.group(1).strip(), am.group(2)
                    pipeline.append(f"EVAL {alias} = {_norm_expr(expr)}")
                    sel_names.append(alias)
                elif re.fullmatch(r"[\w.@]+", s):
                    sel_names.append(s)
                else:
                    name = f"col{len(sel_names)}"
                    pipeline.append(f"EVAL {name} = {_norm_expr(s)}")
                    sel_names.append(name)
    if m.group("order"):
        specs = []
        for part in _split_commas(m.group("order")):
            om = re.match(r"^(.+?)(?:\s+(asc|desc))?$", part.strip(), re.IGNORECASE)
            name = om.group(1).strip()
            if name.isdigit():  # ordinal
                idx = int(name) - 1
                if not (0 <= idx < len(sel_names)):
                    raise IllegalArgumentError(f"invalid ORDER BY ordinal [{name}]")
                name = sel_names[idx]
            d = " DESC" if (om.group(2) or "").lower() == "desc" else ""
            specs.append(name + d)
        pipeline.append("SORT " + ", ".join(specs))
    if m.group("limit"):
        pipeline.append(f"LIMIT {m.group('limit')}")
    if sel_names:
        pipeline.append("KEEP " + ", ".join(sel_names))
    t = execute(engine, " | ".join(pipeline))
    order = sel_names or list(t.columns)
    columns = [{"name": display.get(n, n), "type": t.columns[n].type}
               for n in order]
    rows = []
    for i in range(t.nrows):
        row = []
        for n in order:
            c = t.columns[n]
            if c.null[i]:
                row.append(None)
            else:
                v = c.values[i]
                row.append(v.item() if hasattr(v, "item") else v)
        rows.append(row)
    return {"columns": columns, "rows": rows}
