"""ES|QL parser: pipe pipeline -> stage list with expression ASTs.

A copy of the JAX package's `esql/parser.py` (reference: the ESQL grammar,
x-pack/plugin/esql/src/main/antlr/EsqlBaseParser.g4). Covered subset:
FROM (+METADATA _id), ROW, WHERE, EVAL, STATS ... BY, SORT, LIMIT, KEEP,
DROP, RENAME ... AS ..., DISSECT, GROK, ENRICH, with arithmetic,
comparison and boolean expressions, IN, LIKE, IS [NOT] NULL, and the core
scalar and aggregate functions."""

from __future__ import annotations

import re

from ..utils.errors import IllegalArgumentError


class EsqlParseError(IllegalArgumentError):
    pass


_TOK = re.compile(
    r"""\s*(?:
        (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
      | (?P<str>"(?:[^"\\]|\\.)*")
      | (?P<name>[A-Za-z_@][A-Za-z0-9_.@*]*)
      | (?P<op>==|!=|<=|>=|->|[|,()=<>+\-*/%])
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "from", "row", "where", "eval", "stats", "by", "sort", "limit", "keep",
    "drop", "rename", "as", "asc", "desc", "and", "or", "not", "in", "like",
    "is", "null", "nulls", "first", "last", "metadata", "true", "false",
    "dissect", "grok", "enrich", "on", "with",
}


def tokenize(src: str):
    out = []
    pos = 0
    while pos < len(src):
        m = _TOK.match(src, pos)
        if m is None or m.end() == pos:
            if src[pos:].strip() == "":
                break
            raise EsqlParseError(f"cannot parse ES|QL near: {src[pos:pos+20]!r}")
        pos = m.end()
        if m.group("num") is not None:
            n = m.group("num")
            out.append(("num", float(n) if ("." in n or "e" in n.lower()) else int(n)))
        elif m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1].replace('\\"', '"')))
        elif m.group("name") is not None:
            name = m.group("name")
            low = name.lower()
            out.append(("kw", low) if low in _KEYWORDS else ("name", name))
        else:
            out.append(("op", m.group("op")))
    return out


class _P:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def accept(self, kind, val=None):
        k, v = self.peek()
        if k == kind and (val is None or v == val):
            self.i += 1
            return v
        return None

    def expect(self, kind, val=None):
        got = self.accept(kind, val)
        if got is None:
            k, v = self.peek()
            raise EsqlParseError(f"expected {val or kind}, got {v!r}")
        return got

    # ---- expressions (precedence climbing) -------------------------------

    def expr(self):
        return self._or()

    def _or(self):
        left = self._and()
        while self.accept("kw", "or"):
            left = ("or", left, self._and())
        return left

    def _and(self):
        left = self._not()
        while self.accept("kw", "and"):
            left = ("and", left, self._not())
        return left

    def _not(self):
        if self.accept("kw", "not"):
            return ("not", self._not())
        return self._cmp()

    def _cmp(self):
        left = self._add()
        k, v = self.peek()
        if k == "op" and v in ("==", "!=", "<", "<=", ">", ">="):
            self.i += 1
            return ("cmp", v, left, self._add())
        if k == "kw" and v == "in":
            self.i += 1
            self.expect("op", "(")
            items = [self._add()]
            while self.accept("op", ","):
                items.append(self._add())
            self.expect("op", ")")
            return ("in", left, items)
        if k == "kw" and v == "like":
            self.i += 1
            kk, pat = self.next()
            if kk != "str":
                raise EsqlParseError("LIKE requires a string pattern")
            return ("like", left, pat)
        if k == "kw" and v == "is":
            self.i += 1
            neg = self.accept("kw", "not") is not None
            self.expect("kw", "null")
            return ("isnull", left, neg)
        return left

    def _add(self):
        left = self._mul()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.i += 1
                left = ("bin", v, left, self._mul())
            else:
                return left

    def _mul(self):
        left = self._unary()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/", "%"):
                self.i += 1
                left = ("bin", v, left, self._unary())
            else:
                return left

    def _unary(self):
        if self.accept("op", "-"):
            return ("neg", self._unary())
        return self._primary()

    def _primary(self):
        k, v = self.next()
        if k == "num":
            return ("lit", v)
        if k == "str":
            return ("lit", v)
        if k == "kw" and v in ("true", "false"):
            return ("lit", v == "true")
        if k == "kw" and v == "null":
            return ("lit", None)
        if k == "op" and v == "(":
            e = self.expr()
            self.expect("op", ")")
            return e
        if k == "name":
            if self.accept("op", "("):
                args = []
                if not self.accept("op", ")"):
                    k2, v2 = self.peek()
                    if k2 == "op" and v2 == "*":
                        self.i += 1
                        args.append(("star",))
                    else:
                        args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    self.expect("op", ")")
                return ("call", v.lower(), args)
            return ("col", v)
        raise EsqlParseError(f"unexpected token {v!r}")

    def name_list(self):
        names = [self.expect("name")]
        while self.accept("op", ","):
            names.append(self.expect("name"))
        return names


def parse(src: str) -> list[tuple]:
    """-> [(stage_kind, payload), ...] starting with from/row."""
    stages = []
    for i, part in enumerate(_split_pipes(src)):
        p = _P(tokenize(part))
        k, v = p.next()
        if i == 0:
            if (k, v) == ("kw", "from"):
                names = p.name_list()
                meta = []
                if p.accept("kw", "metadata"):
                    meta = p.name_list()
                stages.append(("from", {"indices": names, "metadata": meta}))
            elif (k, v) == ("kw", "row"):
                stages.append(("row", _assign_list(p)))
            else:
                raise EsqlParseError("ES|QL must start with FROM or ROW")
            continue
        if (k, v) == ("kw", "where"):
            stages.append(("where", p.expr()))
        elif (k, v) == ("kw", "eval"):
            stages.append(("eval", _assign_list(p)))
        elif (k, v) == ("kw", "stats"):
            aggs = _agg_list(p)
            by = []
            if p.accept("kw", "by"):
                by = p.name_list()
            stages.append(("stats", {"aggs": aggs, "by": by}))
        elif (k, v) == ("kw", "sort"):
            specs = []
            while True:
                name = p.expect("name")
                desc = False
                if p.accept("kw", "desc"):
                    desc = True
                else:
                    p.accept("kw", "asc")
                nulls_first = None
                if p.accept("kw", "nulls"):
                    nulls_first = p.accept("kw", "first") is not None
                    if nulls_first is False:
                        p.accept("kw", "last")
                specs.append((name, desc, nulls_first))
                if not p.accept("op", ","):
                    break
            stages.append(("sort", specs))
        elif (k, v) == ("kw", "limit"):
            kk, n = p.next()
            if kk != "num":
                raise EsqlParseError("LIMIT requires a number")
            stages.append(("limit", int(n)))
        elif (k, v) == ("kw", "keep"):
            stages.append(("keep", p.name_list()))
        elif (k, v) == ("kw", "drop"):
            stages.append(("drop", p.name_list()))
        elif (k, v) in (("kw", "dissect"), ("kw", "grok")):
            col = p.expect("name")
            kk, pat = p.next()
            if kk != "str":
                raise EsqlParseError(f"{v.upper()} requires a quoted pattern")
            stages.append((v, {"column": col, "pattern": pat}))
        elif (k, v) == ("kw", "enrich"):
            policy = p.expect("name")
            # policy names may contain hyphens, which tokenize as minus
            while p.peek() == ("op", "-"):
                p.next()
                policy += "-" + p.expect("name")
            p.expect("kw", "on")
            match_col = p.expect("name")
            fields = None
            if p.accept("kw", "with"):
                fields = p.name_list()
            stages.append(("enrich", {"policy": policy, "on": match_col,
                                      "with": fields}))
        elif (k, v) == ("kw", "rename"):
            pairs = []
            while True:
                old = p.expect("name")
                p.expect("kw", "as")
                new = p.expect("name")
                pairs.append((old, new))
                if not p.accept("op", ","):
                    break
            stages.append(("rename", pairs))
        else:
            raise EsqlParseError(f"unknown ES|QL command [{v}]")
        if p.peek()[0] is not None:
            raise EsqlParseError(f"trailing input in ES|QL stage: {part!r}")
    return stages


def _split_pipes(src: str) -> list[str]:
    """Split on | outside quotes."""
    parts = []
    buf = []
    in_str = False
    i = 0
    while i < len(src):
        c = src[i]
        if in_str:
            buf.append(c)
            if c == "\\" and i + 1 < len(src):
                buf.append(src[i + 1])
                i += 1
            elif c == '"':
                in_str = False
        elif c == '"':
            in_str = True
            buf.append(c)
        elif c == "|":
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        i += 1
    parts.append("".join(buf))
    return [p for p in (s.strip() for s in parts) if p]


def _assign_list(p: _P) -> list[tuple[str, tuple]]:
    out = []
    while True:
        name = p.expect("name")
        p.expect("op", "=")
        out.append((name, p.expr()))
        if not p.accept("op", ","):
            break
    return out


def _agg_list(p: _P) -> list[tuple[str, tuple]]:
    """[(out_name, call_ast)] — `name = fn(...)` or bare `fn(...)`."""
    out = []
    while True:
        save = p.i
        name = p.accept("name")
        if name is not None and p.accept("op", "="):
            expr = p.expr()
        else:
            p.i = save
            expr = p.expr()
            if expr[0] == "call":
                arg0 = expr[2][0] if expr[2] else ("star",)
                argname = arg0[1] if arg0[0] == "col" else "*"
                name = f"{expr[1]}({argname})"
            else:
                raise EsqlParseError("STATS requires aggregate function calls")
        out.append((name, expr))
        if not p.accept("op", ","):
            break
    return out
