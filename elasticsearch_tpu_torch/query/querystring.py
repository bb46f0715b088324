"""Lucene query-string syntax -> Query DSL dicts.

This package's copy of the JAX package's `query/querystring.py`, pure
Python. Parity targets: index/query/QueryStringQueryBuilder.java (full syntax,
errors on malformed input) and index/query/SimpleQueryStringBuilder.java
(forgiving operator subset, never throws). Both compile to the existing DSL
dict shapes, so everything downstream (nodes, device eval) is shared.

query_string grammar (the commonly-used subset):
    query    := clause+                      (implicit default_operator)
    clause   := [+|-] [field ':'] atom ['^' boost]
    atom     := '(' query ')' | '"' phrase '"' ['~' slop]
              | range | term ['~' fuzz] | wildcard
    range    := ('[' | '{') val TO val (']' | '}')  | ('>'|'>='|'<'|'<=') val
    special  := _exists_:field | field:* | AND | OR | NOT
"""

from __future__ import annotations

import re

from ..utils.errors import QueryParsingError

_TOKEN_RE = re.compile(
    r"""\s*(?:
      (?P<lparen>\() | (?P<rparen>\)) |
      (?P<quoted>"(?:[^"\\]|\\.)*") |
      (?P<range>(?:[A-Za-z0-9_.\-]+:)?[\[\{][^\]\}]*?\sTO\s[^\]\}]*?[\]\}]) |
      (?P<and>AND\b) | (?P<or>OR\b) | (?P<not>NOT\b) |
      (?P<plus>\+) | (?P<minus>-) |
      (?P<term>[^\s()"]+)
    )""",
    re.VERBOSE,
)


def _tokenize_qs(text: str):
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == pos:
            if text[pos:].strip() == "":
                break
            raise QueryParsingError(f"Failed to parse query [{text}]")
        pos = m.end()
        for name in ("lparen", "rparen", "quoted", "range", "and", "or",
                     "not", "plus", "minus", "term"):
            if m.group(name) is not None:
                out.append((name, m.group(name)))
                break
    return out


_RANGE_OP = re.compile(r"^(>=|<=|>|<)(.+)$")


def _strip_boost(text: str):
    m = re.match(r"^(.*)\^(\d+(?:\.\d+)?)$", text)
    if m:
        return m.group(1), float(m.group(2))
    return text, None


def _strip_fuzz(text: str):
    m = re.match(r"^(.*?)~(\d*)$", text)
    if m and not m.group(1).endswith("\\"):
        return m.group(1), (m.group(2) or "AUTO")
    return text, None


def _atom_query(fld: str, text: str, default_fields, *, lenient=False) -> dict:
    """One bare atom (no +/-/grouping) against one field or the defaults."""
    if fld is None:
        if len(default_fields) == 1:
            fld = default_fields[0]
        else:
            body, _ = _strip_boost(text)
            body2, fuzz = _strip_fuzz(body)
            if ("*" in body or "?" in body or fuzz is not None
                    or body.startswith(("[", "{", ">", "<"))):
                # non-plain atoms expand per default field under dis_max
                return {"dis_max": {"queries": [
                    _atom_query(f, text, default_fields) for f in default_fields
                ]}}
            return {
                "multi_match": {"query": text.replace("\\", ""),
                                "fields": list(default_fields)}
            }
    body, boost = _strip_boost(text)
    m = _RANGE_OP.match(body)
    if m:
        op = {">": "gt", ">=": "gte", "<": "lt", "<=": "lte"}[m.group(1)]
        rng = {op: _maybe_number(m.group(2))}
        if boost:
            rng["boost"] = boost
        return {"range": {fld: rng}}
    if body.startswith(("[", "{")) and body.endswith(("]", "}")):
        inner = body[1:-1]
        lo, hi = re.split(r"\s+TO\s+", inner, maxsplit=1)
        rng = {}
        if lo.strip() != "*":
            rng["gte" if body[0] == "[" else "gt"] = _maybe_number(lo.strip())
        if hi.strip() != "*":
            rng["lte" if body[-1] == "]" else "lt"] = _maybe_number(hi.strip())
        if boost:
            rng["boost"] = boost
        return {"range": {fld: rng}}
    if body == "*":
        q = {"exists": {"field": fld}}
        return q
    body2, fuzz = _strip_fuzz(body)
    if fuzz is not None and body2:
        q = {"fuzzy": {fld: {"value": body2, "fuzziness": fuzz}}}
        if boost:
            q["fuzzy"][fld]["boost"] = boost
        return q
    if "*" in body or "?" in body:
        q = {"wildcard": {fld: {"value": body}}}
        if boost:
            q["wildcard"][fld]["boost"] = boost
        return q
    q = {"match": {fld: {"query": body.replace("\\", "")}}}
    if boost:
        q["match"][fld]["boost"] = boost
    return q


def _maybe_number(s: str):
    try:
        f = float(s)
        return int(f) if f.is_integer() and "." not in s and "e" not in s.lower() else f
    except ValueError:
        return s


class _QSParser:
    def __init__(self, tokens, default_fields, default_operator):
        self.toks = tokens
        self.pos = 0
        self.default_fields = default_fields
        self.op = default_operator.lower()

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else (None, None)

    def parse(self, depth=0) -> dict:
        must, should, must_not = [], [], []
        pending_op = None
        while True:
            kind, text = self.peek()
            if kind is None or kind == "rparen":
                break
            self.pos += 1
            if kind == "and":
                pending_op = "and"
                continue
            if kind == "or":
                pending_op = "or"
                continue
            if kind == "not":
                q = self._clause(depth)
                must_not.append(q)
                pending_op = None
                continue
            if kind == "plus":
                must.append(self._clause(depth))
                pending_op = None
                continue
            if kind == "minus":
                must_not.append(self._clause(depth))
                pending_op = None
                continue
            self.pos -= 1
            q = self._clause(depth)
            op = pending_op or self.op
            if op == "and":
                must.append(q)
            else:
                should.append(q)
            # explicit AND binds the NEXT clause too; keep the mode sticky
            # only for the operator the user wrote (Lucene behavior is
            # left-associative; this subset treats the whole level uniformly)
            pending_op = None
        if must and should:
            # mixed: OR-connected clauses group into one should-bool
            must.append({"bool": {"should": should, "minimum_should_match": 1}})
            should = []
        body = {}
        if must:
            body["must"] = must
        if should:
            body["should"] = should
            body["minimum_should_match"] = 1
        if must_not:
            body["must_not"] = must_not
        if not body:
            return {"match_all": {}}
        if list(body.keys()) == ["must"] and len(must) == 1:
            return must[0]
        if list(body.keys()) == ["should", "minimum_should_match"] and len(should) == 1:
            return should[0]
        return {"bool": body}

    def _clause(self, depth) -> dict:
        kind, text = self.peek()
        if kind is None:
            raise QueryParsingError("unexpected end of query string")
        self.pos += 1
        if kind == "lparen":
            q = self.parse(depth + 1)
            k2, _ = self.peek()
            if k2 != "rparen":
                raise QueryParsingError("missing closing paren in query string")
            self.pos += 1
            return q
        if kind == "quoted":
            phrase = text[1:-1].replace('\\"', '"')
            fld = None
            return self._phrase(fld, phrase)
        if kind == "term":
            # field:... prefix?
            m = re.match(r"^([A-Za-z0-9_.\-]+):(.*)$", text)
            if m and m.group(2) != "":
                fld, rest = m.group(1), m.group(2)
                if fld == "_exists_":
                    return {"exists": {"field": rest}}
                k2, t2 = self.peek()
                if rest == "" and k2 == "quoted":
                    self.pos += 1
                    return self._phrase(fld, t2[1:-1])
                if k2 == "quoted" and rest == "":
                    pass
                if rest.startswith('"') and rest.endswith('"') and len(rest) > 1:
                    return self._phrase(fld, rest[1:-1])
                if k2 == "range" and rest == "":
                    self.pos += 1
                    return _atom_query(fld, t2, self.default_fields)
                return _atom_query(fld, rest, self.default_fields)
            if m and m.group(2) == "":
                fld = m.group(1)
                k2, t2 = self.peek()
                if k2 in ("quoted", "range", "term"):
                    self.pos += 1
                    if k2 == "quoted":
                        return self._phrase(fld, t2[1:-1])
                    return _atom_query(fld, t2, self.default_fields)
                raise QueryParsingError(f"missing value for field [{fld}]")
            return _atom_query(None, text, self.default_fields)
        if kind == "range":
            fld = None
            m = re.match(r"^([A-Za-z0-9_.\-]+):(.*)$", text)
            if m:
                fld, text = m.group(1), m.group(2)
            return _atom_query(fld, text, self.default_fields)
        raise QueryParsingError(f"unexpected token [{text}] in query string")

    def _phrase(self, fld, phrase) -> dict:
        if fld is None:
            if len(self.default_fields) == 1:
                fld = self.default_fields[0]
            else:
                return {"multi_match": {"query": phrase,
                                        "fields": list(self.default_fields),
                                        "type": "phrase"}}
        return {"match_phrase": {fld: {"query": phrase}}}


def parse_query_string(body: dict, mappings) -> dict:
    """query_string body -> DSL dict (strict: malformed input raises)."""
    query = body.get("query")
    if not isinstance(query, str):
        raise QueryParsingError("[query_string] requires a [query] string")
    fields = body.get("fields") or (
        [body["default_field"]] if body.get("default_field") else None
    )
    if fields is None:
        fields = sorted(
            f for f, ft in mappings.fields.items() if ft.type == "text"
        ) or ["*"]
    if fields == ["*"]:
        fields = sorted(
            f for f, ft in mappings.fields.items() if ft.type == "text"
        )
    default_operator = body.get("default_operator", "or")
    toks = _tokenize_qs(query)
    parser = _QSParser(toks, fields, default_operator)
    out = parser.parse()
    if parser.pos != len(toks):
        raise QueryParsingError(f"Failed to parse query [{query}]")
    if body.get("boost"):
        out = {"bool": {"must": [out], "boost": body["boost"]}}
    return out


_SQS_SPECIAL = set('+|-"*()')


def parse_simple_query_string(body: dict, mappings) -> dict:
    """simple_query_string: forgiving subset — never raises on bad syntax
    (reference behavior: SimpleQueryStringBuilder lenient parsing)."""
    query = body.get("query")
    if not isinstance(query, str):
        raise QueryParsingError("[simple_query_string] requires a [query] string")
    fields = body.get("fields")
    if not fields or fields == ["*"]:
        fields = sorted(
            f for f, ft in mappings.fields.items() if ft.type == "text"
        )
    default_operator = body.get("default_operator", "or").lower()

    def atom(text, negate=False):
        if text.startswith('"') and text.endswith('"') and len(text) > 1:
            inner = text[1:-1]
            if len(fields) == 1:
                return {"match_phrase": {fields[0]: {"query": inner}}}
            return {"multi_match": {"query": inner, "fields": list(fields),
                                    "type": "phrase"}}
        if text.endswith("*") and len(text) > 1 and "*" not in text[:-1]:
            sub = {"bool": {"should": [
                {"prefix": {f: {"value": text[:-1].lower()}}} for f in fields
            ], "minimum_should_match": 1}} if len(fields) > 1 else {
                "prefix": {fields[0]: {"value": text[:-1].lower()}}}
            return sub
        if len(fields) == 1:
            return {"match": {fields[0]: {"query": text}}}
        return {"multi_match": {"query": text, "fields": list(fields)}}

    # split respecting quotes
    parts = re.findall(r'"[^"]*"|\S+', query)
    must, should, must_not = [], [], []
    or_next = False
    for raw in parts:
        if raw == "|":
            or_next = True
            continue
        neg = raw.startswith("-") and len(raw) > 1
        plus = raw.startswith("+") and len(raw) > 1
        body_txt = raw[1:] if (neg or plus) else raw
        body_txt = body_txt.strip("()") or body_txt
        if not body_txt or body_txt in ("|",):
            continue
        q = atom(body_txt)
        if neg:
            must_not.append(q)
        elif plus:
            must.append(q)
        elif or_next or default_operator == "or":
            should.append(q)
        else:
            must.append(q)
        or_next = False
    b = {}
    if must:
        b["must"] = must
    if should:
        b["should"] = should
        b["minimum_should_match"] = 1
    if must_not:
        b["must_not"] = must_not
    if not b:
        return {"match_all": {}}
    if list(b.keys()) == ["must"] and len(must) == 1:
        return must[0]
    if list(b.keys()) == ["should", "minimum_should_match"] and len(should) == 1:
        return should[0]
    return {"bool": b}
