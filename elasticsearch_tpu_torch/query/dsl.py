"""JSON Query DSL -> plan nodes.

Parity target: the reference's query parsers (reference behavior:
index/query/*QueryBuilder.java `fromXContent`), desugared by field type as
the JAX package's `query/dsl.py` does:

- `match` on text -> bool-should (must for operator=and) of TermNodes over
  the terms of the field's search analyzer, as MatchQueryBuilder builds a
  BooleanQuery of TermQuerys;
- `term`/`terms`/`match` on numeric, date and boolean fields -> docvalue
  equality (constant score); `range` on them -> a docvalue range. Date
  values parse with the field's `format` (else
  strict_date_optional_time||epoch_millis) to epoch millis, booleans
  (true/false or "true"/"false") to 0/1.

- `knn` -> KnnNode (also the body of a top-level `knn` search section).
- `exists` -> ExistsNode (docvalues, vectors, then text presence).
- `match_phrase` -> PhraseNode over the analyzed tokens' positions (one
  token: a TermNode); `match_phrase_prefix` -> PhrasePrefixNode;
  `match_bool_prefix` -> bool-should of the terms and a prefix on the last;
  `multi_match` -> dis_max of per-field matches (best_fields, phrase,
  bool_prefix) or their bool-should (most_fields); `dis_max` -> DisMaxNode;
  `ids` -> a terms query on the reserved `_id` column.
- `prefix`, `wildcard`, `regexp`, `fuzzy` -> ExpandedTermsNode with a host
  predicate over the field's dictionary (fuzzy: banded Damerau-Levenshtein,
  AUTO distances 0/1/2 by length, scored); `range` on a keyword field ->
  KeywordRangeNode.
- `query_string`, `simple_query_string` -> the Lucene syntax desugared into
  the kinds above (`querystring.py`).

- `script_score`, `function_score`, `script` -> the nodes of
  `script_nodes.py` (their inner queries marked exact).
- `ip` fields: a `term` is the canonical address's postings term, a CIDR
  block (and `range`) an interval of the address-sorted ordinals
  (`IpRangeNode`); `date_nanos` values parse to epoch nanos, int64 end to
  end.
- `geo_bounding_box`, `geo_distance` (`geo.py`); `more_like_this`,
  `terms_set`, `combined_fields`, `rank_feature`, `distance_feature`,
  `pinned`, `wrapper` (`extra.py`); `intervals`, `nested`, `percolate`
  (host matchers feeding an id set: `intervals.py`, `nested.py`,
  `percolate.py`).

Every kind the JAX package's `_PARSERS` registers is ported; any other kind
raises QueryParsingError("... not yet ported").
"""

from __future__ import annotations

import ipaddress
import re

import numpy as np

from ..analysis import get_analyzer
from ..index.mappings import (BOOL_TYPES, DATE_NANOS_TYPES, DATE_TYPES, FLOAT_TYPES, INT_TYPES,
                              IP_TYPES, KEYWORD_TYPES, TEXT_TYPES, Mappings,
                              parse_date_to_millis, parse_date_to_nanos,
                              parse_date_with_formats)
from ..utils.errors import QueryParsingError
from . import extra, geo, intervals, nested, percolate, script_nodes
from .nodes import (
    BoolNode,
    ConstantScoreNode,
    DisMaxNode,
    ExistsNode,
    ExpandedTermsNode,
    IpRangeNode,
    KeywordRangeNode,
    KnnNode,
    MatchAllNode,
    MatchNoneNode,
    PhraseNode,
    QueryNode,
    RangeNode,
    TermNode,
    TermsNode,
)


def parse_query(q: dict | None, mappings: Mappings) -> QueryNode:
    if q is None:
        return MatchAllNode()
    if not isinstance(q, dict) or len(q) != 1:
        raise QueryParsingError(f"query must be an object with exactly one key, got {q!r}")
    (kind, body), = q.items()
    parser = _PARSERS.get(kind)
    if parser is None:
        raise QueryParsingError(f"query [{kind}] is not yet ported")
    return parser(body, mappings)


def _field_type(mappings: Mappings, fld: str) -> str | None:
    ft = mappings.fields.get(fld)
    return ft.type if ft else None


def _coerce_for_field(mappings: Mappings, fld: str, value):
    """-> (kind, coerced_value); kind selects the docvalue column type."""
    t = _field_type(mappings, fld)
    if t in DATE_TYPES:
        ft = mappings.fields[fld]
        if ft.format:
            return "int", parse_date_with_formats(value, ft.format)
        return "int", parse_date_to_millis(value)
    if t in DATE_NANOS_TYPES:
        return "int", parse_date_to_nanos(value)
    if t in IP_TYPES:
        return "ip", str(value)
    if t in BOOL_TYPES:
        if isinstance(value, str):
            value = value == "true"
        return "int", int(bool(value))
    if t in INT_TYPES:
        return "int", int(value)
    if t in FLOAT_TYPES:
        return "float", float(value)
    return "ord", str(value)


def _ip_value_node(fld: str, value, boost: float):
    """An ip term: an address -> the postings term of its canonical form; a
    CIDR block -> an ordinal interval of the address-sorted dictionary
    (reference `dsl.py:_ip_value_node`; behavior: IpFieldMapper termQuery)."""
    s = str(value)
    try:
        if "/" in s:
            net = ipaddress.ip_network(s, strict=False)
            return IpRangeNode(fld, None, None, True, True, boost=boost,
                               lo_s=str(net.network_address), hi_s=str(net.broadcast_address))
        return TermNode(fld, str(ipaddress.ip_address(s)), boost=boost)
    except ValueError as e:
        raise QueryParsingError(f"'{s}' is not an IP string literal: {e}")


def _parse_match(body, mappings):
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError("[match] query expects {field: ...}")
    (fld, spec), = body.items()
    if isinstance(spec, dict):
        text = spec.get("query")
        operator = spec.get("operator", "or")
        boost = float(spec.get("boost", 1.0))
        msm = spec.get("minimum_should_match")
    else:
        text, operator, boost, msm = spec, "or", 1.0, None
    if text is None:
        raise QueryParsingError("[match] requires [query]")
    t = _field_type(mappings, fld)
    if t is not None and t not in TEXT_TYPES and t not in KEYWORD_TYPES:
        # match on a numeric field degrades to equality, like ES
        kind, v = _coerce_for_field(mappings, fld, text)
        if kind == "ip":
            return _ip_value_node(fld, v, boost)
        return RangeNode(fld, v, v, kind=kind, boost=boost)
    ft = mappings.fields.get(fld)
    if ft is not None and ft.type in KEYWORD_TYPES:
        terms = [str(text)]
    else:
        analyzer = ft.get_search_analyzer() if ft else get_analyzer("standard")
        terms = analyzer.terms(str(text))
    if not terms:
        return MatchNoneNode()
    leaves = [TermNode(fld, term) for term in terms]
    if len(leaves) == 1:
        leaves[0].boost = boost
        return leaves[0]
    if operator == "and":
        return BoolNode(must=leaves, boost=boost)
    return BoolNode(should=leaves, boost=boost,
                    minimum_should_match=int(msm) if msm else None)


def _parse_term(body, mappings):
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError("[term] query expects {field: value}")
    (fld, spec), = body.items()
    if isinstance(spec, dict):
        value = spec.get("value")
        boost = float(spec.get("boost", 1.0))
    else:
        value, boost = spec, 1.0
    if fld == "_id":
        # _id lives in the reserved ordinal column, not the inverted index
        return TermsNode("_id", [str(value)], kind="ord", boost=boost)
    t = _field_type(mappings, fld)
    if t in TEXT_TYPES or t in KEYWORD_TYPES or t is None:
        return TermNode(fld, str(value), boost=boost)
    kind, v = _coerce_for_field(mappings, fld, value)
    if kind == "ip":
        return _ip_value_node(fld, v, boost)
    return RangeNode(fld, v, v, kind=kind, boost=boost)


def _parse_terms(body, mappings):
    if not isinstance(body, dict):
        raise QueryParsingError("[terms] expects an object")
    boost = float(body.get("boost", 1.0))
    items = [(f, v) for f, v in body.items() if f != "boost"]
    if len(items) != 1:
        raise QueryParsingError("[terms] query expects a single field")
    fld, values = items[0]
    if not isinstance(values, list):
        raise QueryParsingError("[terms] values must be an array")
    t = _field_type(mappings, fld)
    if fld == "_id":
        return TermsNode("_id", [str(v) for v in values], kind="ord", boost=boost)
    if t in INT_TYPES or t in DATE_TYPES or t in DATE_NANOS_TYPES or t in BOOL_TYPES:
        coerced = [_coerce_for_field(mappings, fld, v)[1] for v in values]
        return TermsNode(fld, coerced, kind="int", boost=boost)
    if t in FLOAT_TYPES:
        return TermsNode(fld, [float(v) for v in values], kind="float", boost=boost)
    if t in IP_TYPES:
        return ConstantScoreNode(
            BoolNode(should=[_ip_value_node(fld, v, 1.0) for v in values]), boost=boost)
    if t in KEYWORD_TYPES or t is None:
        return TermsNode(fld, [str(v) for v in values], kind="ord", boost=boost)
    # text field: OR of term queries, constant score
    return ConstantScoreNode(
        BoolNode(should=[TermNode(fld, str(v)) for v in values]), boost=boost)


def _parse_range(body, mappings):
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError("[range] query expects {field: bounds}")
    (fld, spec), = body.items()
    if not isinstance(spec, dict):
        raise QueryParsingError("[range] bounds must be an object")
    boost = float(spec.get("boost", 1.0))
    lo = hi = None
    inc_lo = inc_hi = True
    kind = None
    for op in ("gte", "gt", "lte", "lt"):
        if op in spec:
            k, v = _coerce_for_field(mappings, fld, spec[op])
            kind = kind or k
            if op == "gte":
                lo = v
            elif op == "gt":
                lo, inc_lo = v, False
            elif op == "lte":
                hi = v
            else:
                hi, inc_hi = v, False
    if kind in ("ord", "ip"):
        # string bounds resolve to the sorted ordinal dictionary at prepare
        cls = IpRangeNode if kind == "ip" else KeywordRangeNode
        return cls(fld, None, None, inc_lo, inc_hi, boost=boost,
                   lo_s=spec.get("gte", spec.get("gt")), hi_s=spec.get("lte", spec.get("lt")))
    return RangeNode(fld, lo, hi, inc_lo, inc_hi, boost=boost, kind=kind or "int")


def _parse_bool(body, mappings):
    if not isinstance(body, dict):
        raise QueryParsingError("[bool] expects an object")

    def clause(name):
        c = body.get(name, [])
        if isinstance(c, dict):
            c = [c]
        return [parse_query(q, mappings) for q in c]

    msm = body.get("minimum_should_match")
    return BoolNode(
        must=clause("must"),
        filter=clause("filter"),
        should=clause("should"),
        must_not=clause("must_not"),
        minimum_should_match=int(msm) if msm is not None else None,
        boost=float(body.get("boost", 1.0)),
    )


def _parse_constant_score(body, mappings):
    if not isinstance(body, dict) or "filter" not in body:
        raise QueryParsingError("[constant_score] requires [filter]")
    return ConstantScoreNode(
        parse_query(body["filter"], mappings), boost=float(body.get("boost", 1.0)))


def _parse_exists(body, mappings):
    if not isinstance(body, dict) or "field" not in body:
        raise QueryParsingError("[exists] requires [field]")
    return ExistsNode(body["field"], boost=float(body.get("boost", 1.0)))


def _parse_match_all(body, mappings):
    body = body or {}
    return MatchAllNode(boost=float(body.get("boost", 1.0)))


def _parse_match_none(body, mappings):
    return MatchNoneNode()


def _search_analyzer(mappings: Mappings, fld: str):
    ft = mappings.fields.get(fld)
    return ft.get_search_analyzer() if ft else get_analyzer("standard")


def _parse_multi_match(body, mappings):
    if not isinstance(body, dict):
        raise QueryParsingError("[multi_match] expects an object")
    text = body.get("query")
    fields = body.get("fields") or []
    mm_type = body.get("type", "best_fields")
    tie = float(body.get("tie_breaker", 0.0))
    boost = float(body.get("boost", 1.0))
    if text is None or not fields:
        raise QueryParsingError("[multi_match] requires [query] and [fields]")
    if mm_type not in ("best_fields", "most_fields", "phrase", "bool_prefix"):
        raise QueryParsingError(f"[multi_match] type [{mm_type}] is not supported")
    per_field = {"bool_prefix": _parse_match_bool_prefix, "phrase": _parse_match_phrase}.get(
        mm_type, _parse_match)
    children = []
    for f in fields:
        fboost = 1.0
        if "^" in f:
            f, fb = f.split("^", 1)
            fboost = float(fb)
        children.append(per_field({f: {"query": text, "boost": fboost}}, mappings))
    if mm_type == "most_fields":
        return BoolNode(should=children, boost=boost)
    return DisMaxNode(children=children, tie_breaker=tie, boost=boost)


def _parse_match_phrase(body, mappings):
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError("[match_phrase] query expects {field: ...}")
    (fld, spec), = body.items()
    if not isinstance(spec, dict):
        spec = {"query": spec}
    if "query" not in spec:
        raise QueryParsingError("[match_phrase] requires [query]")
    text = str(spec["query"])
    boost = float(spec.get("boost", 1.0))
    slop = int(spec.get("slop", 0))
    ft = mappings.fields.get(fld)
    if ft is None or ft.type in KEYWORD_TYPES:
        return TermNode(fld, text, boost=boost)
    if ft.type not in TEXT_TYPES:
        kind, v = _coerce_for_field(mappings, fld, text)
        return RangeNode(fld, v, v, kind=kind, boost=boost)
    toks = ft.get_search_analyzer().analyze(text)
    if not toks:
        return MatchNoneNode()
    if len(toks) == 1:
        return TermNode(fld, toks[0].term, boost=boost)
    return PhraseNode(fld, [(t.term, t.position) for t in toks], boost=boost, slop=slop)


def _parse_match_phrase_prefix(body, mappings):
    """A phrase whose last term is a prefix (reference behavior:
    MatchPhrasePrefixQueryBuilder): the last position expands to at most
    max_expansions terms of the dictionary at prepare."""
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError("[match_phrase_prefix] query expects {field: ...}")
    (fld, spec), = body.items()
    if not isinstance(spec, dict):
        spec = {"query": spec}
    text = str(spec.get("query", ""))
    boost = float(spec.get("boost", 1.0))
    max_exp = int(spec.get("max_expansions", 50))
    ft = mappings.fields.get(fld)
    if ft is None or ft.type not in TEXT_TYPES:
        return _parse_prefix({fld: {"value": text.lower()}}, mappings)
    toks = ft.get_search_analyzer().analyze(text)
    if not toks:
        return MatchNoneNode()
    if len(toks) == 1:
        return _parse_prefix({fld: {"value": toks[0].term, "boost": boost}}, mappings)
    from .prefix_phrase import PhrasePrefixNode

    return PhrasePrefixNode(fld=fld, terms=[(t.term, t.position) for t in toks[:-1]],
                            prefix=toks[-1].term, prefix_position=toks[-1].position,
                            max_expansions=max_exp, boost=boost)


def _parse_match_bool_prefix(body, mappings):
    """bool-should of the terms and a prefix on the last one (reference
    behavior: MatchBoolPrefixQueryBuilder)."""
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError("[match_bool_prefix] query expects {field: ...}")
    (fld, spec), = body.items()
    if not isinstance(spec, dict):
        spec = {"query": spec}
    text = str(spec.get("query", ""))
    boost = float(spec.get("boost", 1.0))
    terms = [t.term for t in _search_analyzer(mappings, fld).analyze(text)]
    if not terms:
        return MatchNoneNode()
    clauses = [TermNode(fld, t) for t in terms[:-1]]
    clauses.append(_parse_prefix({fld: {"value": terms[-1]}}, mappings))
    return BoolNode(should=clauses, minimum_should_match=1, boost=boost)


def _parse_dis_max(body, mappings):
    if not isinstance(body, dict) or "queries" not in body:
        raise QueryParsingError("[dis_max] requires [queries]")
    return DisMaxNode(children=[parse_query(q, mappings) for q in body["queries"]],
                      tie_breaker=float(body.get("tie_breaker", 0.0)),
                      boost=float(body.get("boost", 1.0)))


def _parse_ids(body, mappings):
    # a terms query on the reserved _id ordinal column
    if not isinstance(body, dict) or "values" not in body:
        raise QueryParsingError("[ids] requires [values]")
    return TermsNode("_id", [str(v) for v in body["values"]], kind="ord")


def _single_field_body(kind, body, value_key="value"):
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError(f"[{kind}] query expects {{field: ...}}")
    (fld, spec), = body.items()
    if isinstance(spec, dict):
        if value_key not in spec:
            raise QueryParsingError(f"[{kind}] requires [{value_key}]")
        return fld, spec
    return fld, {value_key: spec}


def _parse_prefix(body, mappings):
    fld, spec = _single_field_body("prefix", body)
    value = str(spec["value"])
    ci = bool(spec.get("case_insensitive", False))
    if ci:
        pre = value.lower()
        matcher = lambda t: t.lower().startswith(pre)  # noqa: E731
    else:
        matcher = lambda t: t.startswith(value)  # noqa: E731
    return ExpandedTermsNode(kind="prefix", fld=fld, matcher=matcher,
                             boost=float(spec.get("boost", 1.0)),
                             literal_prefix="" if ci else value)


def _wildcard_regex(pattern: str) -> str:
    return "".join(".*" if ch == "*" else "." if ch == "?" else re.escape(ch) for ch in pattern)


def _regex_node(kind: str, fld: str, spec: dict, pattern: str,
                literal_prefix: str) -> ExpandedTermsNode:
    ci = bool(spec.get("case_insensitive", False))
    try:
        rx = re.compile(pattern, re.IGNORECASE if ci else 0)
    except re.error as e:
        raise QueryParsingError(f"[{kind}] invalid pattern [{spec['value']}]: {e}")
    return ExpandedTermsNode(kind=kind, fld=fld, matcher=lambda t: rx.fullmatch(t) is not None,
                             boost=float(spec.get("boost", 1.0)),
                             literal_prefix="" if ci else literal_prefix)


def _regexp_literal_prefix(pattern: str) -> str:
    """The text every match of a regexp starts with: its leading letters and
    digits, less the last when an optional quantifier follows it; none for
    a pattern with an alternation."""
    if "|" in pattern:
        return ""
    m = re.match(r"[A-Za-z0-9]*", pattern)
    lit = m.group(0)
    if pattern[len(lit): len(lit) + 1] in ("?", "*", "{"):
        lit = lit[:-1]
    return lit


def _parse_wildcard(body, mappings):
    if isinstance(body, dict) and len(body) == 1:
        # the legacy form {field: {"wildcard": "pat*"}}
        (fld0, spec0), = body.items()
        if isinstance(spec0, dict) and "value" not in spec0 and "wildcard" in spec0:
            body = {fld0: {**spec0, "value": spec0["wildcard"]}}
    fld, spec = _single_field_body("wildcard", body)
    pattern = str(spec["value"])
    return _regex_node("wildcard", fld, spec, _wildcard_regex(pattern),
                       re.match(r"[^*?]*", pattern).group(0))


def _parse_regexp(body, mappings):
    """Lucene RegExp's core operators map onto Python `re`; its `&` and `~`
    operators are not supported."""
    fld, spec = _single_field_body("regexp", body)
    pattern = str(spec["value"])
    return _regex_node("regexp", fld, spec, pattern, _regexp_literal_prefix(pattern))


def _edit_distance_within(a: str, b: str, maxd: int, transpositions: bool = True) -> bool:
    """Banded (Damerau-)Levenshtein with an early exit past maxd."""
    if abs(len(a) - len(b)) > maxd:
        return False
    if maxd == 0:
        return a == b
    prev2 = None
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        row_min = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            if (transpositions and prev2 is not None and j > 1
                    and ca == b[j - 2] and a[i - 2] == cb):
                cur[j] = min(cur[j], prev2[j - 2] + 1)
            row_min = min(row_min, cur[j])
        if row_min > maxd:
            return False
        prev2, prev = prev, cur
    return prev[len(b)] <= maxd


def edits_within_many(codes: np.ndarray, word: np.ndarray, maxd: int,
                      transpositions: bool = True) -> np.ndarray:
    """`_edit_distance_within(term, word, maxd, transpositions)` for every
    row of `codes` (the code points of terms of one length, [n, L] int32)
    at once: the same banded table, a row of it per character of `word`,
    each column a vector over the terms. The scalar version's early exit
    (a row whose minimum passes maxd) rejects only terms past maxd, and the
    (restricted Damerau-)Levenshtein distance is symmetric, so the rows may
    run over either string."""
    n, n_chars = codes.shape
    if maxd == 0:
        return np.all(codes == word, axis=1) if n_chars == len(word) else np.zeros(n, bool)
    prev2, prev = None, np.tile(np.arange(n_chars + 1, dtype=np.int32), (n, 1))
    ok = np.ones(n, bool)
    for i in range(1, len(word) + 1):
        ca = word[i - 1]
        cur = np.empty_like(prev)
        cur[:, 0] = i
        row_min = np.full(n, i, np.int32)
        for j in range(1, n_chars + 1):
            v = np.minimum(np.minimum(prev[:, j], cur[:, j - 1]) + 1,
                           prev[:, j - 1] + (codes[:, j - 1] != ca))
            if transpositions and prev2 is not None and j > 1:
                swap = (codes[:, j - 2] == ca) & (codes[:, j - 1] == word[i - 2])
                v = np.where(swap, np.minimum(v, prev2[:, j - 2] + 1), v)
            cur[:, j] = v
            np.minimum(row_min, v, out=row_min)
        ok &= row_min <= maxd
        prev2, prev = prev, cur
    return ok & (prev[:, n_chars] <= maxd)


def bucket_by_length(terms: list[str]) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """`terms` by length L -> (their positions in `terms`, int64; their code
    points [n, L] int32): the rows `edits_within_many` takes."""
    by_len: dict[int, list[int]] = {}
    for i, t in enumerate(terms):
        by_len.setdefault(len(t), []).append(i)
    out = {}
    for n_chars, pos in by_len.items():
        codes = np.fromiter((ord(ch) for i in pos for ch in terms[i]), np.int32,
                            count=len(pos) * n_chars).reshape(len(pos), n_chars)
        out[n_chars] = (np.asarray(pos, np.int64), codes)
    return out


class FuzzyMatcher:
    """The fuzzy query's term test: a term that starts with `prefix` and is
    within `maxd` edits of `value`, over a run of a pack's sorted
    dictionary at once (the terms of each qualifying length as numpy
    vectors, `edits_within_many`)."""

    def __init__(self, value: str, maxd: int, prefix: str, transpositions: bool):
        self.value, self.maxd, self.prefix = value, maxd, prefix
        self.transpositions = transpositions

    def match_run(self, pack, fld: str, lo: int, hi: int) -> np.ndarray:
        """-> the mask over `terms_for_field(fld)[lo:hi]` of the terms this
        matcher takes."""
        word = np.fromiter(map(ord, self.value), np.int32, count=len(self.value))
        pre = word[:len(self.prefix)]
        mask = np.zeros(hi - lo, bool)
        for n_chars, (pos, codes) in pack.term_code_buckets(fld).items():
            if abs(n_chars - len(self.value)) > self.maxd or n_chars < len(pre):
                continue
            rows = np.nonzero((pos >= lo) & (pos < hi)
                              & np.all(codes[:, :len(pre)] == pre, axis=1))[0]
            if len(rows):
                ok = edits_within_many(codes[rows], word, self.maxd, self.transpositions)
                mask[pos[rows[ok]] - lo] = True
        return mask


def _fuzzy_max_dist(fuzziness, term: str) -> int:
    s = "AUTO" if fuzziness is None else str(fuzziness).upper()
    if s.startswith("AUTO"):
        low, high = 3, 6
        if s.startswith("AUTO:"):  # AUTO:low,high
            try:
                low, high = (int(x) for x in s[5:].split(","))
            except ValueError:
                raise QueryParsingError(f"failed to parse fuzziness [{fuzziness}]")
        n = len(term)
        return 0 if n < low else (1 if n < high else 2)
    try:
        return int(float(s))
    except ValueError:
        raise QueryParsingError(f"failed to parse fuzziness [{fuzziness}]")


def _parse_fuzzy(body, mappings):
    fld, spec = _single_field_body("fuzzy", body)
    value = str(spec["value"])
    maxd = _fuzzy_max_dist(spec.get("fuzziness"), value)
    prefix_length = int(spec.get("prefix_length", 0))
    transpositions = bool(spec.get("transpositions", True))
    pre = value[:prefix_length]
    return ExpandedTermsNode(kind="fuzzy", fld=fld,
                             matcher=FuzzyMatcher(value, maxd, pre, transpositions),
                             boost=float(spec.get("boost", 1.0)), scored=True,
                             max_expansions=int(spec.get("max_expansions", 50)),
                             literal_prefix=pre)


def _parse_query_string(body, mappings):
    from .querystring import parse_query_string

    return parse_query(parse_query_string(body, mappings), mappings)


def _parse_simple_query_string(body, mappings):
    from .querystring import parse_simple_query_string

    return parse_query(parse_simple_query_string(body, mappings), mappings)


def parse_knn(body, mappings) -> KnnNode:
    """knn section/query: {"field", "query_vector", "k", "num_candidates",
    "filter", "boost", "similarity", "nprobe"}."""
    if not isinstance(body, dict) or "field" not in body or "query_vector" not in body:
        raise QueryParsingError("[knn] requires [field] and [query_vector]")
    k = int(body.get("k", 10))
    nc = int(body["num_candidates"]) if body.get("num_candidates") is not None else None
    if k < 1 or (nc is not None and nc < k):
        raise QueryParsingError("[knn] k must be >= 1 and num_candidates >= k")
    filt = body.get("filter")
    fnode = None
    if filt is not None:
        if isinstance(filt, list):
            fnode = BoolNode(filter=[parse_query(q, mappings) for q in filt])
        else:
            fnode = parse_query(filt, mappings)
    nprobe = body.get("nprobe")
    if nprobe is not None and int(nprobe) < 1:
        raise QueryParsingError("[knn] nprobe must be >= 1")
    return KnnNode(
        fld=body["field"],
        qvec=[float(x) for x in body["query_vector"]],
        k=k,
        num_candidates=nc,
        filter_node=fnode,
        boost=float(body.get("boost", 1.0)),
        similarity_threshold=(float(body["similarity"])
                              if body.get("similarity") is not None else None),
        nprobe=int(nprobe) if nprobe is not None else None,
    )


_PARSERS = {
    "match": _parse_match,
    "match_phrase": _parse_match_phrase,
    "match_phrase_prefix": _parse_match_phrase_prefix,
    "match_bool_prefix": _parse_match_bool_prefix,
    "multi_match": _parse_multi_match,
    "dis_max": _parse_dis_max,
    "ids": _parse_ids,
    "prefix": _parse_prefix,
    "wildcard": _parse_wildcard,
    "regexp": _parse_regexp,
    "fuzzy": _parse_fuzzy,
    "query_string": _parse_query_string,
    "simple_query_string": _parse_simple_query_string,
    "match_all": _parse_match_all,
    "match_none": _parse_match_none,
    "term": _parse_term,
    "terms": _parse_terms,
    "range": _parse_range,
    "bool": _parse_bool,
    "constant_score": _parse_constant_score,
    "knn": parse_knn,
    "exists": _parse_exists,
    "script_score": lambda body, m: script_nodes.parse_script_score(body, m, parse_query),
    "script": lambda body, m: script_nodes.parse_script_filter(body, m, parse_query),
    "function_score": lambda body, m: script_nodes.parse_function_score(body, m, parse_query),
    "geo_bounding_box": geo.parse_geo_bounding_box,
    "geo_distance": geo.parse_geo_distance,
    "more_like_this": extra.parse_more_like_this,
    "terms_set": extra.parse_terms_set,
    "combined_fields": extra.parse_combined_fields,
    "rank_feature": extra.parse_rank_feature,
    "distance_feature": extra.parse_distance_feature,
    "pinned": extra.parse_pinned,
    "wrapper": extra.parse_wrapper,
    "intervals": intervals.parse_intervals,
    "nested": nested.parse_nested,
    "percolate": percolate.parse_percolate,
}
