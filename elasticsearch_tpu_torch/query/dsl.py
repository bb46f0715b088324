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

Ported kinds: match, term, terms, range, bool, constant_score, match_all,
match_none, knn, exists. Every other kind raises QueryParsingError("... not yet
ported").
"""

from __future__ import annotations

from ..analysis import get_analyzer
from ..index.mappings import (BOOL_TYPES, DATE_TYPES, FLOAT_TYPES, INT_TYPES, KEYWORD_TYPES,
                              TEXT_TYPES, Mappings, parse_date_to_millis,
                              parse_date_with_formats)
from ..utils.errors import QueryParsingError
from .nodes import (
    BoolNode,
    ConstantScoreNode,
    ExistsNode,
    KnnNode,
    MatchAllNode,
    MatchNoneNode,
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
    if t in BOOL_TYPES:
        if isinstance(value, str):
            value = value == "true"
        return "int", int(bool(value))
    if t in INT_TYPES:
        return "int", int(value)
    if t in FLOAT_TYPES:
        return "float", float(value)
    return "ord", str(value)


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
    if t in INT_TYPES or t in DATE_TYPES or t in BOOL_TYPES:
        coerced = [_coerce_for_field(mappings, fld, v)[1] for v in values]
        return TermsNode(fld, coerced, kind="int", boost=boost)
    if t in FLOAT_TYPES:
        return TermsNode(fld, [float(v) for v in values], kind="float", boost=boost)
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
    if kind == "ord":
        raise QueryParsingError(f"[range] on keyword field [{fld}] is not yet ported")
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
    "match_all": _parse_match_all,
    "match_none": _parse_match_none,
    "term": _parse_term,
    "terms": _parse_terms,
    "range": _parse_range,
    "bool": _parse_bool,
    "constant_score": _parse_constant_score,
    "knn": parse_knn,
    "exists": _parse_exists,
}
