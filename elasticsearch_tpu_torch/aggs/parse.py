"""Aggregation DSL JSON -> AggNode tree.

This package's copy of the JAX package's `aggs/parse.py`. Parity target:
agg parsing registered in search/SearchModule.java (reference) with the
{"<name>": {"<type>": {...}, "aggs": {...}}} request shape, the geo aggs
(geo_bounds, geo_centroid, geotile_grid) included. Aggregation types that
plugins register in the reference are unknown here.
"""

from __future__ import annotations

from ..query.dsl import parse_query
from ..utils.errors import QueryParsingError
from .nodes import (
    AggNode,
    AutoDateHistogramAgg,
    CompositeAgg,
    AvgAgg,
    CardinalityAgg,
    DateHistogramAgg,
    DateRangeAgg,
    ExtendedStatsAgg,
    FilterAgg,
    FiltersAgg,
    GeoBoundsAgg,
    GeoCentroidAgg,
    GeotileGridAgg,
    GlobalAgg,
    HistogramAgg,
    MaxAgg,
    MinAgg,
    MissingAgg,
    MultiTermsAgg,
    PercentilesAgg,
    RangeAgg,
    RareTermsAgg,
    SignificantTermsAgg,
    StatsAgg,
    SumAgg,
    TermsAgg,
    TopHitsAgg,
    ValueCountAgg,
    WeightedAvgAgg,
)

_METRICS = {
    "min": MinAgg,
    "max": MaxAgg,
    "sum": SumAgg,
    "avg": AvgAgg,
    "stats": StatsAgg,
    "value_count": ValueCountAgg,
    "cardinality": CardinalityAgg,
}


def parse_aggs(aggs_dict: dict, mappings, _top=True) -> dict[str, AggNode]:
    """-> {agg_name: AggNode} for one level (children parsed recursively)."""
    if not isinstance(aggs_dict, dict):
        raise QueryParsingError("[aggs] must be an object")
    out: dict[str, AggNode] = {}
    for name, spec in aggs_dict.items():
        if not isinstance(spec, dict):
            raise QueryParsingError(f"aggregation [{name}] must be an object")
        if "composite" in spec and not _top:
            raise QueryParsingError(
                f"[composite] aggregation [{name}] cannot be used as a sub-aggregation"
            )
        sub = spec.get("aggs") or spec.get("aggregations") or {}
        children = parse_aggs(sub, mappings, _top=False) if sub else {}
        types = [k for k in spec if k not in ("aggs", "aggregations", "meta")]
        if len(types) != 1:
            raise QueryParsingError(f"aggregation [{name}] must define exactly one type")
        typ = types[0]
        body = spec[typ]
        out[name] = _build(name, typ, body, children, mappings)
    return out


def _field_of(name, typ, body):
    fld = body.get("field")
    if not fld:
        raise QueryParsingError(f"[{typ}] aggregation [{name}] requires [field]")
    return fld


def _build(name, typ, body, children, mappings) -> AggNode:
    if typ in _METRICS:
        cls = _METRICS[typ]
        return cls(name, _field_of(name, typ, body), children=children or None)
    if typ == "percentiles":
        return PercentilesAgg(
            name, _field_of(name, typ, body), percents=body.get("percents"), children=children or None
        )
    if typ == "terms":
        return TermsAgg(
            name,
            _field_of(name, typ, body),
            size=int(body.get("size", 10)),
            order=body.get("order"),
            children=children or None,
        )
    if typ == "histogram":
        if "interval" not in body:
            raise QueryParsingError(f"[histogram] aggregation [{name}] requires [interval]")
        return HistogramAgg(
            name,
            _field_of(name, typ, body),
            interval=body["interval"],
            offset=body.get("offset", 0.0),
            min_doc_count=body.get("min_doc_count"),
            children=children or None,
        )
    if typ == "date_histogram":
        return DateHistogramAgg(
            name,
            _field_of(name, typ, body),
            fixed_interval=body.get("fixed_interval") or body.get("interval"),
            calendar_interval=body.get("calendar_interval"),
            offset=body.get("offset", 0),
            min_doc_count=body.get("min_doc_count"),
            format=body.get("format"),
            children=children or None,
        )
    if typ == "range":
        if "ranges" not in body:
            raise QueryParsingError(f"[range] aggregation [{name}] requires [ranges]")
        return RangeAgg(
            name,
            _field_of(name, typ, body),
            ranges=body["ranges"],
            keyed=bool(body.get("keyed", False)),
            children=children or None,
        )
    if typ == "filter":
        return FilterAgg(name, parse_query(body, mappings), children=children or None)
    if typ == "filters":
        named = body.get("filters")
        if not isinstance(named, dict):
            raise QueryParsingError(f"[filters] aggregation [{name}] requires keyed [filters]")
        return FiltersAgg(
            name,
            {n: parse_query(q, mappings) for n, q in named.items()},
            children=children or None,
        )
    if typ == "missing":
        return MissingAgg(name, _field_of(name, typ, body), children=children or None)
    if typ == "global":
        return GlobalAgg(name, children or None)
    if typ == "extended_stats":
        return ExtendedStatsAgg(
            name, _field_of(name, typ, body),
            sigma=float(body.get("sigma", 2.0)), children=children or None,
        )
    if typ == "weighted_avg":
        value = (body.get("value") or {}).get("field")
        weight = (body.get("weight") or {}).get("field")
        if not value or not weight:
            raise QueryParsingError(
                f"[weighted_avg] aggregation [{name}] requires value.field and weight.field"
            )
        return WeightedAvgAgg(name, value, weight, children=children or None)
    if typ == "rare_terms":
        return RareTermsAgg(
            name, _field_of(name, typ, body),
            max_doc_count=int(body.get("max_doc_count", 1)),
            children=children or None,
        )
    if typ == "multi_terms":
        sources = body.get("terms")
        if not isinstance(sources, list) or len(sources) < 2:
            raise QueryParsingError(
                f"[multi_terms] aggregation [{name}] requires a [terms] array of 2+ fields"
            )
        return MultiTermsAgg(
            name, [s["field"] for s in sources],
            size=int(body.get("size", 10)),
            order=body.get("order"),
            children=children or None,
        )
    if typ == "significant_terms":
        return SignificantTermsAgg(
            name, _field_of(name, typ, body),
            size=int(body.get("size", 10)),
            min_doc_count=int(body.get("min_doc_count", 3)),
            children=children or None,
        )
    if typ == "date_range":
        if "ranges" not in body:
            raise QueryParsingError(f"[date_range] aggregation [{name}] requires [ranges]")
        return DateRangeAgg(
            name, _field_of(name, typ, body),
            ranges=body["ranges"],
            keyed=bool(body.get("keyed", False)),
            format=body.get("format"),
            children=children or None,
        )
    if typ == "auto_date_histogram":
        return AutoDateHistogramAgg(
            name, _field_of(name, typ, body),
            buckets=int(body.get("buckets", 10)),
            format=body.get("format"),
            children=children or None,
        )
    if typ == "geo_bounds":
        return GeoBoundsAgg(name, _field_of(name, typ, body))
    if typ == "geo_centroid":
        return GeoCentroidAgg(name, _field_of(name, typ, body))
    if typ == "geotile_grid":
        return GeotileGridAgg(name, _field_of(name, typ, body),
                              precision=body.get("precision", 7),
                              size=int(body.get("size", 10000)),
                              children=children or None)
    if typ == "top_hits":
        return TopHitsAgg(name, size=int(body.get("size", 3)))
    if typ == "composite":
        raw = body.get("sources")
        if not isinstance(raw, list) or not raw:
            raise QueryParsingError(
                f"[composite] aggregation [{name}] requires [sources]")
        sources = []
        for entry in raw:
            (sname, sdef), = entry.items()
            (styp, sbody), = sdef.items()
            if styp not in ("terms", "histogram", "date_histogram"):
                raise QueryParsingError(
                    f"[composite] unsupported source type [{styp}]")
            sources.append((sname, styp, sbody["field"], sbody))
        return CompositeAgg(
            name, sources, size=int(body.get("size", 10)),
            after=body.get("after"), children=children or None,
        )
    raise QueryParsingError(f"unknown aggregation type [{typ}]")
