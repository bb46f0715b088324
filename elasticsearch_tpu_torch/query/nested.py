"""The `nested` query: per-object matching of nested documents.

This package's copy of the JAX package's `query/nested.py` (reference
behavior: index/query/NestedQueryBuilder.java: a parent matches when ANY
of its nested objects satisfies the inner query as a unit). The nested
objects live in the stored source (`ShardPack.doc_sources`); the inner
query's predicate subset (term, terms, match, range, exists, bool),
compiled once per request, is walked on the host per object at prepare, and the matched parent docids
feed the device as an id set (`nodes.id_set_match`). The score is the
constant boost (score_mode none).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..index.mappings import parse_date_to_millis
from ..utils.errors import MapperParsingError, QueryParsingError
from .nodes import QueryNode, id_set_match


def _get_path(obj, path: str):
    cur = obj
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def _values_of(obj, rel_path: str) -> list:
    v = _get_path(obj, rel_path)
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _values_getter(rel_path: str):
    """`_values_of` for one path: a key without dots reads the object
    directly."""
    if "." in rel_path:
        return lambda obj: _values_of(obj, rel_path)

    def get(obj):
        v = obj.get(rel_path)
        if v is None:
            return ()
        return v if isinstance(v, list) else (v,)
    return get


def _compile_predicate(q: dict, rel, mappings):
    """The inner query's subset -> a predicate over one nested object (the
    reference's `_match_predicate`, with each clause's field path, type and
    bounds resolved once per request instead of once per object)."""
    (kind, body), = q.items()
    if kind == "bool":
        must = [_compile_predicate(c, rel, mappings) for c in body.get("must", []) or []]
        must += [_compile_predicate(c, rel, mappings) for c in body.get("filter", []) or []]
        must_not = [_compile_predicate(c, rel, mappings) for c in body.get("must_not", []) or []]
        should = [_compile_predicate(c, rel, mappings) for c in body.get("should", []) or []]
        need = (int(body.get("minimum_should_match",
                             0 if (body.get("must") or body.get("filter")) else 1))
                if should else 0)

        def pred(obj):
            if not all(m(obj) for m in must) or any(m(obj) for m in must_not):
                return False
            return not should or sum(1 for c in should if c(obj)) >= need
        return pred
    if kind in ("term", "match"):
        (fld, spec), = body.items()
        want = (spec.get("value" if kind == "term" else "query")
                if isinstance(spec, dict) else spec)
        values = _values_getter(rel(fld))
        ft = mappings.fields.get(fld)
        if kind == "match" and ft is not None and ft.type == "text":
            words = [w.lower() for w in str(want).split()]

            def pred(obj):
                toks = {t.lower() for v in values(obj) for t in str(v).split()}
                return any(w in toks for w in words)
            return pred
        swant = str(want)
        return lambda obj: any(v == want or str(v) == swant for v in values(obj))
    if kind == "terms":
        (fld, wants), = body.items()
        values, swants = _values_getter(rel(fld)), [str(w) for w in wants]
        return lambda obj: any(v in wants or str(v) in swants for v in values(obj))
    if kind == "exists":
        values = _values_getter(rel(body["field"]))
        return lambda obj: bool(values(obj))
    if kind == "range":
        (fld, spec), = body.items()
        ft = mappings.fields.get(fld)
        is_date = ft is not None and ft.type == "date"
        values = _values_getter(rel(fld))

        def conv(x):
            return parse_date_to_millis(x) if is_date else float(x)

        gte, gt = (conv(spec[op]) if op in spec else None for op in ("gte", "gt"))
        lte, lt = (conv(spec[op]) if op in spec else None for op in ("lte", "lt"))

        def within(fv) -> bool:  # the reference's `not fv >= bound` tests, NaN included
            return ((gte is None or fv >= gte) and (gt is None or fv > gt)
                    and (lte is None or fv <= lte) and (lt is None or fv < lt))

        def pred(obj):
            for v in values(obj):
                try:
                    fv = conv(v)
                except (MapperParsingError, TypeError, ValueError):
                    continue  # a value that does not parse never matches
                if within(fv):
                    return True
            return False
        return pred

    def unsupported(obj):
        raise QueryParsingError(f"query [{kind}] is not supported inside [nested] here")
    return unsupported


@dataclass
class NestedNode(QueryNode):
    path: str = ""
    query: dict = dc_field(default_factory=dict)
    mappings: object = None
    boost: float = 1.0

    def prepare(self, pack):
        real = getattr(pack, "pack", pack)  # a shard view's own sources
        sources = getattr(real, "doc_sources", None)
        matched = []
        if sources is not None:
            prefix = self.path + "."

            def rel(f):
                return f[len(prefix):] if f.startswith(prefix) else f

            pred = _compile_predicate(self.query, rel, self.mappings)
            objs_of = ((lambda src: src.get(self.path)) if "." not in self.path
                       else (lambda src: _get_path(src, self.path)))
            for docid, src in enumerate(sources):
                objs = objs_of(src)
                if objs is None:
                    continue
                for obj in objs if isinstance(objs, list) else [objs]:
                    if isinstance(obj, dict) and pred(obj):
                        matched.append(docid)
                        break
        return np.asarray(matched, np.int64)

    def device_eval(self, dev, params, ctx):
        return id_set_match(params, self.boost, ctx)


def parse_nested(body, mappings) -> NestedNode:
    if not isinstance(body, dict):
        raise QueryParsingError("[nested] expects an object")
    path, query = body.get("path"), body.get("query")
    if not path or not isinstance(query, dict):
        raise QueryParsingError("[nested] requires [path] and [query]")
    if path not in getattr(mappings, "nested_paths", set()):
        raise QueryParsingError(f"[nested] failed to find nested object under path [{path}]")
    return NestedNode(path=path, query=query, mappings=mappings,
                      boost=float(body.get("boost", 1.0)))
