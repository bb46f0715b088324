"""The long-tail query kinds.

This package's copy of the JAX package's `query/extra.py` (reference
behavior: index/query/MoreLikeThisQueryBuilder.java, TermsSetQueryBuilder.java,
CombinedFieldsQueryBuilder.java, RankFeatureQueryBuilder.java,
DistanceFeatureQueryBuilder.java, PinnedQueryBuilder.java,
WrapperQueryBuilder.java):

- `more_like_this`: the like texts (and the `_source` of like `_id`s) are
  analyzed on the host, each (field, term) ranked by tf * idf over the
  global df (the stacked pack's on several shards), the top
  `max_query_terms` become a `BoolNode` of `TermNode`s with the
  minimum_should_match;
- `terms_set`: the children's scores added one after the other in f32, a
  doc matching when its count of matching terms reaches the per-doc
  `minimum_should_match_field`;
- `combined_fields`: a should-bool of per-field matches (the JAX package's
  approximation of BM25F);
- `rank_feature` (saturation, log, sigmoid, linear) and `distance_feature`
  (a date or numeric column, or a geo_point's haversine) as f32 elementwise
  functions of a column;
- `pinned`: the ids above every organic score, in list order;
- `wrapper`: a base64 JSON query.

Each evaluates on the device; the term selection and id lookups are host
work at prepare, as there.
"""

from __future__ import annotations

import base64
import binascii
import json
from bisect import bisect_left
from collections import Counter
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..index.mappings import parse_date_to_millis
from ..ops.scoring import bm25_idf
from ..utils.errors import QueryParsingError
from .nodes import BoolNode, MatchNoneNode, QueryNode, TermNode, _doc_match, _empty

_I32_MAX = 2**31 - 1


class _OneShard:
    """A bare pack (one shard, or a pack under a statistics view) seen as the
    stacked pack that `more_like_this` reads: its shards and global df."""

    def __init__(self, pack):
        self.shards = [pack]
        self.n_max = pack.num_docs
        self.S = 1
        self._pack = pack

    def df(self, key) -> int:
        tid = self._pack.term_dict.get(key)
        return 0 if tid is None else int(self._pack.term_df[tid])


def _doc_source(pack, like_id: str):
    """The sources of the docs of one shard pack whose `_id` is `like_id`."""
    sources = getattr(pack, "doc_sources", None)
    col = pack.docvalues.get("_id")
    if sources is None or col is None or not col.ord_terms:
        return []
    i = bisect_left(col.ord_terms, like_id)
    if i >= len(col.ord_terms) or col.ord_terms[i] != like_id:
        return []
    return [sources[d] for d in np.flatnonzero(col.values == i) if d < len(sources)]


@dataclass
class MoreLikeThisNode(QueryNode):
    fields: list = dc_field(default_factory=list)
    like_texts: list = dc_field(default_factory=list)
    like_ids: list = dc_field(default_factory=list)
    unlike_texts: list = dc_field(default_factory=list)
    mappings: object = None
    max_query_terms: int = 25
    min_term_freq: int = 2
    min_doc_freq: int = 5
    minimum_should_match: str = "30%"
    boost: float = 1.0
    _inner: QueryNode | None = None

    def _select_terms(self, stacked, df_of) -> list[tuple[str, str]]:
        """The (field, term) candidates ranked by tf * idf, ties by (field,
        term) (reference `extra.py:MoreLikeThisNode._select_terms`)."""
        tf: Counter = Counter()
        for fld in self.fields:
            ft = self.mappings.fields.get(fld)
            if ft is None or ft.type not in ("text", "keyword"):
                continue
            analyzer = ft.get_analyzer() if ft.type == "text" else None
            texts = list(self.like_texts)
            for like_id in self.like_ids:
                for pack in stacked.shards:
                    for src in _doc_source(pack, like_id):
                        v = src.get(fld)
                        if isinstance(v, str):
                            texts.append(v)
            unlike_terms = set()
            for u in self.unlike_texts:
                if analyzer:
                    unlike_terms |= {t.term for t in analyzer.analyze(u)}
                else:
                    unlike_terms.add(u)
            for text in texts:
                toks = [t.term for t in analyzer.analyze(text)] if analyzer else [text]
                for t in toks:
                    if t not in unlike_terms:
                        tf[(fld, t)] += 1
        n_docs = max(stacked.n_max * stacked.S, 1)
        scored = []
        for (fld, term), f in tf.items():
            if f < self.min_term_freq:
                continue
            df = df_of((fld, term))
            if df < self.min_doc_freq:
                continue
            scored.append((f * bm25_idf(n_docs, df), fld, term))
        scored.sort(key=lambda x: (-x[0], x[1], x[2]))
        return [(fld, term) for _, fld, term in scored[: self.max_query_terms]]

    def prepare(self, pack):
        if self._inner is None:
            stacked = getattr(pack, "stacked", None)
            if stacked is None:
                one = _OneShard(pack)
                selected = self._select_terms(one, one.df)
            else:
                selected = self._select_terms(stacked, lambda k: stacked.global_df.get(k, 0))
            if not selected:
                self._inner = MatchNoneNode()
            else:
                msm = self.minimum_should_match
                if isinstance(msm, str) and msm.endswith("%"):
                    msm_n = max(1, int(len(selected) * int(msm[:-1]) / 100))
                else:
                    msm_n = int(msm)
                self._inner = BoolNode(should=[TermNode(f, t) for f, t in selected],
                                       minimum_should_match=msm_n, boost=self.boost)
        return self._inner.prepare(pack)

    def device_eval(self, dev, params, ctx):
        return self._inner.device_eval(dev, params, ctx)


def parse_more_like_this(body, mappings) -> MoreLikeThisNode:
    fields = body.get("fields")
    if not fields:
        fields = sorted(f for f, ft in mappings.fields.items() if ft.type == "text")
    likes = body.get("like")
    if likes is None:
        raise QueryParsingError("[more_like_this] requires [like]")
    if not isinstance(likes, list):
        likes = [likes]
    texts, ids = [], []
    for like in likes:
        if isinstance(like, str):
            texts.append(like)
        elif isinstance(like, dict) and "_id" in like:
            ids.append(like["_id"])
        else:
            raise QueryParsingError(f"cannot parse [like] entry {like!r}")
    unlikes = body.get("unlike") or []
    if not isinstance(unlikes, list):
        unlikes = [unlikes]
    return MoreLikeThisNode(
        fields=list(fields), like_texts=texts, like_ids=ids,
        unlike_texts=[u for u in unlikes if isinstance(u, str)], mappings=mappings,
        max_query_terms=int(body.get("max_query_terms", 25)),
        min_term_freq=int(body.get("min_term_freq", 2)),
        min_doc_freq=int(body.get("min_doc_freq", 5)),
        minimum_should_match=body.get("minimum_should_match", "30%"),
        boost=float(body.get("boost", 1.0)))


@dataclass
class TermsSetNode(QueryNode):
    fld: str = ""
    terms: list = dc_field(default_factory=list)
    msm_field: str = ""
    boost: float = 1.0
    _nodes: list = dc_field(default_factory=list)

    def prepare(self, pack):
        self._nodes = [TermNode(self.fld, t) for t in self.terms]
        return tuple(n.prepare(pack) for n in self._nodes), float(np.float32(self.boost))

    def device_eval(self, dev, params, ctx):
        childs, boost = params
        got = dev["dv_int"].get(self.msm_field)
        if got is None:
            return _empty(ctx)
        n1 = ctx.num_docs + 1
        total = torch.zeros(n1, dtype=torch.float32, device=ctx.device)
        cnt = torch.zeros(n1, dtype=torch.int32, device=ctx.device)
        zero = torch.zeros((), dtype=torch.float32, device=ctx.device)
        for node, p in zip(self._nodes, childs):  # one elementwise add per child, in order
            s, m = node.device_eval(dev, p, ctx)
            total = total + torch.where(m, s, zero)
            cnt = cnt + m.to(torch.int32)
        msm_v, msm_h = got
        n = ctx.num_docs
        required = torch.where(msm_h, msm_v, _I32_MAX).to(torch.int32)
        match = _doc_match((cnt[:n] >= required) & (cnt[:n] > 0), ctx)
        return torch.where(match, boost * total, zero), match


@dataclass
class RankFeatureNode(QueryNode):
    fld: str = ""
    mode: str = "saturation"  # saturation | log | sigmoid | linear
    pivot: float | None = None
    exponent: float = 1.0
    scaling_factor: float = 1.0
    boost: float = 1.0

    def prepare(self, pack):
        if self.pivot is None and self.mode in ("saturation", "sigmoid"):
            # the default pivot: the column's mean (the reference stores a
            # geometric mean; the JAX package's analog is this one)
            col = pack.docvalues.get(self.fld)
            vals = None
            if col is not None and col.kind == "float" and col.has_value.any():
                vals = col.values[col.has_value]
            self.pivot = float(np.mean(vals)) if vals is not None else 1.0
        return None

    def device_eval(self, dev, params, ctx):
        got = dev["dv_float"].get(self.fld)
        if got is None:
            return _empty(ctx)
        v, h = got
        n = ctx.num_docs
        x = torch.clamp_min(v[:n].to(torch.float32), 0.0)
        f32 = np.float32
        if self.mode == "saturation":
            s = x / (x + f32(self.pivot))
        elif self.mode == "log":
            s = torch.log(f32(self.scaling_factor) + x)
        elif self.mode == "sigmoid":
            xp = x ** f32(self.exponent)
            s = xp / (xp + f32(f32(self.pivot) ** f32(self.exponent)))
        else:  # linear
            s = x
        match = _doc_match(h[:n], ctx)
        score = torch.zeros(n + 1, dtype=torch.float32, device=ctx.device)
        score[:n] = torch.where(h[:n], self.boost * s, torch.zeros((), device=ctx.device))
        return score, match


@dataclass
class DistanceFeatureNode(QueryNode):
    fld: str = ""
    kind: str = "numeric"  # numeric (a date) | geo
    origin: float = 0.0
    origin_lat: float = 0.0
    origin_lon: float = 0.0
    pivot: float = 1.0
    boost: float = 1.0

    def prepare(self, pack):
        return None

    def device_eval(self, dev, params, ctx):
        n = ctx.num_docs
        if self.kind == "geo":
            from .geo import geo_cols, haversine_m

            got = geo_cols(dev, self.fld)
            if got is None:
                return _empty(ctx)
            lat, h, lon = got
            dist = haversine_m(lat[:n], lon[:n], self.origin_lat, self.origin_lon)
        else:
            got = dev["dv_int"].get(self.fld) or dev["dv_float"].get(self.fld)
            if got is None:
                return _empty(ctx)
            v, h = got
            dist = torch.abs(v[:n].to(torch.float32) - np.float32(self.origin))
        h = h[:n]
        pivot = np.float32(self.pivot)
        s = pivot / (pivot + dist)
        match = _doc_match(h, ctx)
        score = torch.zeros(n + 1, dtype=torch.float32, device=ctx.device)
        score[:n] = torch.where(h, self.boost * s, torch.zeros((), device=ctx.device))
        return score, match


@dataclass
class PinnedNode(QueryNode):
    """The pinned ids score above any organic score, in list order
    (reference behavior: PinnedQueryBuilder, MAX_ORGANIC_SCORE): 1.7e18 less
    1e12 per list position, a step above the f32 ulp there."""

    ids: list = dc_field(default_factory=list)
    organic: QueryNode = None

    def prepare(self, pack):
        col = getattr(pack, "pack", pack).docvalues.get("_id")  # the shard's own ids
        matched, ranks = [], []
        if col is not None and col.ord_terms:
            for rank, want in enumerate(self.ids):
                i = bisect_left(col.ord_terms, str(want))
                if i < len(col.ord_terms) and col.ord_terms[i] == str(want):
                    for d in np.flatnonzero(col.values == i):
                        if int(d) not in matched:  # a doc keeps its first position
                            matched.append(int(d))
                            ranks.append(rank)
        pin = (np.float32(1.7e18)
               - np.asarray(ranks, np.float32) * np.float32(1e12)).astype(np.float32)
        return np.asarray(matched, np.int64), pin, self.organic.prepare(pack)

    def device_eval(self, dev, params, ctx):
        ids, pin, op = params
        os_, om = self.organic.device_eval(dev, op, ctx)
        scores = torch.where(om, os_, torch.zeros((), device=ctx.device))
        match = om.clone()
        if len(ids):
            tgt = torch.from_numpy(ids).to(ctx.device)
            scores[tgt] = torch.from_numpy(pin).to(ctx.device)
            match[tgt] = True
        match[ctx.num_docs] = False
        return scores, match


def parse_terms_set(body, mappings) -> TermsSetNode:
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError("[terms_set] expects {field: {...}}")
    (fld, spec), = body.items()
    terms = spec.get("terms")
    msm_field = spec.get("minimum_should_match_field")
    if not isinstance(terms, list) or not msm_field:
        raise QueryParsingError("[terms_set] requires [terms] and [minimum_should_match_field]")
    return TermsSetNode(fld=fld, terms=[str(t) for t in terms], msm_field=msm_field,
                        boost=float(spec.get("boost", 1.0)))


def parse_combined_fields(body, mappings) -> QueryNode:
    text = body.get("query")
    fields = body.get("fields")
    if text is None or not fields:
        raise QueryParsingError("[combined_fields] requires [query] and [fields]")
    from .dsl import _parse_match

    operator = body.get("operator", "or")
    children = [_parse_match({f.split("^")[0]: {"query": text, "operator": operator}}, mappings)
                for f in fields]
    return BoolNode(should=children, minimum_should_match=1,
                    boost=float(body.get("boost", 1.0)))


def parse_rank_feature(body, mappings) -> RankFeatureNode:
    fld = body.get("field")
    if not fld:
        raise QueryParsingError("[rank_feature] requires [field]")
    mode, pivot, exponent, scaling = "saturation", None, 1.0, 1.0
    for m in ("saturation", "log", "sigmoid", "linear"):
        if m in body:
            mode = m
            spec = body[m] or {}
            pivot = spec.get("pivot")
            exponent = float(spec.get("exponent", 1.0))
            scaling = float(spec.get("scaling_factor", 1.0))
    return RankFeatureNode(fld=fld, mode=mode, pivot=float(pivot) if pivot is not None else None,
                           exponent=exponent, scaling_factor=scaling,
                           boost=float(body.get("boost", 1.0)))


def parse_distance_feature(body, mappings) -> DistanceFeatureNode:
    fld, origin, pivot = body.get("field"), body.get("origin"), body.get("pivot")
    if fld is None or origin is None or pivot is None:
        raise QueryParsingError("[distance_feature] requires [field], [origin] and [pivot]")
    boost = float(body.get("boost", 1.0))
    ft = mappings.fields.get(fld)
    if ft is not None and ft.type == "geo_point":
        from ..index.pack import _parse_geo_point
        from .geo import parse_distance_meters

        lat, lon = _parse_geo_point(origin)
        return DistanceFeatureNode(fld=fld, kind="geo", origin_lat=lat, origin_lon=lon,
                                   pivot=parse_distance_meters(pivot), boost=boost)
    if ft is not None and ft.type == "date":
        from ..utils.durations import parse_duration_millis

        return DistanceFeatureNode(fld=fld, kind="numeric",
                                   origin=float(parse_date_to_millis(origin)),
                                   pivot=float(parse_duration_millis(pivot)), boost=boost)
    return DistanceFeatureNode(fld=fld, kind="numeric", origin=float(origin),
                               pivot=float(pivot), boost=boost)


def parse_pinned(body, mappings) -> PinnedNode:
    ids, organic = body.get("ids"), body.get("organic")
    if not isinstance(ids, list) or organic is None:
        raise QueryParsingError("[pinned] requires [ids] and [organic]")
    from .dsl import parse_query

    return PinnedNode(ids=[str(i) for i in ids], organic=parse_query(organic, mappings))


def parse_wrapper(body, mappings) -> QueryNode:
    raw = body.get("query")
    if not raw:
        raise QueryParsingError("[wrapper] requires base64 [query]")
    from .dsl import parse_query

    try:
        inner = json.loads(base64.b64decode(raw))
    except (binascii.Error, ValueError, TypeError) as ex:
        raise QueryParsingError(f"failed to decode wrapper query: {ex}")
    return parse_query(inner, mappings)
