"""`_rank_eval` and the RRF retriever.

Counterpart of the JAX package's `search/rankeval.py` (behavior:
modules/rank-eval TransportRankEvalAction with PrecisionAtK, RecallAtK,
MeanReciprocalRank, DiscountedCumulativeGain and ExpectedReciprocalRank;
x-pack rank-rrf RRFRankBuilder). Each rated request runs through
`Engine.search_multi` over the indices its ratings name (not the index of
the request's path), so each ends in the searches' `scan_topk` selections;
the metrics are host arithmetic over the hits' (index, id) keys. The RRF
retriever fuses its sub-retrievers' ranked lists (a `standard` query, a
`knn` section) by sum 1 / (rank_constant + rank).
"""

from __future__ import annotations

import math

from ..utils.errors import IllegalArgumentError


def _rated_map(ratings) -> dict:
    return {(r["_index"], r["_id"]): int(r["rating"]) for r in ratings}


def _metric_precision(hit_keys, rated, k, relevant_threshold=1):
    top = hit_keys[:k]
    if not top:
        return 0.0, []
    rel = sum(1 for key in top if rated.get(key, 0) >= relevant_threshold)
    return rel / len(top), top


def _metric_recall(hit_keys, rated, k, relevant_threshold=1):
    total_rel = sum(1 for v in rated.values() if v >= relevant_threshold)
    if total_rel == 0:
        return 0.0, hit_keys[:k]
    rel = sum(1 for key in hit_keys[:k] if rated.get(key, 0) >= relevant_threshold)
    return rel / total_rel, hit_keys[:k]


def _metric_mrr(hit_keys, rated, k, relevant_threshold=1):
    for i, key in enumerate(hit_keys[:k]):
        if rated.get(key, 0) >= relevant_threshold:
            return 1.0 / (i + 1), hit_keys[:k]
    return 0.0, hit_keys[:k]


def _dcg(gains):
    return sum(g / math.log2(i + 2) for i, g in enumerate(gains))


def _metric_dcg(hit_keys, rated, k, normalize=False):
    gains = [(2 ** rated.get(key, 0) - 1) for key in hit_keys[:k]]
    dcg = _dcg(gains)
    if not normalize:
        return dcg, hit_keys[:k]
    ideal = sorted((2 ** v - 1 for v in rated.values()), reverse=True)[:k]
    idcg = _dcg(ideal)
    return (dcg / idcg if idcg > 0 else 0.0), hit_keys[:k]


def _metric_err(hit_keys, rated, k, max_rating=3):
    p_stop = 1.0
    err = 0.0
    for i, key in enumerate(hit_keys[:k]):
        r = rated.get(key, 0)
        useful = (2 ** r - 1) / (2 ** max_rating)
        err += p_stop * useful / (i + 1)
        p_stop *= 1 - useful
    return err, hit_keys[:k]


def rank_eval(engine, body: dict) -> dict:
    requests = body.get("requests")
    if not isinstance(requests, list) or not requests:
        raise IllegalArgumentError("[rank_eval] requires [requests]")
    metric_spec = body.get("metric") or {"precision": {}}
    (metric_name, mopts), = metric_spec.items()
    k = int(mopts.get("k", 10))
    details = {}
    total = 0.0
    for req in requests:
        rid = req.get("id")
        if not rid:
            raise IllegalArgumentError("every rank_eval request needs an [id]")
        ratings = req.get("ratings") or []
        rated = _rated_map(ratings)
        search_body = req.get("request") or {}
        expr = ",".join(sorted({r["_index"] for r in ratings})) or "_all"
        res = engine.search_multi(
            expr, query=search_body.get("query"),
            size=int(search_body.get("size", k)), from_=0,
        )
        hit_keys = [(h["_index"], h["_id"]) for h in res["hits"]["hits"]]
        if metric_name == "precision":
            score, top = _metric_precision(
                hit_keys, rated, k, int(mopts.get("relevant_rating_threshold", 1)))
        elif metric_name == "recall":
            score, top = _metric_recall(
                hit_keys, rated, k, int(mopts.get("relevant_rating_threshold", 1)))
        elif metric_name == "mean_reciprocal_rank":
            score, top = _metric_mrr(
                hit_keys, rated, k, int(mopts.get("relevant_rating_threshold", 1)))
        elif metric_name == "dcg":
            score, top = _metric_dcg(hit_keys, rated, k, bool(mopts.get("normalize")))
        elif metric_name == "expected_reciprocal_rank":
            score, top = _metric_err(hit_keys, rated, k,
                                     int(mopts.get("maximum_relevance", 3)))
        else:
            raise IllegalArgumentError(f"unknown rank_eval metric [{metric_name}]")
        total += score
        details[rid] = {
            "metric_score": score,
            "unrated_docs": [
                {"_index": ix, "_id": i} for ix, i in top if (ix, i) not in rated
            ],
            "hits": [
                {"hit": {"_index": ix, "_id": i},
                 "rating": rated.get((ix, i))}
                for ix, i in top
            ],
        }
    return {
        "metric_score": total / len(requests),
        "details": details,
        "failures": {},
    }


def rrf_retriever_search(engine, expression, retriever: dict, size, from_):
    """RRF retriever: reciprocal-rank fusion of sub-retrievers (reference
    behavior: x-pack/plugin/rank-rrf RRFRankBuilder — score =
    sum 1/(rank_constant + rank) over retrievers)."""
    (kind, body), = retriever.items()
    if kind == "standard":
        return engine.search_multi(expression, query=body.get("query"),
                                   size=size, from_=from_)
    if kind == "knn":
        return engine.search_multi(expression, knn=body, size=size, from_=from_)
    if kind != "rrf":
        raise IllegalArgumentError(f"unknown retriever [{kind}]")
    subs = body.get("retrievers")
    if not isinstance(subs, list) or len(subs) < 2:
        raise IllegalArgumentError("[rrf] requires 2+ [retrievers]")
    rank_constant = int(body.get("rank_constant", 60))
    window = int(body.get("rank_window_size", 100))
    fused: dict = {}
    hit_of = {}
    for sub in subs:
        res = rrf_retriever_search(engine, expression, sub, window, 0)
        for rank, h in enumerate(res["hits"]["hits"]):
            key = (h["_index"], h["_id"])
            fused[key] = fused.get(key, 0.0) + 1.0 / (rank_constant + rank + 1)
            hit_of.setdefault(key, h)
    order = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))
    hits = []
    for key, score in order[from_: from_ + size]:
        h = dict(hit_of[key])
        h["_score"] = score
        hits.append(h)
    return {
        "hits": {
            "total": {"value": len(fused), "relation": "eq"},
            "max_score": hits[0]["_score"] if hits else None,
            "hits": hits,
        },
    }
