"""Helpers of the port's text-DSL and sorted-search tests: the same index in
both packages, and the comparison of their `_search` responses.

Tolerances: totals equal; scores within 1e-6 relative (the two packages
run the same f32 operations, up to XLA's FMA contraction on the CPU and a
fuzzy query's f64 per-doc sum, rounded once, where the JAX package adds in
f32); ids equal except where the two scores agree within 1e-5 relative
(fp-ties), or within the impact tier's tie class where a test passes it
(`impact_tie`); each hit's `_source` equal. Sorted hits: the `sort` arrays
equal, ids equal up to full-key ties (the JAX package documents no order
among them; the port orders them by (shard, docid)). `rest_both` drives
one REST sequence through both packages' apps.
"""

from __future__ import annotations

import json

import numpy as np

from elasticsearch_tpu.engine.engine import Engine as RefEngine
from elasticsearch_tpu_torch.engine import Engine


def close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def same_sort(a: list, b: list) -> bool:
    """Two `sort` arrays agree: equal, a float within 1e-6 relative (a
    `_score` key)."""
    return len(a) == len(b) and all(
        x == y or (isinstance(x, float) and isinstance(y, float) and close(x, y, 1e-6))
        for x, y in zip(a, b))


def same_hits(got: dict, want: dict, what: str, tie: float = 0.0) -> None:
    """Two `_search` responses' `hits` (and `aggregations`) agree. `tie`
    (absolute, default none) widens the score and fp-tie tolerances to the
    impact tier's quantization tie class (`impact_tie`), where a search
    scores from the impact tier of a tail segment."""
    gh, wh = got["hits"], want["hits"]
    assert gh.get("total") == wh.get("total"), what
    if wh["max_score"] is None:
        assert gh["max_score"] is None, what
    else:
        assert close(gh["max_score"], wh["max_score"], 1e-6) or \
            abs(gh["max_score"] - wh["max_score"]) <= tie, what
    assert len(gh["hits"]) == len(wh["hits"]), (what, len(gh["hits"]), len(wh["hits"]))
    for g, w in zip(gh["hits"], wh["hits"]):
        assert g.get("fields") == w.get("fields") or g["_id"] != w["_id"], (what, g, w)
        if w["_score"] is None:
            assert g["_score"] is None, what
            assert same_sort(g["sort"], w["sort"]), (what, g, w)
            if g["_id"] != w["_id"]:  # full-key ties only
                continue
        else:
            gap = abs(g["_score"] - w["_score"])
            assert close(g["_score"], w["_score"], 1e-6) or gap <= tie, (what, g, w)
            if g["_id"] != w["_id"]:  # fp-ties only
                assert close(g["_score"], w["_score"], 1e-5) or gap <= tie, (what, g, w)
                continue
        assert g["_source"] == w["_source"] and g["_index"] == w["_index"], what
    assert got.get("aggregations") == want.get("aggregations"), what


def _term_nodes(node) -> list:
    from elasticsearch_tpu_torch.query.nodes import BoolNode, ConstantScoreNode, TermNode

    if isinstance(node, TermNode):
        return [node]
    if isinstance(node, BoolNode):
        return [t for grp in (node.must, node.filter, node.should, node.must_not)
                for c in grp for t in _term_nodes(c)]
    if isinstance(node, ConstantScoreNode):
        return _term_nodes(node.child)
    return []


def impact_tie(idx, query) -> float:
    """The quantization tie class of the port's impact-tier scores of
    `query` on a port `EsIndex` as its tiers stand: per tier, 2 · Σ
    boost·idf·ubf / QMAX over the terms that tier serves from its codes
    (each term's largest per-shard ubf), + 1e-7; the largest over the tiers
    (a hit's score comes from one tier). Queue C, slice 11: the impact
    tier's scores lie within it of exact BM25."""
    from elasticsearch_tpu_torch.query.dsl import parse_query

    worst = 0.0
    for searcher in idx.tier_searchers():
        sp = getattr(searcher, "sp", None)
        view = searcher._views[0] if sp is not None else searcher.view
        packs = list(sp.shards) if sp is not None else [searcher.pack]
        bound = 0.0
        for t in _term_nodes(parse_query(query, idx.mappings)):
            params = t.prepare(view)
            if params[0] != "impact":
                continue
            key = (t.fld, t.term)
            ubf = max((float(p.impact_ubf[p.term_dict[key]]) for p in packs
                       if key in p.term_dict), default=0.0)
            bound += params[2] * ubf / packs[0].impact_meta["qmax"]
        worst = max(worst, bound)
    return 2 * worst + 1e-7


def sorted_ties_hold(got: dict, want: dict) -> None:
    """Sorted pages: ids equal within each run of equal `sort` arrays."""
    def runs(hits):
        out = {}
        for h in hits:
            out.setdefault(repr(h["sort"]), set()).add(h["_id"])
        return out

    g, w = got["hits"]["hits"], want["hits"]["hits"]
    assert len(g) == len(w) and all(same_sort(a["sort"], b["sort"]) for a, b in zip(g, w))
    full_g, full_w = runs(g), runs(w)
    last = repr(w[-1]["sort"]) if w else None
    if set(full_g) == set(full_w):  # a float key off by an ulp makes other runs
        for key, ids in full_w.items():
            if key != last:  # the last run may continue past the page
                assert full_g[key] == ids


def pages_of(one: list, size: int, n_pages: int) -> list:
    """The hits that `n_pages` search_after pages of `size` give, from one
    sorted page `one`: each page starts after the last hit whose sort keys
    equal the previous page's last keys (search_after skips the rest of a
    full-key tie, as Elasticsearch's does without a tiebreak field)."""
    out, start = [], 0
    for _ in range(n_pages):
        page = one[start: start + size]
        if not page:
            break
        out += page
        last = page[-1]["sort"]
        start += len(page)
        while start < len(one) and one[start]["sort"] == last:
            start += 1
    return out


class Pair:
    """The same index in both packages (reference `Engine(None)`, port
    `Engine(device="cpu")`), driven by the same calls."""

    def __init__(self, mapping: dict, settings: dict | None = None):
        self.ref_engine, self.port_engine = RefEngine(None), Engine(device="cpu")
        self.ref = self.ref_engine.create_index("idx", mapping, dict(settings or {}))
        self.port = self.port_engine.create_index("idx", mapping, dict(settings or {}))

    def close(self):
        self.ref_engine.close()
        self.port_engine.close()

    def index(self, docs):
        for i, d in docs:
            self.ref.index_doc(i, d)
            self.port.index_doc(i, d)

    def refresh(self):
        self.ref.refresh()
        self.port.refresh()

    def search(self, **kw) -> tuple[dict, dict]:
        return self.port.search(**kw), self.ref.search(**kw)

    def check(self, what: str, **kw) -> dict:
        got, want = self.search(**kw)
        same_hits(got, want, f"{what} {kw}")
        return got


def text_docs(seed: int, n: int, vocab: int = 60, mean_len: int = 10) -> list:
    """(id, source) docs: a Zipf `body` of w<i> words, a short `title` on
    some docs, a keyword `tag` (missing on some), a long `n` and a double
    `p` (missing on some, -0.0 and +0.0 among the values)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        words = rng.choice(vocab, size=int(rng.integers(2, 2 * mean_len)), p=p)
        src = {"body": " ".join(f"w{w}" for w in words), "n": int(rng.integers(0, 50))}
        if i % 3 == 0:
            src["title"] = " ".join(f"w{w}" for w in words[:3])
        if i % 7:
            src["tag"] = f"k{int(rng.integers(0, 12)):02d}"
        if i % 5:
            src["p"] = [-0.0, 0.0, 1.5, -2.25, 3.0][int(rng.integers(0, 5))]
        docs.append((f"d{i}", src))
    return docs


MAPPING = {"properties": {"body": {"type": "text"}, "title": {"type": "text"},
                          "tag": {"type": "keyword"}, "n": {"type": "long"},
                          "p": {"type": "double"}}}


def _rest_payload(body) -> tuple[bytes, str]:
    if body is None:
        return b"", "application/json"
    if isinstance(body, str):
        return body.encode(), "application/x-ndjson"
    return json.dumps(body).encode(), "application/json"


def rest_both(sequence, ref_dir, port_app=None) -> tuple[dict, dict]:
    """One REST sequence [(name, method, path, body, params)] through the
    port's `RestApp` (device="cpu", no socket; or `port_app`) and the JAX
    package's aiohttp app (its TestClient, the engine's data under
    `ref_dir`, sparse terms from its impact tier as the port scores them)
    -> ({name: (status, response)} of the port, of the reference)."""
    import asyncio
    import os

    from aiohttp.test_utils import TestClient, TestServer

    from elasticsearch_tpu.rest.app import make_app as ref_make_app
    from elasticsearch_tpu_torch.rest import make_app

    app = port_app if port_app is not None else make_app(device="cpu")
    port = {}
    try:
        for name, method, path, body, params in sequence:
            data, ctype = _rest_payload(body)
            status, _h, raw = app.handle(method, path, dict(params), {"Content-Type": ctype},
                                         data)
            port[name] = (status, json.loads(raw) if raw else None)
    finally:
        if port_app is None:
            app.close()

    async def scenario():
        client = TestClient(TestServer(ref_make_app(engine=RefEngine(str(ref_dir)))))
        await client.start_server()
        out = {}
        try:
            for name, method, path, body, params in sequence:
                data, ctype = _rest_payload(body)
                r = await client.request(method, path, params=params, data=data,
                                         headers={"Content-Type": ctype})
                raw = await r.read()
                out[name] = (r.status, json.loads(raw) if raw else None)
        finally:
            await client.close()
        return out

    old = os.environ.get("ES_TPU_IMPACT")
    os.environ["ES_TPU_IMPACT"] = "force"
    loop = asyncio.new_event_loop()
    try:
        ref = loop.run_until_complete(scenario())
    finally:
        loop.close()
        if old is None:
            os.environ.pop("ES_TPU_IMPACT", None)
        else:
            os.environ["ES_TPU_IMPACT"] = old
    return port, ref
