"""A minimal in-memory index: write, refresh, BM25 `_search` and `_msearch`.

Counterpart of the JAX package's `engine/engine.EsIndex` for one shard:
`index_doc` validates a document against the mappings (growing dynamic
mappings) and keeps its source; `refresh` packs every document and uploads
the pack to the device; `search` answers a query or `knn` sections with the
reference's response shape; `msearch` answers a list of search bodies as REST `_msearch` does,
packing the term disjunctions among them into batched programs (the term
lane of the reference's serving wave). Writes become visible at the next
`refresh`, as after a Lucene reader reopen; a search before the first
refresh refreshes first.

Not ported yet: the translog, deletes, shards and replicas, tiered
refresh, REST, the serving queue, tenancy, deadlines, caches,
aggregations, `knn` together with `query` (the hybrid rewrite) and `knn`
bodies in `msearch`.
"""

from __future__ import annotations

import json
import uuid

import numpy as np

from ..index.mappings import Mappings
from ..index.pack import PackBuilder
from ..query.dsl import parse_knn, parse_query
from ..query.executor import ShardSearcher
from ..query.nodes import BoolNode, KnnNode
from ..serving.coalesce import term_disjunction_of
from ..utils.errors import ElasticsearchTpuError, IllegalArgumentError
from ..utils.torch_env import resolve_device

_MSEARCH_BODY_KEYS = {"query", "size", "from"}  # a knn body is not yet ported


class EsIndex:
    def __init__(self, name: str, mappings: Mappings | dict | None = None,
                 settings: dict | None = None, device=None):
        self.name = name
        self.mappings = mappings if isinstance(mappings, Mappings) else Mappings(mappings)
        self.settings = {"number_of_shards": 1, "number_of_replicas": 0}
        self.settings.update(settings or {})
        if int(self.settings["number_of_shards"]) != 1:
            raise IllegalArgumentError("number_of_shards other than 1 is not yet ported")
        self.device = resolve_device(device)
        # id -> (source, parsed fields, version); insertion order = docid order
        self._docs: dict[str, tuple[dict, dict, int]] = {}
        self._searcher: ShardSearcher | None = None
        self._hits_src: list[tuple[str, dict]] = []  # docid -> (id, source)

    def index_doc(self, doc_id: str | None, source: dict) -> dict:
        if doc_id is None:
            doc_id = uuid.uuid4().hex
        # the stored source is a snapshot: later caller mutation cannot
        # change what a search returns
        source = json.loads(json.dumps(source, separators=(",", ":")))
        parsed = self.mappings.parse_document(source)
        old = self._docs.get(doc_id)
        version = 1 if old is None else old[2] + 1
        self._docs[doc_id] = (source, parsed, version)
        return {"_index": self.name, "_id": doc_id, "_version": version,
                "result": "created" if old is None else "updated"}

    def refresh(self) -> None:
        """Pack every document and upload the pack (a full rebuild)."""
        ids = list(self._docs)
        builder = PackBuilder(self.mappings)
        builder.add_documents_batch([e[1] for e in self._docs.values()], doc_ids=ids)
        pack = builder.build(device=self.device)
        self._searcher = None  # release the old pack's device memory first
        self._searcher = ShardSearcher(pack, device=self.device, mappings=self.mappings)
        self._hits_src = [(i, e[0]) for i, e in zip(ids, self._docs.values())]

    @property
    def searcher(self) -> ShardSearcher:
        if self._searcher is None:
            self.refresh()
        return self._searcher

    def search(self, query: dict | None = None, size: int = 10, from_: int = 0,
               knn: dict | list | None = None) -> dict:
        """`_search` with a query, or with `knn` sections (one dict, or a
        list whose sections are OR-ed), as the reference's `_search_inner`
        answers them: at most k_total = sum of the sections' k hits, the
        total clamped to k_total, and a filtered ANN section that could not
        fill the page rerun on the exact scan."""
        searcher = self.searcher
        k_total = None
        if knn is not None:
            if query is not None:
                raise IllegalArgumentError(
                    "[knn] together with [query] (the hybrid rewrite) is not yet ported")
            nodes = [parse_knn(b, self.mappings) for b in (knn if isinstance(knn, list) else [knn])]
            self._apply_knn_settings(nodes)
            query = nodes[0] if len(nodes) == 1 else BoolNode(should=nodes, minimum_should_match=1)
            k_total = sum(kn.k for kn in nodes)
            size = min(size, max(k_total - from_, 0))
        res = searcher.search(query, size=size, from_=from_)
        if k_total is not None:
            if self._knn_mark_starved(query, len(res.doc_ids) + from_, size + from_):
                res = searcher.search(query, size=size, from_=from_)
            res.total = min(res.total, k_total)
        hits = []
        for d, score in zip(res.doc_ids, res.scores):
            doc_id, src = self._hits_src[d]
            hits.append({"_index": self.name, "_id": doc_id,
                         "_score": float(score), "_source": src})
        return {"hits": {"total": {"value": res.total, "relation": "eq"},
                         "max_score": res.max_score, "hits": hits}}

    # ---- knn ---------------------------------------------------------------

    def _apply_knn_settings(self, nodes: list[KnnNode]) -> None:
        """Fill each section's nprobe from the `knn.nprobe` index setting
        when the body pins none (0 = auto: probes sized to num_candidates)."""
        try:
            default = int(self.settings.get("knn.nprobe") or 0)
        except (TypeError, ValueError):
            default = 0
        if default > 0:
            for kn in nodes:
                if kn.nprobe is None:
                    kn.nprobe = default

    @staticmethod
    def _knn_nodes_of(node) -> list[KnnNode]:
        if isinstance(node, KnnNode):
            return [node]
        if isinstance(node, BoolNode):
            return [c for c in node.should if isinstance(c, KnnNode)]
        return []

    def _knn_mark_starved(self, node, hits_found: int, window: int) -> bool:
        """A filtered or thresholded section on the ANN path that could not
        fill the window is starved: the filter may have eaten the
        oversampled candidates. Flip those sections to force_exact and say
        whether a rerun is needed (the only case the ANN path falls back)."""
        nodes = self._knn_nodes_of(node)
        starved = [kn for kn in nodes if getattr(kn, "_ann", None) is not None
                   and (kn.filter_node is not None or kn.similarity_threshold is not None)]
        if not starved or hits_found >= min(window, sum(kn.k for kn in nodes) or window):
            return False
        for kn in starved:
            kn.force_exact = True
        return True

    def msearch(self, searches: list[dict]) -> dict:
        """`_msearch` over this index: one response per search body, in
        order, each with "status" (reference behavior: REST `_msearch`).

        Bodies whose query is a term disjunction (`term_disjunction_of`)
        are grouped by (field, k = size + from); each group is one
        `ShardSearcher.msearch` call, whose totals follow its
        track_total_hits=10,000 contract. Every other body goes through
        `search`. A body that fails answers with its error envelope."""
        responses: list = [None] * len(searches)
        groups: dict[tuple, list] = {}
        searcher = self.searcher
        for i, body in enumerate(searches):
            try:
                if not isinstance(body, dict):
                    raise IllegalArgumentError("an msearch body must be an object")
                extra = sorted(set(body) - _MSEARCH_BODY_KEYS)
                if extra:
                    raise IllegalArgumentError(f"msearch body keys {extra} are not yet ported")
                query = body.get("query")
                try:
                    size, from_ = int(body.get("size", 10)), int(body.get("from", 0))
                except (TypeError, ValueError):
                    raise IllegalArgumentError("[size] and [from] must be integers") from None
                spec = None
                if isinstance(query, dict) and searcher.pack.num_docs > 0:
                    try:
                        spec = term_disjunction_of(parse_query(query, self.mappings))
                    except ElasticsearchTpuError:
                        spec = None  # the per-query route raises it
                if spec is None:
                    responses[i] = {**self.search(query, size=size, from_=from_),
                                    "status": 200}
                    continue
            except ElasticsearchTpuError as ex:
                responses[i] = {**ex.to_dict(), "status": ex.status}
                continue
            fld, terms = spec
            groups.setdefault((fld, max(size + from_, 1)), []).append(
                (i, terms, size, from_))
        for (fld, k), members in groups.items():
            v, dc, tt, _ = searcher.msearch(fld, [m[1] for m in members], k)
            for row, (i, _terms, size, from_) in enumerate(members):
                nvalid = int(np.isfinite(v[row]).sum())
                hits = []
                for j in list(range(min(nvalid, k)))[from_: size + from_]:
                    doc_id, src = self._hits_src[int(dc[row][j])]
                    hits.append({"_index": self.name, "_id": doc_id,
                                 "_score": float(v[row][j]), "_source": src})
                responses[i] = {"hits": {
                    "total": {"value": int(tt[row]), "relation": "eq"},
                    "max_score": float(v[row][0]) if nvalid else None,
                    "hits": hits,
                }, "status": 200}
        return {"took": 0, "responses": responses}
