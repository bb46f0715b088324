"""A minimal in-memory index: write, refresh, BM25 `_search` and `_msearch`.

Counterpart of the JAX package's `engine/engine.EsIndex` for one shard:
`index_doc` validates a document against the mappings (growing dynamic
mappings) and keeps its source; `refresh` packs every document and uploads
the pack to the device; `search` answers with the reference's response
shape; `msearch` answers a list of search bodies as REST `_msearch` does,
packing the term disjunctions among them into batched programs (the term
lane of the reference's serving wave). Writes become visible at the next
`refresh`, as after a Lucene reader reopen; a search before the first
refresh refreshes first.

Not ported yet: the translog, deletes, shards and replicas, tiered
refresh, REST, the serving queue, tenancy, deadlines, caches and
aggregations.
"""

from __future__ import annotations

import json
import uuid

import numpy as np

from ..index.mappings import Mappings
from ..index.pack import PackBuilder
from ..query.dsl import parse_query
from ..query.executor import ShardSearcher
from ..serving.coalesce import term_disjunction_of
from ..utils.errors import ElasticsearchTpuError, IllegalArgumentError
from ..utils.torch_env import resolve_device

_MSEARCH_BODY_KEYS = {"query", "size", "from"}


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
        pack = builder.build()
        self._searcher = None  # release the old pack's device memory first
        self._searcher = ShardSearcher(pack, device=self.device, mappings=self.mappings)
        self._hits_src = [(i, e[0]) for i, e in zip(ids, self._docs.values())]

    @property
    def searcher(self) -> ShardSearcher:
        if self._searcher is None:
            self.refresh()
        return self._searcher

    def search(self, query: dict | None = None, size: int = 10, from_: int = 0) -> dict:
        res = self.searcher.search(query, size=size, from_=from_)
        hits = []
        for d, score in zip(res.doc_ids, res.scores):
            doc_id, src = self._hits_src[d]
            hits.append({"_index": self.name, "_id": doc_id,
                         "_score": float(score), "_source": src})
        return {"hits": {"total": {"value": res.total, "relation": "eq"},
                         "max_score": res.max_score, "hits": hits}}

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
