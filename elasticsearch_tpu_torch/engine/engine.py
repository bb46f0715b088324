"""A minimal in-memory index: write, refresh, BM25 `_search`.

Counterpart of the JAX package's `engine/engine.EsIndex` for one shard:
`index_doc` validates a document against the mappings (growing dynamic
mappings) and keeps its source; `refresh` packs every document and uploads
the pack to the device; `search` answers with the reference's response
shape. Writes become visible at the next `refresh`, as after a Lucene
reader reopen; a search before the first refresh refreshes first.

Not ported yet: the translog, deletes, shards and replicas, tiered
refresh, REST, serving, caches and aggregations.
"""

from __future__ import annotations

import json
import uuid

from ..index.mappings import Mappings
from ..index.pack import PackBuilder
from ..query.executor import ShardSearcher
from ..utils.errors import IllegalArgumentError
from ..utils.torch_env import resolve_device


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
