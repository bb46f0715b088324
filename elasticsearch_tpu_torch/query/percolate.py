"""The `percolate` query: the stored queries that match given documents.

This package's copy of the JAX package's `query/percolate.py` (reference
behavior: modules/percolator PercolateQueryBuilder.java). Each shard keeps
its stored queries on the host (`ShardPack.percolator`). The given
documents are packed once into a small `ShardSearcher` on the index's
device; every stored query runs against it (its match & live count on the
device, all counts copied back at once), and the docids of the matching
stored queries feed the device as an id set (`nodes.id_set_match`).

A stored query that does not parse or plan (a query error: QueryParsingError,
IllegalArgumentError, MapperParsingError) never matches, as in the
reference. Anything else, a CUDA launch or build failure above all, is
raised: the reference's matcher catches every exception.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..utils.errors import IllegalArgumentError, MapperParsingError, QueryParsingError
from .nodes import QueryNode, id_set_match

_QUERY_ERRORS = (QueryParsingError, IllegalArgumentError, MapperParsingError)


@dataclass
class PercolateNode(QueryNode):
    fld: str = ""
    documents: list = dc_field(default_factory=list)
    mappings: object = None
    boost: float = 1.0
    _matcher: object = None

    def _ensure_matcher(self, device):
        if self._matcher is not None:
            return self._matcher
        from ..index.pack import PackBuilder
        from .executor import ShardSearcher

        b = PackBuilder(self.mappings)
        b.add_documents_batch([self.mappings.parse_document(d) for d in self.documents])
        pack = b.build(dense_min_df=1 << 62)
        self._matcher = ShardSearcher(pack, device=device, mappings=self.mappings)
        return self._matcher

    def _count(self, m, qdict):
        """A stored query's match & live count on the matcher's device, or
        None for a query error."""
        from .dsl import parse_query

        try:
            node = parse_query(qdict, self.mappings)
            _, match = node.device_eval(m.dev, node.prepare(m.view), m.ctx)
        except _QUERY_ERRORS:
            return None
        return (match[: m.pack.num_docs] & m.dev["live"]).sum()

    def matching_docids(self, stored: list, device) -> np.ndarray:
        """The docids of the stored queries that match the documents."""
        if not stored:
            return np.zeros(0, np.int64)
        m = self._ensure_matcher(device)
        docids, counts = [], []
        for docid, q in stored:
            c = self._count(m, q)
            if c is not None:
                docids.append(docid)
                counts.append(c)
        if not counts:
            return np.zeros(0, np.int64)
        hit = (torch.stack(counts) > 0).cpu().numpy()
        return np.asarray(docids, np.int64)[hit]

    def prepare(self, pack):
        real = getattr(pack, "pack", pack)  # a shard view's own stored queries
        return real.percolator.get(self.fld, [])

    def device_eval(self, dev, params, ctx):
        return id_set_match(self.matching_docids(params, ctx.device), self.boost, ctx)


def parse_percolate(body, mappings) -> PercolateNode:
    if not isinstance(body, dict):
        raise IllegalArgumentError("[percolate] expects an object")
    fld = body.get("field")
    if not fld:
        raise IllegalArgumentError("[percolate] requires [field]")
    docs = body.get("documents")
    if docs is None:
        doc = body.get("document")
        if doc is None:
            raise IllegalArgumentError("[percolate] requires [document] or [documents]")
        docs = [doc]
    return PercolateNode(fld=fld, documents=list(docs), mappings=mappings,
                         boost=float(body.get("boost", 1.0)))
