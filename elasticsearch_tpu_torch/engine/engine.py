"""A minimal in-memory index: write, refresh, BM25 `_search` and `_msearch`.

Counterpart of the JAX package's `engine/engine.EsIndex`: `index_doc`
validates a document against the mappings (growing dynamic mappings) and
keeps its source; `refresh` packs every document and uploads the pack to
the device; `search` answers a query or `knn` sections with the
reference's response shape; `msearch` answers a list of search bodies as
REST `_msearch` does, packing the term disjunctions among them into
batched programs (the term lane of the reference's serving wave). Writes
become visible at the next `refresh`, as after a Lucene reader reopen; a
search before the first refresh refreshes first.

With `number_of_shards` S > 1, `refresh` routes the documents to shards by
murmur3 of their ids in insertion order (`parallel.stacked.route_docs`),
packs each shard and serves them all from one `parallel.StackedSearcher`
with global statistics; hits resolve by (shard, docid) and the term lane
goes to `parallel.msearch_sharded`. One shard keeps the single-shard
`ShardSearcher`.

`Engine` is the registry of indices behind the REST layer (`rest/app.py`):
index creation with the reference's name checks, expression resolution,
`_bulk`, cluster settings, the circuit breakers (each index's pack bytes
are charged to `fielddata` at refresh) and the serving front end
(`serving/service.py`), whose waves run through
`EsIndex.search_wave_begin` / `_fetch` / `_finish`.

Not ported yet: the translog, deletes and updates, replicas, tiered
refresh, aliases and templates, ingest pipelines, tenancy metering,
caches, aggregations, searches over several indices, `knn` together with
`query` (the hybrid rewrite), `knn` bodies in `msearch`, and `knn` on an
index of more than one shard.
"""

from __future__ import annotations

import fnmatch
import json
import time
import uuid

import numpy as np

from ..common.breaker import CircuitBreakerService
from ..common.settings import ClusterSettings, default_cluster_settings
from ..index.mappings import Mappings
from ..index.pack import PackBuilder
from ..parallel.sharded import (StackedSearcher, msearch_sharded, msearch_wave_begin,
                                msearch_wave_fetch, msearch_wave_finish)
from ..parallel.stacked import build_stacked_pack_routed, route_docs
from ..query.dsl import parse_knn, parse_query
from ..query.executor import ShardSearcher
from ..query.nodes import BoolNode, KnnNode
from ..serving.coalesce import term_disjunction_of
from ..utils.errors import (
    ElasticsearchTpuError,
    IllegalArgumentError,
    IndexAlreadyExistsError,
    IndexNotFoundError,
    VersionConflictError,
    not_yet_ported,
)
from ..utils.torch_env import resolve_device

_MSEARCH_BODY_KEYS = {"query", "size", "from"}  # a knn body is not yet ported
# the keyword arguments of EsIndex.search, and so of a serving wave entry
_SEARCH_KWARGS = ("query", "size", "from_", "knn", "track_total_hits")


class EsIndex:
    def __init__(self, name: str, mappings: Mappings | dict | None = None,
                 settings: dict | None = None, device=None, breaker_account=None):
        self.name = name
        self.mappings = mappings if isinstance(mappings, Mappings) else Mappings(mappings)
        self.settings = {"number_of_shards": 1, "number_of_replicas": 0}
        self.settings.update(settings or {})
        self.num_shards = int(self.settings["number_of_shards"])
        if self.num_shards < 1:
            raise IllegalArgumentError("number_of_shards must be >= 1")
        self.device = resolve_device(device)
        # id -> (source, parsed fields, version, seq_no); insertion order =
        # docid order
        self._docs: dict[str, tuple[dict, dict, int, int]] = {}
        self._seq_no = 0
        # called with the pack's device bytes at refresh (Engine: fielddata)
        self._breaker_account = breaker_account
        self._searcher: ShardSearcher | StackedSearcher | None = None
        # per shard, docid -> (id, source): the routed lists of the last refresh
        self.shard_docs: list[list[tuple[str, dict]]] = [[] for _ in range(self.num_shards)]

    def index_doc(self, doc_id: str | None, source: dict, op_type: str = "index") -> dict:
        """Write one document. op_type "create" refuses an existing id with
        a 409 (reference `engine.py:386`); a document without an id gets
        one and is created."""
        if doc_id is None:
            doc_id = uuid.uuid4().hex
            op_type = "create"
        old = self._docs.get(doc_id)
        if op_type == "create" and old is not None:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, document already exists "
                f"(current version [{old[2]}])")
        # the stored source is a snapshot: later caller mutation cannot
        # change what a search returns
        source = json.loads(json.dumps(source, separators=(",", ":")))
        parsed = self.mappings.parse_document(source)
        version = 1 if old is None else old[2] + 1
        seq_no = self._seq_no
        self._seq_no += 1
        self._docs[doc_id] = (source, parsed, version, seq_no)
        return {"_index": self.name, "_id": doc_id, "_version": version, "_seq_no": seq_no,
                "result": "created" if old is None else "updated"}

    def get_doc(self, doc_id: str) -> dict | None:
        """Realtime get: the last written version, refreshed or not."""
        e = self._docs.get(doc_id)
        if e is None:
            return None
        return {"_id": doc_id, "_version": e[2], "_seq_no": e[3], "_source": e[0]}

    def refresh(self) -> None:
        """Pack every document and upload the pack (a full rebuild)."""
        ids = list(self._docs)
        if self.num_shards == 1:
            builder = PackBuilder(self.mappings)
            builder.add_documents_batch([e[1] for e in self._docs.values()], doc_ids=ids)
            pack = builder.build(device=self.device)
            self._account(pack.nbytes())
            self._searcher = None  # release the old pack's device memory first
            self._searcher = ShardSearcher(pack, device=self.device, mappings=self.mappings)
            self.shard_docs = [[(i, e[0]) for i, e in zip(ids, self._docs.values())]]
            return
        # one routing pass drives both the shard packs and hit resolution
        routed = route_docs([(i, (e[0], e[1])) for i, e in self._docs.items()],
                            self.num_shards)
        sp = build_stacked_pack_routed([[(i, e[1]) for i, e in docs] for docs in routed],
                                       self.mappings, parsed=True)
        self._account(sp.nbytes())
        self._searcher = None
        self._searcher = StackedSearcher(sp, device=self.device)
        self.shard_docs = [[(i, e[0]) for i, e in docs] for docs in routed]

    def _account(self, n_bytes: int) -> None:
        """Charge the pack's device bytes before it is uploaded (a trip
        raises the breaker's 429 and leaves the old pack serving)."""
        if self._breaker_account is not None:
            self._breaker_account(n_bytes)

    @property
    def _hits_src(self) -> list[tuple[str, dict]]:
        """docid -> (id, source) of a one-shard index."""
        return self.shard_docs[0]

    @_hits_src.setter
    def _hits_src(self, docs: list[tuple[str, dict]]) -> None:
        self.shard_docs = [docs]

    def _hit(self, shard: int, docid: int, score) -> dict:
        doc_id, src = self.shard_docs[shard][docid]
        return {"_index": self.name, "_id": doc_id, "_score": float(score), "_source": src}

    @property
    def searcher(self) -> ShardSearcher | StackedSearcher:
        if self._searcher is None:
            self.refresh()
        return self._searcher

    def search(self, query: dict | None = None, size: int = 10, from_: int = 0,
               knn: dict | list | None = None,
               track_total_hits: bool | int | None = None) -> dict:
        """`_search` with a query, or with `knn` sections (one dict, or a
        list whose sections are OR-ed), as the reference's `_search_inner`
        answers them: at most k_total = sum of the sections' k hits, the
        total clamped to k_total, and a filtered ANN section that could not
        fill the page rerun on the exact scan. track_total_hits=False drops
        `hits.total`; totals are exact otherwise (the reference's relation
        "eq": its block-max WAND pruning is off by default)."""
        searcher = self.searcher
        k_total = None
        if knn is not None:
            if self.num_shards > 1:
                raise IllegalArgumentError(
                    "[knn] on an index of more than one shard is not yet ported")
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
        return self._format_generic_hits(res, track_total_hits)

    def _format_generic_hits(self, res, track_total_hits=None) -> dict:
        """A ShardResult or StackedResult -> the response body `search`
        returns, shared by the solo path and the serving wave's generic lane
        (reference `engine.py:1368-1412`), so both build it the same way."""
        shards = getattr(res, "doc_shards", np.zeros(len(res.doc_ids), np.int32))
        hits = [self._hit(int(s), int(d), score)
                for s, d, score in zip(shards, res.doc_ids, res.scores)]
        hits_obj = {"total": {"value": res.total, "relation": "eq"},
                    "max_score": res.max_score, "hits": hits}
        if track_total_hits is False:
            del hits_obj["total"]  # the reference omits hits.total entirely
        return {"hits": hits_obj}

    def _term_hits(self, v, sh, dc, total: int, k: int, size: int, from_: int,
                   track_total_hits=None) -> dict:
        """One row of the batched term lane (scores [k], shards, docids, its
        total) -> the response body, as the reference's term lane builds it
        (`engine.py:1926-1948`)."""
        nvalid = int(np.isfinite(v).sum())
        hits = [self._hit(int(sh[j]), int(dc[j]), v[j])
                for j in list(range(min(nvalid, k)))[from_: size + from_]]
        hits_obj = {"total": {"value": int(total), "relation": "eq"},
                    "max_score": float(v[0]) if nvalid else None, "hits": hits}
        if track_total_hits is False:
            del hits_obj["total"]
        return {"hits": hits_obj}

    def count(self, query: dict | None = None) -> int:
        """`_count`: the exact total of a size-0 search."""
        return self.searcher.search(query, size=0).total

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
        track_total_hits=10,000 contract, or on more than one shard one
        `msearch_sharded` call (exact totals). Every other body goes through
        `search`. A body that fails answers with its error envelope."""
        responses: list = [None] * len(searches)
        groups: dict[tuple, list] = {}
        searcher = self.searcher
        n_docs = (searcher.pack if self.num_shards == 1 else searcher.sp).num_docs
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
                spec = self._term_spec(query, n_docs)
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
            queries = [m[1] for m in members]
            if self.num_shards == 1:
                v, dc, tt, _ = searcher.msearch(fld, queries, k)
                sh = np.zeros(dc.shape, np.int32)
            else:
                v, sh, dc, tt = msearch_sharded(searcher, fld, queries, k)
            for row, (i, _terms, size, from_) in enumerate(members):
                responses[i] = {**self._term_hits(v[row], sh[row], dc[row], tt[row], k,
                                                  size, from_), "status": 200}
        return {"took": 0, "responses": responses}

    # ---- serving waves -----------------------------------------------------

    def _term_spec(self, query, n_docs: int):
        """(field, terms) when a query body rides the batched term lane."""
        if not isinstance(query, dict) or n_docs == 0:
            return None
        try:
            return term_disjunction_of(parse_query(query, self.mappings))
        except ElasticsearchTpuError:
            return None  # the per-query route raises it

    def search_wave_begin(self, entries: list[dict]) -> dict:
        """Begin one coalesced wave of independent `search` requests (each
        entry: the keyword arguments of `search`) against this index, as the
        reference's `search_wave_begin` (`engine.py:1568`) lays it out:

          * term lane: a term disjunction (match / term / bool-should of
            terms on one field) joins one `msearch_wave` batch per (field,
            k = size + from), padded to the wave's tier;
          * generic lane: every other query is planned and launched here
            (`search_many_begin`), copied back by `search_wave_fetch` in one
            copy; a knn-only entry runs its own `search` here (its starved
            filter rerun needs the host);
          * fallback: anything else (a key `search` does not take, knn with
            query) runs the full solo `search`, as the reference's does.

        -> a wave job for `search_wave_fetch` and `search_wave_finish`."""
        n = len(entries)
        job = {"entries": entries, "slots": [None] * n, "fmt": [None] * n, "lane": None,
               "term_lanes": [], "meta": {"wave_size": n, "term_packed": 0,
                                          "term_waves": [], "fallback_solo": 0}}
        searcher = self.searcher  # refreshes first when needed, as `search`
        n_docs = (searcher.pack if self.num_shards == 1 else searcher.sp).num_docs
        term_groups: dict[tuple, list] = {}
        generic_ix, generic_reqs = [], []
        for i, e in enumerate(entries):
            try:
                if set(e) - set(_SEARCH_KWARGS) or (
                        e.get("knn") is not None and e.get("query") is not None):
                    job["meta"]["fallback_solo"] += 1
                    job["slots"][i] = ("resp", self.search(**e))
                    continue
                if e.get("knn") is not None:
                    job["slots"][i] = ("resp", self.search(**e))
                    continue
                size, from_ = int(e.get("size", 10)), int(e.get("from_", 0))
                p = {"size": size, "from_": from_, "tth": e.get("track_total_hits")}
                job["fmt"][i] = p
                spec = self._term_spec(e.get("query"), n_docs)
                if spec is not None:
                    fld, terms = spec
                    term_groups.setdefault((fld, max(size + from_, 1)), []).append((i, terms))
                    continue
                node = parse_query(e.get("query"), self.mappings)
                generic_ix.append(i)
                generic_reqs.append(dict(query=node, size=size, from_=from_))
            except ElasticsearchTpuError as ex:
                job["slots"][i] = ("error", ex)
        if generic_ix:
            try:
                job["lane"] = {"ix": generic_ix,
                               "state": searcher.search_many_begin(generic_reqs)}
            except ElasticsearchTpuError:
                # one request failed to plan: each runs solo, with its own
                # answer or error
                job["meta"]["fallback_solo"] += len(generic_ix)
                for i in generic_ix:
                    try:
                        job["slots"][i] = ("resp", self.search(**entries[i]))
                    except ElasticsearchTpuError as ex:
                        job["slots"][i] = ("error", ex)
        for (fld, k), members in sorted(term_groups.items()):
            try:
                st = msearch_wave_begin(searcher, fld, [t for _, t in members], k)
                job["term_lanes"].append({"fld": fld, "k": k, "members": members, "st": st})
            except ElasticsearchTpuError as ex:
                for i, _terms in members:
                    job["slots"][i] = ("error", ex)
        return job

    def search_wave_fetch(self, job: dict) -> None:
        """Copy the wave's outputs to the host: the generic lane's one copy
        (the term lanes resolved in begin). No tensor work: it may run on
        the serving completer thread while the engine thread begins the
        next wave."""
        if job["lane"] is not None:
            self.searcher.search_many_fetch(job["lane"]["state"])
        for tl in job["term_lanes"]:
            msearch_wave_fetch(tl["st"])

    def search_wave_finish(self, job: dict) -> list:
        """-> per entry, its response dict or its exception, in entry order."""
        lane = job["lane"]
        if lane is not None:
            for i, res in zip(lane["ix"], self.searcher.search_many_finish(lane["state"])):
                job["slots"][i] = ("resp", self._format_generic_hits(res, job["fmt"][i]["tth"]))
        for tl in job["term_lanes"]:
            (v, sh, dc, tt), tier = msearch_wave_finish(tl["st"])
            job["meta"]["term_packed"] += len(tl["members"])
            job["meta"]["term_waves"].append((len(tl["members"]), int(tier)))
            for row, (i, _terms) in enumerate(tl["members"]):
                p = job["fmt"][i]
                job["slots"][i] = ("resp", self._term_hits(
                    v[row], sh[row], dc[row], tt[row], tl["k"], p["size"], p["from_"], p["tth"]))
        return [slot[1] for slot in job["slots"]]


# ---------------------------------------------------------------------------
# the node's registry of indices
# ---------------------------------------------------------------------------

# search keyword arguments of the reference that the port does not take yet
_SEARCH_NOT_PORTED = ("aggs", "sort", "search_after", "script_fields", "collapse",
                      "rescore", "runtime_mappings")


class Engine:
    """The node's indices, cluster settings, circuit breakers and serving
    front end (reference `engine.py:2094`, the analog of the per-node
    IndicesService). Defaults to the CUDA card and raises without one,
    unless the caller passes device="cpu"."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.indices: dict[str, EsIndex] = {}
        self.settings = ClusterSettings(default_cluster_settings())
        self.breakers = CircuitBreakerService(self.device, limits={
            c: self.settings.get(f"indices.breaker.{c}.limit")
            for c in ("total", "fielddata", "request")})
        for child in ("total", "fielddata", "request"):
            self.settings.add_consumer(f"indices.breaker.{child}.limit",
                                       lambda raw, c=child: self.breakers.set_limit(c, raw))
        self._serving = None
        # the serving consumers go through the lazy property: a node that
        # serves no coalesced traffic never starts the scheduler threads
        self.settings.add_consumer("serving.enabled", lambda v: self.serving.set_enabled(v))
        for key, attr in (("serving.max_wave", "set_max_wave"),
                          ("serving.coalesce.max_wait", "set_max_wait"),
                          ("serving.queue.max_depth", "set_queue_depth"),
                          ("serving.tenant.weights", "set_tenant_weights")):
            self.settings.add_consumer(key, lambda v, a=attr: getattr(self.serving, a)(v))

    # ---- serving -----------------------------------------------------------

    @property
    def serving(self):
        if self._serving is None:
            from ..serving.service import ServingService

            self._serving = ServingService(self)
        return self._serving

    def serving_if_enabled(self):
        """The serving service iff coalescing is on, without building it to
        learn that it is off (reference `engine.py:2504-2512`)."""
        if self._serving is not None:
            return self._serving if self._serving.enabled else None
        if self.settings.get("serving.enabled"):
            return self.serving
        return None

    # ---- indices -----------------------------------------------------------

    def _pack_accounter(self, name: str):
        return lambda n: self.breakers.set_steady("fielddata", name, n,
                                                  label=f"index [{name}] packs")

    def create_index(self, name: str, mappings: dict | None = None,
                     settings: dict | None = None) -> EsIndex:
        if name in self.indices:
            raise IndexAlreadyExistsError(name)
        if not name or name != name.lower() or name.startswith(("_", "-", "+")):
            raise IllegalArgumentError(f"invalid index name [{name}]")
        settings = dict(settings or {})
        settings.setdefault("creation_date", int(time.time() * 1000))
        idx = EsIndex(name, Mappings(mappings or {}), settings, device=self.device,
                      breaker_account=self._pack_accounter(name))
        self.indices[name] = idx
        return idx

    def delete_index(self, name: str) -> None:
        self.get_index(name)
        del self.indices[name]
        self.breakers.set_steady("fielddata", name, 0)

    def get_index(self, name: str) -> EsIndex:
        idx = self.indices.get(name)
        if idx is None:
            raise IndexNotFoundError(name)
        return idx

    def get_or_autocreate(self, name: str) -> EsIndex:
        """Create on first write (the reference's action.auto_create_index
        default)."""
        if name not in self.indices:
            return self.create_index(name)
        return self.indices[name]

    def resolve_search(self, expression, ignore_unavailable: bool = False,
                       allow_no_indices: bool = True) -> list[tuple[EsIndex, None]]:
        """An index expression -> [(index, alias filter)]: names, comma lists,
        `*`/`?` wildcards, `_all` and `-` exclusions, in stable order
        (reference `cluster/metadata.resolve_expression`; behavior:
        IndexNameExpressionResolver.concreteIndexNames). Aliases are not
        ported, so the filter is always None."""
        if expression is None or expression in ("", "_all", "*"):
            parts = ["*"]
        elif isinstance(expression, str):
            parts = [p for p in expression.split(",") if p]
        else:
            parts = list(expression)
        concrete = list(self.indices)
        out: list[str] = []
        for part in parts:
            neg = part.startswith("-") and out  # '-' excludes only after an inclusion
            pat = part[1:] if neg else part
            if pat == "_all":
                pat = "*"
            if neg:
                out = [n for n in out if not fnmatch.fnmatchcase(n, pat)]
            elif "*" in pat or "?" in pat:
                out += [n for n in sorted(concrete)
                        if fnmatch.fnmatchcase(n, pat) and n not in out]
            elif pat in concrete:
                if pat not in out:
                    out.append(pat)
            elif not ignore_unavailable:
                raise IndexNotFoundError(pat)
        if not out and not allow_no_indices:
            raise IndexNotFoundError(
                expression if isinstance(expression, str) else ",".join(parts))
        return [(self.indices[n], None) for n in out]

    # ---- documents ---------------------------------------------------------

    def bulk(self, operations: list) -> dict:
        """operations: (action, index, id, source). Per-item results, not
        transactional (reference `engine.py:3623`; behavior:
        TransportShardBulkAction). index and create write; delete and
        update answer a per-item 400, not yet ported."""
        items: list = []
        errors = False
        for action, index_name, doc_id, source in operations:
            try:
                if action not in ("index", "create"):
                    raise not_yet_ported(f"bulk action [{action}]")
                idx = self.get_or_autocreate(index_name)
                r = idx.index_doc(doc_id, source, op_type=action)
                items.append({action: {**r, "_index": index_name,
                                       "status": 201 if r["result"] == "created" else 200}})
            except Exception as ex:  # noqa: BLE001 - a per-item envelope
                errors = True
                if isinstance(ex, ElasticsearchTpuError):
                    err, status = {"type": ex.type, "reason": ex.reason}, ex.status
                else:
                    err, status = {"type": "exception", "reason": str(ex)}, 500
                items.append({action: {"_index": index_name, "_id": doc_id,
                                       "status": status, "error": err}})
        return {"errors": errors, "items": items}

    # ---- search ------------------------------------------------------------

    def search_multi(self, expression, *, ignore_unavailable: bool = False,
                     allow_no_indices: bool = True, **kwargs) -> dict:
        """`_search` over an index expression with one concrete target."""
        for key in _SEARCH_NOT_PORTED:
            if kwargs.pop(key, None) is not None:
                raise not_yet_ported(f"[{key}]")
        targets = self.resolve_search(expression, ignore_unavailable, allow_no_indices)
        if not targets:
            return {"hits": {"total": {"value": 0, "relation": "eq"},
                             "max_score": None, "hits": []}}
        if len(targets) > 1:
            raise not_yet_ported("a search over several indices")
        return targets[0][0].search(**kwargs)

    def count_multi(self, expression, query=None, ignore_unavailable: bool = False,
                    allow_no_indices: bool = True) -> int:
        return sum(idx.count(query) for idx, _ in
                   self.resolve_search(expression, ignore_unavailable, allow_no_indices))

    def cluster_health(self, expression: str | None = None) -> dict:
        """Cluster health from each index's replicas: one node cannot assign
        a replica, so an index with replicas is yellow, else green
        (reference `engine.py:2694`; the port has no red index: every
        index serves from its first search on)."""
        names = sorted(self.indices)
        if expression:
            try:
                names = sorted(idx.name for idx, _ in self.resolve_search(expression))
            except ElasticsearchTpuError:
                names = []
        per_index = {}
        active = unassigned = 0
        for n in names:
            idx = self.indices[n]
            replicas = int(idx.settings.get("number_of_replicas") or 0)
            active += idx.num_shards
            unassigned += replicas * idx.num_shards
            per_index[n] = {"status": "yellow" if replicas else "green",
                            "number_of_shards": idx.num_shards,
                            "number_of_replicas": replicas,
                            "active_shards": idx.num_shards,
                            "unassigned_shards": replicas * idx.num_shards}
        total = active + unassigned
        return {
            "cluster_name": "elasticsearch-tpu",
            "status": "yellow" if unassigned else "green",
            "timed_out": False,
            "number_of_nodes": 1,
            "number_of_data_nodes": 1,
            "active_primary_shards": active,
            "active_shards": active,
            "relocating_shards": 0,
            "initializing_shards": 0,
            "unassigned_shards": unassigned,
            "active_shards_percent_as_number": (
                100.0 if total == 0 else round(100.0 * active / total, 1)),
            "indices": per_index,
        }

    def close(self) -> None:
        if self._serving is not None:
            self._serving.stop()
