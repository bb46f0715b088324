"""A minimal in-memory index: writes, tiered refresh, BM25 `_search` and `_msearch`.

Counterpart of the JAX package's `engine/engine.EsIndex`: `index_doc`
validates a document against the mappings (growing dynamic mappings) and
keeps its source; `delete_doc` marks it dead; `refresh` makes the writes
since the last refresh searchable; `search` answers a query or `knn`
sections, with `aggs` beside them, with the reference's response shape; `msearch` answers a list of
search bodies as REST `_msearch` does, packing the term disjunctions among
them into batched programs (the term lane of the reference's serving
wave). Writes become visible at the next `refresh`, as after a Lucene
reader reopen: explicitly, or before a search, a wave or a count once
`refresh_interval` (index setting, default "1s"; "-1": explicit refreshes
only) has passed since the last one. A new index refreshes at once, so it
is searchable as empty (reference `engine.py:193-196`).

Refresh is an LSM of sealed tiers, as in the reference (`engine.py:584-950`):
a new index's base is empty; a refresh, while the docs outside the base
stay within max(256, base/10), is incremental: it clears the live
bit of each superseded or deleted copy in whichever tier holds it, packs
only the new docs as one sealed tail segment (a `StackedSearcher` with no
dense tier), and scores every tier under the statistics combined over all
of them (replaced and deleted copies keep counting in df and avgdl until
a merge, as Lucene counts its deleted documents; the base's dense tier and
impact codes are re-derived on the device). Past the cluster setting
`indexing.tiers.max_segments` (default 4) the segments fold into one,
inline; beyond the growth bound a full rebuild packs a new base. A base
of zero docs takes no kernel launch (`scan_topk` chooses its empty route
by shape). Every build runs into
locals and installs only after the breaker admitted it: a trip or a failed
build leaves the old tiers serving. `search`, `count` and the serving
wave's tiered lane run each tier and merge by (score desc, tier asc, rank
asc); a kNN-only search runs its sections on each tier (each segment
probes its own ANN index) and merges the same way; anything else the
tiers cannot serve (`knn` with `query`, a query that fails to parse, the
`searcher` property) merges them into one base first.

With `number_of_shards` S > 1, the base routes the documents to shards by
murmur3 of their ids in insertion order (`parallel.stacked.route_docs`),
packs each shard and serves them all from one `parallel.StackedSearcher`
with global statistics; hits resolve by (shard, docid) and the term lane
goes to `parallel.msearch_sharded`. One shard keeps the single-shard
`ShardSearcher` as its base.

`knn` sections answer alone (at most k_total hits), or together with
`query` as the reference's hybrid rewrite: each section's global top k
joins the query as a `PinnedScoresNode` should clause, so a doc's score is
its query score plus its knn score where it is among a section's k.

`Engine` is the registry of indices behind the REST layer (`rest/app.py`):
index creation with the reference's name checks, expression resolution,
`_bulk` (index, create, delete, update), `_update`, cluster settings, the
circuit breakers (each index's pack bytes are charged to `fielddata` at
refresh; `esql.materialization` the live tables of an ES|QL query), the
serving front end (`serving/service.py`), whose waves run through
`EsIndex.search_wave_begin` / `_fetch` / `_finish`, and the ES|QL profile
ring (`esql_recorder`).

Tenancy (reference `engine.py:2333-2570`): `Engine.superpacks` (the
`SuperpackManager`, made at first use), `superpacks_if_enabled`,
`metering` (the node's `TenantMeter`) and `tenant_stats`; with the serving
front end up the LSM tail fold rides the serving queue as the `_merge`
tenant (`schedule_tail_merge`), else it folds inline; deleting an index
evicts its superpack lane.

Scripts: `script_fields` (evaluated over the hits' sources on the host,
reference `engine.py:1023`), `runtime_mappings` (docvalues columns
computed on the device for the request, visible to queries, aggs and sort:
`ShardSearcher` / `StackedSearcher.ensure_runtime_field`) and a scripted
`_update` or upsert (`script/update.py`).

Searches over several indices (`Engine.search_multi`, reference
`engine.py:2902-3100`): a fan-out with the can-match pre-filter
(`search/canmatch.py`) and the coordinator's merge; `EsIndex.explain`,
`Engine.mget`, `Engine.field_caps`, and the stored scripts of the search
templates (`Engine.stored_scripts`, in memory).

Not ported yet: the translog, `if_seq_no` / `if_primary_term`, by-query
deletes and updates, replicas, aliases and index templates, ingest
pipelines, caches, cross-cluster search, aggregations and `knn` over
several indices (the reference's 400s) and `query_vector_builder`.
"""

from __future__ import annotations

import fnmatch
import json
import time
import uuid
from dataclasses import dataclass

import numpy as np

from ..aggs.pipeline import apply_pipeline_aggs, strip_pipeline_aggs
from ..common.breaker import CircuitBreakerService, CircuitBreakingError
from ..common.settings import ClusterSettings, default_cluster_settings
from ..index.mappings import JSON_SCALARS, Mappings
from ..index.pack import PackBuilder
from ..monitoring.refresh_profile import (RefreshRecorder, build_stage, profile_refresh,
                                          refresh_stage)
from ..parallel.sharded import (StackedResult, StackedSearcher, msearch_sharded,
                                msearch_wave_begin, msearch_wave_fetch, msearch_wave_finish)
from ..parallel.stacked import build_stacked_pack_routed, route_docs
from ..query.dsl import parse_knn, parse_query
from ..query.executor import ShardSearcher
from ..query.nodes import (BoolNode, ConstantScoreNode, DisMaxNode, ExistsNode,
                           ExpandedTermsNode, KnnNode, MatchAllNode, MatchNoneNode, PhraseNode,
                           PinnedScoresNode, RangeNode, TermNode, TermsNode)
from ..query.sort import is_score_only, parse_sort
from ..search.canmatch import can_match
from ..serving.coalesce import term_disjunction_of
from ..serving.queue import ServingRejectedError
from ..tenancy.metering import TenantMeter, normalize_tenant
from ..utils.durations import parse_duration_seconds
from ..utils.errors import (
    DocumentMissingError,
    ElasticsearchTpuError,
    IllegalArgumentError,
    IndexAlreadyExistsError,
    IndexNotFoundError,
    ResourceNotFoundError,
    SearchPhaseExecutionError,
    VersionConflictError,
)
from ..utils.torch_env import resolve_device

# the keyword arguments of EsIndex.search that an `_msearch` body passes
# through as is; a body with one of them runs as a solo `search`
_SOLO_KWARGS = ("sort", "search_after", "collapse", "rescore", "track_total_hits",
                "script_fields", "runtime_mappings")
_MSEARCH_BODY_KEYS = {"query", "size", "from", "knn", "aggs", "aggregations", *_SOLO_KWARGS}
# the keyword arguments of a serving wave entry that the wave's lanes serve
_SEARCH_KWARGS = ("query", "size", "from_", "knn", "track_total_hits", "aggs")
# what the wave runs as a solo search (the reference's `_WAVE_UNSUPPORTED`)
_WAVE_SOLO = ("sort", "search_after", "collapse", "rescore", "script_fields",
              "runtime_mappings")
# query nodes that score each doc independently of the others, so each tier
# evaluates them alone and the coordinator merges (reference `_tier_node`)
_TIER_SAFE = (TermNode, TermsNode, MatchAllNode, MatchNoneNode, RangeNode, ExistsNode,
              PhraseNode, ExpandedTermsNode)
# rescore's score_mode combinations (reference `engine.py:1325-1337`)
_RESCORE_MODES = {"total": lambda a, b: a + b, "multiply": lambda a, b: a * b,
                  "avg": lambda a, b: (a + b) / 2.0, "max": max, "min": min}
# a tail segment's dense-tier threshold: no dense tier
_NO_DENSE = 1 << 62


class _StrKey:
    """An orderable string sort key, so a descending string key composes
    with numeric keys in one tuple sort (reference `engine.py:63`)."""

    __slots__ = ("v", "desc")

    def __init__(self, v, desc):
        self.v, self.desc = v, desc

    def __lt__(self, other):
        return (self.v > other.v) if self.desc else (self.v < other.v)

    def __eq__(self, other):
        return self.v == other.v


def _merge_key(sort_values: list, sort_fields) -> list:
    """A hit's `sort` array -> its key in the cross-index merge (reference
    `engine.py:3049-3064`): each field a (missing rank, value) pair, so a
    missing value orders by the field's `missing` policy and values of
    different types never compare."""
    ks = []
    for v, sf in zip(sort_values, sort_fields):
        if v is None:
            ks.append((-1 if sf.missing == "_first" else 1, 0))
        elif isinstance(v, str):
            ks.append((0, _StrKey(v, sf.desc)))
        elif isinstance(v, bool) or not isinstance(v, (int, float)):
            ks.append((0, _StrKey(str(v), sf.desc)))
        else:
            ks.append((0, -v if sf.desc else v))
    return ks


class _NotPlainJson(Exception):
    pass


def _plain_copy(value):
    """A copy of plain JSON data (dicts with str keys, lists and tuples,
    str, int, float, bool, None; exact types only), lists for tuples."""
    t = type(value)
    if t in JSON_SCALARS:
        return value
    if t is list or t is tuple:
        if all(type(x) in JSON_SCALARS for x in value):
            return list(value)  # a vector's components: one pass
        return [_plain_copy(x) for x in value]
    if t is dict:
        if not all(type(k) is str for k in value):
            raise _NotPlainJson
        return {k: _plain_copy(x) for k, x in value.items()}
    raise _NotPlainJson


def _json_snapshot(source):
    """`json.loads(json.dumps(source))`: a copy a caller's later mutation
    cannot reach, with JSON's conversions (tuples to lists, non-str keys to
    str) and its errors. Plain JSON data is copied without the text round
    trip, which costs ~0.5 ms for a 384-float vector; anything else, a
    cycle included, takes the round trip."""
    try:
        return _plain_copy(source)
    except (_NotPlainJson, RecursionError):
        return json.loads(json.dumps(source, separators=(",", ":")))


@dataclass
class _DocEntry:
    """The last write of one id (reference `engine.py:80`): its source and
    parsed fields, version, seq_no, and whether it is alive."""

    source: dict
    parsed: dict
    version: int
    seq_no: int
    alive: bool = True


@dataclass
class _TailSegment:
    """One sealed tail segment (reference `engine.py:88`): the docs one
    incremental refresh wrote, packed and uploaded as their own
    StackedSearcher. `stats` freezes the segment's (field_stats, df) at its
    build; superseded copies keep counting in them until a fold."""

    searcher: StackedSearcher | None
    shard_docs: list  # per shard, docid -> (id, source)
    pos: dict  # id -> (shard, docid) within this segment
    stats: tuple
    nbytes: int = 0


class EsIndex:
    def __init__(self, name: str, mappings: Mappings | dict | None = None,
                 settings: dict | None = None, device=None, breaker_account=None):
        self.name = name
        self.settings = {"number_of_shards": 1, "number_of_replicas": 0,
                         "refresh_interval": "1s"}
        self.settings.update(settings or {})
        # the settings' custom analyzers, resolved before the field types
        # (reference `engine.py:132-135`)
        registry = None
        if self.settings.get("analysis"):
            from ..analysis.custom import build_analysis_registry

            registry = build_analysis_registry(self.settings["analysis"])
        if isinstance(mappings, Mappings):
            self.mappings = mappings
            if registry is not None:
                mappings.set_analysis(registry)
        else:
            self.mappings = Mappings(mappings, analysis_registry=registry)
        self.num_shards = int(self.settings["number_of_shards"])
        if self.num_shards < 1:
            raise IllegalArgumentError("number_of_shards must be >= 1")
        self.device = resolve_device(device)
        self.engine = None  # the owning Engine: its cluster settings
        # id -> its last write; insertion order = docid order of a rebuild
        self._docs: dict[str, _DocEntry] = {}
        self._seq_no = 0
        # called with the tiers' device bytes at refresh (Engine: fielddata)
        self._breaker_account = breaker_account
        self._searcher: ShardSearcher | StackedSearcher | None = None
        # per shard, docid -> (id, source) of the base
        self.shard_docs: list[list[tuple[str, dict]]] = [[] for _ in range(self.num_shards)]
        # ---- write state: ids written since the last refresh, and the
        # monotonic stamps refresh_interval reads
        self._pending: set[str] = set()
        self._dirty = False
        self._dirty_since: float | None = None
        self._last_refresh = 0.0
        self._merge_inflight = False  # a `_merge` tenant fold is queued
        # ---- tiers: the sealed base and the tail segments after it
        self._tails: list[_TailSegment] = []
        self._tail_docs: dict[str, tuple[dict, dict]] = {}  # id -> (source, parsed), not in base
        self._tail_pos: dict[str, tuple[int, int, int]] = {}  # id -> (segment, shard, docid)
        self._base_pos: dict[str, tuple[int, int]] = {}  # id -> (shard, docid)
        self._base_stats: tuple[dict, dict] | None = None  # (field_stats, df) at base build
        self._base_nbytes = 0
        self.counters: dict[str, int] = {}
        self.last_refresh_kind: str | None = None  # "full" | "incremental"
        # a new index is searchable at once, as empty: its base is empty,
        # so the refresh rule counts every doc against max(256, 0)
        # (reference `engine.py:193-196`)
        self.refresh()

    # ---- documents ---------------------------------------------------------

    def _written(self, doc_id: str) -> None:
        self._pending.add(doc_id)
        self._dirty = True
        if self._dirty_since is None:
            self._dirty_since = time.monotonic()

    def index_doc(self, doc_id: str | None, source: dict, op_type: str = "index") -> dict:
        """Write one document. op_type "create" refuses a live id with a 409
        (reference `engine.py:386`); a document without an id gets one and
        is created; writing a deleted id creates it again."""
        if doc_id is None:
            doc_id = uuid.uuid4().hex
            op_type = "create"
        old = self._docs.get(doc_id)
        if op_type == "create" and old is not None and old.alive:
            raise VersionConflictError(
                f"[{doc_id}]: version conflict, document already exists "
                f"(current version [{old.version}])")
        # the stored source is a snapshot: later caller mutation cannot
        # change what a search returns
        source = _json_snapshot(source)
        parsed = self.mappings.parse_document(source)
        version = 1 if old is None else old.version + 1
        seq_no = self._seq_no
        self._seq_no += 1
        self._docs[doc_id] = _DocEntry(source, parsed, version, seq_no)
        self._written(doc_id)
        created = old is None or not old.alive
        return {"_index": self.name, "_id": doc_id, "_version": version, "_seq_no": seq_no,
                "result": "created" if created else "updated"}

    def delete_doc(self, doc_id: str) -> dict:
        """Delete one document (reference `engine.py:460`): 404
        document_missing_exception for a missing or deleted id; the version
        is bumped and the delete takes a seq_no."""
        e = self._docs.get(doc_id)
        if e is None or not e.alive:
            raise DocumentMissingError(f"[{doc_id}]: document missing", index=self.name)
        e.alive = False
        e.version += 1
        e.seq_no = self._seq_no
        self._seq_no += 1
        self._written(doc_id)
        return {"_index": self.name, "_id": doc_id, "_version": e.version,
                "_seq_no": e.seq_no, "result": "deleted"}

    def get_doc(self, doc_id: str) -> dict | None:
        """Realtime get: the last written version, refreshed or not."""
        e = self._docs.get(doc_id)
        if e is None or not e.alive:
            return None
        return {"_id": doc_id, "_version": e.version, "_seq_no": e.seq_no, "_source": e.source}

    # ---- refresh -----------------------------------------------------------

    def refresh(self) -> None:
        """Make every write searchable: incremental while the reference's
        rule allows it (`_can_refresh_incremental`), else a full rebuild."""
        if self._searcher is not None and not self._pending and not self._dirty:
            return  # nothing written since the last refresh
        if self._can_refresh_incremental():
            with profile_refresh(self, "incremental"):
                self._refresh_incremental()
            self.last_refresh_kind = "incremental"
        else:
            with profile_refresh(self, "full"):
                self._refresh_full()
            self.last_refresh_kind = "full"
        self._dirty = False
        self._dirty_since = None
        self._last_refresh = time.monotonic()
        self.counters["refresh_total"] = self.counters.get("refresh_total", 0) + 1

    def _maybe_refresh(self) -> None:
        """Refresh before a search, a wave or a count when writes wait and
        `refresh_interval` has passed (reference `engine.py:976`)."""
        if not self._dirty:
            return
        try:
            secs = parse_duration_seconds(self.settings.get("refresh_interval", "1s"), 1.0)
        except IllegalArgumentError:
            secs = 1.0
        if secs is None:  # "-1": explicit refreshes only
            return
        if time.monotonic() - self._last_refresh >= secs:
            self.refresh()

    def _can_refresh_incremental(self) -> bool:
        """The reference's rule (`engine.py:646`): a base exists (the empty
        one of a new index counts), and the docs outside it stay within
        max(256, base/10)."""
        if self._searcher is None:
            return False
        base_n = sum(len(lst) for lst in self.shard_docs)
        projected = len(self._tail_docs) + len(self._pending)
        return projected <= max(256, base_n // 10)

    def _build_base(self, docs: list[tuple[str, dict, dict]]):
        """Pack (id, source, parsed) docs as a base, on the index's device
        where the build admits it (`PackBuilder`).
        -> (upload, shard_docs, nbytes): `upload()` puts the pack on the
        device and returns (searcher, (field_stats, df))."""
        if self.num_shards == 1:
            builder = PackBuilder(self.mappings, device=self.device)
            with refresh_stage("analyze"):
                builder.add_documents_batch([p for _i, _s, p in docs],
                                            doc_ids=[i for i, _s, _p in docs])
            pack = builder.build()
            pack.doc_sources = [src for _i, src, _p in docs]
            stats = ({f: dict(st) for f, st in pack.field_stats.items()},
                     {key: int(pack.term_df[tid]) for key, tid in pack.term_dict.items()})
            nbytes = pack.nbytes()

            def upload():
                with build_stage("build.device_put", self.device, nbytes=nbytes):
                    return ShardSearcher(pack, device=self.device, mappings=self.mappings), stats

            return upload, [[(i, src) for i, src, _p in docs]], nbytes
        # one routing pass drives both the shard packs and hit resolution
        with refresh_stage("route"):
            routed = route_docs([(i, (src, p)) for i, src, p in docs], self.num_shards)
        sp = build_stacked_pack_routed([[(i, e[1]) for i, e in lst] for lst in routed],
                                       self.mappings, parsed=True, device=self.device,
                                       sources=[[e[0] for _i, e in lst] for lst in routed])
        stats = ({f: dict(st) for f, st in sp.field_stats.items()}, dict(sp.global_df))
        nbytes = sp.nbytes()

        def upload():
            with build_stage("build.device_put", self.device, nbytes=nbytes):
                return StackedSearcher(sp, device=self.device), stats

        return upload, [[(i, e[0]) for i, e in lst] for lst in routed], nbytes

    def _install_base(self, docs: list[tuple[str, dict, dict]]) -> None:
        """Build a fresh base of `docs` and make it the only tier. The old
        tiers serve until the new pack is admitted by the breaker and on
        the device."""
        upload, shard_docs, nbytes = self._build_base(docs)
        self._account(nbytes)
        searcher, stats = upload()
        self._searcher = searcher
        self._tails = []
        self.shard_docs = shard_docs
        self._tail_pos = {}
        self._tail_docs = {}
        self._base_pos = {doc_id: (s, d) for s, lst in enumerate(shard_docs)
                          for d, (doc_id, _src) in enumerate(lst)}
        self._base_stats = stats
        self._base_nbytes = nbytes

    def _refresh_full(self) -> None:
        """Rebuild one sealed base from the live docs: no segment, and the
        statistics reset to the live docs'."""
        self._install_base([(i, e.source, e.parsed) for i, e in self._docs.items() if e.alive])
        self._pending.clear()

    def _merge_tiers(self) -> None:
        """The major merge (reference `engine.py:660`): fold the base and
        every segment into a fresh base of exactly the visible docs (live
        base docs, then the segments' docs by id), leaving pending writes
        pending."""
        base = self._searcher
        visible = []
        for s, lst in enumerate(self.shard_docs):
            live = base.live_host(s)
            for d, (doc_id, src) in enumerate(lst):
                if live[d]:
                    # a live base copy of an id written since is parsed
                    # again; otherwise the entry holds this very version
                    parsed = (self.mappings.parse_document(src) if doc_id in self._pending
                              else self._docs[doc_id].parsed)
                    visible.append((doc_id, src, parsed))
        visible += [(i, src, p) for i, (src, p) in
                    sorted(self._tail_docs.items(), key=lambda kv: kv[0])]
        with profile_refresh(self, "merge"), \
                build_stage("build.merge", self.device, docs=len(visible),
                            nbytes=self._base_nbytes):
            self._install_base(visible)
        self.counters["merge_total"] = self.counters.get("merge_total", 0) + 1

    def _segment(self, docs: list[tuple[str, tuple[dict, dict]]], extra_nbytes: int,
                 tails: list) -> _TailSegment:
        """Pack (id, (source, parsed)) docs as one sealed segment with no
        dense tier (its vector fields, and their ANN index where the
        segment holds enough vectors, as a base packs them), charge the
        breaker for it beside `extra_nbytes`, and upload it under the
        statistics combined over the base and `tails` + it. Touches no tier
        state."""
        with refresh_stage("route"):
            routed = route_docs(docs, self.num_shards)
        sp = build_stacked_pack_routed([[(i, e[1]) for i, e in lst] for lst in routed],
                                       self.mappings, dense_min_df=_NO_DENSE, parsed=True,
                                       device=self.device,
                                       sources=[[e[0] for _i, e in lst] for lst in routed])
        self._account(extra_nbytes + sp.nbytes())
        shard_docs = [[(i, e[0]) for i, e in lst] for lst in routed]
        seg = _TailSegment(
            searcher=None, shard_docs=shard_docs,
            pos={doc_id: (s, d) for s, lst in enumerate(shard_docs)
                 for d, (doc_id, _src) in enumerate(lst)},
            stats=({f: dict(st) for f, st in sp.field_stats.items()}, dict(sp.global_df)),
            nbytes=sp.nbytes())
        # the combined statistics are on the pack before its searcher
        # exists, so the construction derives its impact codes from them
        sp.stats_override = self._combined_override(tails + [seg])
        with build_stage("build.device_put", self.device, nbytes=seg.nbytes):
            seg.searcher = StackedSearcher(sp, device=self.device)
        return seg

    def _refresh_incremental(self) -> None:
        """Refresh in proportion to the writes since the last refresh
        (reference `engine.py:794`): the live bit of each superseded or
        deleted copy is cleared in whichever tier holds it, the new docs are
        packed as one sealed segment (none for a refresh that only deletes),
        and every tier then scores under the combined statistics. The
        segment is built and admitted before any tier state changes."""
        base = self._searcher
        new_docs = {}
        kill_base, kill_tail = [], []
        for did in self._pending:
            e = self._docs.get(did)
            if did in self._base_pos:
                kill_base.append(self._base_pos[did])
            if did in self._tail_pos:
                kill_tail.append(self._tail_pos[did])
            if e is not None and e.alive:
                new_docs[did] = (e.source, e.parsed)
        seg = None
        if new_docs:
            seg = self._segment(sorted(new_docs.items(), key=lambda kv: kv[0]),
                                self._base_nbytes + sum(t.nbytes for t in self._tails),
                                self._tails)
        # ---- install: nothing above touched serving state
        for s, d in kill_base:
            base.mark_dead(s, d)
        flipped = {g for g, s, d in kill_tail if self._tails[g].searcher.mark_dead(s, d)}
        for did in self._pending:
            self._tail_pos.pop(did, None)
            if did in new_docs:
                self._tail_docs[did] = new_docs[did]
            else:
                self._tail_docs.pop(did, None)
        self._pending.clear()
        base.update_live()
        for g in sorted(flipped):
            self._tails[g].searcher.update_live()
        if seg is None:
            # a refresh that only deletes: the live flips are the whole
            # change, and the frozen statistics already count the dead docs
            return
        # deadness across the tiers, as the reference carries it
        seg.searcher.sp.dead_count = base.dead_count + sum(t.searcher.dead_count
                                                           for t in self._tails)
        ordinal = len(self._tails)
        self._tails.append(seg)
        for doc_id, (s, d) in seg.pos.items():
            self._tail_pos[doc_id] = (ordinal, s, d)
        self._install_combined_stats(seg.searcher.sp.stats_override)
        if self.merge_pending():
            with refresh_stage("segment_merge"):
                self._schedule_tail_merge()

    def _combined_override(self, tails: list) -> dict:
        """The statistics of every tier (reference `engine.py:751`): the
        base's at its build (dead docs included) plus each segment's at its
        own, summed in tier order."""
        fs = {f: dict(st) for f, st in self._base_stats[0].items()}
        gdf = dict(self._base_stats[1])
        for seg in tails:
            for f, st in seg.stats[0].items():
                g = fs.setdefault(f, {"sum_dl": 0.0, "doc_count": 0})
                g["sum_dl"] += st["sum_dl"]
                g["doc_count"] += st["doc_count"]
            for key, v in seg.stats[1].items():
                gdf[key] = gdf.get(key, 0) + v
        return {"field_stats": fs, "global_df": gdf}

    def _install_combined_stats(self, override: dict) -> None:
        """Score every tier under `override` (reference `engine.py:770`):
        the base re-derives its dense tier and impact codes, each older
        segment its impact codes; a segment already derived from it (the
        one built this refresh) is skipped."""
        self._searcher.set_stats_override(override)
        for seg in self._tails:
            sp = seg.searcher.sp
            if sp.stats_override is override and sp._impact_basis is override:
                continue
            seg.searcher.set_stats_override(override)

    def max_tail_segments(self) -> int:
        """The segment bound (cluster setting `indexing.tiers.max_segments`;
        4 for an index outside an Engine)."""
        if self.engine is not None:
            return max(1, int(self.engine.settings.get("indexing.tiers.max_segments")))
        return 4

    def merge_pending(self) -> bool:
        return len(self._tails) > self.max_tail_segments()

    def _schedule_tail_merge(self) -> None:
        """Fold the segments: on the serving queue as the `_merge` tenant
        when the engine's front end is up (`Engine.schedule_tail_merge`),
        else inline. A failed fold installs nothing, is counted in
        `merge_failures`, and a later refresh past the bound retries it."""
        if self.engine is not None:
            self.engine.schedule_tail_merge(self)
        else:
            self._fold_tail_inline()

    def _fold_tail_inline(self) -> None:
        try:
            self._merge_tail_segments()
        except Exception:  # noqa: BLE001 - the fold is housekeeping
            self.counters["merge_failures"] = self.counters.get("merge_failures", 0) + 1

    def _merge_tail_segments(self) -> bool:
        """The minor fold (reference `engine.py:913`): every segment into one
        sealed segment of the docs they hold live, leaving the base sealed;
        superseded copies drop out of the statistics. Built and admitted
        before the swap."""
        base = self._searcher
        if len(self._tails) < 2:
            return False
        visible = sorted(self._tail_docs.items(), key=lambda kv: kv[0])
        with profile_refresh(self, "segment_merge"), \
                build_stage("build.segment_merge", self.device, docs=len(visible),
                            nbytes=sum(t.nbytes for t in self._tails)):
            merged = self._segment(visible, self._base_nbytes, [])
            merged.searcher.sp.dead_count = base.dead_count
            self._tails = [merged]
            self._tail_pos = {doc_id: (0, s, d) for doc_id, (s, d) in merged.pos.items()}
            self._install_combined_stats(merged.searcher.sp.stats_override)
        self.counters["segment_merge_total"] = self.counters.get("segment_merge_total", 0) + 1
        return True

    def refresh_lag_ms(self) -> float:
        """Milliseconds the oldest write not yet searchable has waited; 0
        when every write is (reference `engine.py:639`)."""
        if self._dirty_since is None:
            return 0.0
        return (time.monotonic() - self._dirty_since) * 1000.0

    def tier_stats(self) -> dict:
        """Live docs in the base and in the segments, the segments' share,
        and the segment count (reference `engine.py:618`)."""
        base = sum(len(lst) for lst in self.shard_docs)
        base_live = max(base - self._searcher.dead_count, 0)
        tail = len(self._tail_docs)
        total = base_live + tail
        return {"base_docs": int(base_live), "tail_docs": int(tail),
                "tail_fraction": round(tail / total, 6) if total else 0.0,
                "segments": len(self._tails)}

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
        """The one merged searcher, for a consumer that is not tier-aware:
        the tiers merge into a fresh base first (reference `engine.py:567`)."""
        if self._tails:
            self._merge_tiers()
        return self._searcher

    def tier_searchers(self) -> list:
        """Every tier's searcher, base first."""
        return [self._searcher] + [seg.searcher for seg in self._tails]

    def search(self, query: dict | None = None, size: int = 10, from_: int = 0,
               knn: dict | list | None = None,
               track_total_hits: bool | int | None = None, aggs: dict | None = None,
               sort=None, search_after: list | None = None, collapse=None,
               rescore=None, script_fields: dict | None = None,
               runtime_mappings: dict | None = None) -> dict:
        """`_search` (`_search_inner`), with the request's `runtime_mappings`
        installed on the merged searcher for its duration (reference
        `engine.py:1153-1170`: each a docvalues column on the device, seen by
        the query, the aggs and the sort) and its `script_fields` evaluated
        over the hits (`_apply_script_fields`)."""
        kw = dict(query=query, size=size, from_=from_, knn=knn,
                  track_total_hits=track_total_hits, aggs=aggs, sort=sort,
                  search_after=search_after, collapse=collapse, rescore=rescore,
                  plain_tiers=not script_fields)
        if runtime_mappings:
            self._maybe_refresh()
            searcher = self.searcher  # the tiers merge first, as the reference's
            try:
                for nm, spec in runtime_mappings.items():
                    if not isinstance(spec, dict) or "script" not in spec:
                        raise IllegalArgumentError(f"runtime field [{nm}] requires a [script]")
                    searcher.ensure_runtime_field(nm, spec.get("type", "double"), spec["script"])
                out = self._search_inner(**kw)
            finally:
                searcher.remove_runtime_fields(list(runtime_mappings))
        else:
            out = self._search_inner(**kw)
        self._apply_script_fields(out["hits"]["hits"], script_fields)
        return out

    @staticmethod
    def _apply_script_fields(hits: list, script_fields: dict | None) -> None:
        """script_fields (reference `engine.py:1023`; behavior:
        ScriptFieldsPhase): {name: {"script": ...}} evaluated over the hits'
        source values on the host (a date string read as epoch millis, any
        other non-number as 0) with `_score`, each hit's value under
        `fields.<name>`."""
        if not script_fields or not hits:
            return
        from ..index.mappings import parse_date_to_millis
        from ..script.expression import compile_script

        for name, spec in script_fields.items():
            cs = compile_script(spec.get("script", spec) if isinstance(spec, dict) else spec)
            env = {}
            for f in cs.fields:
                vals = []
                for h in hits:
                    v = h.get("_source", {}).get(f, 0)
                    if isinstance(v, str):
                        try:
                            v = parse_date_to_millis(v)
                        except ElasticsearchTpuError:
                            v = 0
                    vals.append(float(v) if isinstance(v, (int, float, bool)) else 0.0)
                env[f] = np.asarray(vals, np.float32)
            scores = np.asarray([h.get("_score") or 0.0 for h in hits], np.float32)
            out = np.broadcast_to(np.asarray(cs.evaluate(env, score=scores)), (len(hits),))
            for h, v in zip(hits, out):
                h.setdefault("fields", {})[name] = [float(v)]

    def _search_inner(self, query: dict | None = None, size: int = 10, from_: int = 0,
                      knn: dict | list | None = None,
                      track_total_hits: bool | int | None = None, aggs: dict | None = None,
                      sort=None, search_after: list | None = None, collapse=None,
                      rescore=None, plain_tiers: bool = True) -> dict:
        """`_search` with a query, with `knn` sections (one dict, or a list
        whose sections are OR-ed), or with both, as the reference's
        `_search_inner` answers them. knn alone: at most k_total = sum of
        the sections' k hits, the total clamped to k_total, and a filtered
        ANN section that could not fill the page rerun on the exact scan.
        knn with a query: the hybrid rewrite (`_hybrid_node`), no clamp.
        track_total_hits=False drops `hits.total`; totals are exact
        otherwise (the reference's relation "eq": its block-max WAND pruning
        is off by default). With tail segments a query or a kNN-only search
        runs on each tier and the hits merge; a hybrid, or any search with
        `aggs`, `sort`, `search_after`, `collapse` or `rescore`, merges the
        tiers first, as the reference's does. Sparse terms score from the
        impact tier on every shard and tier that holds its codes
        (`query.nodes.TermNode`), as the reference does on its accelerator.

        `aggs` (reference `engine.py:1170-1215`): the pipeline aggs are
        stripped and run on the host after the reduce
        (`aggs.pipeline`); the rest run on the device over the query's match
        set (beside `knn`: the kNN node's, or the hybrid's), and top_hits
        resolve to hits (`_resolve_top_hits`).

        `sort` on fields (reference `engine.py:1180-1222`): hits carry
        `_score: null` and a `sort` array, `max_score` is null, and
        `search_after` pages by the previous page's last `sort` array (it
        needs a sort on fields). `collapse` ({"field": f}) keeps the best hit
        per value of f, each hit with `fields: {f: [value]}` (aggs over the
        uncollapsed matches). `rescore` (one spec or a list, reference
        `engine.py:1301-1345`) re-scores the top `window_size` hits by its
        `rescore_query` in exact BM25, combined by `score_mode` (total,
        multiply, avg, max, min) with `query_weight` and
        `rescore_query_weight`. Refused with the reference's 400s:
        collapse with rescore, knn with a field sort, collapse or rescore
        with a field sort."""
        self._maybe_refresh()
        if collapse is not None and rescore is not None:
            raise IllegalArgumentError("cannot use [collapse] in conjunction with [rescore]")
        aggs_request = aggs
        plain = (sort is None and search_after is None and collapse is None and rescore is None
                 and plain_tiers)
        if self._tails and knn is None and not aggs_request and plain:
            node = self._tier_node(query)
            if node is not None:
                return self._search_tiered(query, size, from_, track_total_hits)
        aggs, had_pipeline = strip_pipeline_aggs(aggs_request)
        aggs = aggs or None
        sort_fields = parse_sort(sort)
        if not is_score_only(sort_fields):
            if knn is not None:
                raise IllegalArgumentError("knn with field sort is not supported")
            if collapse is not None or rescore is not None:
                raise IllegalArgumentError("collapse/rescore with field sort is not supported")
            return self._search_sorted(query, sort_fields, size, from_, search_after, aggs,
                                       aggs_request, had_pipeline, track_total_hits)
        if search_after is not None:
            raise IllegalArgumentError("search_after requires an explicit sort on fields")
        knn_only = knn is not None and query is None
        if knn is not None:
            bodies = knn if isinstance(knn, list) else [knn]
            nodes = self._knn_nodes(bodies)
            k_total = sum(kn.k for kn in nodes)
            if knn_only and self._tails and not aggs_request and plain:
                return self._search_tiered_knn(bodies, size, from_, k_total, track_total_hits)
            if knn_only:
                query = self._knn_query(nodes)
                size = min(size, max(k_total - from_, 0))
            else:
                query = self._hybrid_node(query, nodes)
        searcher = self.searcher
        if collapse is not None:
            cfld = collapse.get("field") if isinstance(collapse, dict) else collapse
            if not cfld:
                raise IllegalArgumentError("no [field] specified for collapse")
            res = searcher.search_collapse(query, cfld, size=size, from_=from_)
            if aggs:
                # aggs run over the uncollapsed match set
                res.aggregations = searcher.search(query, size=1, aggs=aggs).aggregations
        elif rescore is not None:
            res = self._rescore(searcher, query, rescore, size, from_, aggs)
        else:
            res = searcher.search(query, size=size, from_=from_, aggs=aggs)
            if knn is not None and self._knn_mark_starved(query, len(res.doc_ids) + from_,
                                                          size + from_):
                res = searcher.search(query, size=size, from_=from_, aggs=aggs)
        if knn_only:
            res.total = min(res.total, k_total)
        return self._format_generic_hits(res, track_total_hits, aggs_request, had_pipeline,
                                         collapse=collapse)

    def _search_sorted(self, query, sort_fields, size: int, from_: int, search_after, aggs,
                       aggs_request, had_pipeline: bool, track_total_hits) -> dict:
        """A field-sorted search on the merged searcher -> the response body
        (reference `engine.py:1180-1222`)."""
        hits_raw, total, aggregations = self.searcher.search_sorted(
            query, sort_fields, size=size, from_=from_, search_after=search_after, aggs=aggs)
        hits = []
        for h in hits_raw:
            s, d, values = h if len(h) == 3 else (0, *h)
            doc_id, src = self.shard_docs[s][d]
            hits.append({"_index": self.name, "_id": doc_id, "_score": None, "_source": src,
                         "sort": values})
        if had_pipeline and aggregations is not None:
            apply_pipeline_aggs(aggs_request, aggregations)
        self._resolve_top_hits(aggregations)
        hits_obj = {"total": {"value": total, "relation": "eq"}, "max_score": None,
                    "hits": hits}
        if track_total_hits is False:
            del hits_obj["total"]
        out = {"hits": hits_obj}
        if aggregations is not None:
            out["aggregations"] = aggregations
        return out

    @staticmethod
    def _rescore(searcher, query, rescore, size: int, from_: int, aggs) -> StackedResult:
        """The first pass fetches max(size + from, every window) hits; each
        rescore spec in turn re-scores the top `window_size` of the running
        order at those hits (`searcher.scores_at`, exact BM25) and re-sorts
        the window by the combined score (Python floats, a stable sort);
        the rest keeps its order (reference `engine.py:1301-1345`)."""
        specs = rescore if isinstance(rescore, list) else [rescore]
        windows = [int(sp.get("window_size", 10)) for sp in specs]
        res = searcher.search(query, size=max(size + from_, max(windows)), from_=0, aggs=aggs)
        shards = getattr(res, "doc_shards", np.zeros(len(res.doc_ids), np.int32))
        order = list(zip(shards, res.doc_ids, res.scores))
        for spec, w in zip(specs, windows):
            q2 = spec.get("query") or {}
            rq = q2.get("rescore_query")
            if rq is None:
                raise IllegalArgumentError("rescore requires [rescore_query]")
            qw = float(q2.get("query_weight", 1.0))
            rw = float(q2.get("rescore_query_weight", 1.0))
            mode = q2.get("score_mode", "total")
            win = order[:w]
            if not win:
                continue
            s2, ok2 = searcher.scores_at(rq, np.asarray([x[0] for x in win], np.int32),
                                         np.asarray([x[1] for x in win], np.int32))
            combined = []
            for (_s, _d, s1), sc2, k2 in zip(win, s2, ok2):
                a, b = qw * float(s1), rw * float(sc2)
                if not k2:
                    c = a
                elif mode in _RESCORE_MODES:
                    c = _RESCORE_MODES[mode](a, b)
                else:
                    raise IllegalArgumentError(f"unsupported rescore score_mode [{mode}]")
                combined.append(c)
            rescored = sorted(zip(win, combined), key=lambda t: -t[1])
            order = [(s_, d_, c) for (s_, d_, _), c in rescored] + order[w:]
        order = order[from_: from_ + size]
        return StackedResult(np.asarray([x[0] for x in order], np.int32),
                             np.asarray([x[1] for x in order], np.int32),
                             np.asarray([x[2] for x in order], np.float32), res.total,
                             float(order[0][2]) if order else None, res.aggregations)

    def _hybrid_node(self, query, nodes: list[KnnNode]) -> BoolNode:
        """`knn` together with `query` (reference `engine.py:1262-1280`):
        each section first retrieves its global top k on the merged
        searcher, and those score-docs join the query as one
        PinnedScoresNode per section (the KnnScoreDocQueryBuilder rewrite):
        bool should [query, *pinned], minimum_should_match 1."""
        qnode = parse_query(query, self.mappings)
        searcher = self.searcher
        S = self.num_shards
        pinned = []
        for kn in nodes:
            kres = self._knn_exec(searcher, kn, kn.k)
            shards = getattr(kres, "doc_shards", np.zeros(len(kres.doc_ids), np.int32))
            per_shard = [([], []) for _ in range(S)]
            for s, d, sc in zip(shards, kres.doc_ids, kres.scores):
                per_shard[int(s)][0].append(int(d))
                per_shard[int(s)][1].append(float(sc))
            pinned.append(PinnedScoresNode(per_shard=[
                (np.asarray(ids, np.int32), np.asarray(scs, np.float32))
                for ids, scs in per_shard]))
        return BoolNode(should=[qnode, *pinned], minimum_should_match=1)

    # ---- tiers -------------------------------------------------------------

    def _tier_node(self, query):
        """The parsed query when each tier can evaluate it alone and the
        coordinator merge the hits (every node scores a doc independently of
        the others: reference `engine.py:1463`, on the node types this
        package has), else None (a query that fails to parse: the merged
        path raises its error)."""
        def ok(node) -> bool:
            if isinstance(node, BoolNode):
                return all(ok(c) for grp in (node.must, node.filter, node.should, node.must_not)
                           for c in grp)
            if isinstance(node, ConstantScoreNode):
                return ok(node.child)
            if isinstance(node, DisMaxNode):
                return all(ok(c) for c in node.children)
            return isinstance(node, _TIER_SAFE)

        try:
            node = parse_query(query, self.mappings)
        except ElasticsearchTpuError:
            return None
        return node if ok(node) else None

    def _search_tiered(self, query, size: int, from_: int, track_total_hits=None) -> dict:
        """The query on the base and on each segment, k = size + from each,
        then `_tiered_merge` (reference `engine.py:1497`). Each tier parses
        and plans the body itself, against its own statistics view."""
        k = max(size + from_, 1)
        tails = list(self._tails)
        rb = self._searcher.search(query, size=k)
        rts = [seg.searcher.search(query, size=k) for seg in tails]
        return self._tiered_merge(rb, rts, size, from_, track_total_hits,
                                  [seg.shard_docs for seg in tails])

    def _search_tiered_knn(self, bodies: list, size: int, from_: int, k_total: int,
                           track_total_hits=None) -> dict:
        """A kNN-only search on base + segments (reference
        `engine.py:1233-1261`): each tier runs its own freshly parsed
        sections (prepare sets each tier's ANN plan and force_exact) with
        the starved-filter rerun, k = the clamped page's end; the tiers
        merge as `_tiered_merge` does and the total clamps to k_total. A
        segment built with the index's mappings carries its own ANN index
        when it holds enough vectors, and is probed like the base."""
        eff_size = min(size, max(k_total - from_, 0))
        k = max(eff_size + from_, 1)

        tails = list(self._tails)
        rb = self._knn_exec(self._searcher, self._knn_query(self._knn_nodes(bodies)), k)
        rts = [self._knn_exec(seg.searcher, self._knn_query(self._knn_nodes(bodies)), k)
               for seg in tails]
        out = self._tiered_merge(rb, rts, eff_size, from_, track_total_hits,
                                 [seg.shard_docs for seg in tails])
        if track_total_hits is not False:
            tv = out["hits"]["total"]
            tv["value"] = min(tv["value"], k_total)
        return out

    def _tiered_merge(self, rb, rts, size: int, from_: int, track_total_hits,
                      tail_shard_docs) -> dict:
        """Merge the base's and the segments' results, each in (score desc,
        docid asc) order, by (score desc, tier asc, rank asc), Lucene's
        TopDocs.merge with the segments' shards after the base's (reference
        `engine.py:1524`); totals sum. Shared by the solo path and the
        serving wave's tiered lane; `tail_shard_docs` are the segments'
        docs as the tiers were searched."""
        rows = []
        for tier, r in enumerate((rb, *rts)):
            shards = getattr(r, "doc_shards", None)
            if shards is None:
                shards = np.zeros(len(r.doc_ids), np.int32)
            for rank, (s, d, sc) in enumerate(zip(shards, r.doc_ids, r.scores)):
                rows.append((-float(sc), tier, rank, int(s), int(d)))
        rows.sort()
        hits = []
        for negsc, tier, _rank, s, d in rows[from_: from_ + size]:
            docs = self.shard_docs if tier == 0 else tail_shard_docs[tier - 1]
            doc_id, src = docs[s][d]
            hits.append({"_index": self.name, "_id": doc_id, "_score": -negsc, "_source": src})
        max_score = max((x for x in (rb.max_score, *(r.max_score for r in rts))
                         if x is not None), default=None)
        hits_obj = {"total": {"value": rb.total + sum(r.total for r in rts), "relation": "eq"},
                    "max_score": max_score, "hits": hits}
        if track_total_hits is False:
            del hits_obj["total"]
        return {"hits": hits_obj}

    def _format_generic_hits(self, res, track_total_hits=None, aggs_request=None,
                             had_pipeline: bool = False, collapse=None) -> dict:
        """A ShardResult or StackedResult -> the response body `search`
        returns, shared by the solo path and the serving wave's generic lane
        (reference `engine.py:1368-1412`), so both build it the same way:
        the pipeline aggs, then the top hits resolved, then
        `aggregations` beside `hits`; a collapsed hit carries its key as
        `fields: {field: [key]}`."""
        shards = getattr(res, "doc_shards", np.zeros(len(res.doc_ids), np.int32))
        hits = [self._hit(int(s), int(d), score)
                for s, d, score in zip(shards, res.doc_ids, res.scores)]
        if collapse is not None and res.collapse_keys is not None:
            cfld = collapse.get("field") if isinstance(collapse, dict) else collapse
            for h, key in zip(hits, res.collapse_keys):
                h["fields"] = {cfld: [key]}
        if had_pipeline and res.aggregations is not None:
            apply_pipeline_aggs(aggs_request, res.aggregations)
        self._resolve_top_hits(res.aggregations)
        hits_obj = {"total": {"value": res.total, "relation": "eq"},
                    "max_score": res.max_score, "hits": hits}
        if track_total_hits is False:
            del hits_obj["total"]  # the reference omits hits.total entirely
        out = {"hits": hits_obj}
        if res.aggregations is not None:
            out["aggregations"] = res.aggregations
        return out

    def _resolve_top_hits(self, aggregations) -> None:
        """Replace top_hits (shard, docid) placeholders with hit envelopes
        (reference `engine.py:993`, the fetch sub-search of
        search/aggregations/metrics/TopHitsAggregator.java)."""
        if not aggregations:
            return

        def walk(obj):
            if isinstance(obj, dict):
                inner = obj.get("hits")
                if isinstance(inner, dict) and isinstance(inner.get("hits"), list):
                    resolved = []
                    for h in inner["hits"]:
                        if isinstance(h, dict) and h.pop("_resolve_top_hit", False):
                            doc_id, src = self.shard_docs[h.pop("_shard")][h.pop("_doc")]
                            resolved.append({"_index": self.name, "_id": doc_id,
                                             "_score": h["_score"], "_source": src})
                        else:
                            resolved.append(h)
                    inner["hits"] = resolved
                for v in obj.values():
                    walk(v)
            elif isinstance(obj, list):
                for v in obj:
                    walk(v)

        walk(aggregations)

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
        """`_count`: the exact total of a size-0 search, summed over the
        tiers (reference `engine.py:2015`)."""
        self._maybe_refresh()
        if self._tails and self._tier_node(query) is not None:
            return sum(t.search(query, size=0).total for t in self.tier_searchers())
        return self.searcher.search(query, size=0).total

    def explain(self, doc_id: str, query=None) -> dict:
        """`_explain` (reference `engine.py:2026-2083`; behavior:
        TransportExplainAction): the doc's score under the query, as a
        search of the query with an `ids` filter on the doc, in exact BM25
        (`mark_exact`: never the impact tier's quantized score); for a
        top-level `bool`, each `must` and `should` clause scored alone the
        same way, as the details. Each score is one `scan_topk` selection
        on the merged searcher."""
        if self.get_doc(doc_id) is None:
            raise DocumentMissingError(f"[{doc_id}]: document missing", index=self.name)
        self._maybe_refresh()
        from ..query.nodes import mark_exact

        def score_of(q):
            wrapped = {"bool": {"must": [q if q is not None else {"match_all": {}}],
                                "filter": [{"ids": {"values": [doc_id]}}]}}
            res = self.searcher.search(mark_exact(parse_query(wrapped, self.mappings)), size=1)
            return None if res.total == 0 else float(res.scores[0])

        top = score_of(query)
        if top is None:
            return {"_id": doc_id, "matched": False,
                    "explanation": {"value": 0.0, "description": "no matching term",
                                    "details": []}}
        details = []
        if isinstance(query, dict) and "bool" in query:
            b = query["bool"]
            clauses = (b.get("must") or []) + (b.get("should") or [])
            if not isinstance(clauses, list):
                clauses = [clauses]
            for c in clauses:
                s = score_of(c)
                if s is not None:
                    details.append({
                        "value": s,
                        "description": f"clause {json.dumps(c, separators=(',', ':'))[:120]}",
                        "details": []})
        return {"_id": doc_id, "matched": True,
                "explanation": {"value": top,
                                "description": "sum of:" if details else
                                "score, computed from query",
                                "details": details}}

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

    def _knn_nodes(self, bodies: list) -> list[KnnNode]:
        """The knn sections parsed, with the index's nprobe setting."""
        nodes = [parse_knn(b, self.mappings) for b in bodies]
        self._apply_knn_settings(nodes)
        return nodes

    @staticmethod
    def _knn_query(nodes: list[KnnNode]):
        """One section alone, or the sections OR-ed."""
        return nodes[0] if len(nodes) == 1 else BoolNode(should=nodes, minimum_should_match=1)

    def _knn_exec(self, searcher, node, k: int):
        """One knn node tree on one searcher, with the starved-filter rerun
        (reference `engine.py:1456`)."""
        res = searcher.search(node, size=k)
        if self._knn_mark_starved(node, len(res.doc_ids), k):
            res = searcher.search(node, size=k)
        return res

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
        `search`, a body with `knn`, `aggs`, `sort`, `search_after`, `collapse`,
        `rescore` or `track_total_hits` included, and so does every body while
        the index has tail segments (as the reference's REST `_msearch`
        answers without serving: the batched arms do not run per tier). A
        body that fails answers with its error envelope."""
        responses: list = [None] * len(searches)
        groups: dict[tuple, list] = {}
        self._maybe_refresh()
        if self._tails:
            searcher, n_docs = None, 0  # no body takes the term lane
        else:
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
                aggs = body.get("aggs") or body.get("aggregations")
                solo = {k: body[k] for k in _SOLO_KWARGS if body.get(k) is not None}
                spec = (self._term_spec(query, n_docs)
                        if body.get("knn") is None and not aggs and not solo else None)
                if spec is None:
                    responses[i] = {**self.search(query, size=size, from_=from_,
                                                  knn=body.get("knn"), aggs=aggs, **solo),
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

          * tiered lane: on an index with tail segments, when every entry is
            tier-capable (a query `_tier_node` takes, no knn, no aggs), each tier
            plans and launches every entry (`search_many_begin` on the base
            and on each segment), and finish merges per entry as the solo
            tiered `search` does;
          * term lane: a term disjunction (match / term / bool-should of
            terms on one field) joins one `msearch_wave` batch per (field,
            k = size + from), padded to the wave's tier;
          * generic lane: every other query, with its aggs (the pipeline
            aggs stripped, then applied in finish), is planned and launched
            here (`search_many_begin`), copied back by `search_wave_fetch` in
            one copy (a two-pass terms agg's second pass runs in finish); a
            knn-only entry runs its own `search` here (its starved filter
            rerun needs the host);
          * fallback: anything else (a key `search` does not take, `sort`,
            `search_after`, `collapse`, `rescore`, knn with query) runs the
            full solo `search`, as the reference's does,
            before the lanes (a solo search may merge the tiers).

        A wave on an index with tail segments that holds a knn entry merges
        the tiers before the generic lane, as the reference's does
        (`engine.py:1737-1765`). -> a wave job for `search_wave_fetch` and
        `search_wave_finish`."""
        n = len(entries)
        job = {"entries": entries, "slots": [None] * n, "fmt": [None] * n, "lane": None,
               "term_lanes": [], "tiered": None,
               "meta": {"wave_size": n, "term_packed": 0, "term_waves": [],
                        "fallback_solo": 0, "tiered_packed": 0}}
        self._maybe_refresh()
        wave_ix = []
        for i, e in enumerate(entries):
            if set(e) - set(_SEARCH_KWARGS) - set(_WAVE_SOLO) or any(
                    e.get(k) is not None for k in _WAVE_SOLO) or (
                    e.get("knn") is not None and e.get("query") is not None):
                job["meta"]["fallback_solo"] += 1
                try:
                    job["slots"][i] = ("resp", self.search(**e))
                except ElasticsearchTpuError as ex:
                    job["slots"][i] = ("error", ex)
                continue
            try:
                size, from_ = int(e.get("size", 10)), int(e.get("from_", 0))
            except (TypeError, ValueError) as ex:
                job["slots"][i] = ("error", IllegalArgumentError(str(ex)))
                continue
            job["fmt"][i] = {"size": size, "from_": from_, "tth": e.get("track_total_hits")}
            wave_ix.append(i)
        if self._tails and wave_ix and all(
                entries[i].get("knn") is None and not entries[i].get("aggs")
                and self._tier_node(entries[i].get("query")) is not None for i in wave_ix):
            reqs = [dict(query=entries[i].get("query"), from_=0,
                         size=max(job["fmt"][i]["size"] + job["fmt"][i]["from_"], 1))
                    for i in wave_ix]
            tails = list(self._tails)
            job["tiered"] = {
                "ix": wave_ix,
                "base": (self._searcher, self._searcher.search_many_begin(reqs)),
                "tails": [(seg.searcher, seg.searcher.search_many_begin([dict(r) for r in reqs]))
                          for seg in tails],
                # the docs the tiers were searched with: a later fold may
                # replace the segment list before this wave finishes
                "shard_docs": [seg.shard_docs for seg in tails]}
            job["meta"]["tiered_packed"] = len(wave_ix)
            return job
        if not wave_ix:
            return job
        searcher = self.searcher  # merges the tiers when present, as solo
        n_docs = (searcher.pack if self.num_shards == 1 else searcher.sp).num_docs
        term_groups: dict[tuple, list] = {}
        generic_ix, generic_reqs = [], []
        for i in wave_ix:
            e, p = entries[i], job["fmt"][i]
            try:
                if e.get("knn") is not None:
                    job["slots"][i] = ("resp", self.search(**e))
                    continue
                aggs_request = e.get("aggs")
                spec = None if aggs_request else self._term_spec(e.get("query"), n_docs)
                if spec is not None:
                    fld, terms = spec
                    term_groups.setdefault((fld, max(p["size"] + p["from_"], 1)), []).append(
                        (i, terms))
                    continue
                node = parse_query(e.get("query"), self.mappings)
                aggs, p["had_pipeline"] = strip_pipeline_aggs(aggs_request)
                p["aggs_request"] = aggs_request
                generic_ix.append(i)
                generic_reqs.append(dict(query=node, size=p["size"], from_=p["from_"],
                                         aggs=aggs or None))
            except ElasticsearchTpuError as ex:
                job["slots"][i] = ("error", ex)
        if generic_ix:
            try:
                job["lane"] = {"ix": generic_ix, "searcher": searcher,
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
        """Copy the wave's outputs to the host: the generic lane's one copy,
        or each tier's (the term lanes resolved in begin). No tensor work
        and no engine state: it may run on the serving completer thread
        while the engine thread begins the next wave."""
        if job["lane"] is not None:
            job["lane"]["searcher"].search_many_fetch(job["lane"]["state"])
        t = job["tiered"]
        if t is not None:
            for searcher, st in [t["base"], *t["tails"]]:
                searcher.search_many_fetch(st)
        for tl in job["term_lanes"]:
            msearch_wave_fetch(tl["st"])

    def search_wave_finish(self, job: dict) -> list:
        """-> per entry, its response dict or its exception, in entry order."""
        lane = job["lane"]
        if lane is not None:
            for i, res in zip(lane["ix"], lane["searcher"].search_many_finish(lane["state"])):
                p = job["fmt"][i]
                job["slots"][i] = ("resp", self._format_generic_hits(
                    res, p["tth"], p.get("aggs_request"), p.get("had_pipeline", False)))
        t = job["tiered"]
        if t is not None:
            base = t["base"][0].search_many_finish(t["base"][1])
            tails = [searcher.search_many_finish(st) for searcher, st in t["tails"]]
            for pos, i in enumerate(t["ix"]):
                p = job["fmt"][i]
                job["slots"][i] = ("resp", self._tiered_merge(
                    base[pos], [r[pos] for r in tails], p["size"], p["from_"], p["tth"],
                    t["shard_docs"]))
        for tl in job["term_lanes"]:
            (v, sh, dc, tt), tier = msearch_wave_finish(tl["st"])
            job["meta"]["term_packed"] += len(tl["members"])
            job["meta"]["term_waves"].append((len(tl["members"]), int(tier)))
            for row, (i, _terms) in enumerate(tl["members"]):
                p = job["fmt"][i]
                job["slots"][i] = ("resp", self._term_hits(
                    v[row], sh[row], dc[row], tt[row], tl["k"], p["size"], p["from_"], p["tth"]))
        return [slot[1] for slot in job["slots"]]

    def search_wave(self, entries: list[dict]) -> list:
        """begin, fetch and finish of one wave in one call."""
        job = self.search_wave_begin(entries)
        self.search_wave_fetch(job)
        return self.search_wave_finish(job)


# ---------------------------------------------------------------------------
# the node's registry of indices
# ---------------------------------------------------------------------------

class Engine:
    """The node's indices, cluster settings, circuit breakers and serving
    front end (reference `engine.py:2094`, the analog of the per-node
    IndicesService). Defaults to the CUDA card and raises without one,
    unless the caller passes device="cpu"."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # the node's name in profile shard ids (the reference's task
        # manager's default)
        self.node_name = "node-0"
        self.indices: dict[str, EsIndex] = {}
        # named synonym sets: set name -> rules
        self.synonym_sets: dict[str, list[str]] = {}
        # stored scripts (search templates): id -> {"lang", "source"}; kept
        # in memory, as the synonym sets are (the reference saves them)
        self.stored_scripts: dict[str, dict] = {}
        self.settings = ClusterSettings(default_cluster_settings())
        self.breakers = CircuitBreakerService(self.device, limits={
            c: self.settings.get(f"indices.breaker.{c}.limit")
            for c in ("total", "fielddata", "request", "esql.materialization")})
        for child in ("total", "fielddata", "request", "esql.materialization"):
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
        # the execution planner is process-wide: the dispatch sites consult it
        # on every arm choice, so a settings update takes effect on the next
        for key in ("planner.enabled", "planner.ema.alpha", "planner.knn.target_ms"):
            self.settings.add_consumer(key, self._planner_settings)
        self._planner_settings()
        # the write path's RefreshProfile ring (GET /_refresh/profile), one
        # per engine (reference `engine.py:2440-2455`)
        self.refresh_recorder = RefreshRecorder(self.settings.get("indexing.profile.size"))
        self.settings.add_consumer("indexing.profile.size", self.refresh_recorder.set_size)
        self._esql_recorder = None
        # tenancy: the per-tenant ledger, one per engine, and the superpacks
        # (made at first use)
        self.metering = TenantMeter(top_k=self.settings.get("metering.tenant.top_k"))
        self.settings.add_consumer("metering.tenant.top_k", self.metering.set_top_k)
        self._superpacks = None
        self.settings.add_consumer("serving.merge.weight",
                                   lambda v: self.serving.set_merge_weight(v))
        for key, kw in (("planner.tenant.fairshare", "enabled"),
                        ("planner.tenant.fairshare.min_factor", "min_factor"),
                        ("slo.tenant.device_ms_per_s", "budget_ms_per_s")):
            self.settings.add_consumer(
                key, lambda v, kw=kw: self.serving.configure_fairshare(**{kw: v}))

    def _planner_settings(self, _v=None) -> None:
        """Push the planner.* settings into the process-wide planner
        (reference `engine.py:2235-2243`)."""
        from ..planner import execution_planner

        get = self.settings.get
        execution_planner().configure(
            enabled=bool(get("planner.enabled")), alpha=float(get("planner.ema.alpha")),
            knn_target_ms=float(get("planner.knn.target_ms")))

    @property
    def esql_recorder(self):
        """The ES|QL query-profile ring (`esql/profile.py`, GET
        /_esql/profile), one per engine, built at first use (reference
        `engine.py:2456-2463`)."""
        if self._esql_recorder is None:
            from ..esql.profile import EsqlRecorder

            self._esql_recorder = EsqlRecorder()
        return self._esql_recorder

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

    # ---- tenancy -----------------------------------------------------------

    @property
    def superpacks(self):
        """The tenant superpacks (`tenancy.SuperpackManager`), made at first
        use."""
        if self._superpacks is None:
            from ..tenancy import SuperpackManager

            self._superpacks = SuperpackManager(self)
        return self._superpacks

    def superpacks_if_enabled(self):
        """The superpack manager iff `superpack.enabled` (checked once per
        wave)."""
        return self.superpacks if self.settings.get("superpack.enabled") else None

    def tenant_stats(self) -> dict:
        """`GET /_tenants/stats`: the meter's ledger, each superpack member's
        row with its share of its class's device bytes."""
        out = self.metering.stats()
        if self._superpacks is not None:
            rows = out["tenants"]
            for name in self._superpacks.member_names():
                row = rows.get(normalize_tenant(name))
                if row is not None:
                    ms = self._superpacks.member_stats(name) or {}
                    row["superpack_hbm_bytes"] = int(ms.get("hbm_bytes_per_tenant", 0))
        out["superpack"] = (self._superpacks.stats() if self._superpacks is not None
                            else {"enabled": bool(self.settings.get("superpack.enabled")),
                                  "members": 0, "size_classes": 0})
        return out

    def schedule_tail_merge(self, idx) -> bool:
        """One LSM tail fold for `idx` (reference `engine.py:2523`): with the
        serving front end up it rides the serving queue as the `_merge`
        tenant, so folds and searches share the card through one scheduler;
        otherwise, or when the queue sheds it, it folds inline. A failed
        fold is counted in `merge_failures` (it installs nothing).
        -> True when a fold is queued."""
        svc = self.serving_if_enabled()
        if svc is None:
            idx._fold_tail_inline()
            return False
        if idx._merge_inflight:
            return True
        idx._merge_inflight = True
        try:
            fut = svc.submit_merge(idx._merge_tail_segments, index=idx.name)
        except (ServingRejectedError, CircuitBreakingError):
            idx._merge_inflight = False
            idx._fold_tail_inline()
            return False

        def _done(f):
            idx._merge_inflight = False
            if f.exception() is not None:
                idx.counters["merge_failures"] = idx.counters.get("merge_failures", 0) + 1

        fut.add_done_callback(_done)
        return True

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
        # named synonym sets (PUT /_synonyms/{set}) resolve into the filter
        # specs before the index builds its analyzers (reference
        # `engine.py:2616-2624`)
        for fspec in ((settings.get("analysis") or {}).get("filter") or {}).values():
            if isinstance(fspec, dict) and fspec.get("synonyms_set"):
                rules = self.synonym_sets.get(fspec["synonyms_set"])
                if rules is None:
                    raise IllegalArgumentError(
                        f"synonyms set [{fspec['synonyms_set']}] not found")
                fspec["_resolved_set"] = list(rules)
        idx = EsIndex(name, mappings or {}, settings, device=self.device,
                      breaker_account=self._pack_accounter(name))
        idx.engine = self
        self.indices[name] = idx
        return idx

    # ---- synonym sets (reference `rest/app.py:626-690`) ---------------------

    def put_synonyms(self, set_name: str, rules: list) -> bool:
        """Store a named synonym set and reload the search analyzers of every
        index whose analysis names it (documents indexed under the old rules
        keep their terms until a reindex, as in Elasticsearch). -> True when
        the set is new."""
        if not isinstance(rules, list):
            raise IllegalArgumentError("[synonyms_set] list is required")
        resolved = [r["synonyms"] if isinstance(r, dict) else str(r) for r in rules]
        created = set_name not in self.synonym_sets
        self.synonym_sets[set_name] = resolved
        from ..analysis.custom import build_analysis_registry

        for idx in self.indices.values():
            analysis = idx.settings.get("analysis") or {}
            touched = False
            for fspec in (analysis.get("filter") or {}).values():
                if isinstance(fspec, dict) and fspec.get("synonyms_set") == set_name:
                    fspec["_resolved_set"] = list(resolved)
                    touched = True
            if touched:
                idx.mappings.set_analysis(build_analysis_registry(analysis))
        return created

    def get_synonyms(self, set_name: str | None = None) -> dict:
        if set_name:
            if set_name not in self.synonym_sets:
                raise ResourceNotFoundError(f"synonym set [{set_name}] not found")
            rules = self.synonym_sets[set_name]
            return {"count": len(rules),
                    "synonyms_set": [{"id": str(i), "synonyms": r} for i, r in enumerate(rules)]}
        return {"count": len(self.synonym_sets),
                "results": [{"synonyms_set": n, "count": len(r)}
                            for n, r in sorted(self.synonym_sets.items())]}

    def delete_synonyms(self, set_name: str) -> None:
        if set_name not in self.synonym_sets:
            raise ResourceNotFoundError(f"synonym set [{set_name}] not found")
        del self.synonym_sets[set_name]

    def delete_index(self, name: str) -> None:
        self.get_index(name)
        del self.indices[name]
        self.breakers.set_steady("fielddata", name, 0)
        if self._superpacks is not None:
            self._superpacks.evict(name)

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
        TransportShardBulkAction): index and create write, delete deletes,
        update merges its [doc] object into the live source."""
        items: list = []
        errors = False
        for action, index_name, doc_id, source in operations:
            try:
                idx = self.get_or_autocreate(index_name)
                if action in ("index", "create"):
                    r = idx.index_doc(doc_id, source, op_type=action)
                    status = 201 if r["result"] == "created" else 200
                elif action == "delete":
                    r, status = idx.delete_doc(doc_id), 200
                elif action == "update":
                    if not isinstance(source, dict) or not isinstance(source.get("doc"), dict):
                        raise IllegalArgumentError("update action requires a [doc] object")
                    e = idx._docs.get(doc_id)
                    if e is None or not e.alive:
                        raise DocumentMissingError(f"[{doc_id}]: document missing")
                    r, status = idx.index_doc(doc_id, {**e.source, **source["doc"]}), 200
                else:
                    raise IllegalArgumentError(f"unknown bulk action [{action}]")
                items.append({action: {**r, "_index": index_name, "status": status}})
            except Exception as ex:  # noqa: BLE001 - a per-item envelope
                errors = True
                if isinstance(ex, ElasticsearchTpuError):
                    err, status = {"type": ex.type, "reason": ex.reason}, ex.status
                else:
                    err, status = {"type": "exception", "reason": str(ex)}, 500
                items.append({action: {"_index": index_name, "_id": doc_id,
                                       "status": status, "error": err}})
        return {"errors": errors, "items": items}

    def update_doc_api(self, index_name: str, doc_id: str, body: dict) -> dict:
        """`POST /{index}/_update/{id}` (reference `engine.py:3183-3241`;
        behavior: UpdateHelper): merge [doc] into the live source, or run a
        [script] over a copy of it (`script.update.UpdateScript`: ctx.op
        noop answers a noop, delete deletes); `upsert` or `doc_as_upsert`
        for a missing id, the script run over the upsert first with
        `scripted_upsert`; a merge that changes nothing is a noop
        (`detect_noop`, default true)."""
        from ..script.update import UpdateScript

        idx = self.get_or_autocreate(index_name)
        e = idx._docs.get(doc_id)
        exists = e is not None and e.alive
        doc, script = body.get("doc"), body.get("script")
        if doc is not None and script is not None:
            raise IllegalArgumentError("can't provide both script and doc")
        if doc is None and script is None:
            raise IllegalArgumentError("script or doc is missing")
        if not exists:
            if body.get("doc_as_upsert") and doc is not None:
                return {**idx.index_doc(doc_id, dict(doc)), "result": "created"}
            upsert = body.get("upsert")
            if upsert is None:
                raise DocumentMissingError(f"[{doc_id}]: document missing", index=idx.name)
            src = dict(upsert)
            if script is not None and body.get("scripted_upsert"):
                if UpdateScript(script).apply(src) in ("noop", "delete"):
                    return {"_id": doc_id, "result": "noop", "_version": 0, "_seq_no": -1}
            return {**idx.index_doc(doc_id, src), "result": "created"}
        if script is not None:
            src = json.loads(json.dumps(e.source))
            op = UpdateScript(script).apply(src)
            if op == "noop":
                return {"_index": idx.name, "_id": doc_id, "result": "noop",
                        "_version": e.version, "_seq_no": e.seq_no}
            if op == "delete":
                return {**idx.delete_doc(doc_id), "result": "deleted"}
            return idx.index_doc(doc_id, src)
        merged = {**e.source, **doc}
        if body.get("detect_noop", True) and merged == e.source:
            return {"_index": idx.name, "_id": doc_id, "result": "noop",
                    "_version": e.version, "_seq_no": e.seq_no}
        return idx.index_doc(doc_id, merged)

    # ---- search ------------------------------------------------------------

    def search_multi(self, expression, *, ignore_unavailable: bool = False,
                     allow_no_indices: bool = True, **kwargs) -> dict:
        """`_search` over an index expression (reference `engine.py:2902-3100`).
        One target answers as its `EsIndex.search`. Several fan out: each
        index that `search.canmatch.can_match` keeps runs `size + from`
        hits from 0 (a skipped index adds its shards to `skipped_shards` and
        launches nothing), and the coordinator merges: totals add up, hits
        re-sort by (score desc, `_index`, `_id`) or by each hit's `sort`
        keys (`_merge_key`), `collapse` keeps the best hit per key across
        indices, then `from` / `size` apply. `aggs` and `knn` over several
        indices answer the reference's 400s.

        The failure envelope: an index whose search raises one of the
        port's search errors (an `ElasticsearchTpuError` other than an
        `IllegalArgumentError`, which stays the caller's 400) becomes a
        `shard_failures` entry, and the request fails with
        `SearchPhaseExecutionError` when every searched index failed. Any
        other exception (a kernel build or launch failure on the card)
        propagates; the reference turns every exception into an entry."""
        targets = self.resolve_search(expression, ignore_unavailable, allow_no_indices)
        if not targets:
            return {"hits": {"total": {"value": 0, "relation": "eq"},
                             "max_score": None, "hits": []}}
        if len(targets) == 1:
            return targets[0][0].search(**kwargs)
        if kwargs.get("aggs"):
            raise IllegalArgumentError(
                "aggregations over multiple indices are not supported yet; "
                "target a single concrete index")
        if kwargs.get("knn"):
            raise IllegalArgumentError("knn over multiple indices is not supported yet")
        size = kwargs.get("size", 10)
        from_ = kwargs.get("from_", 0)
        sub_results = []
        skipped_shards = failed_shards = 0
        shard_failures: list[dict] = []
        for idx, _alias_filter in targets:
            kw = dict(kwargs, size=size + from_, from_=0)
            if not can_match(idx, kw.get("query")):
                skipped_shards += idx.num_shards
                continue
            try:
                sub_results.append(idx.search(**kw))
            except IllegalArgumentError:
                raise  # a malformed request is the caller's 400
            except ElasticsearchTpuError as ex:
                failed_shards += idx.num_shards
                shard_failures.append({
                    "shard": 0, "index": idx.name, "node": self.node_name,
                    "reason": {"type": type(ex).__name__.lower(), "reason": str(ex)[:512]}})
        if shard_failures and not sub_results:
            raise SearchPhaseExecutionError(
                "all shards failed: " + "; ".join(
                    f"[{f['index']}] {f['reason']['reason']}" for f in shard_failures),
                failures=shard_failures)
        sort_fields = parse_sort(kwargs.get("sort"))
        all_hits = [h for r in sub_results for h in r["hits"]["hits"]]
        if is_score_only(sort_fields):
            all_hits.sort(key=lambda h: (-(h["_score"] or 0.0), h["_index"], h["_id"]))
        else:
            all_hits.sort(key=lambda h: _merge_key(h["sort"], sort_fields))
        collapse = kwargs.get("collapse")
        cfld = collapse.get("field") if isinstance(collapse, dict) else collapse
        if cfld:
            # each index collapsed its own hits: keep the best hit per key
            seen, deduped = set(), []
            for h in all_hits:
                ck = (h.get("fields") or {}).get(cfld, [None])[0]
                marker = ("null",) if ck is None else ("k", ck)
                if marker not in seen:
                    seen.add(marker)
                    deduped.append(h)
            all_hits = deduped
        totals = [r["hits"]["total"] for r in sub_results if "total" in r["hits"]]
        max_scores = [r["hits"]["max_score"] for r in sub_results
                      if r["hits"]["max_score"] is not None]
        hits_obj = {"max_score": max(max_scores) if max_scores else None,
                    "hits": all_hits[from_:from_ + size]}
        if len(totals) == len(sub_results):
            hits_obj["total"] = {
                "value": sum(t["value"] for t in totals),
                "relation": "gte" if any(t.get("relation") == "gte" for t in totals) else "eq"}
        out = {"hits": hits_obj, "skipped_shards": skipped_shards}
        if shard_failures:
            out["failed_shards"] = failed_shards
            out["shard_failures"] = shard_failures
        return out

    def mget(self, items: list[tuple[str, str]]) -> list[dict]:
        """[(index, id)] -> `_mget` doc envelopes, realtime from each index's
        last writes (reference `engine.py:3435-3453`): a missing id is
        `found: false`, a missing index an error object."""
        out = []
        for index_name, doc_id in items:
            try:
                idx = self.get_index(index_name)
            except IndexNotFoundError as ex:
                out.append({"_index": index_name, "_id": doc_id,
                            "error": {"type": ex.type, "reason": ex.reason}})
                continue
            got = idx.get_doc(doc_id)
            if got is None:
                out.append({"_index": idx.name, "_id": doc_id, "found": False})
            else:
                out.append({"_index": idx.name, "found": True, **got})
        return out

    def field_caps(self, expression, fields="*") -> dict:
        """The union of the resolved indices' field schemas (reference
        `engine.py:3455-3490`; behavior: TransportFieldCapabilitiesAction):
        per field and type, searchable and aggregatable, and where a field
        has several types, the indices of each."""
        targets = self.resolve_search(expression)
        pats = fields.split(",") if isinstance(fields, str) else list(fields)
        caps: dict[str, dict[str, dict]] = {}
        per_type: dict[tuple[str, str], list[str]] = {}
        for idx, _ in targets:
            for name, ft in idx.mappings.fields.items():
                if not any(fnmatch.fnmatchcase(name, p) for p in pats):
                    continue
                caps.setdefault(name, {}).setdefault(ft.type, {
                    "type": ft.type, "metadata_field": False,
                    "searchable": bool(ft.index),
                    "aggregatable": bool(ft.doc_values) and ft.type != "text"})
                per_type.setdefault((name, ft.type), []).append(idx.name)
        for name, by_type in caps.items():
            if len(by_type) > 1:
                for t, body in by_type.items():
                    body["indices"] = sorted(per_type[(name, t)])
        return {"indices": [i.name for i, _ in targets], "fields": caps}

    def suggest_multi(self, expression, body: dict) -> dict:
        """A `suggest` section over an index expression with one concrete
        target (reference `engine.py:3533-3543`)."""
        from ..search.suggest import run_suggest

        targets = self.resolve_search(expression or "_all", allow_no_indices=True)
        if len(targets) != 1:
            raise IllegalArgumentError(
                "suggest over multiple indices is not supported; target one index")
        return run_suggest(targets[0][0], body)

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
