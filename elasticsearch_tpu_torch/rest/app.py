"""The REST API: the Elasticsearch HTTP contract over `engine.Engine`.

The reference app (`rest/app.py`) is built on aiohttp. This one is
framework-free: `RestApp.handle(method, path, query, headers, body)` ->
(status, headers, body bytes), which `rest/server.py` serves through the
standard library's HTTP server and tests call with no socket. Engine work
runs on one worker thread, so engine state is touched serially (reference
`rest/app.py:168-203`); the serving front end runs its wave stages on the
same worker.

Routes, with the reference's response shapes and error envelope
{"error": {"type", "reason", ...}, "status": N} (429s carry Retry-After):
`/`; index create, delete, get, head and `_mapping`; `_doc` and `_create`
writes, gets and deletes and `_update` with `refresh`; `_bulk` (NDJSON:
index, create, delete and update lines); `_refresh`; `_search`
(through the serving queue when `serving.enabled` is on; the fetch
sub-phases, `suggest` and `profile: true` trees after it); `_msearch`
(sub-searches submitted together when serving is on, so they coalesce);
`_count`; `_cluster/settings`; `_cluster/health`; `_serving/stats`;
`_synonyms` (PUT, GET and DELETE of named synonym sets; a PUT reloads the
search analyzers of the indices that use the set);
`_refresh/profile`; ES|QL (`_query`, `_esql/query`, `_esql/profile`), `_sql`
and `_eql/search`; the tenant ledger, `_tenants/stats` and `_cat/tenants`
(each `_bulk` meters its NDJSON bytes and docs to the `X-Opaque-Id`
tenant); search templates (`_scripts/{id}`, `_search/template`,
`_msearch/template`, `_render/template`), `_rank_eval` and the `retriever`
key of a search body; `_search` over a comma list, a wildcard or `_all`
(the fan-out with can-match, `_shards.skipped` and `failed`); `_analyze`,
`_validate/query`, `_termvectors`, `_mtermvectors`, `_explain`,
`_field_caps` and `_mget`. Any other path answers a 400 envelope, a known
path with another method 405.
"""

from __future__ import annotations

import json
import logging
import re
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

from ..engine.engine import Engine
from ..query.dsl import parse_query
from ..search.fetch import apply_fetch_phase
from ..search.profile import empty_shard, profile_shards
from ..telemetry import collect_profile_events
from ..tenancy.metering import normalize_tenant
from ..utils.durations import parse_duration_seconds
from ..utils.errors import (ActionRequestValidationError, ElasticsearchTpuError,
                            IllegalArgumentError, ResourceNotFoundError,
                            SearchPhaseExecutionError, not_yet_ported)
from ..utils.params import bool_param, track_total_hits_param

_log = logging.getLogger(__name__)
JSON_TYPE = "application/json; charset=UTF-8"
# search body keys the port serves (the `_source` spec included); every
# other key of the reference is refused as not yet ported
_SEARCH_BODY_KEYS = {"query", "knn", "size", "from", "track_total_hits", "timeout",
                     "aggs", "aggregations", "_source", "stored_fields", "docvalue_fields",
                     "fields", "highlight", "sort", "search_after", "collapse", "rescore",
                     "script_fields", "runtime_mappings", "suggest", "profile",
                     "allow_partial_search_results"}
# GET /_cat/tenants columns (the reference's `engine/admin.cat_tenants`)
_CAT_TENANTS = ("tenant", "requests", "waves", "device_ms", "device_ms_per_s", "queue_p99_ms",
                "sheds", "shed_rate", "cache.hits", "cache.misses", "ingest.bytes",
                "dominant_kernel")
_SEARCH_PARAMS_NOT_PORTED = ("scroll", "routing", "preference", "q")


def _collected(fn, *args, **kwargs):
    """fn(...) inside a profile collector -> (its result, the events)."""
    with collect_profile_events() as events:
        return fn(*args, **kwargs), events


def _err(ex: Exception) -> tuple[int, dict, dict]:
    """An exception -> (status, extra headers, the error envelope)."""
    if isinstance(ex, ElasticsearchTpuError):
        body, status = ex.to_dict(), ex.status
    else:
        body = {"error": {"type": "exception", "reason": str(ex)}, "status": 500}
        status = 500
    headers = {}
    retry_after = getattr(ex, "retry_after_s", None)
    if retry_after is not None:
        headers["Retry-After"] = str(int(max(1, retry_after)))
    return status, headers, body


class _Route:
    def __init__(self, methods: str, pattern: str, fn):
        self.methods = None if methods == "*" else set(methods.split("|"))
        self.regex = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$")
        self.fn = fn


class RestApp:
    """The dispatcher: one engine, one engine worker thread."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine")
        engine.serving.bind_executor(self.pool.submit)
        r = _Route
        self.routes = [
            r("GET", "/", self.root),
            r("GET", "/_cluster/health", self.cluster_health),
            r("GET", "/_cluster/health/{index}", self.cluster_health),
            r("GET", "/_cluster/settings", self.get_cluster_settings),
            r("PUT", "/_cluster/settings", self.put_cluster_settings),
            r("GET", "/_serving/stats", self.serving_stats),
            r("GET", "/_refresh/profile", self.refresh_profile),
            r("GET", "/_tenants/stats", self.tenants_stats),
            r("GET", "/_cat/tenants", self.cat_tenants),
            r("PUT", "/_synonyms/{set}", self.put_synonyms),
            r("GET", "/_synonyms", self.get_synonyms),
            r("GET", "/_synonyms/{set}", self.get_synonyms),
            r("DELETE", "/_synonyms/{set}", self.delete_synonyms),
            r("POST", "/_query", self.esql),
            r("POST", "/_esql/query", self.esql),
            r("GET", "/_esql/profile", self.esql_profile),
            r("POST", "/_sql", self.sql),
            r("GET|POST", "/{index}/_eql/search", self.eql),
            r("PUT|POST", "/_scripts/{id}", self.put_stored_script),
            r("GET", "/_scripts/{id}", self.get_stored_script),
            r("DELETE", "/_scripts/{id}", self.delete_stored_script),
            r("*", "/_search/template", self.search_template),
            r("*", "/_render/template", self.render_template),
            r("*", "/_render/template/{id}", self.render_template),
            r("*", "/_msearch/template", self.msearch_template),
            r("*", "/_rank_eval", self.rank_eval),
            r("*", "/_analyze", self.analyze),
            r("*", "/_validate/query", self.validate_query),
            r("*", "/_mtermvectors", self.mtermvectors),
            r("*", "/_field_caps", self.field_caps),
            r("POST|GET", "/_mget", self.mget),
            r("POST|PUT", "/_bulk", self.bulk),
            r("POST", "/_msearch", self.msearch),
            r("*", "/_search", self.search),
            r("*", "/_count", self.count),
            r("POST", "/_refresh", self.refresh),
            r("PUT", "/{index}", self.create_index),
            r("DELETE", "/{index}", self.delete_index),
            r("GET", "/{index}", self.get_index),
            r("HEAD", "/{index}", self.head_index),
            r("GET", "/{index}/_mapping", self.get_mapping),
            r("POST|GET", "/{index}/_refresh", self.refresh),
            r("POST|PUT", "/{index}/_bulk", self.bulk),
            r("*", "/{index}/_search/template", self.search_template),
            r("*", "/{index}/_msearch/template", self.msearch_template),
            r("*", "/{index}/_rank_eval", self.rank_eval),
            r("*", "/{index}/_analyze", self.analyze),
            r("*", "/{index}/_validate/query", self.validate_query),
            r("*", "/{index}/_termvectors/{id}", self.termvectors),
            r("*", "/{index}/_mtermvectors", self.mtermvectors),
            r("*", "/{index}/_explain/{id}", self.explain),
            r("*", "/{index}/_field_caps", self.field_caps),
            r("POST|GET", "/{index}/_mget", self.mget),
            r("*", "/{index}/_search", self.search),
            r("POST", "/{index}/_msearch", self.msearch),
            r("*", "/{index}/_count", self.count),
            r("POST", "/{index}/_doc", self.put_doc),
            r("PUT|POST", "/{index}/_doc/{id}", self.put_doc),
            r("GET", "/{index}/_doc/{id}", self.get_doc),
            r("DELETE", "/{index}/_doc/{id}", self.delete_doc),
            r("POST", "/{index}/_update/{id}", self.update_doc),
            r("PUT|POST", "/{index}/_create/{id}", self.create_doc),
        ]

    def call(self, fn, *args, **kwargs):
        """Run fn on the engine worker and wait for it."""
        return self.pool.submit(fn, *args, **kwargs).result()

    def close(self) -> None:
        """Stop the serving front end, then the worker its waves run on."""
        self.engine.close()
        self.pool.shutdown(wait=True)

    # ---- dispatch ---------------------------------------------------------------

    def handle(self, method: str, path: str, query: dict | None = None,
               headers: dict | None = None, body: bytes = b"") -> tuple[int, dict, bytes]:
        """One request -> (status, headers, body bytes). `query` maps each
        parameter to its value ("" for a bare flag)."""
        method = method.upper()
        query = dict(query or {})
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        req = {"method": method, "path": path, "query": query, "headers": headers,
               "body": body or b"", "match": {}}
        allowed = []
        for route in self.routes:
            m = route.regex.match(path)
            if m is None:
                continue
            if route.methods is not None and method not in route.methods:
                allowed += sorted(route.methods)
                continue
            req["match"] = m.groupdict()
            try:
                status, out, extra = route.fn(req)
            except json.JSONDecodeError as ex:
                status, extra, out = _err(
                    IllegalArgumentError(f"failed to parse request body: {ex}"))
            except Exception as ex:  # noqa: BLE001 - the error envelope boundary
                if not isinstance(ex, ElasticsearchTpuError):
                    _log.exception("%s %s failed", method, path)
                status, extra, out = _err(ex)
            return self._respond(method, status, out, extra)
        if allowed:
            return self._respond(method, 405, {
                "error": f"Incorrect HTTP method for uri [{path}] and method [{method}], "
                         f"allowed: {sorted(set(allowed))}", "status": 405}, {})
        return self._respond(method, 400, {"error": {
            "type": "illegal_argument_exception",
            "reason": f"no handler found for uri [{path}] and method [{method}]"},
            "status": 400}, {})

    @staticmethod
    def _respond(method: str, status: int, out, extra: dict) -> tuple[int, dict, bytes]:
        if out is None or method == "HEAD":
            return status, dict(extra), b""
        if isinstance(out, str):  # a _cat text table
            return status, {"Content-Type": JSON_TYPE, **extra}, out.encode()
        return status, {"Content-Type": JSON_TYPE, **extra}, json.dumps(out).encode()

    @staticmethod
    def _json(req, default=None):
        raw = req["body"]
        if not raw or not raw.strip():
            return default
        return json.loads(raw)

    # ---- root, cluster --------------------------------------------------------

    def root(self, req):
        return 200, {"name": "elasticsearch-tpu-torch", "cluster_name": "elasticsearch-tpu",
                     "version": {"number": "8.14.0", "build_flavor": "cuda",
                                 "lucene_version": "none (blocked-CSR packs on the card)"},
                     "tagline": "You Know, for Search"}, {}

    def cluster_health(self, req):
        h = self.call(self.engine.cluster_health, req["match"].get("index"))
        if req["query"].get("level") != "indices":
            h.pop("indices", None)
        return 200, h, {}

    def get_cluster_settings(self, req):
        s = self.engine.settings
        return 200, {"persistent": dict(s.persistent), "transient": dict(s.transient)}, {}

    def put_cluster_settings(self, req):
        return 200, self.call(self.engine.settings.update, self._json(req, {}) or {}), {}

    def serving_stats(self, req):
        return 200, {"serving": self.engine.serving.stats()}, {}

    @staticmethod
    def _ring_n(req) -> int | None:
        """A profile ring's `n` parameter: the newest n records (None: all)."""
        n = req["query"].get("n")
        try:
            return int(n) if n else None
        except ValueError:
            raise IllegalArgumentError(f"failed to parse [n] value [{n}]") from None

    def refresh_profile(self, req):
        """GET /_refresh/profile[?n=]: the engine's RefreshProfile ring, oldest
        first (reference `rest/app.py:2707`)."""
        return 200, self.engine.refresh_recorder.profiles(self._ring_n(req)), {}

    # ---- synonym sets ------------------------------------------------------------

    def put_synonyms(self, req):
        """PUT /_synonyms/{set} (reference `rest/app.py:626-659`): store the
        set and reload the search analyzers that name it."""
        body = self._json(req, {}) or {}
        created = self.call(self.engine.put_synonyms, req["match"]["set"],
                            body.get("synonyms_set"))
        return 200, {"result": "created" if created else "updated"}, {}

    def get_synonyms(self, req):
        return 200, self.engine.get_synonyms(req["match"].get("set")), {}

    def delete_synonyms(self, req):
        self.call(self.engine.delete_synonyms, req["match"]["set"])
        return 200, {"acknowledged": True}, {}

    # ---- tenants -----------------------------------------------------------------

    def tenants_stats(self, req):
        """GET /_tenants/stats (reference `rest/app.py:2699`): the per-tenant
        ledger (apportioned device ms and its burn rate and kernel split,
        queue waits and p99, sheds and expiries, ingest volume), superpack
        members' bytes and the superpack summary."""
        return 200, {"tenants": self.engine.tenant_stats()}, {}

    def cat_tenants(self, req):
        """GET /_cat/tenants (reference `rest/app.py:1703`,
        `engine/admin.cat_tenants`): one row per metered tenant, device ms
        descending, with its dominant kernel; `format=json`, or text with
        `v` (a header row) and `h` (columns)."""
        rows = []
        for tenant, r in self.engine.metering.rows().items():
            kernels = r.get("kernels") or {}
            rows.append({"tenant": tenant, "requests": r["requests"], "waves": r["waves"],
                         "device_ms": r["device_ms"], "device_ms_per_s": r["device_ms_per_s"],
                         "queue_p99_ms": r["queue_p99_ms"], "sheds": r["sheds"],
                         "shed_rate": r["shed_rate"], "cache.hits": r["cache"]["hits"],
                         "cache.misses": r["cache"]["misses"],
                         "ingest.bytes": r["ingest_bytes"],
                         "dominant_kernel": next(iter(kernels)) if kernels else "-"})
        q = req["query"]
        cols = [c for c in q["h"].split(",") if c in _CAT_TENANTS] if q.get("h") else \
            list(_CAT_TENANTS)
        rows = [{c: row[c] for c in cols} for row in rows]
        if q.get("format") == "json":
            return 200, rows, {}
        table = ([cols] if bool_param(q, "v") else []) + [[str(row[c]) for c in cols]
                                                          for row in rows]
        widths = [max((len(str(line[i])) for line in table), default=0)
                  for i in range(len(cols))]
        text = "".join(" ".join(str(v).ljust(w) for v, w in zip(line, widths)).rstrip() + "\n"
                       for line in table)
        return 200, text, {"Content-Type": "text/plain; charset=UTF-8"}

    # ---- ES|QL, SQL, EQL -------------------------------------------------------

    def esql(self, req):
        """POST /_query, /_esql/query (reference `rest/app.py:1381-1396`):
        the pipe runs on the engine worker. The reference registers each
        query as a cancellable task; `_tasks` is not ported yet."""
        from ..esql import esql_query

        return 200, self.call(esql_query, self.engine, self._json(req, {}) or {},
                              tenant=req["headers"].get("x-opaque-id")), {}

    def esql_profile(self, req):
        """GET /_esql/profile[?n=]: the engine's ES|QL profile ring, oldest
        first, and the recorder's cumulative stats (reference
        `rest/app.py:2718`)."""
        rec = self.engine.esql_recorder
        return 200, {**rec.profiles(self._ring_n(req)), "stats": rec.stats()}, {}

    def sql(self, req):
        """POST /_sql (reference `rest/app.py:1399-1405`)."""
        from ..esql.sql import sql_query

        return 200, self.call(sql_query, self.engine, self._json(req, {}) or {}), {}

    def eql(self, req):
        """GET|POST /{index}/_eql/search (reference `rest/app.py:1407-1413`)."""
        from ..esql.eql import eql_search

        return 200, self.call(eql_search, self.engine, req["match"]["index"],
                              self._json(req, {}) or {}), {}

    # ---- indices --------------------------------------------------------------

    def create_index(self, req):
        name = req["match"]["index"]
        body = self._json(req, {}) or {}
        if body.get("aliases"):
            raise not_yet_ported("[aliases]")
        settings = dict(body.get("settings") or {})
        if isinstance(settings.get("index"), dict):
            settings.update(settings.pop("index"))
        self.call(self.engine.create_index, name, body.get("mappings"), settings)
        return 200, {"acknowledged": True, "shards_acknowledged": True, "index": name}, {}

    def delete_index(self, req):
        self.call(self.engine.delete_index, req["match"]["index"])
        return 200, {"acknowledged": True}, {}

    def get_index(self, req):
        idx = self.engine.get_index(req["match"]["index"])
        return 200, {idx.name: {"aliases": {}, "mappings": idx.mappings.to_dict(),
                                "settings": {"index": {k: str(v) for k, v in
                                                       idx.settings.items()}}}}, {}

    def head_index(self, req):
        return (200 if req["match"]["index"] in self.engine.indices else 404), None, {}

    def get_mapping(self, req):
        idx = self.engine.get_index(req["match"]["index"])
        return 200, {idx.name: {"mappings": idx.mappings.to_dict()}}, {}

    def refresh(self, req):
        """Per-index refresh; a failure is an entry of `_shards.failures`,
        not an HTTP error (reference behavior: BroadcastResponse)."""
        name = req["match"].get("index")
        targets = ([i for i, _ in self.engine.resolve_search(name)] if name
                   else list(self.engine.indices.values()))
        failures = []
        for idx in targets:
            try:
                self.call(idx.refresh)
            except Exception as ex:  # noqa: BLE001 - a per-shard envelope
                failures.append({"shard": 0, "index": idx.name, "node": "node-0",
                                 "reason": {"type": type(ex).__name__.lower(),
                                            "reason": str(ex)[:512]}})
        n = len(targets)
        shards = {"total": n, "successful": n - len(failures), "failed": len(failures)}
        if failures:
            shards["failures"] = failures
        return 200, {"_shards": shards}, {}

    # ---- documents ------------------------------------------------------------

    @staticmethod
    def _doc_result(r: dict, index_name: str, query: dict) -> dict:
        out = {"_index": index_name, "_id": r["_id"], "_version": r["_version"],
               "_seq_no": r["_seq_no"], "_primary_term": 1, "result": r["result"],
               "_shards": {"total": 1, "successful": 1, "failed": 0}}
        if query.get("refresh") in ("", "true"):
            out["forced_refresh"] = True
        return out

    def _write(self, req, op_type: str):
        name = req["match"]["index"]
        body = self._json(req)
        if not isinstance(body, dict):
            raise IllegalArgumentError("request body is required")
        if req["query"].get("pipeline") or req["query"].get("routing"):
            raise not_yet_ported("[pipeline] and [routing] on a write")
        idx = self.call(self.engine.get_or_autocreate, name)
        r = self.call(idx.index_doc, req["match"].get("id"), body, op_type)
        if req["query"].get("refresh") in ("", "true", "wait_for"):
            self.call(idx.refresh)
        return r, self._doc_result(r, name, req["query"])

    def put_doc(self, req):
        r, out = self._write(req, req["query"].get("op_type", "index"))
        return (201 if r["result"] == "created" else 200), out, {}

    def create_doc(self, req):
        return 201, self._write(req, "create")[1], {}

    def get_doc(self, req):
        idx = self.engine.get_index(req["match"]["index"])
        got = idx.get_doc(req["match"]["id"])
        if got is None:
            return 404, {"_index": idx.name, "_id": req["match"]["id"], "found": False}, {}
        return 200, {"_index": idx.name, "found": True, **got}, {}

    def delete_doc(self, req):
        """(reference `rest/app.py:441`)"""
        idx = self.engine.get_index(req["match"]["index"])
        r = self.call(idx.delete_doc, req["match"]["id"])
        if req["query"].get("refresh") in ("", "true", "wait_for"):
            self.call(idx.refresh)
        return 200, self._doc_result(r, idx.name, req["query"]), {}

    def update_doc(self, req):
        """`_update`: doc merge, upsert, doc_as_upsert, detect_noop
        (reference `rest/app.py:449`)."""
        name = req["match"]["index"]
        r = self.call(self.engine.update_doc_api, name, req["match"]["id"],
                      self._json(req, {}) or {})
        if req["query"].get("refresh") in ("", "true", "wait_for"):
            self.call(self.engine.get_index(name).refresh)
        return (201 if r["result"] == "created" else 200), \
            self._doc_result(r, name, req["query"]), {}

    def bulk(self, req):
        """NDJSON action and source lines (reference `rest/app.py:1751-1805`)."""
        default_index = req["match"].get("index")
        lines = req["body"].decode("utf-8").split("\n")
        ops = []
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            i += 1
            if not line:
                continue
            (action, meta), = json.loads(line).items()
            if action not in ("index", "create", "delete", "update"):
                raise IllegalArgumentError(
                    f"Malformed action/metadata line: unknown action [{action}]")
            index_name = meta.get("_index", default_index)
            if not index_name:
                raise IllegalArgumentError("bulk item missing _index")
            doc_id = meta.get("_id")
            source = None
            if action != "delete":
                while i < len(lines) and not lines[i].strip():
                    i += 1
                if i >= len(lines):
                    raise IllegalArgumentError("bulk action missing source line")
                source = json.loads(lines[i])
                i += 1
            ops.append((action, index_name, None if doc_id is None else str(doc_id), source))
        t0 = time.monotonic()
        res = self.call(self.engine.bulk, ops)
        # per-tenant ingest metering: the NDJSON bytes as they came in
        self.engine.metering.note_ingest(normalize_tenant(req["headers"].get("x-opaque-id")),
                                         len(req["body"]), docs=len(ops))
        if req["query"].get("refresh") in ("", "true", "wait_for"):
            for name in dict.fromkeys(op[1] for op in ops):
                idx = self.engine.indices.get(name)
                if idx is not None:
                    self.call(idx.refresh)
        res["took"] = int((time.monotonic() - t0) * 1000)
        return 200, res, {}

    # ---- search ---------------------------------------------------------------

    def _search_start(self, expression, body, query: dict, headers: dict):
        """Check a search and start it: through the serving queue when
        serving is on and the request is wave-eligible (a Future), else on
        the engine worker (the response). A `profile: true` request is never
        wave-eligible: its main search runs inside the profile collector.
        -> the state `_search_finish` completes."""
        body = body or {}
        if not isinstance(body, dict):
            raise IllegalArgumentError("a search body must be an object")
        if body.get("retriever") is not None:
            return self._retriever(expression, body, query)
        for key in body:
            if key not in _SEARCH_BODY_KEYS:
                raise not_yet_ported(f"[{key}] in a search body")
        for key in _SEARCH_PARAMS_NOT_PORTED:
            if key in query:
                raise not_yet_ported(f"the [{key}] parameter")
        kwargs = dict(query=body.get("query"), knn=body.get("knn"),
                      size=int(query.get("size", body.get("size", 10))),
                      from_=int(query.get("from", body.get("from", 0))),
                      track_total_hits=track_total_hits_param(body, query),
                      aggs=body.get("aggs") or body.get("aggregations"),
                      sort=body.get("sort"), search_after=body.get("search_after"),
                      collapse=body.get("collapse"), rescore=body.get("rescore"),
                      script_fields=body.get("script_fields"),
                      runtime_mappings=body.get("runtime_mappings"))
        iu = bool_param(query, "ignore_unavailable")
        ani = bool_param(query, "allow_no_indices", True)
        t0 = time.monotonic()
        events = None
        sv = self.engine.serving_if_enabled()
        entry = (sv.classify(expression, body, query)
                 if sv is not None and not body.get("profile") else None)
        if entry is not None:
            t_raw = body.get("timeout") or query.get("timeout")
            if t_raw is None:
                t_raw = self.engine.settings.get("search.default_search_timeout")
            res = sv.submit(entry, tenant=normalize_tenant(headers.get("x-opaque-id")),
                            timeout_s=parse_duration_seconds(t_raw, None))
        elif body.get("profile"):
            # the collector lives on the engine worker, around the search
            res, events = self.call(_collected, self.engine.search_multi, expression,
                                    ignore_unavailable=iu, allow_no_indices=ani, **kwargs)
        else:
            res = self.call(self.engine.search_multi, expression, ignore_unavailable=iu,
                            allow_no_indices=ani, **kwargs)
        return expression, body, query, t0, res, events

    def _retriever(self, expression, body: dict, query: dict) -> dict:
        """A body with a `retriever` (`standard`, `knn`, `rrf`) answers
        before the normal search, with no fetch phase, as the reference's
        (`rest/app.py:1871-1890`)."""
        from ..search.rankeval import rrf_retriever_search

        t0 = time.monotonic()
        res = self.call(rrf_retriever_search, self.engine, expression, body["retriever"],
                        int(query.get("size", body.get("size", 10))),
                        int(query.get("from", body.get("from", 0))))
        return {"took": int((time.monotonic() - t0) * 1000), "timed_out": False,
                "_shards": {"total": 1, "successful": 1, "skipped": 0, "failed": 0}, **res}

    def _search_finish(self, started) -> dict:
        """The fetch phase over the hits (the `_source`, `docvalue_fields`
        and `stored_fields` URL parameters first), then `suggest` and the
        `profile` trees, and `_shards` with the fan-out's skipped and
        failed indices' shards (reference `rest/app.py:1966-2100`). A
        partial answer is served unless `allow_partial_search_results` is
        false (body, then URL parameter; the cluster default is true)."""
        if isinstance(started, dict):  # a retriever's complete answer
            return started
        expression, body, query, t0, res, events = started
        if isinstance(res, Future):
            res = res.result()
        took = int((time.monotonic() - t0) * 1000)
        # the fetch options given as URL parameters
        if "_source" in query and "_source" not in body:
            rs = query["_source"]
            body = {**body, "_source": (rs == "true") if rs in ("true", "false")
                    else rs.split(",")}
        inc, exc = query.get("_source_includes"), query.get("_source_excludes")
        if (inc or exc) and not isinstance(body.get("_source"), dict):
            body = {**body, "_source": {"includes": inc.split(",") if inc else [],
                                        "excludes": exc.split(",") if exc else []}}
        for key in ("docvalue_fields", "stored_fields"):
            if key in query and key not in body:
                body = {**body, key: query[key].split(",")}
        t_fetch = time.monotonic()
        apply_fetch_phase(res["hits"]["hits"], body,
                          lambda name: self.engine.get_index(name).mappings)
        fetch_ms = (time.monotonic() - t_fetch) * 1000
        if body.get("suggest"):
            res["suggest"] = self.call(self.engine.suggest_multi, expression, body["suggest"])
        if body.get("profile"):
            res["profile"] = self.call(self._profile, expression, body, events,
                                       int((time.monotonic() - t0) * 1e9),
                                       {"query_ms": took, "fetch_ms": round(fetch_ms, 3)})
        try:
            n_shards = sum(i.num_shards for i, _ in self.engine.resolve_search(
                expression, bool_param(query, "ignore_unavailable"), True))
        except ElasticsearchTpuError:
            n_shards = 1
        if bool_param(query, "rest_total_hits_as_int"):
            tot = res.get("hits", {}).get("total")
            if isinstance(tot, dict):
                res["hits"]["total"] = tot["value"]
        skipped = res.pop("skipped_shards", 0)
        failed = res.pop("failed_shards", 0)
        failures = res.pop("shard_failures", None)
        if failed:
            allow = body.get("allow_partial_search_results")
            if allow is None:
                allow = bool_param(query, "allow_partial_search_results", True)
            if not allow:
                raise SearchPhaseExecutionError(
                    f"{failed} shard failure(s) and allow_partial_search_results is false",
                    failures=failures)
        shards = {"total": n_shards, "successful": max(n_shards - failed, 0),
                  "skipped": skipped, "failed": failed}
        if failures:
            shards["failures"] = failures
        return {"took": took, "timed_out": False, "_shards": shards, **res}

    def _profile(self, expression, body: dict, events, took_ns: int, phases: dict) -> dict:
        """The profile trees of every target index (on the engine worker);
        an index never refreshed gives its empty shard entry."""
        shards = []
        for idx, _alias_filter in self.engine.resolve_search(expression or "_all", True, True):
            if idx._searcher is None:
                shards.append(empty_shard(idx, self.engine.node_name))
                continue
            node = parse_query(body.get("query") or {"match_all": {}}, idx.mappings)
            shards.extend(profile_shards(idx, node, took_ns, self.engine.node_name,
                                         device_events=events, phases=phases))
        return {"shards": shards}

    def search(self, req):
        started = self._search_start(req["match"].get("index"), self._json(req, {}),
                                     req["query"], req["headers"])
        return 200, self._search_finish(started), {}

    def msearch(self, req):
        """Header and body line pairs (reference `rest/app.py:2113-2145`).
        Serving off: the sub-searches run one after another. Serving on:
        they are submitted ahead of their answers, so they coalesce, at most
        two full waves at a time (within the queue's depth), as
        Elasticsearch bounds an msearch's concurrency; the reference submits
        them all and sheds those past the queue's depth."""
        lines = [ln for ln in req["body"].decode("utf-8").split("\n") if ln.strip()]
        if len(lines) % 2:
            raise IllegalArgumentError("msearch body must be header/body line pairs")
        shared = {k: req["query"][k] for k in ("rest_total_hits_as_int", "typed_keys")
                  if k in req["query"]}
        subs = []
        for i in range(0, len(lines), 2):
            header = json.loads(lines[i])
            subs.append((header.get("index", req["match"].get("index")),
                         json.loads(lines[i + 1])))
        sv = self.engine.serving_if_enabled()
        window = 1
        if sv is not None and len(subs) > 1:
            window = min(2 * sv.max_wave, sv.queue_cap)

        def start(name, body):
            try:
                return self._search_start(name, body, shared, req["headers"])
            except ElasticsearchTpuError as ex:
                return ex

        def finish(started):
            try:
                if isinstance(started, ElasticsearchTpuError):
                    raise started
                return {**self._search_finish(started), "status": 200}
            except ElasticsearchTpuError as ex:
                return {**ex.to_dict(), "status": ex.status}

        responses, started = [], deque()
        for sub in subs:
            if len(started) >= window:
                responses.append(finish(started.popleft()))
            started.append(start(*sub))
        responses += [finish(s) for s in started]
        return 200, {"took": 0, "responses": responses}, {}

    def count(self, req):
        body = self._json(req, {}) or {}
        expression = req["match"].get("index")
        n = self.call(self.engine.count_multi, expression, body.get("query"))
        n_shards = sum(i.num_shards for i, _ in self.engine.resolve_search(expression))
        return 200, {"count": n, "_shards": {"total": n_shards, "successful": n_shards,
                                             "skipped": 0, "failed": 0}}, {}

    # ---- search templates, stored scripts, rank eval ----------------------------

    def put_stored_script(self, req):
        """PUT|POST /_scripts/{id} (reference `rest/app.py:555-566`); kept in
        memory (`Engine.stored_scripts`)."""
        script = (self._json(req, {}) or {}).get("script")
        if not isinstance(script, dict) or "source" not in script:
            raise IllegalArgumentError("stored script requires [script.source]")
        self.engine.stored_scripts[req["match"]["id"]] = {
            "lang": script.get("lang", "mustache"), "source": script["source"]}
        return 200, {"acknowledged": True}, {}

    def get_stored_script(self, req):
        sid = req["match"]["id"]
        script = self.engine.stored_scripts.get(sid)
        if script is None:
            return 404, {"_id": sid, "found": False}, {}
        return 200, {"_id": sid, "found": True, "script": script}, {}

    def delete_stored_script(self, req):
        sid = req["match"]["id"]
        if self.engine.stored_scripts.pop(sid, None) is None:
            raise ResourceNotFoundError(f"stored script [{sid}] not found")
        return 200, {"acknowledged": True}, {}

    def search_template(self, req):
        """/_search/template (reference `rest/app.py:533-541`): the rendered
        body runs through `_search` as a plain body does."""
        from ..search.templates import resolve_template

        _, parsed = resolve_template(self.engine, self._json(req, {}) or {})
        started = self._search_start(req["match"].get("index"), parsed, req["query"],
                                     req["headers"])
        return 200, self._search_finish(started), {}

    def render_template(self, req):
        """/_render/template[/{id}] (reference `rest/app.py:543-552`)."""
        from ..search.templates import resolve_template

        body = self._json(req, {}) or {}
        if req["match"].get("id"):
            body = {**body, "id": req["match"]["id"]}
        return 200, {"template_output": resolve_template(self.engine, body)[1]}, {}

    def msearch_template(self, req):
        """/_msearch/template (reference `rest/app.py:806-824`): header and
        template line pairs, each answered in turn, an error as its own
        entry."""
        from ..search.templates import resolve_template

        lines = [ln for ln in req["body"].decode("utf-8").split("\n") if ln.strip()]
        responses = []
        for i in range(0, len(lines) - 1, 2):
            header = json.loads(lines[i])
            tpl = json.loads(lines[i + 1])
            try:
                _, parsed = resolve_template(self.engine, tpl)
                started = self._search_start(header.get("index") or req["match"].get("index"),
                                             parsed, {}, req["headers"])
                responses.append({**self._search_finish(started), "status": 200})
            except ElasticsearchTpuError as ex:
                responses.append({**ex.to_dict(), "status": ex.status})
        return 200, {"took": 1, "responses": responses}, {}

    def rank_eval(self, req):
        """/_rank_eval (reference `rest/app.py:1592-1596`): the requests run
        over the indices their ratings name, not the path's."""
        from ..search.rankeval import rank_eval

        return 200, self.call(rank_eval, self.engine, self._json(req, {}) or {}), {}

    # ---- the search-side APIs ------------------------------------------------------

    def analyze(self, req):
        """/_analyze (reference `rest/app.py:1599-1609`): `text`, `analyzer`
        and `field` also as URL parameters."""
        from ..engine import admin

        body = self._json(req, {}) or {}
        for p in ("text", "analyzer", "field"):
            if p in req["query"] and p not in body:
                body[p] = req["query"][p]
        return 200, self.call(admin.analyze, self.engine, req["match"].get("index"), body), {}

    def validate_query(self, req):
        from ..engine import admin

        return 200, self.call(admin.validate_query, self.engine, req["match"].get("index"),
                              self._json(req, {}) or {},
                              bool_param(req["query"], "explain")), {}

    def termvectors(self, req):
        """/{index}/_termvectors/{id} (reference `rest/app.py:1622-1629`): the
        options come from the body; the URL parameter `fields` only."""
        from ..engine import admin

        return 200, self.call(admin.termvectors, self.engine, req["match"]["index"],
                              req["match"]["id"], self._json(req, None),
                              req["query"].get("fields")), {}

    def mtermvectors(self, req):
        """/_mtermvectors (reference `rest/app.py:826-849`): `docs` or `ids`,
        an error as its own entry."""
        from ..engine import admin

        body = self._json(req, {}) or {}
        default_index = req["match"].get("index")
        docs = body.get("docs")
        if docs is None and body.get("ids"):
            docs = [{"_id": i} for i in body["ids"]]
        out = []
        for d in docs or []:
            index_name = d.get("_index", default_index)
            doc_id = d.get("_id")
            if not index_name or doc_id is None:
                out.append({"_index": index_name, "_id": doc_id,
                            "error": {"type": "illegal_argument_exception",
                                      "reason": "[_index] and [_id] are required"}})
                continue
            try:
                out.append(self.call(admin.termvectors, self.engine, index_name, doc_id, d,
                                     None))
            except ElasticsearchTpuError as ex:
                out.append({"_index": index_name, "_id": doc_id, **ex.to_dict()})
        return 200, {"docs": out}, {}

    def explain(self, req):
        """/{index}/_explain/{id} (reference `rest/app.py:2254-2262`): the
        body's query; with only `q` given, the reference scores match_all,
        and so does the port."""
        body = self._json(req, {}) or {}
        q = body.get("query")
        if q is None and req["query"].get("q") is None:
            raise IllegalArgumentError("query is missing")
        idx = self.engine.get_index(req["match"]["index"])
        return 200, {"_index": idx.name, **self.call(idx.explain, req["match"]["id"], q)}, {}

    def field_caps(self, req):
        body = self._json(req, {}) or {}
        fields = req["query"].get("fields") or body.get("fields") or "*"
        return 200, self.call(self.engine.field_caps, req["match"].get("index"), fields), {}

    def mget(self, req):
        """/_mget (reference `rest/app.py:2205-2251`): `docs` or `ids`, each
        doc's `_source` spec over the URL's (`_source`, `_source_includes`,
        `_source_excludes`), through `search.fetch.filter_source`."""
        from ..search.fetch import filter_source

        body = self._json(req, {}) or {}
        default_index = req["match"].get("index")
        items, specs = [], []
        if "docs" in body:
            for d in body["docs"]:
                name = d.get("_index", default_index)
                if not name:
                    raise ActionRequestValidationError("index is missing")
                if "_id" not in d:
                    raise ActionRequestValidationError("id is missing")
                items.append((name, str(d["_id"])))
                specs.append(d.get("_source"))
        elif "ids" in body:
            if not default_index:
                raise IllegalArgumentError("ids form requires an index in the path")
            items = [(default_index, str(i)) for i in body["ids"]]
            specs = [None] * len(items)
        else:
            raise IllegalArgumentError("unexpected content, expected [docs] or [ids]")
        q = req["query"]
        req_spec = None
        if q.get("_source") is not None:
            rs = q["_source"]
            req_spec = (rs == "true") if rs in ("true", "false") else rs.split(",")
        inc, exc = q.get("_source_includes"), q.get("_source_excludes")
        if inc or exc:
            req_spec = {"includes": inc.split(",") if inc else [],
                        "excludes": exc.split(",") if exc else []}
        docs = self.call(self.engine.mget, items)
        for doc, spec in zip(docs, specs):
            spec = spec if spec is not None else req_spec
            if spec is None or "_source" not in doc:
                continue
            filtered = filter_source(doc["_source"], spec)
            if filtered is None:
                doc.pop("_source", None)
            else:
                doc["_source"] = filtered
        return 200, {"docs": docs}, {}


def make_app(engine: Engine | None = None, device=None) -> RestApp:
    """A RestApp over `engine`, or over a new Engine on `device` (the CUDA
    card by default; without one it raises unless device="cpu")."""
    return RestApp(engine if engine is not None else Engine(device=device))
