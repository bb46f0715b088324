"""Tenant superpacks: many small indices served from one stacked layout.

The counterpart of the JAX package's `tenancy/superpack.py`. A service
with thousands of small tenant indices cannot afford a device upload and a
dispatch per tenant per request. A `SuperpackManager` packs small tenant
indices into shared stacked device layouts, one per size class (power-of-two
(docs, blocks) buckets, so a 100-doc tenant never rents a 1M-doc tenant's
padding), each lane one tenant, and a serving wave that mixes tenants of a
class runs as one tenant-gather call (`tenancy/kernels.py`) per (size
class, field, k, norms) group. Each tenant's finite rows are byte-equal to
its own index's exact arm.

Lifecycle:
  * a tenant's refresh leaves its lane stale; the refold (tail segments
    major-merged into a fresh base first) rides the serving queue as the
    `_merge` internal tenant (`ServingService.submit_merge`), or runs
    inline through `adopt` / `refold`;
  * a fold builds the new lane on the device before it writes it: a
    failure while staging leaves every lane as it was; the write itself is
    an in-place copy into the lane's slot, ordered on the device's stream
    after every wave launched before it;
  * each lane keeps an epoch that a refold bumps (the request cache,
    not ported, will scope a tenant's entries by it);
  * serving waves claim eligible entries (`wave_claim`) and run them as
    one duck-typed wave job with `EsIndex`'s begin / fetch / finish
    protocol; the fetch is one combined copy to the host.

Eligibility (per claim): one shard, a sealed base with no tail segment and
nothing pending, no dense tier, more than 0 and at most `superpack.max_docs`
documents. The reference also refuses a tenant whose own index would route
the impact arm (`impact_arm_usable`); on an accelerator that refuses every
tenant with terms, and the port routes the impact arm wherever the codes
are resident. So here a member is scored by the exact tenant arm whatever
the planner would pick for its index; with superpacks off the per-index
wave may take the impact arm, within `ops.batched.impact_tie_class` of
these rows. `superpack_enabled` reads the `superpack.enabled` cluster
setting alone.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..index.pack import BLOCK
from .kernels import tenant_term_disjunction

MIN_DOC_CLASS = 128  # smallest n_pad tier
MIN_BLOCK_CLASS = 8  # smallest nb_pad tier
MIN_LANES = 8  # initial lane capacity per class (grows by powers of two)


def _pow2_at_least(x: int, floor: int) -> int:
    v = max(int(x), floor)
    return 1 << (v - 1).bit_length()


def size_class_of(num_docs: int, num_blocks: int) -> tuple[int, int]:
    """Power-of-two (n_pad, nb_pad) bucket of a tenant pack: every member of
    a class shares one device layout."""
    return (_pow2_at_least(num_docs, MIN_DOC_CLASS),
            _pow2_at_least(num_blocks, MIN_BLOCK_CLASS))


def superpack_enabled(settings) -> bool:
    """The `superpack.enabled` cluster setting (False without settings)."""
    if settings is None:
        return False
    return bool(settings.get("superpack.enabled"))


class _Lane:
    """One member tenant's slot in a size-class superpack."""

    __slots__ = ("name", "lane", "ss", "num_docs", "num_blocks", "epoch")

    def __init__(self, name, lane, ss, num_docs, num_blocks, epoch):
        self.name = name
        self.lane = lane
        self.ss = ss  # the member's base ShardSearcher at fold time
        self.num_docs = num_docs
        self.num_blocks = num_blocks
        self.epoch = epoch  # per-lane epoch, bumped by each refold


def _pack_blocks(ss) -> int:
    return int(ss.pack.post_docids.shape[0])


class Superpack:
    """One size class: the lane tensors on the device and the shape keys
    of the tenant-gather calls it served."""

    def __init__(self, key: tuple[int, int], device):
        self.n_pad, self.nb_pad = key
        self.key = key
        self.device = torch.device(device)
        self.capacity = 0
        self.dev: dict[str, torch.Tensor] = {}
        self.lanes: dict[str, _Lane] = {}  # member name -> lane
        self.free: list[int] = []
        # the reference's compiled-program cache keys: (Ts, B, kk, Q tier,
        # has_norms), never a tenant
        self._programs: set = set()
        self.folds = 0
        self.fold_failures = 0

    # ---- layout ----------------------------------------------------------

    def _blank(self, T: int) -> dict[str, torch.Tensor]:
        """T empty lanes: the class sentinel docid n_pad, tf 0, dead."""
        kw = {"device": self.device}
        return {
            "post_docids": torch.full((T, self.nb_pad, BLOCK), self.n_pad, dtype=torch.int32,
                                      **kw),
            "post_tfs": torch.zeros((T, self.nb_pad, BLOCK), dtype=torch.float32, **kw),
            "post_dls": torch.zeros((T, self.nb_pad, BLOCK), dtype=torch.float32, **kw),
            "live": torch.zeros((T, self.n_pad), dtype=torch.bool, **kw),
        }

    def _ensure_capacity(self, want: int) -> None:
        if want <= self.capacity:
            return
        T = _pow2_at_least(want, MIN_LANES)
        dev = self._blank(T)
        for k, arr in self.dev.items():
            dev[k][: self.capacity] = arr
        self.free.extend(range(self.capacity, T))
        self.dev, self.capacity = dev, T

    # ---- fold (adopt / refold) ------------------------------------------

    def stage_lane(self, ss) -> dict[str, torch.Tensor]:
        """One lane's tensors from a member's device pack, built on the
        device beside the class's: the tenant's blocks (its own pad slots
        keep its sentinel docid num_docs, dead in `live`), the class
        sentinel n_pad past them."""
        nb = _pack_blocks(ss)
        n = int(ss.pack.num_docs)
        if nb > self.nb_pad or n > self.n_pad:
            raise ValueError("pack exceeds its size class")
        lane = {k: v[0] for k, v in self._blank(1).items()}
        for k in ("post_docids", "post_tfs", "post_dls"):
            lane[k][:nb] = ss.dev[k].to(self.device)
        lane["live"][:n] = ss.dev["live"][:n].to(self.device)
        return lane

    def fold(self, name: str, ss) -> _Lane:
        """Build and install one tenant's lane. The lane is staged on the
        device before anything is written, so a failure leaves every lane,
        this tenant's old one included, as it was."""
        member = self.lanes.get(name)
        lane = member.lane if member is not None else (
            self.free[-1] if self.free else self.capacity)
        self._ensure_capacity(lane + 1)
        staged = self.stage_lane(ss)
        # ---- commit: copies into the lane's slot, nothing below raises
        for k, v in staged.items():
            self.dev[k][lane].copy_(v)
        if member is None and lane in self.free:
            self.free.remove(lane)
        new = _Lane(name, lane, ss, int(ss.pack.num_docs), _pack_blocks(ss),
                    (member.epoch + 1) if member is not None else 0)
        self.lanes[name] = new
        self.folds += 1
        return new

    def release(self, name: str) -> None:
        """Drop a member: its lane goes dead (live all False) and back on
        the free list; its arrays stay until the slot is leased again."""
        member = self.lanes.pop(name, None)
        if member is None:
            return
        self.dev["live"][member.lane] = False
        self.free.append(member.lane)

    def note_program(self, Ts: int, B: int, kk: int, Q: int, has_norms: bool) -> None:
        self._programs.add((Ts, B, kk, Q, has_norms))

    # ---- accounting ------------------------------------------------------

    def hbm_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self.dev.values()))

    def padded_waste_bytes(self) -> int:
        """Bytes of the layout that hold no member's data: vacant lanes,
        blocks past each member's own, docs past each member's count."""
        if not self.capacity:
            return 0
        per_block = BLOCK * sum(self.dev[k].element_size()
                                for k in ("post_docids", "post_tfs", "post_dls"))
        used_blocks = sum(m.num_blocks for m in self.lanes.values())
        used_docs = sum(m.num_docs for m in self.lanes.values())
        return int((self.capacity * self.nb_pad - used_blocks) * per_block
                   + (self.capacity * self.n_pad - used_docs)
                   * self.dev["live"].element_size())

    def stats(self) -> dict:
        hbm = self.hbm_bytes()
        members = len(self.lanes)
        return {
            "size_class": {"n_pad": self.n_pad, "nb_pad": self.nb_pad},
            "members": members,
            "lanes": self.capacity,
            "hbm_bytes": hbm,
            "hbm_bytes_per_tenant": (hbm // members) if members else 0,
            "padded_waste_bytes": self.padded_waste_bytes(),
            "compiled_programs": len(self._programs),
            "folds": self.folds,
            "fold_failures": self.fold_failures,
        }


class SuperpackManager:
    """Engine-scoped registry of size-class superpacks, and the owner of
    the duck-typed serving-wave job (`search_wave_begin` / `_fetch` /
    `_finish`)."""

    name = "_superpack"
    # search keyword arguments the tenant-gather lane does not serve
    _BLOCKED_KWARGS = ("aggs", "knn", "sort", "search_after", "script_fields", "collapse",
                       "rescore", "suggest", "highlight", "_source", "min_score",
                       "runtime_mappings")

    def __init__(self, engine):
        self.engine = engine
        self.device = engine.device
        self.packs: dict[tuple[int, int], Superpack] = {}
        self._folding: set[str] = set()
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {}

    def enabled(self) -> bool:
        return superpack_enabled(self.engine.settings)

    # ---- membership ------------------------------------------------------

    def member_of(self, name: str) -> _Lane | None:
        for sp in self.packs.values():
            m = sp.lanes.get(name)
            if m is not None:
                return m
        return None

    def _max_docs(self) -> int:
        return int(self.engine.settings.get("superpack.max_docs"))

    def _eligible_searcher(self, ss) -> bool:
        """The member must be exactly the shape the tenant-gather call
        replicates: one shard (a ShardSearcher), no dense tier, more than 0
        and at most superpack.max_docs docs. No impact-arm gate (module
        docstring)."""
        from ..query.executor import ShardSearcher

        if not isinstance(ss, ShardSearcher):
            return False
        n = int(ss.pack.num_docs)
        return (0 < n <= self._max_docs() and ss.pack.dense_tfn is None
                and "dense_tfn" not in ss.dev)

    def _fold_candidate(self, idx) -> bool:
        """Worth scheduling a fold: a refreshed single-shard index that could
        fit (tail segments allowed: the refold merges them)."""
        if (idx._searcher is None or idx._pending or idx._dirty or idx.num_shards != 1
                or len(idx._docs) > self._max_docs()):
            return False
        return any(e.alive for e in idx._docs.values())

    @staticmethod
    def _base_clean(idx) -> bool:
        return (idx._searcher is not None and not idx._pending and not idx._dirty
                and not idx._tails)

    def _member_fresh(self, idx, member: _Lane) -> bool:
        return member.ss is idx._searcher and self._base_clean(idx)

    def adopt(self, idx) -> bool:
        """Inline fold (the engine thread, tests, chip_smoke). The serving
        path's adoption goes through `_schedule_fold` as the `_merge`
        tenant."""
        return self.refold(idx.name)

    def refold(self, name: str) -> bool:
        """(Re)build one tenant's lane from its current base; tail segments
        are major-merged into a fresh base first. A failure leaves the old
        lane and every neighbour as they were. -> whether the tenant is a
        current member."""
        idx = self.engine.indices.get(name)
        if idx is None:
            self.evict(name)
            return False
        if idx._tails and self._fold_candidate(idx):
            idx._merge_tiers()
        if not self._base_clean(idx):
            return False
        ss = idx._searcher
        member = self.member_of(name)
        if member is not None and member.ss is ss:
            return True  # already current
        if not self._eligible_searcher(ss):
            if member is not None:
                self.evict(name)
            return False
        key = size_class_of(int(ss.pack.num_docs), _pack_blocks(ss))
        for k, sp in self.packs.items():
            if k != key and name in sp.lanes:
                sp.release(name)
        pack = self.packs.get(key)
        if pack is None:
            pack = self.packs[key] = Superpack(key, self.device)
        try:
            pack.fold(name, ss)
        except Exception:
            pack.fold_failures += 1
            self.counters["fold_failures"] = self.counters.get("fold_failures", 0) + 1
            raise
        self.counters["folds"] = self.counters.get("folds", 0) + 1
        return True

    def evict(self, name: str) -> None:
        for sp in self.packs.values():
            sp.release(name)

    def _schedule_fold(self, idx) -> None:
        """Queue this tenant's fold as the `_merge` internal tenant: it takes
        a weighted round-robin wave slot on the engine thread."""
        name = idx.name
        with self._lock:
            if name in self._folding:
                return
            self._folding.add(name)
        svc = self.engine.serving_if_enabled()
        fut = None
        if svc is not None:
            from ..serving.queue import ServingRejectedError

            try:
                fut = svc.submit_merge(lambda: self.refold(name), index=name)
            except ServingRejectedError:
                fut = None  # shed: a later claim schedules it again
        if fut is None:
            with self._lock:
                self._folding.discard(name)
            return

        def _done(_f):
            with self._lock:
                self._folding.discard(name)

        fut.add_done_callback(_done)

    # ---- serving-wave claim ----------------------------------------------

    def wave_claim(self, entry: dict) -> bool:
        """Engine thread, in `ServingService._wave_begin`: claim one entry
        for the superpack lane. True only when the member's lane is current
        and the query is a term disjunction; a stale member (or a promising
        non-member) schedules its refold and serves per index this wave."""
        if entry.get("internal") is not None:
            return False
        name = entry.get("index")
        kwargs = entry.get("kwargs")
        if not name or not isinstance(kwargs, dict):
            return False
        idx = self.engine.indices.get(name)
        if idx is None:
            return False
        if any(kwargs.get(k) is not None for k in self._BLOCKED_KWARGS):
            return False
        member = self.member_of(name)
        if member is None or not self._member_fresh(idx, member):
            if member is not None or self._fold_candidate(idx):
                self._schedule_fold(idx)
            return False
        query = kwargs.get("query")
        if not isinstance(query, dict):
            return False
        from ..query.dsl import parse_query
        from ..serving.coalesce import term_disjunction_of
        from ..utils.errors import ElasticsearchTpuError

        try:
            spec = term_disjunction_of(parse_query(query, idx.mappings))
        except ElasticsearchTpuError:
            return False  # the per-index path answers with the error
        if spec is None or not spec[1]:
            return False
        fld, terms = spec
        try:
            size, from_ = int(kwargs.get("size", 10)), int(kwargs.get("from_", 0))
        except (TypeError, ValueError):
            return False
        tth = kwargs.get("track_total_hits")
        entry["_superpack"] = {"idx": idx, "member": member, "fld": fld, "terms": terms,
                               "k": max(size + from_, 1), "size": size, "from_": from_,
                               "tth": 10_000 if tth is None else tth}
        return True

    # ---- the wave job ----------------------------------------------------

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _plan_group(self, pack: Superpack, fld: str, k: int, has_norms: bool,
                    plans: list) -> dict:
        """Pad a group's per-member plans to one (Q tier, Ts, B) shape and
        launch the tenant-gather call. plans: (pos, BatchPlan, lane,
        avgdl). -> the group's pending state."""
        from ..ops.batched import BatchTermSearcher

        Ts = max(pl.sparse_rows.shape[1] for _, pl, _, _ in plans)
        B = max(pl.sparse_rows.shape[2] for _, pl, _, _ in plans)
        Qc = len(plans)
        Qt = BatchTermSearcher.wave_q_tier(Qc)
        kk = min(max(k, 1), pack.n_pad)
        rows = np.zeros((Qt, Ts, B), np.int32)
        ws = np.zeros((Qt, Ts), np.float32)
        tids = np.zeros((Qt,), np.int32)
        avgdls = np.ones((Qt,), np.float32)
        for qi, (_pos, pl, lane, avgdl) in enumerate(plans):
            sr = pl.sparse_rows[0]
            rows[qi, : sr.shape[0], : sr.shape[1]] = sr
            ws[qi, : pl.sparse_weights.shape[1]] = pl.sparse_weights[0]
            tids[qi] = lane
            avgdls[qi] = avgdl
        pack.note_program(Ts, B, kk, Qt, has_norms)
        outs = tenant_term_disjunction(pack.dev, kk, self._put(rows), self._put(ws),
                                       self._put(tids), self._put(avgdls), pack.n_pad,
                                       has_norms=has_norms)
        fields = dict(tier="superpack", shards=1, tenants=len({p[2] for p in plans}),
                      queries=Qt, k=kk, num_docs=pack.n_pad, rows=int(rows.size))
        return {"pending": outs, "host": None, "fields": fields, "Qc": Qc, "Qt": Qt, "kk": kk,
                "plans": [(pos, lane) for pos, _pl, lane, _a in plans]}

    @staticmethod
    def _avgdl(ss, fld: str) -> np.float32:
        """The f32 avgdl the member's own arm divides by (`ctx.avgdl`, made
        from the same host value), read on the host; 1 without norms."""
        return np.float32(ss.view.avgdl(fld)) if fld in ss.ctx.has_norms else np.float32(1.0)

    def _member_plan(self, member: _Lane, fld: str, terms, k: int):
        """The member's own exact-arm plan and its f32 avgdl: the per-index
        weights and block rows of `BatchTermSearcher.plan`."""
        from ..ops.batched import BatchTermSearcher

        return BatchTermSearcher(member.ss).plan(fld, [terms], k), self._avgdl(member.ss, fld)

    def search_wave_begin(self, entries: list[dict]) -> dict:
        """One wave job over claimed entries of many member indices: one
        tenant-gather call per (size class, field, k, has_norms) group,
        launched here; `search_wave_fetch` copies every group's outputs in
        one copy."""
        n = len(entries)
        job = {"entries": entries, "slots": [None] * n, "groups": [], "index_names": [],
               "t0": time.monotonic(),
               "meta": {"wave_size": n, "term_packed": 0, "term_waves": [],
                        "fallback_solo": 0, "tiered_packed": 0}}
        groups: dict[tuple, dict] = {}
        for i, entry in enumerate(entries):
            ctx = entry.pop("_superpack", None)
            if ctx is None:
                job["slots"][i] = ("error", RuntimeError("superpack wave entry lost its claim"))
                continue
            idx, member = ctx["idx"], ctx["member"]
            if idx.name not in job["index_names"]:
                job["index_names"].append(idx.name)
            idx.counters["query_total"] = idx.counters.get("query_total", 0) + 1
            pack = self.packs[size_class_of(member.num_docs, member.num_blocks)]
            has_norms = ctx["fld"] in member.ss.ctx.has_norms
            gkey = (pack.key, ctx["fld"], ctx["k"], has_norms)
            g = groups.setdefault(gkey, {"pack": pack, "fld": ctx["fld"], "k": ctx["k"],
                                         "has_norms": has_norms, "members": [],
                                         "st": None, "rows": {}})
            # the doc table captured now: a later refresh must not swap it
            g["members"].append({"i": i, "ctx": ctx, "shard_docs": idx.shard_docs[0]})
        for g in groups.values():
            plans = []
            for pos, m in enumerate(g["members"]):
                member = m["ctx"]["member"]
                pl, avgdl = self._member_plan(member, g["fld"], m["ctx"]["terms"], g["k"])
                plans.append((pos, pl, member.lane, avgdl))
            g["st"] = self._plan_group(g["pack"], g["fld"], g["k"], g["has_norms"], plans)
        job["groups"] = list(groups.values())
        return job

    def search_wave_fetch(self, job: dict) -> None:
        """One combined device-to-host copy of every group's outputs (no
        engine state: the serving completer thread runs it)."""
        from ..ops.batched import fetch

        pend = [g["st"] for g in job["groups"] if g["st"]["host"] is None]
        if not pend:
            return
        for st, host in zip(pend, fetch([[st["pending"]] for st in pend])):
            st["host"] = host

    def search_wave_finish(self, job: dict) -> list:
        """Per-entry responses, in entry order, built as the per-index term
        lane builds them (`EsIndex._term_hits`)."""
        self.search_wave_fetch(job)
        for g in job["groups"]:
            st, k = g["st"], g["k"]
            cv, ci, ct = st["host"]
            for qi, (pos, _lane) in enumerate(st["plans"]):
                g["rows"][pos] = (cv[qi], ci[qi], int(ct[qi]))
            job["meta"]["term_waves"].append((st["Qc"], int(st["Qt"])))
            job["meta"]["term_packed"] += len(g["members"])
            took_ms = (time.monotonic() - job["t0"]) * 1000
            for pos, m in enumerate(g["members"]):
                ctx = m["ctx"]
                rv, ri, rt = g["rows"][pos]
                nvalid = int(np.isfinite(rv).sum())
                take = list(range(min(nvalid, k)))[ctx["from_"]: ctx["size"] + ctx["from_"]]
                hits = []
                for j in take:
                    doc_id, src = m["shard_docs"][int(ri[j])]
                    hits.append({"_index": ctx["idx"].name, "_id": doc_id,
                                 "_score": float(rv[j]), "_source": src})
                hits_obj = {"total": {"value": rt, "relation": "eq"},
                            "max_score": float(rv[0]) if nvalid else None, "hits": hits}
                if ctx["tth"] is False:
                    del hits_obj["total"]
                job["slots"][m["i"]] = ("resp", {"hits": hits_obj})
                idx = ctx["idx"]
                idx.counters["query_time_ms"] = (idx.counters.get("query_time_ms", 0)
                                                 + int(took_ms))
        return [payload for _kind, payload in job["slots"]]

    # ---- the solo route (tests, chip_smoke) ------------------------------

    def msearch(self, name: str, fld: str, queries: list, k: int = 10):
        """The tenant-gather call for one member's batch. -> (scores [Q, kk],
        shard zeros [Q, kk], docids [Q, kk], totals [Q]) numpy, the output
        of `EsIndex`'s term lane."""
        from ..ops.batched import BatchTermSearcher, fetch
        from ..telemetry import time_kernel

        member = self.member_of(name)
        if member is None:
            raise KeyError(f"[{name}] is not a superpack member")
        pack = self.packs[size_class_of(member.num_docs, member.num_blocks)]
        ss = member.ss
        pl = BatchTermSearcher(ss).plan(fld, queries, k)
        Q = len(queries)
        kk = min(max(k, 1), pack.n_pad)
        has_norms = fld in ss.ctx.has_norms
        avgdl = self._avgdl(ss, fld)
        Ts, B = pl.sparse_rows.shape[1], pl.sparse_rows.shape[2]
        pack.note_program(Ts, B, kk, Q, has_norms)
        fields = dict(tier="superpack", shards=1, tenants=1, queries=Q, k=kk,
                      num_docs=pack.n_pad, rows=int(pl.sparse_rows.size))
        with time_kernel("superpack.tenant_gather", self.device, **fields):
            outs = tenant_term_disjunction(
                pack.dev, kk, self._put(pl.sparse_rows), self._put(pl.sparse_weights),
                self._put(np.full((Q,), member.lane, np.int32)),
                self._put(np.full((Q,), avgdl, np.float32)), pack.n_pad, has_norms=has_norms)
            v, i, t = fetch([[outs]])[0]
        return v, np.zeros(i.shape, np.int32), i, t

    # ---- accounting ------------------------------------------------------

    def compiled_program_count(self) -> int:
        """Distinct tenant-gather shape keys (Ts, B, kk, Q tier, has_norms)
        over every size class: the reference's compiled programs, which
        grow with the size classes and the wave tiers, not the tenants."""
        return sum(len(sp._programs) for sp in self.packs.values())

    def member_count(self) -> int:
        return sum(len(sp.lanes) for sp in self.packs.values())

    def hbm_bytes(self) -> int:
        return sum(sp.hbm_bytes() for sp in self.packs.values())

    def padded_waste_bytes(self) -> int:
        return sum(sp.padded_waste_bytes() for sp in self.packs.values())

    def member_names(self) -> list[str]:
        return [name for sp in self.packs.values() for name in sp.lanes]

    def member_stats(self, name: str) -> dict | None:
        """One member's size class, lane and share of its class's bytes."""
        for sp in self.packs.values():
            m = sp.lanes.get(name)
            if m is not None:
                return {"size_class": f"{sp.n_pad}x{sp.nb_pad}", "lane": m.lane,
                        "epoch": m.epoch,
                        "hbm_bytes_per_tenant": sp.hbm_bytes() // max(len(sp.lanes), 1)}
        return None

    def stats(self) -> dict:
        classes = {f"{k[0]}x{k[1]}": sp.stats() for k, sp in sorted(self.packs.items())}
        members = self.member_count()
        hbm = self.hbm_bytes()
        waste = self.padded_waste_bytes()
        return {
            "enabled": self.enabled(),
            "members": members,
            "size_classes": len(self.packs),
            "compiled_programs": self.compiled_program_count(),
            "hbm_bytes": hbm,
            "hbm_bytes_per_tenant": (hbm // members) if members else 0,
            "padded_waste_bytes": waste,
            "padded_waste_pct": round(100.0 * waste / hbm, 3) if hbm else 0.0,
            "folds": self.counters.get("folds", 0),
            "fold_failures": self.counters.get("fold_failures", 0),
            "classes": classes,
        }
