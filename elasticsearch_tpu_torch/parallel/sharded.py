"""Multi-shard search on one device: `StackedSearcher` and sharded `_msearch`.

The counterpart of the JAX package's `parallel/sharded.py` on one device
(its `mesh=None` route). The reference runs one per-shard body under
`vmap` over the stacked [S, ...] pack, then merges the per-shard rows in
Lucene's TopDocs.merge order (score desc, shard asc, doc asc; reference
behavior: SearchPhaseController.java:232). PyTorch runs eagerly, so the
port runs the same per-shard body in a loop over the shards, each on its
shard's slice of the stacked tensors, and merges on the device
(`spmd.merge_topk_rows`).

  - `_search`: each shard's `(scores, match)` from the query nodes, planned
    against the shard's `_ShardView` (global statistics), then one
    streamed `scan_topk` over the S·n_max lanes
    (`ops.scoring.top_k_with_total_stacked`). A kNN node plans once per
    request (shard 0's view) and runs its probe and `ann_gather_scan` on
    each shard's own tiles, then its k-th value (`scan_topk`) per shard.
  - `_msearch` (`msearch_sharded`): per-shard partials from one arm, which
    the execution planner picks (site "sharded.msearch_partials") among
    those that serve, in the reference's order (a cold planner takes the
    first): fused (0 < k <= 16 on a pack with a dense tier: one
    `fused_tile_candidates` launch per (shard, chunk), any query flagged by
    a shard re-run on the exact partials), impact (the code blocks gathered
    and scaled by `impact_gather`, every candidate kept), exact; then the
    merge.

Scoring uses global statistics only (dfs_query_then_fetch): idf from the
global df, avgdl from the summed field statistics, the dense tier chosen by
global df. The dense tier's tfn rows and the impact codes are derived on
the device from the global avgdl, in the reference's f32 operations
(`refresh_dense_tfn`, `refresh_impacts`); the raw tf rows are not kept.
As one tier of a tiered index, the searcher scores under the statistics
combined over every tier (`set_stats_override` re-derives both on the
device), and `update_live` ships the live bits that later writes cleared.

Aggregations (`_search` with `aggs`): each shard evaluates the agg trees
under its match & live mask with `ctx.sharded` (mergeable partials: the
cardinality bitmaps, the percentiles' sorted values, the exact long sums'
halves), the partials stack on a leading shard axis, ride the request's
one copy back, and merge on the host (`AggNode.merge_partials`, the
`sum_exact` rule in Python ints). Keyword and int columns carry global
ordinals (`StackedPack`), so per-shard buckets line up.

Field-sorted search (`search_sorted`, reference `sharded.py:1512`) sorts
every shard's candidates together on shard-major lanes, so full-key ties
order by (shard, docid); keyword keys are the stacked global ordinals.
`search_collapse` (`:668`) keeps the best hit per field value, a group's
winner the lowest shard among its maxima (`query.executor.collapse_top`);
`scores_at` (`:706`) evaluates a rescore query at given (shard, docid) hits.

No mesh and no torch.distributed: every shard lives on the searcher's one
device. WAND and the request cache are not ported.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ann import ann_to_device
from ..index.device_build import CODE_DTYPES, impact_codes_device
from ..monitoring.refresh_profile import build_stage, refresh_stage
from ..ops import fused as F
from ..ops.batched import (BatchTermSearcher, batch_term_disjunction, fetch, pack_outputs,
                           unpack_outputs)
from ..ops.kernels import split_bf16
from ..aggs.nodes import flatten_outputs, stack_outputs, unflatten_outputs
from ..ops.scoring import bm25_idf, top_k_with_total_stacked
from ..query.dsl import parse_query
from ..script.runtime import RuntimeFieldHost
from ..query.executor import (collapse_groups, collapse_keys, collapse_top, eval_aggs,
                              prepare_aggs, select_sorted)
from ..query.nodes import ExecContext, QueryNode, mark_exact
from ..query.sort import SortPlan
from ..telemetry import profile_event, time_kernel
from ..utils.torch_env import resolve_device
from .spmd import merge_topk_rows
from .stacked import StackedPack

# the per-shard [S, ...] arrays of a stacked ANN index
_ANN_ARRAYS = ("centroids", "order", "codes", "scale", "offset")


def stacked_to_device(sp: StackedPack, device) -> dict:
    """Upload the stacked [S, ...] host arrays under the leaf names of
    `query.executor.pack_to_device`: postings, norms, text presence,
    docvalues (keyword ordinals widened to int64; an int column's global
    ordinals `dv_int_ord` and a keyword's multi-value pairs `dv_mv`), live
    docs, the vector
    fields (values, presence, and squared norms summed on the host in f32,
    as the one-shard upload sums them) and the position keys. The scored dense tier, the impact
    codes and each shard's ANN tiles (`StackedSearcher`) are made on the
    device by the searcher."""
    device = torch.device(device)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dev = {
        "post_docids": put(sp.post_docids),
        "post_tfs": put(sp.post_tfs),
        "post_dls": put(sp.post_dls),
        "norms": {f: put(a) for f, a in sp.norms.items()},
        "text_has": {f: put(a) for f, a in sp.text_present.items()},
        "dv_int": {},
        "dv_float": {},
        "dv_ord": {},
        "dv_int_ord": {},
        "dv_mv": {},
        "live": put(sp.live),
        "vec": {},
        "vec_has": {},
        "vec_sq": {},
    }
    for f, col in sp.global_docvalues.items():
        key = {"int": "dv_int", "float": "dv_float", "ord": "dv_ord"}[col.kind]
        vals = col.values if col.kind != "ord" else col.values.astype(np.int64)
        dev[key][f] = (put(vals), put(col.has_value))
        if col.uniq_ords is not None:
            dev["dv_int_ord"][f] = put(col.uniq_ords)
        if col.mv_pair_docs is not None:
            dev["dv_mv"][f] = (put(col.mv_pair_docs), put(col.mv_pair_ords))
    for f, vc in sp.vectors.items():
        dev["vec"][f] = put(vc.values)
        dev["vec_has"][f] = put(vc.has_value)
        dev["vec_sq"][f] = put((vc.values * vc.values).sum(axis=-1).astype(np.float32))
    if sp.pos_keys is not None:
        dev["pos_keys"] = put(sp.pos_keys)
    return dev


@dataclass
class StackedResult:
    doc_shards: np.ndarray  # [<=size] int32 shard of each hit
    doc_ids: np.ndarray  # [<=size] int32 docid within its shard
    scores: np.ndarray  # [<=size] float32
    total: int
    max_score: float | None
    aggregations: dict | None = None
    collapse_keys: list | None = None  # a collapsed search's field value per hit


class StackedSearcher(RuntimeFieldHost):
    """Multi-shard searcher over one device-resident stacked pack, scoring
    with global term statistics (the reference's dfs_query_then_fetch,
    search/dfs/DfsPhase.java)."""

    def __init__(self, stacked: StackedPack, device=None):
        self.device = resolve_device(device)
        self.sp = stacked
        self.dev = stacked_to_device(stacked, self.device)
        self.ctx = ExecContext(
            num_docs=stacked.n_max,
            avgdl=self._ctx_avgdl(),
            has_norms=frozenset(stacked.norms),
            device=self.device,
            sharded=True,
        )
        self._views = [stacked.shard_view(s) for s in range(stacked.S)]
        self._fused: _FusedShardedMsearch | None = None
        # arms, queries, escalations and host planning time of the last
        # msearch_sharded call
        self.last_stats: dict = {}
        self.refresh_dense_tfn()
        self.refresh_impacts()
        # each shard's ANN tiles, uploaded once: its slice of the padded
        # stacked index, with the split-bf16 pair and slot norms derived
        # from that shard's resident vectors
        self._shard_anns = [
            {f: ann_to_device({k: (a[k][s] if k in _ANN_ARRAYS else a[k]) for k in a},
                              self.dev["vec"][f][s], self.device)
             for f, vc in stacked.vectors.items() if (a := vc.ann) is not None}
            for s in range(stacked.S)]
        self._shard_devs = [self._shard_dev(s) for s in range(stacked.S)]

    def _avgdl(self, fld: str) -> float:
        st = self.sp.eff_field_stats.get(fld)
        if not st or st["doc_count"] == 0:
            return 1.0
        return st["sum_dl"] / st["doc_count"]

    def _ctx_avgdl(self) -> dict:
        """Each normed field's effective avgdl as the f32 scalar the
        postings path reads."""
        return {f: torch.tensor(np.float32(self._avgdl(f)), device=self.device)
                for f in self.sp.norms}

    # ---- tiered refresh: live flips and statistics drift -------------------

    @property
    def dead_count(self) -> int:
        return self.sp.dead_count

    def live_host(self, s: int) -> np.ndarray:
        """Shard s's host live bits."""
        return self.sp.live[s]

    def mark_dead(self, s: int, d: int) -> bool:
        """Clear doc (s, d)'s live bit on the host (`update_live` ships it).
        -> whether it was live."""
        sp = self.sp
        if not sp.live[s, d]:
            return False
        sp.shards[s].live[d] = False
        sp.live[s, d] = False
        sp.dead_count += 1
        return True

    def update_live(self) -> None:
        """Re-ship the host live bits to dev["live"] after `mark_dead` flips
        (the reference's `update_live`), in place: the per-shard views and
        the arms' cached references see the new bits."""
        self.dev["live"].copy_(torch.from_numpy(self.sp.live))

    def set_stats_override(self, override: dict | None) -> None:
        """Score under new effective statistics: install them on the pack
        and re-derive what bakes avgdl (the postings path's f32 avgdl, the
        dense tier's tfn rows and the impact codes), one device pass each,
        with no host rebuild. The fused arm's split-bf16 copies of the old
        tier are dropped."""
        self.sp.stats_override = override
        self.ctx.avgdl = self._ctx_avgdl()
        self._fused = None
        self.refresh_dense_tfn()
        self.refresh_impacts()
        self._shard_devs = [self._shard_dev(s) for s in range(self.sp.S)]

    def _shard_dev(self, s: int) -> dict:
        """Shard s's slice of every stacked leaf (views, no copies): the
        `dev` dict a single-shard body reads."""
        def pick(x):
            if isinstance(x, torch.Tensor):
                return x[s]
            if isinstance(x, tuple):
                return tuple(pick(y) for y in x)
            return {k: pick(v) for k, v in x.items()}

        out = {k: pick(v) for k, v in self.dev.items()}
        out["vec_ann"] = self._shard_anns[s]
        return out

    def shard_dev(self, s: int) -> dict:
        return self._shard_devs[s]

    def refresh_dense_tfn(self) -> None:
        """Derive the scored dense tier dev["dense_tfn"] [S, V, n_max] on the
        device from each shard's raw tf postings, its norms and the effective
        avgdl, in the reference's f32 operations: tf / (tf + K), K = k1 *
        (1 - b + b * norm / avgdl) per field (k1 alone without norms). One
        shard at a time; the raw tf rows are not kept."""
        if not self.sp.dense_v:
            return
        with refresh_stage("dense_tier", self.device, basis="device"):
            self._derive_dense_tfn()

    def _derive_dense_tfn(self) -> None:
        sp = self.sp
        V = sp.dense_v
        k1, b = self.ctx.k1, self.ctx.b
        slices, v0 = [], 0
        for fld, group in itertools.groupby(sp.dense_fields):
            c = sum(1 for _ in group)
            avgdl = torch.tensor(np.float32(max(self._avgdl(fld), 1e-9)), device=self.device)
            slices.append((fld, v0, v0 + c, fld in sp.norms, avgdl))
            v0 += c
        tier = torch.zeros((sp.S, V, sp.n_max), dtype=torch.float32, device=self.device)
        for s in range(sp.S):
            rows, docs, tfs = (torch.from_numpy(a).to(self.device) for a in sp.dense_parts(s))
            tf = tier[s]
            tf[rows.long(), docs.long()] = tfs
            del rows, docs, tfs
            for fld, a, c, has_norms, avgdl in slices:
                tfa = tf[a:c]
                if has_norms:
                    K = k1 * (1.0 - b + b * self.dev["norms"][fld][s] / avgdl)
                    den = tfa + K[None, :]
                else:
                    den = tfa + k1
                tfa.div_(den)
                del den
        self.dev["dense_tfn"] = tier

    def refresh_impacts(self) -> None:
        """Derive the stacked impact code blocks dev["impact_codes"] from the
        resident postings and the effective avgdl (the reference's
        `refresh_impacts`), and record the statistics they derive from as
        the pack's impact basis (`StackedPack.impact_serving`)."""
        sp = self.sp
        meta = sp.impact_meta
        if meta is None:
            return
        if (self.ctx.k1, self.ctx.b) != (meta["k1"], meta["b"]):
            return
        with build_stage("build.impact_quantize", self.device, rows=sp.S * sp.nb_max,
                         code_bytes=2 if meta["dtype"] == "uint16" else 1, basis="device"):
            self._derive_impacts()

    def _derive_impacts(self) -> None:
        sp = self.sp
        meta = sp.impact_meta
        k_base, k_slope = self.impact_row_params()
        codes = torch.empty((sp.S, sp.nb_max, sp.post_docids.shape[2]),
                            dtype=CODE_DTYPES[meta["dtype"]], device=self.device)
        for s in range(sp.S):  # one shard at a time bounds the temporaries
            codes[s] = impact_codes_device(
                self.dev["post_tfs"][s], self.dev["post_dls"][s],
                torch.from_numpy(k_base[s]).to(self.device),
                torch.from_numpy(k_slope[s]).to(self.device),
                torch.from_numpy(sp.impact_row_scale_inv[s]).to(self.device),
                qmax=meta["qmax"], dtype=meta["dtype"])
        self.dev["impact_codes"] = codes
        sp._impact_basis = sp.stats_override

    def impact_row_params(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (k_base, k_slope) [S, nb_max] f32: each postings row's length
        norm K(dl) = k_base + k_slope·dl from the effective avgdl of its field
        (k1 alone for a field without norms or a padding row)."""
        sp = self.sp
        meta = sp.impact_meta
        fields = sp.impact_fields
        fld_avgdl = np.array([max(self._avgdl(f), 1e-9) for f in fields] or [1.0], np.float64)
        fld_hn = np.array([f in sp.norms for f in fields] or [False])
        rf = sp.impact_row_field  # [S, nb_max]
        safe = np.maximum(rf, 0)
        hn = fld_hn[safe] & (rf >= 0)
        k1, b = meta["k1"], meta["b"]
        k_base = np.where(hn, k1 * (1.0 - b), k1).astype(np.float32)
        k_slope = np.where(hn, k1 * b / fld_avgdl[safe], 0.0).astype(np.float32)
        return k_base, k_slope

    # ---- _search ---------------------------------------------------------

    def search(self, query: dict | QueryNode | None, size: int = 10, from_: int = 0,
               mappings=None, aggs: dict | None = None) -> StackedResult:
        return self.search_batch([dict(query=query, size=size, from_=from_,
                                       mappings=mappings, aggs=aggs)])[0]

    def search_batch(self, requests: list[dict]) -> list[StackedResult]:
        """Several `search` requests: every request is planned and launched
        before any result is copied back, then all come back in one copy.
        Each request dict: query, size, from_, mappings, aggs."""
        state = self.search_many_begin(requests)
        self.search_many_fetch(state)
        return self.search_many_finish(state)

    def search_many_begin(self, requests: list[dict]) -> dict:
        """Plan and launch every request, copying nothing back (the serving
        wave's generic lane). -> a state for `search_many_fetch` (the one
        device-to-host copy) and `search_many_finish`."""
        states = [self._agg_dispatch(**r) for r in requests]
        words, layout = pack_outputs([[s["outs"]] for s in states if s["outs"] is not None])
        return {"states": states, "words": words, "layout": layout, "host": None}

    @staticmethod
    def search_many_fetch(state: dict) -> None:
        if state["words"] is not None:
            state["host"] = state["words"].cpu().numpy()

    def search_many_finish(self, state: dict) -> list[StackedResult]:
        host = iter(unpack_outputs(state["host"], state["layout"]))
        return [self._agg_finalize(s, next(host) if s["outs"] is not None else None)
                for s in state["states"]]

    def _agg_dispatch(self, query=None, size: int = 10, from_: int = 0, mappings=None,
                      aggs: dict | None = None) -> dict:
        """Plan and launch one request (no copy back): each shard's
        (scores, match) planned against its view, then the global top k; with
        aggs, each shard's agg partials (`ctx.sharded`: bitmaps, sorted
        arrays, exact long halves) under its match & live mask, stacked on a
        leading shard axis for the host merge (the reference's vmapped
        body)."""
        m = mappings if mappings is not None else self.sp.mappings
        node = query if isinstance(query, QueryNode) else parse_query(query, m)
        agg_nodes = None
        if aggs:
            from ..aggs import parse_aggs

            agg_nodes = parse_aggs(aggs, m)
        state = {"size": size, "from_": from_, "outs": None, "aggs": agg_nodes}
        sp = self.sp
        if sp.n_max == 0:
            return state
        scores, match, agg_parts, keep = [], [], [], []
        for s, view in enumerate(self._views):
            sc, mt = node.device_eval(self._shard_devs[s], node.prepare(view), self.ctx)
            scores.append(sc)
            match.append(mt)
            if agg_nodes:
                # every shard plans against the global docvalues (the same
                # plan); a filter agg's query params are the shard's own
                params = {name: a.prepare(view, m)[0] for name, a in agg_nodes.items()}
                out, kept = eval_aggs(agg_nodes, params, self._shard_devs[s], sc, mt, self.ctx)
                agg_parts.append(out)
                keep.append((params, kept))
        if agg_nodes:
            from ..aggs import two_pass_plan

            # a nested two-pass terms agg is refused here; the match sets
            # are kept for a second pass only
            if not two_pass_plan(agg_nodes):
                keep = None
        k = min(max(size + from_, 1), sp.n_max * sp.S)
        v, sh, d, total = top_k_with_total_stacked(torch.stack(scores), torch.stack(match),
                                                   self.dev["live"], k)
        leaves = []
        if agg_nodes:
            leaves, state["spec"] = flatten_outputs(stack_outputs(agg_parts))
            state["keep"] = keep
        state["outs"] = (v, sh, d, total.reshape(1), *leaves)
        return state

    def _agg_finalize(self, state: dict, host) -> StackedResult:
        agg_nodes = state["aggs"]
        if host is None:
            return StackedResult(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                 np.zeros(0, np.float32), 0, None, {} if agg_nodes else None)
        v, sh, d, total, *agg_leaves = host
        aggregations = None
        if agg_nodes:
            aggregations = self._merge_aggs(state, agg_leaves)
        size, from_ = state["size"], state["from_"]
        valid = np.isfinite(v)
        max_score = float(v[0]) if valid.any() else None
        end = max(size + from_, 0)
        return StackedResult(sh[valid][from_:end].astype(np.int32),
                             d[valid][from_:end].astype(np.int32),
                             v[valid][from_:end].astype(np.float32),
                             int(total[0]), max_score, aggregations)

    def _merge_aggs(self, state: dict, leaves: list) -> dict:
        """The coordinator reduce: merge the stacked partials on the host
        (`merge_partials`); a two-pass agg selects its candidates from the
        GLOBAL merged counts (exact, unlike the reference's shard_size
        approximation), runs pass 2 on every shard and merges that too (the
        reference's `_agg_pass2_dispatch` / `_agg_finalize`)."""
        from ..aggs import two_pass_plan

        agg_nodes = state["aggs"]
        stacked = unflatten_outputs(state["spec"], leaves)
        merged = {name: a.merge_partials(stacked[name]) for name, a in agg_nodes.items()}
        tp = two_pass_plan(agg_nodes)
        if tp:
            parts = []
            cands = {name: torch.from_numpy(a.select_candidates(merged[name])).to(self.device)
                     for name, a in tp.items()}
            for s, (params, (dev_a, seg, ok)) in enumerate(state["keep"]):
                parts.append({name: a.device_eval_segmented(
                    dev_a, {**params[name], "cand": cands[name]}, seg, 1, ok, self.ctx)
                    for name, a in tp.items()})
            leaves2, spec2 = flatten_outputs(stack_outputs(parts))
            words, layout = pack_outputs([[tuple(leaves2)]])
            host2 = unpack_outputs(words.cpu().numpy(), layout)[0] if leaves2 else ()
            stacked2 = unflatten_outputs(spec2, host2)
            for name, a in tp.items():
                merged[name].update(a.merge_partials(stacked2[name]))
        return {name: a.finalize(merged[name], 1)[0] for name, a in agg_nodes.items()}

    # ---- field sort, collapse and rescore ----------------------------------

    def _shard_parts(self, node) -> list:
        """Each shard's (dev, scores [N+1], match [N+1], ok [N]) for `node`,
        planned against the shard's view."""
        n = self.sp.n_max
        parts = []
        for s, view in enumerate(self._views):
            dev = self._shard_devs[s]
            sc, mt = node.device_eval(dev, node.prepare(view), self.ctx)
            parts.append((dev, sc, mt, mt[:n] & dev["live"]))
        return parts

    def search_sorted(self, query, sort_fields, size: int = 10, from_: int = 0,
                      search_after=None, aggs: dict | None = None, mappings=None):
        """Field-sorted `_search` over every shard -> (hits [(shard, docid,
        sort values)], total, aggregations); aggs ride beside the sort in
        one pass, their partials merged as `_merge_aggs` merges them."""
        m = mappings if mappings is not None else self.sp.mappings
        node = query if isinstance(query, QueryNode) else parse_query(query, m)
        views = self._views
        agg_nodes, _ = prepare_aggs(aggs, m, views[0], single_pass=True)
        plan = SortPlan(sort_fields, views[0], m)
        sp = self.sp
        n = sp.n_max
        if n == 0:
            return [], 0, ({} if aggs else None)
        after = plan.after_keys(search_after, sp) if search_after is not None else None
        k = min(max(size + from_, 1), n * sp.S)
        parts = self._shard_parts(node)
        lanes, keys_s = select_sorted(plan, [(d, sc, ok) for d, sc, _mt, ok in parts], n, after, k)
        total = sum(ok.sum(dtype=torch.int32) for *_x, ok in parts).reshape(1)
        leaves, state = [], {"aggs": agg_nodes}
        if agg_nodes:
            outs = []
            for s, (dev, sc, mt, _ok) in enumerate(parts):
                params = {name: a.prepare(views[s], m)[0] for name, a in agg_nodes.items()}
                outs.append(eval_aggs(agg_nodes, params, dev, sc, mt, self.ctx)[0])
            leaves, state["spec"] = flatten_outputs(stack_outputs(outs))
        lanes, total, *rest = fetch([[(lanes, total, *keys_s, *leaves)]])[0]
        aggregations = self._merge_aggs(state, rest[len(keys_s):]) if agg_nodes else None
        take = list(range(len(lanes)))[from_: size + from_]
        values = plan.hit_values(rest[: len(keys_s)], take)
        hits = [(int(lanes[i] // n), int(lanes[i] % n), v) for i, v in zip(take, values)]
        return hits, int(total[0]), aggregations

    def search_collapse(self, query, fld: str, size: int = 10, from_: int = 0) -> StackedResult:
        """The best hit per value of `fld` over every shard (groups are the
        global ordinals, `collapse_top`) -> a StackedResult with
        `collapse_keys`."""
        node = query if isinstance(query, QueryNode) else parse_query(query, self.sp.mappings)
        col = self.sp.global_docvalues.get(fld)
        V = collapse_groups(col)
        if self.sp.n_max == 0:
            return StackedResult(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                 np.zeros(0, np.float32), 0, None, collapse_keys=[])
        parts = [(d, sc, ok) for d, sc, _mt, ok in self._shard_parts(node)]
        out = collapse_top(parts, fld, V, max(size + from_, 1))
        top_s, top_sh, top_d, top_g, total = fetch([[(*out[:4], out[4].reshape(1))]])[0]
        valid = np.isfinite(top_s)
        end = max(size + from_, 0)
        return StackedResult(top_sh[valid][from_:end].astype(np.int32),
                             top_d[valid][from_:end].astype(np.int32),
                             top_s[valid][from_:end].astype(np.float32), int(total[0]),
                             float(top_s[0]) if valid.any() else None,
                             collapse_keys=collapse_keys(col, top_g[valid], V)[from_:end])

    def scores_at(self, query, doc_shards: np.ndarray, doc_ids: np.ndarray):
        """A query's scores at given (shard, docid) hits (the rescore
        gather), in exact BM25. -> (scores [m] f32, 0 where the hit does not
        match; match [m] bool)."""
        node = query if isinstance(query, QueryNode) else parse_query(query, self.sp.mappings)
        mark_exact(node)
        n = self.sp.n_max
        parts = self._shard_parts(node)
        scores = torch.stack([sc[:n] for _d, sc, _mt, _ok in parts])
        ok = torch.stack([o for *_x, o in parts])
        sh = torch.from_numpy(np.asarray(doc_shards, np.int64)).to(self.device)
        di = torch.from_numpy(np.asarray(doc_ids, np.int64)).to(self.device)
        hit = ok[sh, di]
        s = torch.where(hit, scores[sh, di], torch.zeros((), device=self.device))
        s, hit = fetch([[(s, hit)]])[0]
        return s, hit

    # ---- runtime fields (script/runtime.RuntimeFieldHost) --------------------

    @property
    def runtime_mappings(self):
        return self.sp.mappings

    @runtime_mappings.setter
    def runtime_mappings(self, m) -> None:
        self.sp.mappings = m

    def _runtime_mapped(self, name: str) -> bool:
        return name in self.sp.global_docvalues

    def _runtime_build(self, compiled, kind: str) -> dict:
        from ..script.runtime import host_column, runtime_values

        S, n_max = self.sp.S, self.sp.n_max
        vals = torch.zeros((S, n_max), dtype=torch.int64 if kind == "int" else torch.float32,
                           device=self.device)
        has = torch.zeros((S, n_max), dtype=torch.bool, device=self.device)
        for s, p in enumerate(self.sp.shards):
            n = p.num_docs
            if n == 0:
                continue
            dev_s = self._shard_devs[s]
            vals[s, :n], has[s, :n] = runtime_values(
                compiled, kind, lambda f: dev_s["dv_float"].get(f) or dev_s["dv_int"].get(f),
                n, self.device)
        col = host_column(kind, vals.cpu().numpy(), has.cpu().numpy())
        dev = {("dv_int" if kind == "int" else "dv_float"): (vals, has)}
        if col.uniq_ords is not None:
            dev["dv_int_ord"] = torch.from_numpy(col.uniq_ords).to(self.device)
        return {"col": col, "dev": dev}

    def _runtime_install(self, name: str, art: dict) -> None:
        self.sp.global_docvalues[name] = art["col"]
        for key, v in art["dev"].items():
            self.dev[key][name] = v
            for s, dev_s in enumerate(self._shard_devs):
                dev_s[key][name] = (tuple(x[s] for x in v) if isinstance(v, tuple) else v[s])

    def _runtime_uninstall(self, name: str) -> None:
        self.sp.global_docvalues.pop(name, None)
        for key in ("dv_int", "dv_float", "dv_int_ord"):
            self.dev[key].pop(name, None)
            for dev_s in self._shard_devs:
                dev_s[key].pop(name, None)

    # ---- batched host-to-device copies -----------------------------------

    def put(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; on the card through pinned memory
        and a non-blocking copy (see `BatchTermSearcher._put`)."""
        t = torch.from_numpy(np.require(a, requirements=["C", "W"]))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def fused_msearch(self):
        """The fused sharded arm, made at first use (its split-bf16 tier
        copies live as long as it does), or None without a dense tier."""
        if not self.sp.dense_v:
            return None
        if self._fused is None:
            self._fused = _FusedShardedMsearch(self)
        return self._fused


def msearch_sharded(ss: StackedSearcher, fld: str, queries: list, k: int = 10):
    """Batched term-disjunction `_msearch` over the shards: per-shard
    partials from the arm the reference picks on a TPU, then the
    coordinator merge on the device and one copy back.
    -> (scores [Q, kk] f32, shard [Q, kk] i32, docid [Q, kk] i64, totals
    [Q] i64) numpy; missing hits carry -inf. `ss.last_stats` records the
    arm's queries, the escalated queries and the host planning ms."""
    ss.last_stats = {"queries": {}, "escalated": 0, "plan_ms": 0.0}
    if not queries:
        kk = min(max(k, 1), max(ss.sp.n_max, 1))
        return (np.zeros((0, kk), np.float32), np.zeros((0, kk), np.int32),
                np.zeros((0, kk), np.int64), np.zeros(0, np.int64))
    return _msearch_sharded_partials(ss, fld, queries, k, finish=_merged)


def _merged(v, i, t):
    """Partials -> the coordinator merge on the device, copied back in
    one copy as msearch_sharded's output."""
    mv, msh, mi, mt = merge_topk_rows(v, i, t)
    mv, msh, mi, mt = fetch([[(mv, msh, mi, mt.to(torch.int32))]])[0]
    return mv, msh, mi.astype(np.int64), mt.astype(np.int64)


def _impact_sharded_usable(ss: StackedSearcher) -> bool:
    """The stacked code blocks are derived and resident: the reference's
    gate with ES_TPU_IMPACT auto on a TPU."""
    return ss.sp.impact_serving() and "impact_codes" in ss.dev


def _msearch_sharded_partials(ss: StackedSearcher, fld: str, queries: list, k: int,
                              finish=None):
    """Per-shard pre-merge rows (v [S, Q, kk], i [S, Q, kk] i32, t [S, Q]
    i32) on the device from the arm the execution planner picks among those
    that serve, in the reference's order (`sharded.py:1770-1800`): fused,
    impact, exact. With `finish` (a function of the partials that ends in a
    device-to-host copy, `_merged`) -> finish's result, the copy closing the
    arm's timing window."""
    from ..planner import execution_planner

    arms = ss.last_stats.setdefault("queries", {})
    fs = ss.fused_msearch()
    fused_ok = fs is not None and fs.usable(k)
    S, Q, n_max = ss.sp.S, len(queries), ss.sp.n_max
    cands = []
    if fused_ok:
        cands.append(("fused", "sharded.fused_pipeline",
                      {"shards": S, "queries": Q, "k": k, "v": ss.sp.dense_v,
                       "num_docs": S * fs.n_pad}))
    if _impact_sharded_usable(ss):
        cands.append(("impact", "sharded.impact_disjunction",
                      {"shards": S, "queries": Q, "k": k, "num_docs": S * n_max}))
    cands.append(("exact", "sharded.exact_disjunction",
                  {"tier": "exact", "shards": S, "queries": Q, "k": k, "num_docs": S * n_max}))
    arm = execution_planner().choose_arm("sharded.msearch_partials", cands)
    if arm == "fused":
        arms["fused"] = arms.get("fused", 0) + Q
        out = fs.msearch_partials(fld, queries, k)
        return out if finish is None else finish(*out)
    if arm == "impact":
        out = _msearch_impact_partials(ss, fld, queries, k, finish=finish)
        if out is not None:
            arms["impact"] = arms.get("impact", 0) + Q
            return out
    arms["exact"] = arms.get("exact", 0) + Q
    return _msearch_exact_partials(ss, fld, queries, k, finish=finish)


def _msearch_stack_plans(ss: StackedSearcher, fld: str, queries: list, k: int, *,
                         impact: bool = False) -> dict | None:
    """The BatchTermSearcher plan of every shard's view, padded to the
    common (Ts, B) shape (row 0 = the padding block) and stacked, byte for
    byte as the reference's `_msearch_stack_plans` stacks them. The pass
    over the queries and terms is made once (`_sparse_terms`); per shard
    only the block rows and impact scales of the batch's unique sparse terms
    are looked up, and a term the shard lacks takes no slot there.
    -> dict of [S, ...] plan arrays and the scoring context; None when
    impact=True and a shard's plan cannot ride the impact tier."""
    t0 = time.perf_counter()
    sp = ss.sp
    Q = len(queries)
    dense_l, (e_q, e_u, e_w), uniq = _sparse_terms(sp, fld, queries)
    W = np.zeros((Q, sp.dense_v), np.float32)
    for qi, dlist in enumerate(dense_l):
        for dr, w in dlist:
            W[qi, dr] += w
    serving = sp.impact_serving()
    shards = []
    for p in sp.shards:
        s0_u, nb_u = _term_blocks(p, fld, uniq)
        inc = nb_u[e_u] > 0
        if impact and inc.any() and not serving:
            return None
        excl = np.cumsum(inc) - inc
        slot = (excl - excl[_first_of_group(e_q)])[inc] if len(e_q) else excl
        ubf = np.zeros(len(uniq), np.float64)
        if serving and p.impact_ubf is not None and uniq:
            tids = np.array([p.term_dict.get((fld, t), -1) for t in uniq], np.int64)
            ubf = np.where(tids >= 0, p.impact_ubf[np.maximum(tids, 0)], 0.0)
        shards.append((inc, slot, s0_u, nb_u, ubf))
    ts_max = max([1] + [int(np.bincount(e_q[inc]).max()) for inc, *_ in shards if inc.any()])
    b_max = max([1] + [int(nb_u[e_u][inc].max()) for inc, _, _, nb_u, _ in shards if inc.any()])
    b_max = 1 << (b_max - 1).bit_length()
    S = sp.S
    rows = np.zeros((S, Q, ts_max, b_max), np.int32)
    ws = np.zeros((S, Q, ts_max), np.float32)
    iws = np.zeros((S, Q, ts_max), np.float32)
    qmax = sp.impact_meta["qmax"] if sp.impact_meta is not None else 1
    for s, (inc, slot, s0_u, nb_u, ubf) in enumerate(shards):
        q, u = e_q[inc], e_u[inc]
        w = [wt for wt, keep in zip(e_w, inc) if keep]
        ws[s, q, slot] = w
        # the reference's float arithmetic: w * (ubf / qmax) in Python floats
        iws[s, q, slot] = [wt * (float(b) / qmax) for wt, b in zip(w, ubf[u])]
        nb = nb_u[u]
        if len(nb):
            lane = np.arange(int(nb.sum())) - np.repeat(np.cumsum(nb) - nb, nb)
            rows[s, np.repeat(q, nb), np.repeat(slot, nb), lane] = np.repeat(s0_u[u], nb) + lane
    out = {
        "W": np.broadcast_to(W, (S,) + W.shape),  # [S, Q, V]: global weights
        "rows": rows,
        "ws": ws,
        "avgdl": sp.shard_view(0).avgdl(fld),
        "has_norms": fld in ss.ctx.has_norms,
        "kk": min(max(k, 1), max(sp.n_max, 1)),
        # query chunks bound the [qc, n_max] f32 score matrix as on one shard
        "qc": max(1, BatchTermSearcher.SCORE_BYTES_BUDGET // (4 * max(sp.n_max, 1))),
    }
    if impact:
        out["iws"] = iws
    ss.last_stats["plan_ms"] = ss.last_stats.get("plan_ms", 0.0) + (time.perf_counter() - t0) * 1e3
    return out


def _run_stacked_plans(ss: StackedSearcher, fld: str, pl: dict, impact: bool, finish=None):
    """The exact machinery of `batch_term_disjunction` on each shard's
    slice, per query chunk. -> (v [S, Q, kk], i [S, Q, kk] i32, t [S, Q]
    i32) on the device, or with `finish` its result: then the launches and
    finish's copy back are timed as `sharded.impact_disjunction` or
    `sharded.exact_disjunction` (the copy closes the window; no
    synchronization of its own)."""
    if finish is None:
        return _launch_stacked_plans(ss, fld, pl, impact)
    sp = ss.sp
    Q = pl["W"].shape[1]
    fields = dict(tier="impact" if impact else "exact", shards=sp.S, queries=Q, k=pl["kk"],
                  num_docs=sp.S * sp.n_max, rows=int(np.prod(pl["rows"].shape)))
    if impact:
        fields["code_bytes"] = ss.dev["impact_codes"].element_size()
    profile_event("tier", tier=fields["tier"], queries=Q)
    with time_kernel("sharded.impact_disjunction" if impact else "sharded.exact_disjunction",
                     ss.device, **fields):
        return finish(*_launch_stacked_plans(ss, fld, pl, impact))


def _launch_stacked_plans(ss: StackedSearcher, fld: str, pl: dict, impact: bool):
    sp = ss.sp
    Q = pl["W"].shape[1]
    qc = pl["qc"]
    avgdl = ss.ctx.avgdl[fld] if pl["has_norms"] else None
    vs, is_, ts = [], [], []
    for s in range(sp.S):
        dev_s = ss.shard_dev(s)
        outs = []
        for a in range(0, Q, qc):
            args = [ss.put(pl[key][s, a: a + qc]) for key in ("W", "rows", "ws")]
            iw = ss.put(pl["iws"][s, a: a + qc]) if impact else None
            outs.append(batch_term_disjunction(
                dev_s, pl["kk"], *args, avgdl=avgdl, num_docs=sp.n_max,
                k1=ss.ctx.k1, b=ss.ctx.b, has_norms=pl["has_norms"], impact_w=iw))
        vs.append(torch.cat([o[0] for o in outs]))
        is_.append(torch.cat([o[1] for o in outs]))
        ts.append(torch.cat([o[2] for o in outs]))
    return torch.stack(vs), torch.stack(is_), torch.stack(ts)


def _msearch_exact_partials(ss: StackedSearcher, fld: str, queries: list, k: int = 10,
                            finish=None):
    """The exact arm per shard (also the escalation target of the fused
    arm's flagged queries) -> pre-merge rows on the device (or `finish` of
    them, `_run_stacked_plans`)."""
    pl = _msearch_stack_plans(ss, fld, queries, k)
    return _run_stacked_plans(ss, fld, pl, impact=False, finish=finish)


def _msearch_impact_partials(ss: StackedSearcher, fld: str, queries: list, k: int = 10,
                             finish=None):
    """The impact arm (BM25S) per shard: the exact arm's body with the
    sparse lanes gathered from the stacked impact code blocks and scaled by
    their dequant weights (`impact_gather`), every candidate kept. None
    when a shard's plan cannot ride the tier (the caller falls back to the
    exact arm)."""
    pl = _msearch_stack_plans(ss, fld, queries, k, impact=True)
    if pl is None:
        return None
    return _run_stacked_plans(ss, fld, pl, impact=True, finish=finish)


def _msearch_sharded_exact(ss: StackedSearcher, fld: str, queries: list, k: int = 10):
    """The exact arm's partials merged -> msearch_sharded's output."""
    return _merged(*_msearch_exact_partials(ss, fld, queries, k))


def _first_of_group(q: np.ndarray) -> np.ndarray:
    """For entries sorted by query, the index of each entry's query's first
    entry."""
    return np.searchsorted(q, q, side="left")


def _sparse_terms(sp: StackedPack, fld: str, queries: list):
    """The per-shard planners' shared pass over a batch: the same on every
    shard, since df, idf, the dense tier and the weights are global.
    -> (dense [(row, w)] per query, sparse entries (query [E], unique term
    [E], w [E] as Python floats) in plan order, unique sparse terms)."""
    doc_count = sp.eff_field_stats.get(fld, {}).get("doc_count") or sp.n_max
    gdf, ddict = sp.eff_global_df, sp.dense_dict
    uniq: dict[str, int] = {}
    e_q, e_u, e_w, dense_l = [], [], [], []
    for qi, terms in enumerate(queries):
        dlist = []
        for term, boost in terms:
            df = gdf.get((fld, term), 0)
            if df <= 0:
                continue
            w = boost * bm25_idf(doc_count, df)
            dr = ddict.get((fld, term))
            if dr is not None:
                dlist.append((dr, w))
                continue
            e_q.append(qi)
            e_u.append(uniq.setdefault(term, len(uniq)))
            e_w.append(w)
        dense_l.append(dlist)
    return dense_l, (np.array(e_q, np.int64), np.array(e_u, np.int64), e_w), list(uniq)


def _term_blocks(pack, fld: str, terms: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """-> (first block row, block count) of each term in one shard's pack,
    (0, 0) where the shard lacks it."""
    tids = np.array([pack.term_dict.get((fld, t), -1) for t in terms] or [-1], np.int64)
    tbs = pack.term_block_start.astype(np.int64)
    have = tids >= 0
    safe = np.where(have, tids, 0)
    s0 = np.where(have, tbs[safe], 0)
    nb = np.where(have, tbs[safe + 1] - tbs[safe], 0)
    return s0[: len(terms)], nb[: len(terms)]


def plan_fused_shards(sp: StackedPack, fld: str, queries: list, k: int) -> list:
    """`ops.fused.plan_fused` against every shard's view, byte for byte
    (one chunk of len(queries) rows), with the pass over the queries and
    terms made once: per shard only the block rows of the batch's unique
    sparse terms are looked up, and a term the shard lacks takes no ordinal
    there, as in plan_fused."""
    dense_l, (e_q, e_u, e_w), uniq = _sparse_terms(sp, fld, queries)
    qc = len(queries)
    td_max = max((len(d) for d in dense_l), default=1) or 1
    Td = 1 << (max(td_max, 4) - 1).bit_length()
    dense_rows = np.zeros((qc, Td), np.int32)
    dense_w = np.zeros((qc, Td), np.float32)
    for qi, dlist in enumerate(dense_l):
        for ti, (dr, w) in enumerate(dlist):
            dense_rows[qi, ti] = dr
            dense_w[qi, ti] = w
    w_all = np.array(e_w, np.float32)
    plans = []
    for p in sp.shards:
        s0_u, nb_u = _term_blocks(p, fld, uniq)
        nb_e = nb_u[e_u]
        inc = nb_e > 0
        excl = np.cumsum(inc) - inc
        ordinal = (excl - excl[_first_of_group(e_q)])[inc] if len(e_q) else excl
        q, nb = e_q[inc], nb_e[inc]
        nreal = int(nb.sum())
        R = 64
        while R < nreal:
            R *= 2
        rows = np.zeros(R, np.int32)
        row_q = np.zeros(R, np.int32)
        row_w = np.zeros(R, np.float32)
        row_t = np.zeros(R, np.int32)
        if nreal:
            first = np.cumsum(nb) - nb
            rows[:nreal] = np.repeat(s0_u[e_u][inc] - first, nb) + np.arange(nreal)
            row_q[:nreal] = np.repeat(q, nb)
            row_w[:nreal] = np.repeat(w_all[inc], nb)
            row_t[:nreal] = np.repeat(ordinal, nb)
        ts = int(np.bincount(q).max()) if len(q) else 0
        plans.append(F.FusedPlan(rows, row_q, row_w, row_t, dense_rows, dense_w, k, ts))
    return plans


class _FusedShardedMsearch:
    """Sharded `_msearch` through the fused kernel, one pipeline per
    (shard, chunk): `ops.fused._fused_pipeline` on the shard's split-bf16
    (hi, lo) tier, its live lanes and its postings, with the shard's lanes
    past its own doc count dead. Queries flagged by any shard re-run on the
    exact partials, whose rows replace the fused rows on every shard, so the
    merge never depends on the fused pass."""

    def __init__(self, ss: StackedSearcher):
        self.ss = ss
        self.S = ss.sp.S
        self.n_max = ss.sp.n_max
        self.t = F.tile_t_for(-(-self.n_max // F.TILE_N))
        self.n_pad = -(-self.n_max // F.TILE_N) * F.TILE_N
        self._tiers: list[tuple[torch.Tensor, torch.Tensor]] | None = None

    def usable(self, k: int) -> bool:
        """A dense tier, 0 < k <= 16, and shards between 4,096 docs and the
        window key's docid budget (`FusedTermSearcher.usable` on n_max)."""
        return (self.ss.sp.dense_v > 0 and 0 < k <= 16
                and 4 * F.FINE_N <= self.n_max <= F.MAX_DOCS_FUSED)

    def _arrays(self, s: int) -> dict:
        """Shard s's pipeline arrays. The split-bf16 copies of the scored
        tier are made for every shard at first use, one shard at a time."""
        dev = self.ss.dev
        if self._tiers is None:
            self._tiers = [split_bf16(dev["dense_tfn"][s]) for s in range(self.S)]
        sd = self.ss.shard_dev(s)
        hi, lo = self._tiers[s]
        return {"tier32": sd["dense_tfn"], "hi": hi, "lo": lo, "live": sd["live"],
                "post_docids": sd["post_docids"], "post_tfs": sd["post_tfs"],
                "post_dls": sd["post_dls"]}

    def _plan_batch(self, fld: str, queries: list, k: int):
        """Per shard, per QC-query chunk, the fused plan of the shard's view
        (`plan_fused_shards`). -> (chunk starts, plans [S][C])."""
        starts = list(range(0, len(queries), F.QC))
        per_chunk = [plan_fused_shards(self.ss.sp, fld, queries[a: a + F.QC], k)
                     for a in starts]
        return starts, [list(ps) for ps in zip(*per_chunk)]

    def msearch_partials(self, fld: str, queries: list, k: int):
        """Pre-merge rows (v [S, Q, k], i [S, Q, k] i32, t [S, Q] i32) on the
        device; the rows of queries flagged by any shard are the exact
        arm's partials."""
        ss = self.ss
        stats = ss.last_stats
        t0 = time.perf_counter()
        starts, plans = self._plan_batch(fld, queries, k)
        stats["plan_ms"] = stats.get("plan_ms", 0.0) + (time.perf_counter() - t0) * 1e3
        has_norms = fld in ss.ctx.has_norms
        avgdl = ss.ctx.avgdl[fld] if has_norms else None
        put = ss.put
        vs, is_, ts, fl = [], [], [], []
        profile_event("tier", tier="fused", queries=len(queries))
        # the launches and the flags' copy back (which closes the window)
        with time_kernel("sharded.fused_pipeline", ss.device, tier="fused", shards=self.S,
                         queries=len(queries), k=k, v=ss.sp.dense_v,
                         num_docs=self.S * self.n_pad):
            for s in range(self.S):
                fa = self._arrays(s)
                outs = [F._fused_pipeline(
                    fa, avgdl, put(p.rows), put(p.row_q), put(p.row_w), put(p.row_t),
                    put(p.dense_rows), put(p.dense_w), k=k, ts=p.ts, n=self.n_max,
                    has_norms=has_norms, k1=ss.ctx.k1, b=ss.ctx.b, t=self.t)
                    for p in plans[s]]
                vs.append(torch.cat([o[0] for o in outs]))
                is_.append(torch.cat([o[1] for o in outs]))
                ts.append(torch.cat([o[2] for o in outs]))
                fl.append(torch.cat([o[3] for o in outs]))
            v, i, t = torch.stack(vs), torch.stack(is_), torch.stack(ts)
            flagged = torch.stack(fl).any(dim=0).cpu().numpy()
        stats["chunks"] = self.S * len(starts)
        if flagged.any():
            still = np.nonzero(flagged)[0]
            stats["escalated"] = stats.get("escalated", 0) + len(still)
            ev, ei, et = _msearch_exact_partials(ss, fld, [queries[j] for j in still], k)
            at = torch.from_numpy(still).to(v.device)
            ke = ev.shape[2]
            v[:, at] = float("-inf")
            v[:, at, :ke] = ev
            i[:, at] = 0
            i[:, at, :ke] = ei
            t[:, at] = et
        return v, i, t




# ---- serving waves -------------------------------------------------------


def msearch_wave(ss, fld: str, queries: list, k: int = 10):
    """Serving-wave `_msearch` of a coalesced term-disjunction batch: padded
    to the batch tier (`BatchTermSearcher.wave_q_tier`) with empty queries,
    run, and the pad rows stripped (reference `parallel/sharded.py:1658`).
    -> ((scores [Q, k], shard [Q, k], doc [Q, k], totals [Q]), tier); the
    reference's request cache is not ported (off)."""
    st = msearch_wave_begin(ss, fld, queries, k)
    msearch_wave_fetch(st)
    return msearch_wave_finish(st)


def msearch_wave_begin(ss, fld: str, queries: list, k: int = 10) -> dict:
    """Pad to the tier and run the batch: `ShardSearcher.msearch` on one
    shard, `msearch_sharded` on a StackedSearcher. The port's arms copy
    their flags to the host inside the call (the escalation rounds of
    `BatchTermSearcher.msearch`, the fused arm's flagged rows), so the batch
    resolves here and `msearch_wave_fetch` has nothing left to copy."""
    Q = len(queries)
    tier = BatchTermSearcher.wave_q_tier(Q)
    padded = list(queries) + [[] for _ in range(tier - Q)]
    if isinstance(ss, StackedSearcher):
        v, sh, dc, tt = msearch_sharded(ss, fld, padded, k)
    else:
        v, dc, tt, _ = ss.msearch(fld, padded, k)
        sh = np.zeros(dc.shape, np.int32)
    return {"Q": Q, "tier": tier, "result": (v, sh, dc, tt)}


def msearch_wave_fetch(st: dict) -> None:
    """No-op: `msearch_wave_begin` resolved the batch (see there)."""


def msearch_wave_finish(st: dict):
    """-> ((scores [Q, k], shard, doc, totals [Q]), tier), pad rows stripped."""
    v, s, d, t = st["result"]
    Q = st["Q"]
    return (v[:Q], s[:Q], d[:Q], t[:Q]), st["tier"]
