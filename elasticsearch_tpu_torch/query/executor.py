"""Shard-level query execution over a device-resident pack.

The analog of the reference's per-shard query phase (reference behavior:
search/query/QueryPhase.java — run the searcher, emit the top-k docids and
scores plus the total). One `ShardSearcher` owns the uploaded pack; each
`search` parses and prepares the query on the host, evaluates its
(scores, match) on the device, and selects through
`ops/scoring.top_k_with_total`. One device-to-host copy per request.
`msearch` runs a batch of term disjunctions through the batched arms of
`ops/batched.BatchTermSearcher`. A search with `aggs` evaluates each agg
tree (`aggs.nodes`) under the query's match & live mask after the
selection, and its outputs ride the same copy back; a two-pass terms agg
runs its second pass when that copy is back.

As the base tier of a tiered index (`engine.EsIndex`), the searcher takes
what the reference's one-shard `StackedSearcher` takes there: later
writes clear live bits (`mark_dead`, then `update_live`), and a statistics
override (`set_stats_override`, the statistics combined over every tier)
is read by planning (`view`: df and doc_count) and by scoring (the f32
avgdl, and the dense tier's tfn rows and the impact codes, re-derived on
the device from the resident postings).

Field-sorted search (`search_sorted`, reference `executor.py:543-602`)
selects by the sort keys (`query.sort`), with aggs beside it in one pass
(a two-pass terms agg is forced to its single pass, as the reference does).
`scores_at` evaluates a query at given hits (rescore, exact BM25), and
`search_collapse` keeps the best hit per value of a field: the semantics
of the reference's one-shard `StackedSearcher.search_collapse`
(`sharded.py:596-703`), shared with the several-shard searcher through
`collapse_top`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..aggs.nodes import flatten_outputs, unflatten_outputs
from ..index.device_build import impact_codes_device
from ..index.pack import ShardPack, impact_row_params, impact_row_terms
from ..monitoring.refresh_profile import build_stage, refresh_stage
from ..ops.batched import BatchTermSearcher, fetch, pack_outputs, unpack_outputs
from ..ops.kernels import MAX_FUSED_K, _select_topk, scan_topk
from ..ops.scoring import top_k_with_total
from ..script.runtime import RuntimeFieldHost
from ..utils.torch_env import resolve_device
from .dsl import parse_query
from .nodes import ExecContext, QueryNode, mark_exact
from .sort import SortPlan, after_mask, sorted_top


def pack_to_device(pack: ShardPack, device) -> dict:
    """Upload a host ShardPack as a flat dict of tensors, with the leaf
    names of the JAX package's `query/executor.pack_to_device` for the
    ported leaves: postings, norms, text presence, docvalues (with an int
    column's ordinals `dv_int_ord` and a keyword's multi-value pairs
    `dv_mv`), live docs, the dense tier, the impact codes (kept at their storage dtype) and the
    vector fields (values, presence, squared norms summed on the host as
    there, and the ANN index through `ann.ann_to_device`) and the position
    keys `pos_keys`. Keyword ordinals widen to int64, as there."""
    device = torch.device(device)

    def put(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):  # a device build's resident array
            return a.to(device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dev = {
        "post_docids": put(pack.post_docids),
        "post_tfs": put(pack.post_tfs),
        "post_dls": put(pack.post_dls),
        "norms": {f: put(a) for f, a in pack.norms.items()},
        "text_has": {f: put(a) for f, a in pack.text_present.items()},
        "dv_int": {},
        "dv_float": {},
        "dv_ord": {},
        "dv_int_ord": {},
        "dv_mv": {},
        "live": put(pack.live),
        "vec": {},
        "vec_has": {},
        "vec_sq": {},
        "vec_ann": {},
    }
    for f, col in pack.docvalues.items():
        key = {"int": "dv_int", "float": "dv_float", "ord": "dv_ord"}[col.kind]
        vals = col.values if col.kind != "ord" else col.values.astype(np.int64)
        dev[key][f] = (put(vals), put(col.has_value))
        if col.uniq_ords is not None:
            dev["dv_int_ord"][f] = put(col.uniq_ords)
        if col.mv_pair_docs is not None:
            dev["dv_mv"][f] = (put(col.mv_pair_docs), put(col.mv_pair_ords))
    for f, vc in pack.vectors.items():
        dev["vec"][f] = put(vc.values)
        dev["vec_has"][f] = put(vc.has_value)
        dev["vec_sq"][f] = put((vc.values * vc.values).sum(axis=-1).astype(np.float32))
        if vc.ann is not None:
            from ..ann import ann_to_device

            dev["vec_ann"][f] = ann_to_device(vc.ann, dev["vec"][f], device)
    if pack.dense_tfn is not None:
        dev["dense_tfn"] = put(pack.dense_tfn)
    if pack.impact_codes is not None:
        dev["impact_codes"] = put(pack.impact_codes)
    if pack.pos_keys is not None:
        dev["pos_keys"] = put(pack.pos_keys)
    return dev


class StatsView:
    """A ShardPack as planning sees it under a statistics override: df
    (`term_blocks`), `field_stats` and `avgdl` are the override's; every
    other attribute is the pack's."""

    def __init__(self, pack: ShardPack, override: dict):
        self._pack = pack
        self._override = override

    def __getattr__(self, name):
        return getattr(self._pack, name)

    @property
    def field_stats(self) -> dict:
        return self._override["field_stats"]

    def avgdl(self, fld: str) -> float:
        st = self._override["field_stats"].get(fld)
        if not st or st["doc_count"] == 0:
            return 1.0
        return st["sum_dl"] / st["doc_count"]

    def term_blocks(self, fld: str, term: str) -> tuple[int, int, int]:
        s, n, df = self._pack.term_blocks(fld, term)
        return s, n, self._override["global_df"].get((fld, term), df)


@dataclass
class ShardResult:
    doc_ids: np.ndarray  # [<=size] int32 local docids
    scores: np.ndarray  # [<=size] float32
    total: int
    max_score: float | None
    aggregations: dict | None = None
    collapse_keys: list | None = None  # a collapsed search's field value per hit


def prepare_aggs(aggs: dict | None, mappings, view,
                 single_pass: bool = False) -> tuple[dict | None, dict]:
    """Parse a request's `aggs` and plan each node against `view` (a pack
    or a shard view). `single_pass`: a two-pass terms agg is forced to its
    single pass (beside a field sort, reference `executor.py:573-579`).
    -> (name -> AggNode or None, name -> params)."""
    if not aggs:
        return None, {}
    from ..aggs import parse_aggs, two_pass_plan

    agg_nodes = parse_aggs(aggs, mappings)
    params = {name: a.prepare(view, mappings)[0] for name, a in agg_nodes.items()}
    tp = two_pass_plan(agg_nodes)  # a nested two-pass terms agg is refused here
    if single_pass and tp:
        for a in tp.values():
            a.force_single_pass = True
        params = {name: a.prepare(view, mappings)[0] for name, a in agg_nodes.items()}
    return agg_nodes, params


def select_sorted(plan: SortPlan, parts: list, n: int, after, k: int):
    """The sorted page over one or several shards: `parts` holds per shard
    (dev, scores, ok); lanes are shard-major (s * n + docid). -> (lanes
    [<= k] int64, the keys at those lanes)."""
    per = [plan.device_keys(dev, sc, n) for dev, sc, _ok in parts]
    keys = [torch.cat(ks) for ks in zip(*per)]
    sel = torch.cat([ok for _dev, _sc, ok in parts])
    if after is not None:
        sel = sel & after_mask(keys, after)
    return sorted_top(keys, sel, k)


def collapse_groups(col) -> int:
    """The group count V of a collapse field's column: keyword ordinals, or
    an int column's unique values (0: every doc in the null group)."""
    if col is None:
        return 0
    if col.kind == "ord":
        return len(col.ord_terms)
    return len(col.uniq_values) if col.uniq_values is not None else 0


def collapse_top(parts: list, fld: str, V: int, k: int):
    """Field collapsing (reference behavior: CollapseBuilder.java + Lucene
    CollapsingTopDocsCollector; the JAX package's `search_collapse`):
    groups are the field's global ordinals, docs without a value share the
    null group V. Per shard, each group's max score and its lowest docid
    among the maxima (scatter amax / amin: no float atomics); over shards,
    the max, won by the lowest shard among the maxima; then the top k groups
    by (score desc, group asc), through `scan_topk`. `parts` holds per
    shard (dev, scores [N+1], ok [N]). -> (scores, shards, docids, groups
    [<= k] tensors, total 0-dim)."""
    gmaxs, gdocs, total = [], [], 0
    for dev, scores, ok in parts:
        n = ok.shape[0]
        device = ok.device
        if fld in dev["dv_ord"]:
            ords, has = dev["dv_ord"][fld]
        elif fld in dev["dv_int_ord"]:
            ords, has = dev["dv_int_ord"][fld], dev["dv_int"][fld][1]
        else:
            ords = torch.full((n,), -1, dtype=torch.int64, device=device)
            has = torch.zeros(n, dtype=torch.bool, device=device)
        grp = torch.where(has & (ords >= 0), ords.to(torch.int64), V)
        neg_inf = torch.tensor(float("-inf"), device=device)
        masked = torch.where(ok, scores[:n], neg_inf)
        gmax = torch.full((V + 1,), float("-inf"), device=device).scatter_reduce(
            0, grp, masked, reduce="amax", include_self=True)
        ismax = ok & (masked == gmax[grp]) & torch.isfinite(masked)
        big = torch.iinfo(torch.int32).max
        docids = torch.arange(n, dtype=torch.int32, device=device)
        gdoc = torch.full((V + 1,), big, dtype=torch.int32, device=device).scatter_reduce(
            0, grp, torch.where(ismax, docids, big), reduce="amin", include_self=True)
        gmaxs.append(gmax)
        gdocs.append(gdoc)
        total = total + ok.sum(dtype=torch.int32)
    gmax, gdoc = torch.stack(gmaxs), torch.stack(gdocs)  # [S, V+1]
    S = gmax.shape[0]
    best = gmax.max(dim=0).values
    shard_ix = torch.arange(S, device=gmax.device)[:, None].expand_as(gmax)
    shard_sel = torch.where(gmax == best[None, :], shard_ix, S).min(dim=0).values.clamp_(max=S - 1)
    doc_sel = gdoc.gather(0, shard_sel[None, :])[0]
    kk = min(k, V + 1)
    finite = torch.isfinite(best)
    if kk <= MAX_FUSED_K:
        top_s, top_g, _ = scan_topk(None, best[None, :], finite, kk, count_positive=False)
    else:
        top_s, top_g = _select_topk(torch.where(finite, best, float("-inf"))[None, :], kk)
    top_s = top_s[0]
    # the slots past the finite groups are dropped by the caller
    top_g = torch.where(torch.isfinite(top_s), top_g[0].long(), 0)
    return top_s, shard_sel[top_g], doc_sel[top_g], top_g, total


def collapse_keys(col, groups, V: int) -> list:
    """Group ids -> the collapse keys of the hits (None: the null group)."""
    out = []
    for g in groups:
        g = int(g)
        if g >= V or col is None:
            out.append(None)
        elif col.kind == "ord":
            out.append(col.ord_terms[g])
        else:
            out.append(int(col.uniq_values[g]))
    return out


def eval_aggs(agg_nodes: dict, agg_params: dict, dev: dict, scores, match, ctx):
    """Every top-level agg under the query's match mask: ok = match & live
    over the real docs, one segment (seg 0; the rest 1, never read), and
    the query's scores in dev["_query_scores"] for top_hits. -> (outputs by
    name, the (dev, seg, ok) a second pass reuses)."""
    n = ctx.num_docs
    ok = match[:n] & dev["live"]
    seg = torch.where(ok, 0, 1)
    dev_a = {**dev, "_query_scores": scores[:n]}
    outs = {name: a.device_eval_segmented(dev_a, agg_params[name], seg, 1, ok, ctx)
            for name, a in agg_nodes.items()}
    return outs, (dev_a, seg, ok)


class ShardSearcher(RuntimeFieldHost):
    def __init__(self, pack: ShardPack, device=None, mappings=None):
        self.device = resolve_device(device)
        self.pack = pack
        self.mappings = mappings
        self.dev = pack_to_device(pack, self.device)
        # what planning reads: the pack, or its view under a statistics
        # override (set_stats_override)
        self.view: ShardPack | StatsView = pack
        self.stats_override: dict | None = None
        self.dead_count = 0  # live bits cleared by later writes
        self.ctx = ExecContext(
            num_docs=pack.num_docs,
            avgdl=self._ctx_avgdl(),
            has_norms=frozenset(pack.norms),
            device=self.device,
        )
        self._batched: BatchTermSearcher | None = None
        # host index arrays of the re-derivations, made at first use
        self._dense_index = None
        self._impact_rows = None

    def _ctx_avgdl(self) -> dict:
        return {f: torch.tensor(np.float32(self.view.avgdl(f)), device=self.device)
                for f in self.pack.norms}

    # ---- tiered refresh: live flips and statistics drift -------------------

    def live_host(self, s: int) -> np.ndarray:
        """The host live bits (s is always 0 here)."""
        return self.pack.live

    def mark_dead(self, s: int, d: int) -> bool:
        """Clear doc d's live bit on the host (s is always 0 here;
        `update_live` ships it). -> whether it was live."""
        if not self.pack.live[d]:
            return False
        self.pack.live[d] = False
        self.dead_count += 1
        return True

    def update_live(self) -> None:
        """Re-ship the host live bits to dev["live"], in place (the batched
        arms read the same tensor)."""
        self.dev["live"].copy_(torch.from_numpy(self.pack.live))

    def set_stats_override(self, override: dict | None) -> None:
        """Plan and score under new effective statistics: the view's df and
        doc_count, the postings path's f32 avgdl, and the dense tier and
        impact codes re-derived on the device. The batched arms' cached
        split-bf16 tier copies are dropped."""
        self.stats_override = override
        self.view = self.pack if override is None else StatsView(self.pack, override)
        self.ctx.avgdl = self._ctx_avgdl()
        self._batched = None
        self.refresh_dense_tfn()
        self.refresh_impacts()

    def refresh_dense_tfn(self) -> None:
        """Re-derive dev["dense_tfn"] under the effective avgdl: each dense
        term's raw tf, gathered from the resident postings and scattered to
        its row, then tf / (tf + K), K = k1 * (1 - b + b * norm / avgdl) per
        field (k1 alone without norms), in the f32 operations of the
        reference's `refresh_dense_tfn`."""
        if "dense_tfn" not in self.dev:
            return
        with refresh_stage("dense_tier", self.device, basis="device"):
            self._derive_dense_tfn()

    def _derive_dense_tfn(self) -> None:
        pack = self.pack
        if self._dense_index is None:
            rows, blocks = [], []
            for (fld, term), r in pack.dense_dict.items():
                s0, nb, _df = pack.term_blocks(fld, term)
                rows.append(np.full(nb, r, np.int64))
                blocks.append(np.arange(s0, s0 + nb, dtype=np.int64))
            fields = [k[0] for k in sorted(pack.dense_dict, key=pack.dense_dict.get)]
            slices, v0 = [], 0
            for fld, group in itertools.groupby(fields):  # rows are grouped by field
                c = sum(1 for _ in group)
                slices.append((fld, v0, v0 + c))
                v0 += c
            self._dense_index = (torch.from_numpy(np.concatenate(rows)).to(self.device),
                                 torch.from_numpy(np.concatenate(blocks)).to(self.device),
                                 slices)
        rows, blocks, slices = self._dense_index
        docs = self.dev["post_docids"][blocks]
        valid = docs < pack.num_docs
        tier = self.dev["dense_tfn"]
        if tier.device.type == "cpu" and not isinstance(pack.dense_tfn, torch.Tensor):
            tier = torch.zeros_like(tier)  # the upload may share the host pack's array
        else:
            # rewritten in place, so the card holds one tier: a card build's
            # tier is the pack's own tensor, which the searcher shares
            tier.zero_()
        tier[rows[:, None].expand_as(docs)[valid], docs[valid].long()] = \
            self.dev["post_tfs"][blocks][valid]
        del docs, valid
        k1, b = self.ctx.k1, self.ctx.b
        for fld, a, c in slices:
            tfa = tier[a:c]
            if fld in pack.norms:
                avgdl = torch.tensor(np.float32(max(self.view.avgdl(fld), 1e-9)),
                                     device=self.device)
                den = tfa + (k1 * (1.0 - b + b * self.dev["norms"][fld] / avgdl))[None, :]
            else:
                den = tfa + k1
            tfa.div_(den)
            del den
        self.dev["dense_tfn"] = tier

    def refresh_impacts(self) -> None:
        """Re-derive dev["impact_codes"] from the resident postings under
        the effective avgdl (the reference's `refresh_impacts`), in the f32
        operations of the host build."""
        meta = self.pack.impact_meta
        if meta is None or "impact_codes" not in self.dev:
            return
        with build_stage("build.impact_quantize", self.device,
                         rows=self.pack.post_docids.shape[0],
                         code_bytes=2 if meta["dtype"] == "uint16" else 1, basis="device"):
            self._derive_impacts()

    def _derive_impacts(self) -> None:
        pack = self.pack
        meta = pack.impact_meta
        if self._impact_rows is None:
            fields = sorted({f for f, _t in pack.term_dict})
            fcode = {f: i for i, f in enumerate(fields)}
            field_of_term = np.array([fcode[f] for (f, _t), _tid in
                                      sorted(pack.term_dict.items(), key=lambda kv: kv[1])],
                                     np.int64)
            self._impact_rows = (impact_row_terms(pack.term_block_start,
                                                  pack.post_docids.shape[0]),
                                 field_of_term, fields)
        row_terms, field_of_term, fields = self._impact_rows
        k_base, k_slope, scale_inv = impact_row_params(
            row_terms, pack.impact_ubf, field_of_term,
            np.array([max(self.view.avgdl(f), 1e-9) for f in fields], np.float64),
            np.array([f in pack.norms for f in fields]), meta["qmax"])
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        self.dev["impact_codes"] = impact_codes_device(
            self.dev["post_tfs"], self.dev["post_dls"], put(k_base), put(k_slope),
            put(scale_inv), qmax=meta["qmax"], dtype=meta["dtype"])

    # ---- runtime fields (script/runtime.RuntimeFieldHost) --------------------

    @property
    def runtime_mappings(self):
        return self.mappings

    @runtime_mappings.setter
    def runtime_mappings(self, m) -> None:
        self.mappings = m

    def _runtime_mapped(self, name: str) -> bool:
        return name in self.pack.docvalues

    def _runtime_build(self, compiled, kind: str) -> dict:
        from ..script.runtime import host_column, runtime_values

        n = self.pack.num_docs
        vals, has = runtime_values(
            compiled, kind, lambda f: self.dev["dv_float"].get(f) or self.dev["dv_int"].get(f),
            n, self.device)
        col = host_column(kind, vals.cpu().numpy(), has.cpu().numpy())
        dev = {("dv_int" if kind == "int" else "dv_float"): (vals, has)}
        if col.uniq_ords is not None:
            dev["dv_int_ord"] = torch.from_numpy(col.uniq_ords).to(self.device)
        return {"col": col, "dev": dev}

    def _runtime_install(self, name: str, art: dict) -> None:
        self.pack.docvalues[name] = art["col"]
        for key, v in art["dev"].items():
            self.dev[key][name] = v

    def _runtime_uninstall(self, name: str) -> None:
        self.pack.docvalues.pop(name, None)
        for key in ("dv_int", "dv_float", "dv_int_ord"):
            self.dev[key].pop(name, None)

    def batched(self) -> BatchTermSearcher:
        """The BatchTermSearcher over this shard's device pack, made at
        first use (its split-bf16 tier copies live as long as it does)."""
        if self._batched is None:
            self._batched = BatchTermSearcher(self)
        return self._batched

    def msearch(self, fld: str, queries, k: int = 10, **kw):
        """Batched term-disjunction `_msearch` -> (scores [Q, k], docids
        [Q, k], totals [Q], first_pass_exact [Q]) numpy; queries are lists
        of (term, boost) on `fld` (see BatchTermSearcher.msearch for the
        keywords and the totals contract)."""
        return self.batched().msearch(fld, queries, k, **kw)

    def search(self, query: dict | QueryNode | None, size: int = 10, from_: int = 0,
               aggs: dict | None = None) -> ShardResult:
        state = self.search_many_begin([dict(query=query, size=size, from_=from_, aggs=aggs)])
        self.search_many_fetch(state)
        return self.search_many_finish(state)[0]

    def search_sorted(self, query, sort_fields, size: int = 10, from_: int = 0,
                      search_after=None, aggs: dict | None = None):
        """Field-sorted `_search` (reference `executor.py:543-602`) -> (hits
        [(docid, sort values)], total, aggregations). Aggs ride beside the
        sort in one pass."""
        node = query if isinstance(query, QueryNode) else parse_query(query, self.mappings)
        agg_nodes, agg_params = prepare_aggs(aggs, self.mappings, self.view, single_pass=True)
        n = self.pack.num_docs
        if n == 0:
            return [], 0, ({} if aggs else None)
        plan = SortPlan(sort_fields, self.view, self.mappings)
        after = plan.after_keys(search_after, self.view) if search_after is not None else None
        k = min(max(size + from_, 1), n)
        scores, match = node.device_eval(self.dev, node.prepare(self.view), self.ctx)
        ok = match[:n] & self.dev["live"]
        lanes, keys_s = select_sorted(plan, [(self.dev, scores, ok)], n, after, k)
        leaves, spec = [], None
        if agg_nodes:
            agg_out, _ = eval_aggs(agg_nodes, agg_params, self.dev, scores, match, self.ctx)
            leaves, spec = flatten_outputs(agg_out)
        lanes, total, *rest = fetch([[(lanes, ok.sum(dtype=torch.int32).reshape(1),
                                       *keys_s, *leaves)]])[0]
        aggregations = None
        if agg_nodes:
            agg_out = unflatten_outputs(spec, rest[len(keys_s):])
            aggregations = {name: a.finalize(agg_out[name], 1)[0]
                            for name, a in agg_nodes.items()}
        take = list(range(len(lanes)))[from_: size + from_]
        values = plan.hit_values(rest[: len(keys_s)], take)
        return [(int(lanes[i]), v) for i, v in zip(take, values)], int(total[0]), aggregations

    def scores_at(self, query, doc_shards: np.ndarray, doc_ids: np.ndarray):
        """A query's scores at given hits (the rescore gather, reference
        `sharded.py:706`), in exact BM25 (rescore windows combine raw
        scores). -> (scores [m] f32, 0 where the hit does not match; match
        [m] bool). `doc_shards` is all zeros here."""
        node = query if isinstance(query, QueryNode) else parse_query(query, self.mappings)
        mark_exact(node)
        scores, match = node.device_eval(self.dev, node.prepare(self.view), self.ctx)
        n = self.pack.num_docs
        di = torch.from_numpy(np.asarray(doc_ids, np.int64)).to(self.device)
        ok = (match[:n] & self.dev["live"])[di]
        s = torch.where(ok, scores[:n][di], torch.zeros((), device=self.device))
        s, ok = fetch([[(s, ok)]])[0]
        return s, ok

    def search_collapse(self, query, fld: str, size: int = 10, from_: int = 0) -> ShardResult:
        """The best hit per value of `fld` (`collapse_top` at one shard).
        -> a ShardResult whose `collapse_keys` are the hits' field values."""
        node = query if isinstance(query, QueryNode) else parse_query(query, self.mappings)
        n = self.pack.num_docs
        col = self.pack.docvalues.get(fld)
        V = collapse_groups(col)
        if n == 0:
            return ShardResult(np.array([], np.int32), np.array([], np.float32), 0, None,
                               collapse_keys=[])
        scores, match = node.device_eval(self.dev, node.prepare(self.view), self.ctx)
        ok = match[:n] & self.dev["live"]
        top_s, _sh, top_d, top_g, total = collapse_top([(self.dev, scores, ok)], fld, V,
                                                       max(size + from_, 1))
        top_s, top_d, top_g, total = fetch([[(top_s, top_d, top_g, total.reshape(1))]])[0]
        valid = np.isfinite(top_s)
        end = max(size + from_, 0)
        res = ShardResult(top_d[valid][from_:end].astype(np.int32),
                          top_s[valid][from_:end].astype(np.float32), int(total[0]),
                          float(top_s[0]) if valid.any() else None)
        res.collapse_keys = collapse_keys(col, top_g[valid], V)[from_:end]
        return res

    def search_many_begin(self, requests: list[dict]) -> dict:
        """Plan and launch every request (dicts of query, size, from_ and
        optionally aggs) without copying anything back: the serving wave's
        generic lane. -> a state whose outputs `search_many_fetch` copies to
        the host in one copy and `search_many_finish` turns into
        ShardResults (running a two-pass terms agg's second pass there)."""
        outs, plans = [], []
        for r in requests:
            node = r["query"]
            if not isinstance(node, QueryNode):
                node = parse_query(node, self.mappings)
            agg_nodes, agg_params = prepare_aggs(r.get("aggs"), self.mappings, self.view)
            n = self.pack.num_docs
            if n == 0:
                outs.append(None)
                plans.append({"aggs": agg_nodes, "spec": None})
                continue
            k = min(max(r["size"] + r["from_"], 1), n)
            scores, match = node.device_eval(self.dev, node.prepare(self.view), self.ctx)
            top_v, top_i, total = top_k_with_total(scores, match, self.dev["live"], k)
            plan = {"aggs": agg_nodes, "params": agg_params, "spec": None}
            leaves = []
            if agg_nodes:
                from ..aggs import two_pass_plan

                agg_out, kept = eval_aggs(agg_nodes, agg_params, self.dev, scores, match,
                                          self.ctx)
                # the match set is kept for a second pass only
                plan["pass2"] = kept if two_pass_plan(agg_nodes) else None
                leaves, plan["spec"] = flatten_outputs(agg_out)
            outs.append((top_v, top_i, total.reshape(1), *leaves))
            plans.append(plan)
        words, layout = pack_outputs([[o] for o in outs if o is not None])
        return {"requests": requests, "outs": outs, "plans": plans, "words": words,
                "layout": layout, "host": None}

    @staticmethod
    def search_many_fetch(state: dict) -> None:
        """The one device-to-host copy of a begun batch (no tensor work)."""
        if state["words"] is not None:
            state["host"] = state["words"].cpu().numpy()

    def search_many_finish(self, state: dict) -> list[ShardResult]:
        host = iter(unpack_outputs(state["host"], state["layout"]))
        out = []
        for r, o, plan in zip(state["requests"], state["outs"], state["plans"]):
            if o is None:
                out.append(ShardResult(np.array([], np.int32), np.array([], np.float32), 0,
                                       None, {} if plan["aggs"] else None))
                continue
            top_scores, top_ids, total, *agg_leaves = next(host)
            aggregations = None
            if plan["aggs"]:
                aggregations = self._finish_aggs(plan, agg_leaves)
            valid = np.isfinite(top_scores)
            max_score = float(top_scores[0]) if valid.any() else None
            size, from_ = r["size"], r["from_"]
            end = max(size + from_, 0)
            out.append(ShardResult(top_ids[valid][from_:end].astype(np.int32),
                                   top_scores[valid][from_:end].astype(np.float32),
                                   int(total[0]), max_score, aggregations))
        return out

    def _finish_aggs(self, plan: dict, leaves: list) -> dict:
        """Host outputs of pass 1 -> the finalized aggregations. A two-pass
        terms (or paged composite) agg picks its candidates from the pass-1
        counts and runs pass 2 here, on the kept match set, with one more
        copy back (the reference's `_finalize_request`)."""
        from ..aggs import two_pass_plan

        agg_nodes, agg_params = plan["aggs"], plan["params"]
        agg_out = unflatten_outputs(plan["spec"], leaves)
        tp = two_pass_plan(agg_nodes)
        if tp:
            dev_a, seg, ok = plan["pass2"]
            outs2 = {}
            for name, a in tp.items():
                cand = torch.from_numpy(a.select_candidates(agg_out[name])).to(self.device)
                outs2[name] = a.device_eval_segmented(
                    dev_a, {**agg_params[name], "cand": cand}, seg, 1, ok, self.ctx)
            leaves2, spec2 = flatten_outputs(outs2)
            words, layout = pack_outputs([[tuple(leaves2)]])
            host2 = unpack_outputs(words.cpu().numpy(), layout)[0] if leaves2 else ()
            outs2 = unflatten_outputs(spec2, host2)
            for name in tp:
                agg_out[name] = {**agg_out[name], **outs2[name]}
        return {name: a.finalize(agg_out[name], 1)[0] for name, a in agg_nodes.items()}
