"""StackedPack: S shard packs with global statistics, stacked as [S, ...].

This package's copy of the JAX package's `parallel/stacked.py`. All shards
live in one process, so the dictionaries and statistics that scoring
reads are global (the reference's dfs_query_then_fetch semantics,
search/dfs/DfsPhase.java): idf from the summed document frequencies,
avgdl from the summed field statistics, keyword ordinals from one sorted
global term list, and dense-tier membership decided on the global df. A
per-shard decision would route terms differently on different shards and
give other scores.

Per-shard state that stays local: each shard's postings and term
dictionary. The arrays are padded to the widest shard: `n_max` docs (lanes
past a shard's own count are dead in `live`, and a postings padding lane
holds docid `n_max`, the dead slot) and `nb_max` postings blocks (padding
rows hold docid `n_max`, tf 0).

Differences from the JAX package, by design:
  - the dense tier is kept as per-shard (row, docid, tf) triples
    (`dense_parts`): at 8 x 1M docs the reference's host [S, V, n_max] f32
    array would be ~29 GB. The searcher
    derives the scored tfn rows on the device from these (as the
    reference's `refresh_dense_tfn` does from its raw rows) and keeps no raw
    tf copy there.

Completion inputs are the union of the shards' lists with shard tags,
(input, weight, shard, docid), sorted by input (reference
`stacked.py:336-344`): the completion suggester's one bisect.

Each shard pack keeps its own percolator queries and, from the build here,
`doc_sources` (each doc's source, by docid) for the host matchers: nested
queries and `more_like_this` by `_id` (reference `stacked.py:613-616`).
An ip column's global ordinals sort by address (`ip_sort_key`), as a
shard's do: the reference sorts the stacked dictionary as strings, under
which its ip range and CIDR planning on several shards bisects an
unsorted key list (ROADMAP queue C).

Positions stack as [S, nbp_max, BLOCK] int64 keys padded with POS_INF
(each shard's rows keep their own directory, `term_pos_blocks` on the
shard view); a multi-term query expands over each shard's own dictionary
(`terms_for_field`), as the reference's per-shard rewrite does.

Vectors stack as [S, n_max, D] values and [S, n_max] presence. A field's
stacked ANN index exists only when every shard holding the field built
one; the shards' tiles pad to the widest (C, L) (pad centroids 1e6, so
their probe logit never wins, pad order -1, pad codes, scale and offset
0), so every shard plans the same probe count and candidate budget.

Tiered refresh: when the pack is one tier of an index (its base, or a
tail segment), the engine sets `stats_override` to the statistics
combined over every tier, and the effective statistics (`eff_field_stats`,
`eff_global_df`) that planning and scoring read are those. `dead_count`
counts the docs whose live bit a later write cleared.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cluster.routing import shards_for_ids
from ..index.mappings import IP_TYPES, Mappings, ip_sort_key
from ..index.pack import (
    BLOCK,
    BM25_B,
    BM25_K1,
    IMPACT_QMAX,
    POS_INF,
    DocValuesColumn,
    PackBuilder,
    ShardPack,
    VectorColumn,
    default_dense_min_df,
    impact_row_terms,
    impact_term_ubf,
)

# "no searcher has derived impact codes for this pack yet": distinct from
# stats_override's None, so a fresh pack never claims to serve them
_IMPACT_UNSET = object()


@dataclass
class _ShardView:
    """ShardPack facade handing global statistics to query planning.

    `term_blocks` resolves against the shard's own postings but reports the
    global df; `field_stats` and `docvalues` come from the global (stacked)
    dictionaries, and `num_docs` is the padded width `n_max`, so every shard
    plans the same shapes and scores with the same statistics."""

    pack: ShardPack
    stacked: "StackedPack"
    shard_index: int = 0

    @property
    def num_docs(self) -> int:
        return self.stacked.n_max

    @property
    def field_stats(self) -> dict:
        return self.stacked.eff_field_stats

    @property
    def docvalues(self) -> dict:
        return self.stacked.global_docvalues

    @property
    def vectors(self) -> dict:
        return self.stacked.vectors

    @property
    def norms(self) -> dict:
        return self.pack.norms

    @property
    def text_present(self) -> dict:
        return self.pack.text_present

    def avgdl(self, fld: str) -> float:
        st = self.stacked.eff_field_stats.get(fld)
        if not st or st["doc_count"] == 0:
            return 1.0
        return st["sum_dl"] / st["doc_count"]

    def term_blocks(self, fld: str, term: str) -> tuple[int, int, int]:
        s, n, df = self.pack.term_blocks(fld, term)
        return s, n, self.stacked.eff_global_df.get((fld, term), df)

    def dense_row_of(self, fld: str, term: str) -> int | None:
        # global tier decision: the same on every shard
        return self.stacked.dense_dict.get((fld, term))

    def impact_wscale(self, fld: str, term: str) -> float | None:
        """The impact tier's dequantization scale ubf/QMAX, gated on the
        stacked serving state (a searcher derived the code blocks from the
        global statistics). 0.0, not None, for a term this shard lacks, so
        every shard plans the same shape."""
        st = self.stacked
        if not st.impact_serving():
            return None
        tid = self.pack.term_dict.get((fld, term))
        if tid is None or self.pack.impact_ubf is None:
            return 0.0
        return float(self.pack.impact_ubf[tid]) / st.impact_meta["qmax"]

    def terms_for_field(self, fld: str) -> list[str]:
        # expansion is per shard: each shard enumerates its own dictionary
        return self.pack.terms_for_field(fld)

    def term_code_buckets(self, fld: str) -> dict:
        return self.pack.term_code_buckets(fld)

    def term_pos_blocks(self, fld: str, term: str) -> tuple[int, int, int]:
        return self.pack.term_pos_blocks(fld, term)


class StackedPack:
    def __init__(self, shards: list[ShardPack], mappings: Mappings,
                 dense_min_df: int | None = None):
        self.shards = shards
        self.mappings = mappings
        self.S = len(shards)
        # the combined statistics of every tier of a tiered index (None:
        # this pack's own), and the docs a later write marked dead
        self.stats_override: dict | None = None
        self.dead_count = 0
        self.n_max = max((p.num_docs for p in shards), default=0)
        self.nb_max = max((p.post_docids.shape[0] for p in shards), default=1)

        # ---- global stats ------------------------------------------------
        self.field_stats: dict[str, dict] = {}
        for p in shards:
            for fld, st in p.field_stats.items():
                g = self.field_stats.setdefault(fld, {"sum_dl": 0.0, "doc_count": 0})
                g["sum_dl"] += st["sum_dl"]
                g["doc_count"] += st["doc_count"]
        self.global_df: dict[tuple[str, str], int] = {}
        for p in shards:
            for key, tid in p.term_dict.items():
                self.global_df[key] = self.global_df.get(key, 0) + int(p.term_df[tid])

        # completion inputs: the shards' lists with shard tags, input-sorted
        self.completion: dict[str, list] = {}
        for i, p in enumerate(shards):
            for fld, entries in p.completion.items():
                self.completion.setdefault(fld, []).extend(
                    (inp, w, i, d) for (inp, w, d) in entries)
        for entries in self.completion.values():
            entries.sort()

        # ---- global docvalue dictionaries + remapped [S, n_max] columns --
        # (keyword ordinals over one global sorted term list, their
        # multi-value pairs remapped and padded to the widest shard with doc
        # -1; int columns' global unique values and per-doc ordinals; every
        # numeric column's global min and max)
        self.global_docvalues: dict[str, DocValuesColumn] = {}
        for fld in sorted({f for p in shards for f in p.docvalues}):
            cols = [p.docvalues.get(fld) for p in shards]
            kind = next(c.kind for c in cols if c is not None)
            vals, has = [], []
            if kind == "ord":
                ft = mappings.fields.get(fld)
                terms = sorted({t for c in cols if c and c.ord_terms for t in c.ord_terms},
                               key=ip_sort_key if ft is not None and ft.type in IP_TYPES
                               else None)
                ord_of = {t: i for i, t in enumerate(terms)}
                mv_any = any(c is not None and c.mv_pair_docs is not None for c in cols)
                mv_docs, mv_ords = [], []
                for p, c in zip(shards, cols):
                    v = np.full(self.n_max, -1, np.int32)
                    h = np.zeros(self.n_max, bool)
                    if c is not None:
                        remap = np.array([ord_of[t] for t in (c.ord_terms or [])] + [-1],
                                         np.int32)
                        v[: p.num_docs] = remap[c.values]
                        h[: p.num_docs] = c.has_value
                        if c.mv_pair_docs is not None:
                            mv_docs.append(c.mv_pair_docs)
                            mv_ords.append(remap[c.mv_pair_ords])
                        else:
                            # a single-valued shard: its pairs are the
                            # (doc, value) entries of the dense column
                            sel = np.flatnonzero(c.has_value)
                            mv_docs.append(sel.astype(np.int32))
                            mv_ords.append(remap[c.values[sel]])
                    else:
                        mv_docs.append(np.array([], np.int32))
                        mv_ords.append(np.array([], np.int32))
                    vals.append(v)
                    has.append(h)
                col = DocValuesColumn(kind, np.stack(vals), np.stack(has), terms)
                if mv_any:
                    pmax = max((len(d) for d in mv_docs), default=1) or 1
                    col.mv_pair_docs = np.full((self.S, pmax), -1, np.int32)
                    col.mv_pair_ords = np.zeros((self.S, pmax), np.int32)
                    for i, (d, o) in enumerate(zip(mv_docs, mv_ords)):
                        col.mv_pair_docs[i, : len(d)] = d
                        col.mv_pair_ords[i, : len(o)] = o
            else:
                dtype = np.int64 if kind == "int" else np.float32
                present = [c.values[c.has_value] for c in cols
                           if c is not None and c.has_value.any()]
                allv = np.concatenate(present) if present else np.array([], dtype)
                for p, c in zip(shards, cols):
                    v = np.zeros(self.n_max, dtype)
                    h = np.zeros(self.n_max, bool)
                    if c is not None:
                        v[: p.num_docs] = c.values
                        h[: p.num_docs] = c.has_value
                    vals.append(v)
                    has.append(h)
                col = DocValuesColumn(kind, np.stack(vals), np.stack(has))
                if len(allv):
                    col.vmin = allv.min().item()
                    col.vmax = allv.max().item()
                if kind == "int" and len(allv):
                    uniq = np.unique(allv)
                    col.uniq_values = uniq
                    col.uniq_ords = np.full((self.S, self.n_max), -1, np.int32)
                    for i, (p, c) in enumerate(zip(shards, cols)):
                        if c is not None and c.has_value.any():
                            col.uniq_ords[i, : p.num_docs][c.has_value] = np.searchsorted(
                                uniq, c.values[c.has_value]).astype(np.int32)
            self.global_docvalues[fld] = col

        # ---- stacked postings, live docs and norms -----------------------
        self.post_docids = np.full((self.S, self.nb_max, BLOCK), self.n_max, np.int32)
        self.post_tfs = np.zeros((self.S, self.nb_max, BLOCK), np.float32)
        self.post_dls = np.ones((self.S, self.nb_max, BLOCK), np.float32)
        self.live = np.zeros((self.S, self.n_max), bool)
        for i, p in enumerate(shards):
            nb = p.post_docids.shape[0]
            d = self.post_docids[i, :nb]
            d[...] = p.post_docids
            d[d == p.num_docs] = self.n_max  # re-sentinel padding to n_max
            self.post_tfs[i, :nb] = p.post_tfs
            self.post_dls[i, :nb] = p.post_dls
            self.live[i, : p.num_docs] = p.live
        # ---- stacked position blocks (reference `stacked.py:312-323`) ------
        self.pos_keys = None
        if any(p.pos_keys is not None for p in shards):
            nbp_max = max(p.pos_keys.shape[0] for p in shards if p.pos_keys is not None)
            self.pos_keys = np.full((self.S, nbp_max, BLOCK), POS_INF, np.int64)
            for i, p in enumerate(shards):
                if p.pos_keys is not None:
                    self.pos_keys[i, : p.pos_keys.shape[0]] = p.pos_keys
        self.norms: dict[str, np.ndarray] = {}
        self.text_present: dict[str, np.ndarray] = {}
        for fld in sorted({f for p in shards for f in p.norms}):
            arr = np.ones((self.S, self.n_max), np.float32)
            pres = np.zeros((self.S, self.n_max), bool)
            for i, p in enumerate(shards):
                if fld in p.norms:
                    arr[i, : p.num_docs] = p.norms[fld]
                    pres[i, : p.num_docs] = p.text_present[fld]
            self.norms[fld] = arr
            self.text_present[fld] = pres
        self.vectors: dict[str, VectorColumn] = {
            fld: self._stack_vectors(fld) for fld in sorted({f for p in shards for f in p.vectors})}

        # ---- impact tier planning state ----------------------------------
        # per-row term field and code scale (avgdl-independent); the code
        # blocks are derived from the global statistics by the searcher
        # (StackedSearcher.refresh_impacts), which records the statistics
        # it derived them from in `_impact_basis`
        self.impact_meta = None
        self._impact_basis = _IMPACT_UNSET
        if any(len(p.term_df) for p in shards):
            dtype = next((p.impact_meta["dtype"] for p in shards
                          if p.impact_meta is not None), "uint16")
            qmax = IMPACT_QMAX[dtype]
            self.impact_fields = sorted({f for p in shards for (f, _t) in p.term_dict})
            fcode = {f: i for i, f in enumerate(self.impact_fields)}
            self.impact_row_scale_inv = np.zeros((self.S, self.nb_max), np.float32)
            self.impact_row_field = np.full((self.S, self.nb_max), -1, np.int32)
            for i, p in enumerate(shards):
                if len(p.term_df) == 0:
                    continue
                ubf = p.impact_ubf
                if ubf is None:
                    ubf = impact_term_ubf(p.term_block_start, p.block_max_tf)
                    p.impact_ubf = ubf
                rt = impact_row_terms(p.term_block_start, p.post_docids.shape[0])
                fields_by_tid = np.array(
                    [fcode[f] for (f, _t), _tid in sorted(p.term_dict.items(),
                                                          key=lambda kv: kv[1])],
                    np.int32)
                sel = rt >= 0
                rows = np.flatnonzero(sel)
                self.impact_row_scale_inv[i, rows] = qmax / np.maximum(ubf[rt[sel]], 1e-9)
                self.impact_row_field[i, rows] = fields_by_tid[rt[sel]]
            self.impact_meta = {"dtype": dtype, "qmax": qmax, "k1": BM25_K1, "b": BM25_B}

        # ---- global dense tier -------------------------------------------
        # membership by global df; each shard keeps (row, docid, tf)
        # triples of its postings in the tier
        n_total = sum(p.num_docs for p in shards)
        thresh = dense_min_df if dense_min_df is not None else default_dense_min_df(n_total)
        dense_keys = sorted(k for k, df in self.global_df.items() if df >= thresh)
        self.dense_dict: dict[tuple[str, str], int] = {k: i for i, k in enumerate(dense_keys)}
        self.dense_fields: list[str] = [k[0] for k in dense_keys]
        self._dense_parts: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        if dense_keys:
            for p in shards:
                rows_l, docs_l, tfs_l = [], [], []
                for i, (fld, term) in enumerate(dense_keys):
                    s0, nb, _df = p.term_blocks(fld, term)
                    if nb == 0:
                        continue
                    docs = p.post_docids[s0: s0 + nb].ravel()
                    valid = docs < p.num_docs
                    docs_l.append(docs[valid])
                    tfs_l.append(p.post_tfs[s0: s0 + nb].ravel()[valid])
                    rows_l.append(np.full(len(docs_l[-1]), i, np.int32))
                cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
                self._dense_parts.append((cat(rows_l, np.int32), cat(docs_l, np.int32),
                                          cat(tfs_l, np.float32)))

    def _stack_vectors(self, fld: str) -> VectorColumn:
        """One dense_vector field over the shards (reference
        `stacked.py:345-390`): [S, n_max, D] values, [S, n_max] presence,
        and the ANN tiles padded to the widest (C, L) when every shard that
        holds the field built them."""
        cols = [p.vectors.get(fld) for p in self.shards]
        vc0 = next(c for c in cols if c is not None)
        D = vc0.dims
        vals = np.zeros((self.S, self.n_max, D), np.float32)
        has = np.zeros((self.S, self.n_max), bool)
        for i, (p, c) in enumerate(zip(self.shards, cols)):
            if c is not None:
                vals[i, : p.num_docs] = c.values
                has[i, : p.num_docs] = c.has_value
        svc = VectorColumn(vals, has, vc0.similarity, D, ann_quant=vc0.ann_quant)
        anns = [c.ann for c in cols if c is not None]
        if anns and all(a is not None for a in anns):
            C = max(a["centroids"].shape[0] for a in anns)
            L = max(a["tile"] for a in anns)
            cents = np.full((self.S, C, D), 1e6, np.float32)
            order = np.full((self.S, C, L), -1, np.int32)
            codes = np.zeros((self.S, C, L, D), np.int8)
            scale = np.zeros((self.S, C, L), np.float32)
            offset = np.zeros((self.S, C, L), np.float32)
            for i, c in enumerate(cols):
                if c is None:
                    continue
                a = c.ann
                ci, li = a["order"].shape
                cents[i, :ci] = a["centroids"]
                order[i, :ci, :li] = a["order"]
                codes[i, :ci, :li] = a["codes"]
                scale[i, :ci, :li] = a["scale"]
                offset[i, :ci, :li] = a["offset"]
            svc.ann = {"centroids": cents, "order": order, "codes": codes, "scale": scale,
                       "offset": offset, "nlist": C, "tile": L,
                       "built_n": max(a["built_n"] for a in anns)}
        return svc

    # ---- dense tier ------------------------------------------------------

    @property
    def dense_v(self) -> int:
        """Dense-tier row count (0 = no tier)."""
        return len(self.dense_dict)

    def dense_parts(self, s: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (tier row [P] i32, docid [P] i32, tf [P] f32) of shard s's
        postings in the dense tier."""
        return self._dense_parts[s]

    @property
    def dense_tf(self) -> np.ndarray | None:
        """[S, V, n_max] f32 raw tf rows of every shard, the reference's
        host tier (materialized on each call; for small packs)."""
        if not self.dense_v:
            return None
        out = np.zeros((self.S, self.dense_v, self.n_max), np.float32)
        for s, (rows, docs, tfs) in enumerate(self._dense_parts):
            out[s, rows, docs] = tfs
        return out

    # ---- serving state ---------------------------------------------------

    def impact_serving(self) -> bool:
        """A searcher derived the resident impact code blocks from the
        current effective statistics (`refresh_impacts` ran after the last
        `stats_override` change): the planning gate of the impact arm. A
        stale basis plans the exact postings path, never wrong scores."""
        return self.impact_meta is not None and self._impact_basis is self.stats_override

    @property
    def eff_field_stats(self) -> dict:
        if self.stats_override is not None:
            return self.stats_override["field_stats"]
        return self.field_stats

    @property
    def eff_global_df(self) -> dict:
        if self.stats_override is not None:
            return self.stats_override["global_df"]
        return self.global_df

    @property
    def num_docs(self) -> int:
        return sum(p.num_docs for p in self.shards)

    def terms_for_field(self, fld: str) -> list[str]:
        """The sorted union of every shard's terms of one field (a phrase
        prefix's global expansions), cached per field."""
        cache = self.__dict__.setdefault("_field_terms", {})
        if fld not in cache:
            cache[fld] = sorted({t for p in self.shards for t in p.terms_for_field(fld)})
        return cache[fld]

    def shard_view(self, s: int) -> _ShardView:
        return _ShardView(self.shards[s], self, s)

    def nbytes(self) -> int:
        """Bytes a StackedSearcher holds on its device for this pack: the
        stacked postings and position keys, live docs, norms and docvalues, the impact codes
        and the scored dense tier derived there, and the split-bf16 (hi, lo)
        copy of that tier that the fused arm adds."""
        arrays = [self.post_docids, self.post_tfs, self.post_dls, self.live]
        arrays += list(self.norms.values()) + list(self.text_present.values())
        if self.pos_keys is not None:
            arrays.append(self.pos_keys)
        total = sum(a.nbytes for a in arrays)
        for col in self.global_docvalues.values():
            # ordinals widen to int64 on the device
            total += col.values.size * (8 if col.kind == "ord" else col.values.itemsize)
            total += col.has_value.nbytes
            total += sum(a.nbytes for a in (col.uniq_ords, col.mv_pair_docs, col.mv_pair_ords)
                         if a is not None)
        lanes = self.S * self.nb_max * BLOCK
        if self.impact_meta is not None:
            total += lanes * (2 if self.impact_meta["dtype"] == "uint16" else 1)
        tier = self.S * self.dense_v * self.n_max
        for vc in self.vectors.values():
            # values, presence, and the squared norms summed at upload
            total += vc.values.nbytes + vc.has_value.nbytes + vc.has_value.size * 4
            if vc.ann is not None:
                a = vc.ann
                total += sum(a[k].nbytes for k in ("centroids", "order", "codes", "scale",
                                                   "offset"))
                # ann_to_device's split-bf16 hi/lo pair and per-slot norms
                total += a["codes"].size * 4 + a["order"].size * 4
        return int(total + tier * 4 + tier * 2 * 2)


def route_docs(docs: list[tuple[str, dict]], num_shards: int) -> list[list[tuple[str, dict]]]:
    """Murmur3-route (id, source) docs to per-shard lists, each in input
    order: the one source of doc -> shard placement for pack building and
    hit resolution."""
    routed: list[list[tuple[str, dict]]] = [[] for _ in range(num_shards)]
    shards = shards_for_ids([doc_id for doc_id, _src in docs], num_shards).tolist()
    for s, doc in zip(shards, docs):
        routed[s].append(doc)
    return routed


def _ingest_shard(shard_docs: list[tuple[str, dict]], mappings: Mappings, parsed: bool,
                  device=None) -> PackBuilder:
    """One shard's docs parsed (unless `parsed`) and analyzed into a
    builder on `device` (`PackBuilder`'s route)."""
    docs = shard_docs if parsed else [(i, mappings.parse_document(src)) for i, src in shard_docs]
    b = PackBuilder(mappings, device=device)
    b.add_documents_batch([p for _, p in docs], doc_ids=[i for i, _ in docs])
    return b


def _build_overlapped(routed, mappings: Mappings, parsed: bool, device) -> list:
    """The shards' packs built one after another, shard k+1 analyzed on a
    worker thread while shard k builds (the reference's depth-1 overlap,
    `stacked.py:541-612`). The worker's time is an async span of the
    profiled refresh (`note_span`); its exception is raised here."""
    import threading
    import time

    from ..monitoring.refresh_profile import active_collector, refresh_stage

    coll = active_collector()

    def spawn(s: int):
        box: dict = {}

        def run():
            t0 = time.perf_counter()
            try:
                box["builder"] = _ingest_shard(routed[s], mappings, parsed, device)
            except BaseException as ex:  # noqa: BLE001 - raised on join
                box["error"] = ex
            finally:
                if coll is not None:
                    coll.note_span("build.analyze", t0, time.perf_counter())

        th = threading.Thread(target=run, daemon=True, name=f"analyze-shard-{s}")
        th.start()
        return th, box

    with refresh_stage("analyze"):
        builder = _ingest_shard(routed[0], mappings, parsed, device)
    packs = []
    pending = None
    try:
        for s in range(len(routed)):
            pending = spawn(s + 1) if s + 1 < len(routed) else None
            packs.append(builder.build(dense_min_df=1 << 62))
            builder = None
            if pending is not None:
                th, box = pending
                with refresh_stage("analyze"):  # the wait for the worker's analysis
                    th.join()
                pending = None
                if "error" in box:
                    raise box["error"]
                builder = box["builder"]
    finally:
        if pending is not None:
            pending[0].join()
    return packs


def build_stacked_pack_routed(routed: list[list[tuple[str, dict]]], mappings: Mappings,
                              dense_min_df: int | None = None, *, parsed: bool = False,
                              device=None, sources: list | None = None) -> StackedPack:
    """Pack each shard's (id, source) list and stack them. `parsed`: the
    lists hold `Mappings.parse_document` output instead of sources, and
    `sources` (per shard, the docs' sources) gives each pack its
    `doc_sources`.
    `device` is each shard builder's (`PackBuilder`: the card's route for
    the stages it admits; None or "cpu": the host route; the ANN build runs
    there, None meaning the card). The shards build in this process, one
    after another, shard k+1 analyzed on a thread while shard k builds."""
    from ..monitoring.refresh_profile import refresh_stage

    packs = _build_overlapped(routed, mappings, parsed, device)
    if sources is None and not parsed:
        sources = [[src for _i, src in lst] for lst in routed]
    for p, src in zip(packs, sources or ()):
        p.doc_sources = list(src)
    with refresh_stage("stack"):
        return StackedPack(packs, mappings, dense_min_df=dense_min_df)


def build_stacked_pack(docs: list[tuple[str, dict]], mappings: Mappings, num_shards: int,
                       dense_min_df: int | None = None, device=None) -> StackedPack:
    """Route (id, source) docs to shards by murmur3, as the reference does,
    and pack each shard."""
    return build_stacked_pack_routed(route_docs(docs, num_shards), mappings,
                                     dense_min_df=dense_min_df, device=device)
