"""Device-resident index pack: blocked-CSR postings + columnar DocValues.

The replacement for Lucene's segment format (reference behavior: Lucene 9
postings/doc-values read through ES's codec layer), laid out exactly as the
JAX package's `index/pack.py` lays it out, array for array:

- Postings are fixed BLOCK=128-lane rows in `post_docids`/`post_tfs`/
  `post_dls` [num_blocks, BLOCK], with the CSR directory
  `term_block_start[T+1]` mapping term id -> row range. Row 0 is an
  all-padding block. Padding lanes hold docid `num_docs` (the dead slot of
  every score accumulator), tf 0 and doc length 1.
- Per-block `block_max_tf` / `block_min_len` (block-max metadata).
- Norms hold the dequantized Lucene 1-byte doc length (smallfloat.py), so
  BM25 matches a CPU Elasticsearch bit for bit.
- DocValues are plain columns: int64 / float32 values + presence, or
  sorted-ordinal int32 + the host-side sorted term list for keywords.
- The dense tier: terms with df >= dense_min_df also get a precomputed
  tf/(tf + K) row of a [V_dense (padded to 128), N] f32 matrix, scored
  elementwise with no gather or scatter.
- The impact tier (BM25S): every posting's BM25 tf part quantized to a
  uint16 or int8 code aligned with `post_docids`, so the batched sparse arm
  is a pure gather + one multiply (see the error model below).
- Dense vectors are a row-major [N, dims] float32 matrix per field, with
  the IVF ANN index (`ann.build_ann`) when the mapping asks for one.

The builder keeps every token as an integer code in flat arrays, and
`build()` assembles the CSR with numpy sorts: no Python loop runs per
posting, so a million-document corpus packs in seconds. The impact codes
are built on the host with numpy; the ANN index's k-means and tile packing
run on the builder's device. Positions are not ported yet.
"""

from __future__ import annotations

from array import array
from dataclasses import dataclass, field as dc_field

import numpy as np

from .mappings import (
    FLOAT_TYPES,
    INT_TYPES,
    KEYWORD_TYPES,
    TEXT_TYPES,
    VECTOR_TYPES,
    Mappings,
)
from .smallfloat import quantize_lengths

BLOCK = 128  # postings lanes per block row

# BM25 defaults baked into dense-tier tfn rows (reference behavior:
# index/similarity/SimilarityService.java:43-58 — BM25 k1=1.2, b=0.75)
BM25_K1 = 1.2
BM25_B = 0.75


# ---------------------------------------------------------------------------
# impact-scored sparse tier (BM25S, https://arxiv.org/pdf/2407.03618):
# per-(term, doc) BM25 contributions precomputed at index time and
# quantized to compact integer codes, so query time is a pure gather + one
# multiply over code blocks, with no tf / doc-length / avgdl math.
#
#   impact(t, d) = idf(t) · tfn(t, d),  tfn = tf / (tf + K(dl, avgdl))
#   code(t, d)   = round(tfn / ubf(t) · QMAX) ∈ [1, QMAX] for tf > 0
#   ubf(t)       = max_tf / (max_tf + k1·(1 − b)): tfn's upper bound over
#                  any doc length, so codes never clip as avgdl drifts
#   score(t, d)  = boost · idf(t) · ubf(t) / QMAX · code(t, d)
#
# Error model: per query term the absolute score error is at most
# boost · idf · ubf / QMAX (codes round to the nearest level; the clamp to
# code >= 1 that keeps every posting a match can round a sub-half-level
# impact up by at most one level). Per-doc error is the sum over the
# query's impact-served terms. uint16 keeps it below f32 tie noise; int8 is
# the compact, coarse alternative.
# ---------------------------------------------------------------------------

IMPACT_QMAX = {"uint16": 65535, "int8": 127}
_IMPACT_NP_DTYPE = {"uint16": np.uint16, "int8": np.int8}


def impact_term_ubf(term_block_start: np.ndarray, block_max_tf: np.ndarray,
                    k1: float = BM25_K1, b: float = BM25_B) -> np.ndarray:
    """[T] per-term tfn upper bound mtf/(mtf + k1·(1−b)) from the pack's
    block-max metadata: avgdl-independent."""
    T = len(term_block_start) - 1
    if T <= 0:
        return np.zeros(0, np.float32)
    # every term owns >= 1 contiguous block row, so reduceat is exact
    mtf = np.maximum.reduceat(block_max_tf, term_block_start[:-1])
    return (mtf / np.maximum(mtf + k1 * (1.0 - b), 1e-9)).astype(np.float32)


def impact_row_terms(term_block_start: np.ndarray,
                     total_blocks: int) -> np.ndarray:
    """[total_blocks] term id of each postings block row (-1 for the
    reserved padding row 0 / rows past the directory)."""
    out = np.full(total_blocks, -1, np.int32)
    T = len(term_block_start) - 1
    if T > 0:
        counts = term_block_start[1:] - term_block_start[:-1]
        out[term_block_start[0]: term_block_start[T]] = np.repeat(
            np.arange(T, dtype=np.int32), counts)
    return out


def impact_row_params(
    row_terms: np.ndarray,  # [nb] int32 (-1 = padding)
    term_ubf: np.ndarray,  # [T] f32
    field_of_term: np.ndarray,  # [T] int
    avgdl_of_field: np.ndarray,  # [F] f64
    has_norms_of_field: np.ndarray,  # [F] bool
    qmax: int,
    k1: float = BM25_K1,
    b: float = BM25_B,
):
    """-> (k_base [nb], k_slope [nb], scale_inv [nb]) f32 per-row code
    parameters: K(dl) = k_base + k_slope·dl, code = tfn·scale_inv."""
    t = row_terms
    safe_t = np.maximum(t, 0)
    fcode = field_of_term[safe_t]
    hn = has_norms_of_field[fcode] & (t >= 0)
    k_base = np.where(hn, k1 * (1.0 - b), k1).astype(np.float32)
    k_slope = np.where(
        hn, k1 * b / np.maximum(avgdl_of_field[fcode], 1e-9), 0.0
    ).astype(np.float32)
    scale_inv = np.where(
        t >= 0, qmax / np.maximum(term_ubf[safe_t], 1e-9), 0.0
    ).astype(np.float32)
    return k_base, k_slope, scale_inv


def impact_codes_host(post_tfs: np.ndarray, post_dls: np.ndarray,
                      k_base: np.ndarray, k_slope: np.ndarray,
                      scale_inv: np.ndarray, qmax: int,
                      dtype: str) -> np.ndarray:
    """Quantized impact codes. Shapes broadcast: per-row params [..., nb]
    against blocked lanes [..., nb, BLOCK]."""
    K = k_base[..., None] + k_slope[..., None] * post_dls
    tfn = post_tfs / (post_tfs + K)  # tf == 0 padding -> 0
    q = np.rint(tfn * scale_inv[..., None])
    q = np.clip(q, 1, qmax)  # tf > 0 must stay a match (code >= 1)
    q = np.where(post_tfs > 0, q, 0)
    return q.astype(_IMPACT_NP_DTYPE[dtype])


def default_dense_min_df(n_docs: int) -> int:
    """df threshold above which a term moves to the dense tier. ~1 posting
    per 2 doc-chunks: dense rows then cost at most ~2x their CSR form."""
    return max(64, n_docs // 256)


@dataclass
class DocValuesColumn:
    kind: str  # "int" | "float" | "ord"
    values: np.ndarray  # [N] int64 | float32 | int32 ordinals (-1 = missing)
    has_value: np.ndarray  # [N] bool
    ord_terms: list[str] | None = None  # sorted terms for kind == "ord"


@dataclass
class VectorColumn:
    values: np.ndarray  # [N, dims] float32
    has_value: np.ndarray  # [N] bool
    similarity: str  # cosine | dot_product | l2_norm | max_inner_product
    dims: int
    # the IVF ANN index (ann.build_ann output: partitions packed into
    # padded cluster tiles + the int8 tier), when the mapping asks for one
    ann: dict | None = None
    ann_quant: str = "int8"  # selection-scan tier of the ANN path


@dataclass
class ShardPack:
    """Immutable packed index for one shard (host-side numpy form)."""

    num_docs: int
    post_docids: np.ndarray  # [num_blocks, BLOCK] int32; pad = num_docs
    post_tfs: np.ndarray  # [num_blocks, BLOCK] float32; pad = 0
    post_dls: np.ndarray  # [num_blocks, BLOCK] float32 doc length; pad = 1
    term_block_start: np.ndarray  # [T+1] int32 (row ranges; row 0 reserved)
    term_df: np.ndarray  # [T] int32
    block_max_tf: np.ndarray  # [num_blocks] float32
    block_min_len: np.ndarray  # [num_blocks] float32
    term_dict: dict[tuple[str, str], int]  # (field, term) -> tid, sorted
    norms: dict[str, np.ndarray]  # text field -> [N] float32 lengths
    text_present: dict[str, np.ndarray]  # text field -> [N] bool
    field_stats: dict[str, dict]  # field -> {sum_dl, doc_count}
    docvalues: dict[str, DocValuesColumn]
    live: np.ndarray  # [N] bool
    dense_tfn: np.ndarray | None = None  # [V_dense padded, N] float32
    dense_dict: dict[tuple[str, str], int] = dc_field(default_factory=dict)
    # impact tier: codes aligned with post_docids, per-term tfn bounds and
    # the quantization contract {"dtype", "qmax", "k1", "b"}; None = tier
    # absent (the batched arms then score the raw postings)
    impact_codes: np.ndarray | None = None  # [num_blocks, BLOCK] u16 | i8
    impact_ubf: np.ndarray | None = None  # [T] f32
    impact_meta: dict | None = None
    vectors: dict[str, VectorColumn] = dc_field(default_factory=dict)

    @property
    def num_terms(self) -> int:
        return len(self.term_df)

    def avgdl(self, fld: str) -> float:
        st = self.field_stats.get(fld)
        if not st or st["doc_count"] == 0:
            return 1.0
        return st["sum_dl"] / st["doc_count"]

    def dense_row_of(self, fld: str, term: str) -> int | None:
        return self.dense_dict.get((fld, term))

    def term_blocks(self, fld: str, term: str) -> tuple[int, int, int]:
        """-> (block_row_start, n_blocks, df); (0, 0, 0) when term absent."""
        tid = self.term_dict.get((fld, term))
        if tid is None:
            return 0, 0, 0
        s = int(self.term_block_start[tid])
        e = int(self.term_block_start[tid + 1])
        return s, e - s, int(self.term_df[tid])

    def impact_wscale(self, fld: str, term: str) -> float | None:
        """ubf(t)/QMAX: the per-term dequantization scale of the impact
        tier; the query-time term weight is boost · idf · this. None when
        the tier is absent or the term unknown."""
        if (self.impact_codes is None or self.impact_meta is None
                or self.impact_ubf is None):
            return None
        tid = self.term_dict.get((fld, term))
        if tid is None:
            return None
        return float(self.impact_ubf[tid]) / self.impact_meta["qmax"]

    def nbytes(self) -> int:
        """Bytes of the arrays that `query.executor.pack_to_device` uploads."""
        arrays = [self.post_docids, self.post_tfs, self.post_dls, self.live]
        arrays += list(self.norms.values()) + list(self.text_present.values())
        for col in self.docvalues.values():
            arrays += [col.values, col.has_value]
        if self.dense_tfn is not None:
            arrays.append(self.dense_tfn)
        if self.impact_codes is not None:
            arrays.append(self.impact_codes)
        for vc in self.vectors.values():
            arrays += [vc.values, vc.has_value]
            if vc.ann is not None:
                arrays += [vc.ann[k] for k in ("centroids", "order", "codes", "scale", "offset")]
        return int(sum(a.nbytes for a in arrays))


class _Vocab(dict):
    """term -> code, assigning the next code to an unseen term."""

    def __missing__(self, key):
        code = self[key] = len(self)
        return code


class _FieldTokens:
    """Flat token stream of one indexed field: term codes and the local
    docid of each token (tf = tokens per (term, doc))."""

    __slots__ = ("vocab", "codes", "docs")

    def __init__(self):
        self.vocab = _Vocab()
        self.codes = array("i")
        self.docs = array("i")


class PackBuilder:
    """Accumulates parsed documents for one shard, then packs.

    The mutable form plays the role of Lucene's IndexWriter RAM buffer;
    `build()` is the refresh that produces an immutable searchable pack.
    `impact_dtype` ("uint16" or "int8") is the impact codes' storage type.
    """

    def __init__(self, mappings: Mappings, impact_dtype: str = "uint16"):
        if impact_dtype not in IMPACT_QMAX:
            raise ValueError(f"impact_dtype must be one of {sorted(IMPACT_QMAX)}, "
                             f"got [{impact_dtype}]")
        self.mappings = mappings
        self.impact_dtype = impact_dtype
        self.num_docs = 0
        self._tokens: dict[str, _FieldTokens] = {}
        # text field -> ([docid], [length]) for docs where the field exists
        self._lengths: dict[str, tuple[array, array]] = {}
        # keyword field -> docs with >= 1 indexed value (idf docCount)
        self._kw_doc_count: dict[str, int] = {}
        # docvalue field -> ([docid], [first value])
        self._dv_raw: dict[str, tuple[list, list]] = {}
        # dense_vector field -> [(docid, components)]
        self.vector_raw: dict[str, list[tuple[int, list[float]]]] = {}

    def _field_tokens(self, fld: str) -> _FieldTokens:
        ft = self._tokens.get(fld)
        if ft is None:
            ft = self._tokens[fld] = _FieldTokens()
        return ft

    def add_document(self, parsed: dict[str, list], doc_id: str | None = None) -> int:
        """parsed = Mappings.parse_document output; returns the local docid.
        doc_id, when given, is stored in the reserved `_id` ordinal column
        (ids/term-on-_id queries run on the device)."""
        docid = self.num_docs
        self.num_docs += 1
        if doc_id is not None:
            self._dv_append("_id", docid, str(doc_id))
        for fld, values in parsed.items():
            ft = self.mappings.fields.get(fld)
            if ft is None:
                continue
            t = ft.type
            if t in TEXT_TYPES:
                if not ft.index:
                    continue
                analyzer = ft.get_analyzer()
                toks = self._field_tokens(fld)
                length = 0
                for v in values:
                    terms = analyzer.terms(v)
                    toks.codes.extend(map(toks.vocab.__getitem__, terms))
                    length += len(terms)
                toks.docs.extend([docid] * length)
                docs, lens = self._lengths.setdefault(fld, (array("i"), array("q")))
                docs.append(docid)
                lens.append(length)
            elif t in KEYWORD_TYPES:
                kept = [v for v in values
                        if ft.ignore_above is None or len(v) <= ft.ignore_above]
                if ft.index and kept:
                    uniq = set(kept)
                    toks = self._field_tokens(fld)
                    toks.codes.extend(map(toks.vocab.__getitem__, uniq))
                    toks.docs.extend([docid] * len(uniq))
                    self._kw_doc_count[fld] = self._kw_doc_count.get(fld, 0) + 1
                if ft.doc_values and kept:
                    self._dv_append(fld, docid, kept[0])
            elif t in INT_TYPES:
                if ft.doc_values and values:
                    self._dv_append(fld, docid, int(values[0]))
            elif t in FLOAT_TYPES:
                if ft.doc_values and values:
                    self._dv_append(fld, docid, float(values[0]))
            elif t in VECTOR_TYPES and values:
                if len(values) != ft.dims:
                    from ..utils.errors import MapperParsingError

                    raise MapperParsingError(
                        f"dense_vector [{fld}] has {len(values)} dims, mapping says {ft.dims}")
                self.vector_raw.setdefault(fld, []).append((docid, [float(x) for x in values]))
        return docid

    def add_documents_batch(self, parsed_docs: list[dict],
                            doc_ids: list | None = None) -> list[int]:
        """Add a burst of parsed documents; returns their local docids.
        Tokens land in the flat per-field code arrays, and `build()` turns
        them into the CSR with numpy sorts."""
        if doc_ids is None:
            doc_ids = [None] * len(parsed_docs)
        return [self.add_document(p, doc_id=d)
                for p, d in zip(parsed_docs, doc_ids)]

    def _dv_append(self, fld: str, docid: int, value) -> None:
        docs, vals = self._dv_raw.setdefault(fld, ([], []))
        docs.append(docid)
        vals.append(value)

    # ---- packing ---------------------------------------------------------

    def _flat_csr(self, N: int):
        """-> (sorted (field, term) keys, term_dict, post_offsets [T+1],
        flat_docs, flat_tfs): each term's postings docid-ascending, terms
        in key order."""
        fields = sorted(self._tokens)
        keys = sorted((f, t) for f in fields for t in self._tokens[f].vocab)
        term_dict = {k: i for i, k in enumerate(keys)}
        T = len(keys)
        parts = []
        for f in fields:
            toks = self._tokens[f]
            if not len(toks.codes):
                continue
            # code -> global tid (vocab iterates in code order)
            tid_of_code = np.fromiter(
                (term_dict[(f, t)] for t in toks.vocab), np.int64,
                count=len(toks.vocab))
            codes = np.frombuffer(toks.codes, np.int32)
            docs = np.frombuffer(toks.docs, np.int32)
            parts.append(tid_of_code[codes] * N + docs)
        if parts:  # tokens exist, so N >= 1
            # one sort groups tokens by (tid, doc); each run is one posting
            uk, tf = np.unique(np.concatenate(parts), return_counts=True)
            tid = uk // N
            flat_docs = (uk - tid * N).astype(np.int32)
            flat_tfs = tf.astype(np.float32)
            df = np.bincount(tid, minlength=T)
        else:
            flat_docs = np.zeros(0, np.int32)
            flat_tfs = np.zeros(0, np.float32)
            df = np.zeros(T, np.int64)
        post_offsets = np.zeros(T + 1, np.int64)
        np.cumsum(df, out=post_offsets[1:])
        return keys, term_dict, post_offsets, flat_docs, flat_tfs

    def build(self, dense_min_df: int | None = None, device=None) -> ShardPack:
        """Pack the documents. `device` runs the ANN index's k-means and
        tile packing (None: the CUDA card, which a pack without an ANN
        index never asks for); the rest is host numpy."""
        N = self.num_docs
        if dense_min_df is None:
            dense_min_df = default_dense_min_df(N)
        keys, term_dict, post_offsets, flat_docs, flat_tfs = self._flat_csr(N)
        T = len(keys)

        # ---- norms (quantized doc lengths) + field stats -----------------
        norms: dict[str, np.ndarray] = {}
        text_present: dict[str, np.ndarray] = {}
        field_stats: dict[str, dict] = {}
        for fld, (docs_a, lens_a) in self._lengths.items():
            docs = np.frombuffer(docs_a, np.int32)
            lens = np.frombuffer(lens_a, np.int64)
            lengths = np.zeros(N, dtype=np.int64)
            present = np.zeros(N, dtype=bool)
            lengths[docs] = lens
            present[docs] = True
            norms[fld] = quantize_lengths(lengths)
            text_present[fld] = present
            # Lucene avgdl = sumTotalTermFreq / docCount, where docCount
            # counts docs with at least one term (Terms.getDocCount)
            field_stats[fld] = {"sum_dl": float(lengths.sum()),
                                "doc_count": int(np.count_nonzero(lens > 0))}
        # norm-less indexed fields (keyword) still need docCount for idf
        for fld, cnt in self._kw_doc_count.items():
            if fld not in field_stats:
                field_stats[fld] = {"sum_dl": 0.0, "doc_count": cnt}

        # ---- blocked postings (segment scatter from the flat CSR) --------
        NP = len(flat_docs)
        df = post_offsets[1:] - post_offsets[:-1]
        term_df = df.astype(np.int32)
        nblk = (df + BLOCK - 1) // BLOCK
        row_base = np.empty(T + 1, dtype=np.int64)
        row_base[0] = 1  # row 0 reserved all-padding
        row_base[1:] = 1 + np.cumsum(nblk)
        total_blocks = int(row_base[-1]) if T else 1
        term_block_start = row_base.astype(np.int32)
        field_names = sorted({k[0] for k in keys})
        fld_code = {f: i for i, f in enumerate(field_names)}
        field_of_term = np.fromiter((fld_code[k[0]] for k in keys), np.int64, count=T)
        post_docids = np.full((total_blocks, BLOCK), N, dtype=np.int32)
        post_tfs = np.zeros((total_blocks, BLOCK), dtype=np.float32)
        post_dls = np.ones((total_blocks, BLOCK), dtype=np.float32)
        block_max_tf = np.zeros(total_blocks, dtype=np.float32)
        block_min_len = np.full(total_blocks, np.inf, dtype=np.float32)
        term_of_post = np.repeat(np.arange(T), df)
        post_dl_flat = np.ones(NP, dtype=np.float32)  # 1.0 for norm-less fields
        if NP:
            local = np.arange(NP, dtype=np.int64) - np.repeat(post_offsets[:-1], df)
            dest_row = row_base[:-1][term_of_post] + local // BLOCK
            dest_col = local % BLOCK
            fop = field_of_term[term_of_post]
            for f, nrm in norms.items():
                code = fld_code.get(f)
                if code is None:
                    continue
                sel = fop == code
                if sel.any():
                    post_dl_flat[sel] = nrm[flat_docs[sel]]
            post_docids[dest_row, dest_col] = flat_docs
            post_tfs[dest_row, dest_col] = flat_tfs
            post_dls[dest_row, dest_col] = post_dl_flat
            # flat order is block-contiguous: reduceat over block starts
            starts = np.flatnonzero(np.diff(dest_row, prepend=-1))
            block_rows = dest_row[starts]
            block_max_tf[block_rows] = np.maximum.reduceat(flat_tfs, starts)
            block_min_len[block_rows] = np.minimum.reduceat(post_dl_flat, starts)
        block_min_len[~np.isfinite(block_min_len)] = 1.0

        # ---- docvalues ---------------------------------------------------
        docvalues: dict[str, DocValuesColumn] = {}
        for fld, (docs_l, vals_l) in self._dv_raw.items():
            ftype = "keyword" if fld == "_id" else self.mappings.fields[fld].type
            docs = np.asarray(docs_l, np.int64)
            has = np.zeros(N, dtype=bool)
            has[docs] = True
            if ftype in KEYWORD_TYPES:
                terms_sorted = sorted(set(vals_l))
                ord_of = {t: i for i, t in enumerate(terms_sorted)}
                vals = np.full(N, -1, dtype=np.int32)
                vals[docs] = np.fromiter(map(ord_of.__getitem__, vals_l),
                                         np.int32, count=len(vals_l))
                docvalues[fld] = DocValuesColumn("ord", vals, has, terms_sorted)
            elif ftype in FLOAT_TYPES:
                vals = np.zeros(N, dtype=np.float32)
                vals[docs] = np.asarray(vals_l, np.float32)
                docvalues[fld] = DocValuesColumn("float", vals, has)
            else:
                vals = np.zeros(N, dtype=np.int64)
                vals[docs] = np.asarray(vals_l, np.int64)
                docvalues[fld] = DocValuesColumn("int", vals, has)

        # per-field scoring constants, indexed by field code (the impact and
        # dense tiers share them)
        avgdl_of_field = np.ones(len(field_names), dtype=np.float64)
        has_norms_of_field = np.zeros(len(field_names), dtype=bool)
        for f, code in fld_code.items():
            st = field_stats.get(f, {"sum_dl": 0.0, "doc_count": 0})
            avgdl_of_field[code] = (st["sum_dl"] / max(st["doc_count"], 1)) or 1.0
            has_norms_of_field[code] = f in norms

        # ---- impact tier (BM25S): quantized per-posting contributions ----
        impact_codes = impact_ubf = impact_meta = None
        if T:
            qmax = IMPACT_QMAX[self.impact_dtype]
            impact_ubf = impact_term_ubf(term_block_start, block_max_tf)
            k_base, k_slope, scale_inv = impact_row_params(
                impact_row_terms(term_block_start, total_blocks), impact_ubf,
                field_of_term, avgdl_of_field, has_norms_of_field, qmax)
            impact_codes = impact_codes_host(post_tfs, post_dls, k_base, k_slope,
                                             scale_inv, qmax, self.impact_dtype)
            impact_meta = {"dtype": self.impact_dtype, "qmax": qmax,
                           "k1": BM25_K1, "b": BM25_B}

        # ---- dense tier (vectorized over all dense postings) -------------
        dense_ids = np.flatnonzero(df >= dense_min_df)
        dense_keys = [keys[i] for i in dense_ids]
        dense_dict = {k: i for i, k in enumerate(dense_keys)}
        dense_tfn = None
        if dense_keys:
            # rows padded to a multiple of 128; padding rows stay all-zero
            v_pad = -len(dense_keys) % 128
            dense_tfn = np.zeros((len(dense_keys) + v_pad, N), dtype=np.float32)
            dense_rank = np.full(T, -1, dtype=np.int64)
            dense_rank[dense_ids] = np.arange(len(dense_ids))
            dmask = dense_rank[term_of_post] >= 0
            rows = dense_rank[term_of_post[dmask]]
            cols = flat_docs[dmask]
            tfs_d = flat_tfs[dmask]
            dls_d = post_dl_flat[dmask]
            fcode = field_of_term[term_of_post[dmask]]
            # K in float64, rounded to f32 once: the reference's host tier
            K = np.where(
                has_norms_of_field[fcode],
                BM25_K1 * (1.0 - BM25_B + BM25_B * dls_d / avgdl_of_field[fcode]),
                BM25_K1,
            )
            dense_tfn[rows, cols] = (tfs_d / (tfs_d + K)).astype(np.float32)

        # ---- vectors ------------------------------------------------------
        vectors: dict[str, VectorColumn] = {}
        for fld, pairs in self.vector_raw.items():
            ft = self.mappings.fields[fld]
            vals = np.zeros((N, ft.dims), dtype=np.float32)
            has = np.zeros(N, dtype=bool)
            docs = np.fromiter((d for d, _ in pairs), np.int64, count=len(pairs))
            vals[docs] = np.asarray([v for _, v in pairs], np.float32)
            has[docs] = True
            vc = VectorColumn(vals, has, ft.similarity, ft.dims, ann_quant=ft.ann_quant)
            if ft.ann_nlist is not None:
                from ..ann import build_ann

                nlist = ft.ann_nlist or max(1, int(has.sum() ** 0.5))
                vc.ann = build_ann(vals, has, nlist, device=device)
            vectors[fld] = vc

        return ShardPack(
            num_docs=N,
            post_docids=post_docids,
            post_tfs=post_tfs,
            post_dls=post_dls,
            term_block_start=term_block_start,
            term_df=term_df,
            block_max_tf=block_max_tf,
            block_min_len=block_min_len,
            term_dict=term_dict,
            norms=norms,
            text_present=text_present,
            field_stats=field_stats,
            docvalues=docvalues,
            live=np.ones(N, dtype=bool),
            dense_tfn=dense_tfn,
            dense_dict=dense_dict,
            impact_codes=impact_codes,
            impact_ubf=impact_ubf,
            impact_meta=impact_meta,
            vectors=vectors,
        )
