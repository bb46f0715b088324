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
  sorted-ordinal int32 + the host-side sorted term list for keywords. What
  the aggregations read besides: an int column's sorted unique values and
  per-doc ordinals (numeric terms buckets), every numeric column's min and
  max over present values (histogram bucket planning), and a keyword's
  (doc, ordinal) pairs over EVERY value when some doc has more than one
  (the single-value column keeps the first value).
- The dense tier: terms with df >= dense_min_df also get a precomputed
  tf/(tf + K) row of a [V_dense (padded to 128), N] f32 matrix, scored
  elementwise with no gather or scatter.
- The impact tier (BM25S): every posting's BM25 tf part quantized to a
  uint16 or int8 code aligned with `post_docids`, so the batched sparse arm
  is a pure gather + one multiply (see the error model below).
- Dense vectors are a row-major [N, dims] float32 matrix per field, with
  the IVF ANN index (`ann.build_ann`) when the mapping asks for one.
- An `ip` field indexes its canonical address as a keyword does; its
  ordinals sort by address (`mappings.ip_sort_key`, v4 below v6), so a
  CIDR block or an ip range is one ordinal interval. `date_nanos` is an
  int64 column of epoch nanoseconds. A `geo_point` is two float32 columns,
  `field#lat` and `field#lon` (a doc's first parseable point). A
  `percolator` field keeps its (docid, query) pairs on the host
  (`ShardPack.percolator`), a `completion` field its sorted (input,
  weight, docid) triples (`ShardPack.completion`, on both build routes);
  `doc_sources`, set by the stacked build and the engine's base, holds
  each doc's source for the host matchers (`nested`, `more_like_this` by
  id).

The builder keeps every token as an integer code in flat arrays, and
`build()` assembles the CSR with sorts: no Python loop runs per posting.
A burst of documents is analyzed at once (`analysis.batched.analyze_burst`).
Two routes give the same bytes: the host route (numpy), and on the CUDA
card the stages of `index/device_build.py` (analysis, the flat CSR, the
blocked postings, impact codes, the dense tier and positions), each above
its element floor. Norms and docvalues stay on the host; the ANN index's
k-means and tile packing run on the build's device. Each stage is a
`monitoring.refresh_profile` stage mark.

Positions (phrase queries) are the blocked sorted int64 keys
docid * POS_L + position of each term in `pos_keys` [num_pos_blocks,
BLOCK], padded with POS_INF behind a reserved all-padding row 0, with the
directory `term_pos_start` [T+1] and the per-term counts `term_pos_count`.
The values of a multi-valued text field are 100 positions apart
(`position_increment_gap`), and a position at POS_L - 64 or beyond is
dropped (the doc still matches and counts the token; phrases cannot see
it), as in the JAX package.
"""

from __future__ import annotations

from array import array
from dataclasses import dataclass, field as dc_field
from itertools import chain

import numpy as np
import torch

from . import device_build as db

from .mappings import (
    BOOL_TYPES,
    DATE_NANOS_TYPES,
    DATE_TYPES,
    FLOAT_TYPES,
    GEO_TYPES,
    INT_TYPES,
    IP_TYPES,
    KEYWORD_TYPES,
    TEXT_TYPES,
    VECTOR_TYPES,
    Mappings,
    ip_sort_key,
)
from .smallfloat import quantize_lengths

BLOCK = 128  # postings lanes per block row

# BM25 defaults baked into dense-tier tfn rows (reference behavior:
# index/similarity/SimilarityService.java:43-58 — BM25 k1=1.2, b=0.75)
BM25_K1 = 1.2
BM25_B = 0.75

# Position keys: docid * POS_L + position. POS_L is global, not per pack, so
# one phrase plan serves every shard; POS_INF pads the key blocks.
POS_L = 1 << 17
POS_INF = np.int64(1) << 62
# positions at POS_L - 64 or beyond are not stored
_POS_MAX = POS_L - 64
# text field: positions between the values of a multi-valued field
POSITION_INCREMENT_GAP = 100


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

def _parse_geo_point(v):
    """A geo_point value -> (lat, lon), or None: {"lat", "lon"}, "lat,lon",
    [lon, lat] (GeoJSON order) or {"type": "Point", "coordinates": [lon,
    lat]} (reference `index/pack.py:_parse_geo_point`; behavior:
    common/geo/GeoPoint.java parsing)."""
    try:
        if isinstance(v, dict):
            if "lat" in v and "lon" in v:
                return float(v["lat"]), float(v["lon"])
            if v.get("type", "").lower() == "point" and v.get("coordinates"):
                lon, lat = v["coordinates"][:2]
                return float(lat), float(lon)
            return None
        if isinstance(v, str):
            lat_s, lon_s = v.split(",", 1)
            return float(lat_s), float(lon_s)
        if isinstance(v, (list, tuple)) and len(v) >= 2:
            return float(v[1]), float(v[0])
    except (ValueError, TypeError):
        from ..utils.errors import MapperParsingError

        raise MapperParsingError(f"failed to parse geo_point value [{v!r}]")
    return None


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
    # terms-agg support for int columns: sorted unique values + per-doc
    # ordinal (the analog of Lucene sorted-numeric global ordinals)
    uniq_values: np.ndarray | None = None  # [V] int64
    uniq_ords: np.ndarray | None = None  # [N] int32 (-1 = missing)
    # column min/max over present values (histogram bucket planning)
    vmin: float | int = 0
    vmax: float | int = 0
    # multi-valued keywords: (doc, ordinal) pairs over EVERY value, sorted
    # by (doc, ordinal); None when no doc has more than one value
    mv_pair_docs: np.ndarray | None = None  # [P] int32
    mv_pair_ords: np.ndarray | None = None  # [P] int32


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
    # positions: blocked sorted int64 keys docid * POS_L + position, padding
    # POS_INF, row 0 reserved; None when no text token was indexed
    pos_keys: np.ndarray | None = None  # [num_pos_blocks, BLOCK] int64
    term_pos_start: np.ndarray | None = None  # [T+1] int32 block row ranges
    term_pos_count: np.ndarray | None = None  # [T] int32 positions per term
    # completion-suggester inputs, host side: field -> sorted
    # [(input, weight, docid)]
    completion: dict[str, list] = dc_field(default_factory=dict)
    # percolator queries, host side: field -> [(docid, query dict)]
    percolator: dict[str, list] = dc_field(default_factory=dict)
    # docid -> source, for the host matchers; None when the builder had none
    doc_sources: list | None = None

    @property
    def num_terms(self) -> int:
        return len(self.term_df)

    def term_pos_blocks(self, fld: str, term: str) -> tuple[int, int, int]:
        """-> (pos_block_row_start, n_blocks, n_positions); zeros when the
        term or the positions are absent."""
        tid = self.term_dict.get((fld, term))
        if tid is None or self.term_pos_start is None:
            return 0, 0, 0
        s = int(self.term_pos_start[tid])
        e = int(self.term_pos_start[tid + 1])
        return s, e - s, int(self.term_pos_count[tid])

    def terms_for_field(self, fld: str) -> list[str]:
        """The sorted terms of one field (the host dictionary that the
        multi-term queries expand over), cached per field."""
        cache = self.__dict__.setdefault("_field_terms", {})
        terms = cache.get(fld)
        if terms is None:
            # term_dict iterates in sorted (field, term) order
            terms = cache[fld] = [t for (f, t) in self.term_dict if f == fld]
        return terms

    def term_code_buckets(self, fld: str) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """`terms_for_field(fld)` by length (`query.dsl.bucket_by_length`),
        for the fuzzy query's edit table; cached per field."""
        from ..query.dsl import bucket_by_length

        cache = self.__dict__.setdefault("_term_codes", {})
        got = cache.get(fld)
        if got is None:
            got = cache[fld] = bucket_by_length(self.terms_for_field(fld))
        return got

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
            arrays += [a for a in (col.uniq_ords, col.mv_pair_docs, col.mv_pair_ords)
                       if a is not None]
        if self.dense_tfn is not None:
            arrays.append(self.dense_tfn)
        if self.impact_codes is not None:
            arrays.append(self.impact_codes)
        if self.pos_keys is not None:
            arrays.append(self.pos_keys)
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
    """Flat token stream of one indexed field, in chunks: term codes, the
    local docid of each token (tf = tokens per (term, doc)) and, for a text
    field, each token's position (docs arrive in order, positions ascend
    within one). A chunk holds numpy arrays, or tensors on the builder's
    device; a keyword column that is not single-valued appends to the
    arrays doc by doc, and `seal` moves them into the chunk list first, so
    the chunks keep stream order."""

    __slots__ = ("vocab", "codes", "docs", "chunks")

    def __init__(self):
        self.vocab = _Vocab()
        self.codes = array("i")
        self.docs = array("i")
        self.chunks: list[tuple] = []  # (codes, docs, positions or None)

    def seal(self) -> None:
        if len(self.codes):
            self.chunks.append((np.frombuffer(self.codes, np.int32),
                                np.frombuffer(self.docs, np.int32), None))
            self.codes, self.docs = array("i"), array("i")

    def n_tokens(self) -> int:
        return len(self.codes) + sum(int(c.shape[0]) for c, _d, _p in self.chunks)


class PackBuilder:
    """Accumulates parsed documents for one shard, then packs.

    The mutable form plays the role of Lucene's IndexWriter RAM buffer;
    `build()` is the refresh that produces an immutable searchable pack.
    `impact_dtype` ("uint16" or "int8") is the impact codes' storage type.
    `device` is where the text analysis and the build stages may run
    (`index.device_build.use_device_build`: the CUDA card, above each
    stage's floor); None or "cpu" is the host route. Both routes give the
    same bytes.
    """

    def __init__(self, mappings: Mappings, impact_dtype: str = "uint16", device=None):
        if impact_dtype not in IMPACT_QMAX:
            raise ValueError(f"impact_dtype must be one of {sorted(IMPACT_QMAX)}, "
                             f"got [{impact_dtype}]")
        self.mappings = mappings
        self.impact_dtype = impact_dtype
        self.device = None if device is None else torch.device(device)
        self.num_docs = 0
        self._tokens: dict[str, _FieldTokens] = {}
        # text field -> ([docid], [length]) for docs where the field exists
        self._lengths: dict[str, tuple[array, array]] = {}
        # keyword field -> docs with >= 1 indexed value (idf docCount)
        self._kw_doc_count: dict[str, int] = {}
        # docvalue field -> ([docid], [first value])
        self._dv_raw: dict[str, tuple[list, list]] = {}
        # keyword field -> [(docid, value)]: a doc's other distinct values
        self._mv_extra: dict[str, list[tuple[int, str]]] = {}
        # dense_vector field -> [(docid, components)]
        self.vector_raw: dict[str, list[tuple[int, list[float]]]] = {}
        # percolator field -> [(docid, query dict)]
        self._percolator_raw: dict[str, list[tuple[int, dict]]] = {}
        # completion field -> [(input, weight, docid)]
        self._completion_raw: dict[str, list[tuple[str, int, int]]] = {}

    def _field_tokens(self, fld: str) -> _FieldTokens:
        ft = self._tokens.get(fld)
        if ft is None:
            ft = self._tokens[fld] = _FieldTokens()
        return ft

    def add_document(self, parsed: dict[str, list], doc_id: str | None = None) -> int:
        """parsed = Mappings.parse_document output; returns the local docid.
        doc_id, when given, is stored in the reserved `_id` ordinal column
        (ids/term-on-_id queries run on the device)."""
        return self.add_documents_batch([parsed], None if doc_id is None else [doc_id])[0]

    def _add_field(self, fld: str, ft, docid: int, values: list) -> None:
        """One doc's values of a keyword, ip, percolator, completion or
        dense_vector field."""
        t = ft.type
        if t in KEYWORD_TYPES or t in IP_TYPES:
            kept = [v for v in values
                    if ft.ignore_above is None or len(v) <= ft.ignore_above]
            if ft.index and kept:
                uniq = set(kept)
                toks = self._field_tokens(fld)
                toks.codes.extend(map(toks.vocab.__getitem__, uniq))
                toks.docs.extend([docid] * len(uniq))
                self._kw_doc_count[fld] = self._kw_doc_count.get(fld, 0) + 1
            if ft.doc_values and kept:
                # the first value drives the single-value column; every
                # value feeds the multi-value pairs of the terms aggs
                self._dv_append(fld, docid, kept[0])
                if len(uniq := set(kept)) > 1:
                    self._mv_extra.setdefault(fld, []).extend(
                        (docid, v) for v in sorted(uniq) if v != kept[0])
        elif t == "percolator":
            for v in values:
                if not isinstance(v, dict):
                    from ..utils.errors import MapperParsingError

                    raise MapperParsingError(f"percolator field [{fld}] requires a query object")
                self._percolator_raw.setdefault(fld, []).append((docid, v))
        elif t == "completion":
            # {"input": str | [str], "weight": w}, a list of inputs, or one
            # input; weight 1 unless given
            for v in values:
                if isinstance(v, dict):
                    inputs = v.get("input") or []
                    if isinstance(inputs, str):
                        inputs = [inputs]
                    weight = int(v.get("weight", 1))
                elif isinstance(v, list):
                    inputs, weight = v, 1
                else:
                    inputs, weight = [v], 1
                self._completion_raw.setdefault(fld, []).extend(
                    (str(inp), weight, docid) for inp in inputs)
        elif t in VECTOR_TYPES and values:
            if len(values) != ft.dims:
                from ..utils.errors import MapperParsingError

                raise MapperParsingError(
                    f"dense_vector [{fld}] has {len(values)} dims, mapping says {ft.dims}")
            self.vector_raw.setdefault(fld, []).append((docid, [float(x) for x in values]))

    def add_documents_batch(self, parsed_docs: list[dict],
                            doc_ids: list | None = None) -> list[int]:
        """Add a burst of parsed documents; returns their local docids. Each
        text field's values go through one `analysis.batched.analyze_burst`
        (on the builder's device when it admits the burst); numeric, date,
        boolean and single-valued keyword fields are added a column at a
        time, the others doc by doc (`_add_field`)."""
        from ..analysis.batched import analyze_burst

        n = len(parsed_docs)
        base = self.num_docs
        self.num_docs += n
        for toks in self._tokens.values():
            toks.seal()
        if doc_ids is not None:
            sel = [i for i, d in enumerate(doc_ids) if d is not None]
            self._dv_extend("_id", [base + i for i in sel], [str(doc_ids[i]) for i in sel])
        fields = self.mappings.fields
        for fld in dict.fromkeys(chain.from_iterable(parsed_docs)):
            ft = fields.get(fld)
            if ft is None:
                continue
            col = [p.get(fld) for p in parsed_docs]
            t = ft.type
            if (t in INT_TYPES or t in DATE_TYPES or t in DATE_NANOS_TYPES or t in BOOL_TYPES
                    or t in FLOAT_TYPES):
                if ft.doc_values:
                    conv = float if t in FLOAT_TYPES else int
                    self._dv_extend(fld, [base + i for i, v in enumerate(col) if v],
                                    [conv(v[0]) for v in col if v])
                continue
            if (t in KEYWORD_TYPES or t in IP_TYPES) and \
                    self._add_single_keywords(fld, ft, base, col):
                continue
            if t in GEO_TYPES:
                self._add_geo_points(fld, base, col)
                continue
            if t not in TEXT_TYPES:
                for i, values in enumerate(col):
                    if values is not None:
                        self._add_field(fld, ft, base + i, values)
                continue
            if not ft.index:
                continue
            present = [i for i, values in enumerate(col) if values is not None]
            per_doc = [col[i] for i in present]
            vals = list(chain.from_iterable(per_doc))
            vdoc = np.repeat(np.arange(len(present), dtype=np.int64),
                             np.fromiter(map(len, per_doc), np.int64, count=len(per_doc)))
            burst = analyze_burst(fields[fld].get_batched_analyzer(), vals, vdoc, len(present),
                                  device=self.device)
            self._ingest_burst(fld, base + np.asarray(present, np.int64), burst)
        return list(range(base, base + n))

    def _add_single_keywords(self, fld: str, ft, base: int, col: list) -> bool:
        """A keyword column whose docs hold at most one value each, added as
        one chunk: the state `_add_field` gives per doc. -> False (nothing
        added) when some doc holds more than one value."""
        if any(v is not None and len(v) > 1 for v in col):
            return False
        cap = ft.ignore_above
        docs = [base + i for i, v in enumerate(col) if v and (cap is None or len(v[0]) <= cap)]
        vals = [v[0] for v in col if v and (cap is None or len(v[0]) <= cap)]
        if ft.index and docs:
            toks = self._field_tokens(fld)
            toks.seal()
            toks.chunks.append((np.fromiter(map(toks.vocab.__getitem__, vals), np.int64,
                                            count=len(vals)), np.asarray(docs, np.int64), None))
            self._kw_doc_count[fld] = self._kw_doc_count.get(fld, 0) + len(docs)
        if ft.doc_values:
            self._dv_extend(fld, docs, vals)
        return True

    def _add_geo_points(self, fld: str, base: int, col: list) -> None:
        """A geo_point column: each doc's first parseable point into the
        `field#lat` / `field#lon` columns, added at once."""
        docs, lats, lons = [], [], []
        for i, values in enumerate(col):
            for v in values or ():
                latlon = _parse_geo_point(v)
                if latlon is not None:  # a single-valued column: the first point
                    docs.append(base + i)
                    lats.append(latlon[0])
                    lons.append(latlon[1])
                    break
        self._dv_extend(f"{fld}#lat", docs, lats)
        self._dv_extend(f"{fld}#lon", docs, lons)

    def _ingest_burst(self, fld: str, fdocs: np.ndarray, burst) -> None:
        """One field's analyzed burst into its token chunks and lengths:
        terms become vocabulary codes (the device path's once per distinct
        term, its tokens staying on its device)."""
        toks = self._field_tokens(fld)
        if burst.term_ids is not None:
            dev = burst.term_ids.device
            code_of = np.fromiter(map(toks.vocab.__getitem__, burst.vocab), np.int64,
                                  count=len(burst.vocab))
            toks.chunks.append((torch.from_numpy(code_of).to(dev)[burst.term_ids],
                                torch.from_numpy(fdocs).to(dev)[burst.doc_idx],
                                burst.positions))
        else:
            codes = np.fromiter(map(toks.vocab.__getitem__, burst.terms), np.int64,
                                count=len(burst.terms))
            toks.chunks.append((codes, fdocs[burst.doc_idx], burst.positions))
        docs, lens = self._lengths.setdefault(fld, (array("i"), array("q")))
        docs.frombytes(fdocs.astype(np.int32).tobytes())
        lens.frombytes(np.asarray(burst.lengths, np.int64).tobytes())

    def _dv_append(self, fld: str, docid: int, value) -> None:
        docs, vals = self._dv_raw.setdefault(fld, ([], []))
        docs.append(docid)
        vals.append(value)

    def _dv_extend(self, fld: str, docids: list, values: list) -> None:
        """Docs and their values of one column; no column for no doc."""
        if docids:
            docs, vals = self._dv_raw.setdefault(fld, ([], []))
            docs.extend(docids)
            vals.extend(values)

    # ---- packing ---------------------------------------------------------

    def _flat_csr(self, N: int, device=None):
        """-> (sorted (field, term) keys, term_dict, post_offsets [T+1],
        flat_docs, flat_tfs, pos_offsets [T+1], flat_pos): each term's
        postings docid-ascending and its position keys ascending, terms in
        key order. With `device`, the grouping runs there and the flat
        arrays and offsets are tensors on it."""
        fields = sorted(self._tokens)
        keys = sorted((f, t) for f in fields for t in self._tokens[f].vocab)
        term_dict = {k: i for i, k in enumerate(keys)}
        T = len(keys)
        if device is None:
            cat = np.concatenate
            put = lambda a: db.as_host(a).astype(np.int64, copy=False)  # noqa: E731
        else:
            put = lambda a: db.as_device(a, device, torch.int64)  # noqa: E731
        parts, docs_parts, pos_tids, pos_keys = [], [], [], []
        for f in fields:
            toks = self._tokens[f]
            toks.seal()
            if not toks.chunks:
                continue
            # code -> global tid (vocab iterates in code order)
            tid_of_code = put(np.fromiter((term_dict[(f, t)] for t in toks.vocab), np.int64,
                                          count=len(toks.vocab)))
            for codes, docs, pos in toks.chunks:
                tids = tid_of_code[put(codes)]
                docs = put(docs)
                parts.append(tids)
                docs_parts.append(docs)
                if pos is not None:
                    pos = put(pos)
                    keep = pos < _POS_MAX
                    pos_tids.append(tids[keep])
                    pos_keys.append(docs[keep] * POS_L + pos[keep])
        if device is not None:
            return (keys, term_dict) + _flat_csr_device(parts, docs_parts, pos_tids, pos_keys,
                                                        N, T, device)
        if parts:  # tokens exist, so N >= 1
            # one sort groups tokens by (tid, doc); each run is one posting
            uk, tf = np.unique(cat(parts) * N + cat(docs_parts), return_counts=True)
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
        # a field's stream is in (doc, position) order and tids of different
        # fields differ, so a stable sort by tid orders the keys per term
        pos_count = np.zeros(T, np.int64)
        flat_pos = np.zeros(0, np.int64)
        if pos_tids:
            ptid = cat(pos_tids)
            flat_pos = cat(pos_keys)[np.argsort(ptid, kind="stable")]
            pos_count = np.bincount(ptid, minlength=T)
        pos_offsets = np.zeros(T + 1, np.int64)
        np.cumsum(pos_count, out=pos_offsets[1:])
        return keys, term_dict, post_offsets, flat_docs, flat_tfs, pos_offsets, flat_pos

    def build(self, dense_min_df: int | None = None, device=None) -> ShardPack:
        """Pack the documents. `device` (None: the builder's) runs each build
        stage that `use_device_build` admits, and the ANN index's k-means and
        tile packing (a builder without a device: the CUDA card, which a pack
        without an ANN index never asks for); the other stages run on the
        host. Every stage is a `refresh_profile` stage mark. A dense tier
        built on the device stays there (`dense_tfn` is then a tensor on it);
        the other arrays come back as numpy."""
        from ..monitoring.refresh_profile import build_stage, refresh_stage

        dev = torch.device(device) if device is not None else self.device
        N = self.num_docs
        if dense_min_df is None:
            dense_min_df = default_dense_min_df(N)

        def route(elements: int):
            """-> (the stage's device or None, its basis)."""
            on = db.use_device_build(elements, dev)
            return (dev if on else None), ("device" if on else "host")

        n_tok = sum(t.n_tokens() for t in self._tokens.values())
        sdev, basis = route(n_tok)
        with refresh_stage("flat_csr", sdev, basis=basis):
            keys, term_dict, post_offsets, flat_docs, flat_tfs, pos_offsets, flat_pos = \
                self._flat_csr(N, sdev)
            post_offsets_h = db.as_host(post_offsets)
        T = len(keys)

        # ---- norms (quantized doc lengths) + field stats -----------------
        norms: dict[str, np.ndarray] = {}
        text_present: dict[str, np.ndarray] = {}
        field_stats: dict[str, dict] = {}
        with build_stage("build.norms", num_docs=N, nfields=len(self._lengths)):
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
        NP = int(post_offsets_h[-1])
        df = post_offsets_h[1:] - post_offsets_h[:-1]
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
        post_dev = None  # (docids, tfs, dls) tensors when the scatter ran on the device
        sdev, basis = route(NP)
        with build_stage("build.csr_assemble", sdev, postings=NP, num_docs=N, terms=T,
                         basis=basis):
            if sdev is not None:
                D = lambda a: db.as_device(a, sdev)  # noqa: E731
                (p_docids, p_tfs, p_dls, bmax, bmin, term_of_post, post_dl_flat) = \
                    db.postings_device(
                        D(flat_docs), D(flat_tfs), D(post_offsets).long(), D(row_base),
                        D(field_of_term),
                        {fld_code[f]: D(n) for f, n in norms.items() if f in fld_code},
                        N, BLOCK)
                post_dev = (p_docids, p_tfs, p_dls)
                post_docids, post_tfs, post_dls, block_max_tf, block_min_len = (
                    db.as_host(a) for a in (p_docids, p_tfs, p_dls, bmax, bmin))
            else:
                flat_docs, flat_tfs = db.as_host(flat_docs), db.as_host(flat_tfs)
                post_docids = np.full((total_blocks, BLOCK), N, dtype=np.int32)
                post_tfs = np.zeros((total_blocks, BLOCK), dtype=np.float32)
                post_dls = np.ones((total_blocks, BLOCK), dtype=np.float32)
                block_max_tf = np.zeros(total_blocks, dtype=np.float32)
                block_min_len = np.full(total_blocks, np.inf, dtype=np.float32)
                term_of_post = np.repeat(np.arange(T), df)
                post_dl_flat = np.ones(NP, dtype=np.float32)  # 1.0 for norm-less fields
                if NP:
                    local = np.arange(NP, dtype=np.int64) - np.repeat(post_offsets_h[:-1], df)
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
        with refresh_stage("docvalues"):
            docvalues = self._docvalues(N)

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
            sdev, basis = route(total_blocks * BLOCK)
            with build_stage("build.impact_quantize", sdev, rows=total_blocks,
                             code_bytes=2 if self.impact_dtype == "uint16" else 1, basis=basis):
                impact_ubf = impact_term_ubf(term_block_start, block_max_tf)
                k_base, k_slope, scale_inv = impact_row_params(
                    impact_row_terms(term_block_start, total_blocks), impact_ubf,
                    field_of_term, avgdl_of_field, has_norms_of_field, qmax)
                if sdev is not None:
                    tfs_d, dls_d = (post_dev[1], post_dev[2]) if post_dev is not None else (
                        db.as_device(post_tfs, sdev), db.as_device(post_dls, sdev))
                    impact_codes = db.as_host(db.impact_codes_device(
                        tfs_d, dls_d, db.as_device(k_base, sdev), db.as_device(k_slope, sdev),
                        db.as_device(scale_inv, sdev), qmax=qmax, dtype=self.impact_dtype))
                else:
                    impact_codes = impact_codes_host(post_tfs, post_dls, k_base, k_slope,
                                                     scale_inv, qmax, self.impact_dtype)
            impact_meta = {"dtype": self.impact_dtype, "qmax": qmax,
                           "k1": BM25_K1, "b": BM25_B}
        del post_dev

        # ---- dense tier (vectorized over all dense postings) -------------
        dense_ids = np.flatnonzero(df >= dense_min_df)
        dense_keys = [keys[i] for i in dense_ids]
        dense_dict = {k: i for i, k in enumerate(dense_keys)}
        dense_tfn = None
        if dense_keys:
            # rows padded to a multiple of 128; padding rows stay all-zero
            rows_pad = len(dense_keys) + (-len(dense_keys) % 128)
            dense_rank = np.full(T, -1, dtype=np.int64)
            dense_rank[dense_ids] = np.arange(len(dense_ids))
            sdev, basis = route(rows_pad * N)
            with refresh_stage("dense_tier", sdev, basis=basis):
                if sdev is not None:
                    D = lambda a: db.as_device(a, sdev)  # noqa: E731
                    dense_tfn = db.dense_tier_device(
                        D(dense_rank), D(term_of_post), D(flat_docs), D(flat_tfs),
                        D(post_dl_flat), D(field_of_term), D(has_norms_of_field),
                        D(avgdl_of_field), N, rows_pad, BM25_K1, BM25_B)
                else:
                    term_of_post, flat_docs, flat_tfs, post_dl_flat = (
                        db.as_host(a) for a in (term_of_post, flat_docs, flat_tfs, post_dl_flat))
                    dense_tfn = np.zeros((rows_pad, N), dtype=np.float32)
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
        del term_of_post, flat_docs, flat_tfs, post_dl_flat

        # ---- position blocks (segment scatter from the flat keys) --------
        pos_keys = term_pos_start = term_pos_count = None
        pos_offsets_h = db.as_host(pos_offsets)
        n_positions = int(pos_offsets_h[-1]) if T else 0
        if n_positions:
            pos_df = pos_offsets_h[1:] - pos_offsets_h[:-1]
            prow_base = np.empty(T + 1, dtype=np.int64)
            prow_base[0] = 1  # row 0 reserved all-padding
            prow_base[1:] = 1 + np.cumsum((pos_df + BLOCK - 1) // BLOCK)
            term_pos_start = prow_base.astype(np.int32)
            term_pos_count = pos_df.astype(np.int32)
            sdev, basis = route(n_positions)
            with refresh_stage("positions", sdev, basis=basis):
                if sdev is not None:
                    pos_keys = db.as_host(db.position_blocks_device(
                        db.as_device(flat_pos, sdev), db.as_device(pos_offsets, sdev),
                        db.as_device(prow_base, sdev), BLOCK, int(POS_INF)))
                else:
                    flat_pos = db.as_host(flat_pos)
                    pos_keys = np.full((int(prow_base[-1]), BLOCK), POS_INF, dtype=np.int64)
                    plocal = np.arange(n_positions, dtype=np.int64) - np.repeat(
                        pos_offsets_h[:-1], pos_df)
                    pterm_row = np.repeat(prow_base[:-1], pos_df)
                    pos_keys[pterm_row + plocal // BLOCK, plocal % BLOCK] = flat_pos
        del flat_pos

        # ---- vectors ------------------------------------------------------
        vectors: dict[str, VectorColumn] = {}
        with refresh_stage("vectors"):
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
                    vc.ann = build_ann(vals, has, nlist, device=dev)
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
            pos_keys=pos_keys,
            term_pos_start=term_pos_start,
            term_pos_count=term_pos_count,
            completion={f: sorted(v) for f, v in self._completion_raw.items()},
            percolator={f: list(v) for f, v in self._percolator_raw.items()},
        )

    def _docvalues(self, N: int) -> dict[str, DocValuesColumn]:
        docvalues: dict[str, DocValuesColumn] = {}
        for fld, (docs_l, vals_l) in self._dv_raw.items():
            if fld == "_id":
                ftype = "keyword"
            elif "#" in fld:
                ftype = "float"  # a geo_point's lat / lon column
            else:
                ftype = self.mappings.fields[fld].type
            docs = np.asarray(docs_l, np.int64)
            has = np.zeros(N, dtype=bool)
            has[docs] = True
            if ftype in KEYWORD_TYPES or ftype in IP_TYPES:
                extras = self._mv_extra.get(fld, [])
                # ip ordinals follow address order, so ranges and sorts do
                terms_sorted = sorted(set(vals_l) | {v for _d, v in extras},
                                      key=ip_sort_key if ftype in IP_TYPES else None)
                ord_of = {t: i for i, t in enumerate(terms_sorted)}
                first = np.fromiter(map(ord_of.__getitem__, vals_l), np.int32,
                                    count=len(vals_l))
                vals = np.full(N, -1, dtype=np.int32)
                vals[docs] = first
                col = DocValuesColumn("ord", vals, has, terms_sorted)
                if extras:
                    # every (doc, ordinal) pair once, sorted by (doc, ordinal)
                    V = max(len(terms_sorted), 1)
                    e_docs = np.fromiter((d for d, _v in extras), np.int64, count=len(extras))
                    e_ords = np.fromiter((ord_of[v] for _d, v in extras), np.int64,
                                         count=len(extras))
                    key = np.unique(np.concatenate([docs * V + first, e_docs * V + e_ords]))
                    col.mv_pair_docs = (key // V).astype(np.int32)
                    col.mv_pair_ords = (key % V).astype(np.int32)
                docvalues[fld] = col
            elif ftype in FLOAT_TYPES:
                vals = np.zeros(N, dtype=np.float32)
                vals[docs] = np.asarray(vals_l, np.float32)
                col = DocValuesColumn("float", vals, has)
                if has.any():
                    col.vmin = float(vals[has].min())
                    col.vmax = float(vals[has].max())
                docvalues[fld] = col
            else:  # int / date / boolean
                vals = np.zeros(N, dtype=np.int64)
                vals[docs] = np.asarray(vals_l, np.int64)
                col = DocValuesColumn("int", vals, has)
                if has.any():
                    present = vals[has]
                    col.vmin = int(present.min())
                    col.vmax = int(present.max())
                    uniq, inv = np.unique(present, return_inverse=True)
                    ords = np.full(N, -1, dtype=np.int32)
                    ords[has] = inv.astype(np.int32)
                    col.uniq_values = uniq
                    col.uniq_ords = ords
                docvalues[fld] = col
        return docvalues


def _flat_csr_device(parts, docs_parts, pos_tids, pos_keys, N: int, T: int, device):
    """The tensor half of `PackBuilder._flat_csr`."""
    if parts:
        flat_docs, flat_tfs, df = db.flat_csr_device(torch.cat(parts), torch.cat(docs_parts), N, T)
    else:
        flat_docs = torch.zeros(0, dtype=torch.int32, device=device)
        flat_tfs = torch.zeros(0, dtype=torch.float32, device=device)
        df = torch.zeros(T, dtype=torch.int64, device=device)
    post_offsets = torch.zeros(T + 1, dtype=torch.int64, device=device)
    post_offsets[1:] = torch.cumsum(df, 0)
    flat_pos = torch.zeros(0, dtype=torch.int64, device=device)
    pos_count = torch.zeros(T, dtype=torch.int64, device=device)
    if pos_tids:
        flat_pos, pos_count = db.sort_positions_device(torch.cat(pos_tids), torch.cat(pos_keys), T)
    pos_offsets = torch.zeros(T + 1, dtype=torch.int64, device=device)
    pos_offsets[1:] = torch.cumsum(pos_count, 0)
    return post_offsets, flat_docs, flat_tfs, pos_offsets, flat_pos
