"""Carry a pack built by the JAX package across to this package.

`pack_from_reference` takes any object (or dict) that has the reference
`ShardPack`'s attribute names holding numpy arrays and plain Python
containers, checks each array's dtype and shape, and returns this
package's `ShardPack`. It never imports the JAX package: a caller hands it
the reference pack object, or a dict loaded from wherever the arrays were
saved. The impact tier comes across when the source has it; a source
without it gives a pack with no impact tier, which the batched arms serve
from the raw postings. Vector fields come across with their ANN index
(the reference's `VectorColumn.ann` dict), so a search can be held against
the reference's own partitions. Docvalue columns come across with what the
aggregations read: an int column's unique values and per-doc ordinals,
every column's min and max, and a keyword's multi-value (doc, ordinal)
pairs. Positions (`pos_keys`, `term_pos_start`, `term_pos_count`) come
across when the source has them, and so do the host-side completion
inputs, percolator queries and `doc_sources`. The slice-18 columns need no kind of their own:
an ip column is "ord" (address-ordered terms), date_nanos "int" (int64
nanos), a geo_point's `field#lat` / `field#lon` "float".

`stacked_pack_from_reference` carries a reference `StackedPack` across the
same way: its per-shard packs, then this package's `StackedPack` over them,
checked against the source's global dictionaries, stacked docvalues
(global ordinals, bounds and multi-value pairs), stacked vectors and
stacked ANN index, byte for byte.
"""

from __future__ import annotations

import numpy as np

from .index.mappings import Mappings
from .index.pack import BLOCK, IMPACT_QMAX, DocValuesColumn, ShardPack, VectorColumn
from .parallel.stacked import StackedPack


def _get(src, name, default=None):
    if isinstance(src, dict):
        return src.get(name, default)
    return getattr(src, name, default)


def _array(src, name, dtype, shape=None) -> np.ndarray:
    a = np.asarray(_get(src, name))
    if a.dtype != np.dtype(dtype):
        raise ValueError(f"pack array [{name}] has dtype {a.dtype}, expected {np.dtype(dtype)}")
    if shape is not None and a.shape != shape:
        raise ValueError(f"pack array [{name}] has shape {a.shape}, expected {shape}")
    return np.ascontiguousarray(a)


_DV_DTYPES = {"int": np.int64, "float": np.float32, "ord": np.int32}


_ANN_ARRAYS = {"centroids": np.float32, "order": np.int32, "codes": np.int8,
               "scale": np.float32, "offset": np.float32}


def _vector_column(col, n: int) -> VectorColumn:
    dims = int(_get(col, "dims"))
    ann = _get(col, "ann")
    if ann is not None:
        C, L = int(ann["nlist"]), int(ann["tile"])
        shapes = {"centroids": (C, dims), "order": (C, L), "codes": (C, L, dims),
                  "scale": (C, L), "offset": (C, L)}
        ann = {**{k: _array(ann, k, dt, shapes[k]) for k, dt in _ANN_ARRAYS.items()},
               "nlist": C, "tile": L, "built_n": int(ann["built_n"])}
    return VectorColumn(
        _array(col, "values", np.float32, (n, dims)),
        _array(col, "has_value", np.bool_, (n,)),
        str(_get(col, "similarity")),
        dims,
        ann=ann,
        ann_quant=str(_get(col, "ann_quant", "int8")),
    )


def _docvalues_column(fld: str, col, n: int) -> DocValuesColumn:
    """A reference DocValuesColumn (or dict) -> this package's, with the
    aggregations' arrays: uniq_values [V] int64, uniq_ords [n] int32,
    vmin/vmax, mv_pair_docs / mv_pair_ords [P] int32."""
    kind = _get(col, "kind")
    if kind not in _DV_DTYPES:
        raise ValueError(f"docvalues [{fld}] of kind [{kind}] is not yet ported")
    ord_terms = _get(col, "ord_terms")
    out = DocValuesColumn(
        kind,
        _array(col, "values", _DV_DTYPES[kind], (n,)),
        _array(col, "has_value", np.bool_, (n,)),
        list(ord_terms) if ord_terms is not None else None,
    )
    if _get(col, "uniq_values") is not None:
        out.uniq_values = _array(col, "uniq_values", np.int64)
        out.uniq_ords = _array(col, "uniq_ords", np.int32, (n,))
    if _get(col, "mv_pair_docs") is not None:
        out.mv_pair_docs = _array(col, "mv_pair_docs", np.int32)
        out.mv_pair_ords = _array(col, "mv_pair_ords", np.int32, out.mv_pair_docs.shape)
    cast = int if kind == "int" else float
    out.vmin = cast(_get(col, "vmin", 0))
    out.vmax = cast(_get(col, "vmax", 0))
    return out


def pack_from_reference(src) -> ShardPack:
    n = int(_get(src, "num_docs"))
    post_docids = _array(src, "post_docids", np.int32)
    nb = post_docids.shape[0]
    if post_docids.shape != (nb, BLOCK):
        raise ValueError(f"post_docids has shape {post_docids.shape}, expected (*, {BLOCK})")
    term_df = _array(src, "term_df", np.int32)
    T = term_df.shape[0]
    docvalues = {}
    for fld, col in (_get(src, "docvalues") or {}).items():
        kind = _get(col, "kind")
        if kind not in _DV_DTYPES:
            raise ValueError(f"docvalues [{fld}] of kind [{kind}] is not yet ported")
        docvalues[fld] = _docvalues_column(fld, col, n)
    dense_tfn = _get(src, "dense_tfn")
    if dense_tfn is not None:
        dense_tfn = _array(src, "dense_tfn", np.float32)
        if dense_tfn.ndim != 2 or dense_tfn.shape[1] != n:
            raise ValueError(f"dense_tfn has shape {dense_tfn.shape}, expected (*, {n})")
    impact_codes = impact_ubf = impact_meta = None
    if _get(src, "impact_codes") is not None:
        impact_meta = dict(_get(src, "impact_meta"))
        dtype = impact_meta.get("dtype")
        if dtype not in IMPACT_QMAX or impact_meta.get("qmax") != IMPACT_QMAX[dtype]:
            raise ValueError(f"impact_meta {impact_meta} is not a known quantization")
        impact_codes = _array(src, "impact_codes", dtype, (nb, BLOCK))
        impact_ubf = _array(src, "impact_ubf", np.float32, (T,))
    pos_keys = term_pos_start = term_pos_count = None
    if _get(src, "pos_keys") is not None:
        pos_keys = _array(src, "pos_keys", np.int64)
        if pos_keys.ndim != 2 or pos_keys.shape[1] != BLOCK:
            raise ValueError(f"pos_keys has shape {pos_keys.shape}, expected (*, {BLOCK})")
        term_pos_start = _array(src, "term_pos_start", np.int32, (T + 1,))
        term_pos_count = _array(src, "term_pos_count", np.int32, (T,))
    return ShardPack(
        num_docs=n,
        post_docids=post_docids,
        post_tfs=_array(src, "post_tfs", np.float32, (nb, BLOCK)),
        post_dls=_array(src, "post_dls", np.float32, (nb, BLOCK)),
        term_block_start=_array(src, "term_block_start", np.int32, (T + 1,)),
        term_df=term_df,
        block_max_tf=_array(src, "block_max_tf", np.float32, (nb,)),
        block_min_len=_array(src, "block_min_len", np.float32, (nb,)),
        term_dict={tuple(k): int(v) for k, v in _get(src, "term_dict").items()},
        norms={f: np.ascontiguousarray(a, np.float32) for f, a in _get(src, "norms").items()},
        text_present={f: np.ascontiguousarray(a, np.bool_)
                      for f, a in _get(src, "text_present").items()},
        field_stats={f: {"sum_dl": float(st["sum_dl"]), "doc_count": int(st["doc_count"])}
                     for f, st in _get(src, "field_stats").items()},
        docvalues=docvalues,
        live=_array(src, "live", np.bool_, (n,)),
        dense_tfn=dense_tfn,
        dense_dict={tuple(k): int(v) for k, v in (_get(src, "dense_dict") or {}).items()},
        impact_codes=impact_codes,
        impact_ubf=impact_ubf,
        impact_meta=impact_meta,
        vectors={f: _vector_column(col, n) for f, col in (_get(src, "vectors") or {}).items()},
        pos_keys=pos_keys,
        term_pos_start=term_pos_start,
        term_pos_count=term_pos_count,
        completion={f: [(str(inp), int(w), int(d)) for inp, w, d in v]
                    for f, v in (_get(src, "completion") or {}).items()},
        percolator={f: [(int(d), q) for d, q in v]
                    for f, v in (_get(src, "percolator") or {}).items()},
        doc_sources=(list(_get(src, "doc_sources")) if _get(src, "doc_sources") is not None
                     else None),
    )


def stacked_pack_from_reference(src, mappings: Mappings | dict) -> StackedPack:
    """A reference `StackedPack` (the object, or a dict with its `shards`,
    `global_df`, `field_stats` and `dense_dict`) -> this package's
    StackedPack over the same shard packs. The global tier's threshold is
    taken from the source's dense keys; the stack is rebuilt here and must
    reproduce the source's global df, field statistics, dense keys and
    completion lists, or this raises."""
    mappings = mappings if isinstance(mappings, Mappings) else Mappings(mappings)
    shards = [pack_from_reference(p) for p in _get(src, "shards")]
    global_df = {tuple(k): int(v) for k, v in _get(src, "global_df").items()}
    dense_dict = {tuple(k): int(v) for k, v in (_get(src, "dense_dict") or {}).items()}
    thresh = min((global_df[k] for k in dense_dict), default=1 << 62)
    sp = StackedPack(shards, mappings, dense_min_df=thresh)
    field_stats = {f: {"sum_dl": float(st["sum_dl"]), "doc_count": int(st["doc_count"])}
                   for f, st in _get(src, "field_stats").items()}
    completion = {f: [(str(inp), int(w), int(sh), int(d)) for inp, w, sh, d in v]
                  for f, v in (_get(src, "completion") or {}).items()}
    for name, got, want in (("global_df", sp.global_df, global_df),
                            ("field_stats", sp.field_stats, field_stats),
                            ("dense_dict", sp.dense_dict, dense_dict),
                            ("completion", sp.completion, completion)):
        if got != want:
            raise ValueError(f"the stacked pack's [{name}] differs from the source's")
    src_dv = _get(src, "stacked_docvalues") or _get(src, "global_docvalues") or {}
    for fld, col in src_dv.items():
        got = sp.global_docvalues.get(fld)
        if got is None:
            raise ValueError(f"the stacked docvalues lack [{fld}]")
        for name in ("values", "has_value", "uniq_values", "uniq_ords", "mv_pair_docs",
                     "mv_pair_ords"):
            a, b = getattr(got, name), _get(col, name)
            if (a is None) != (b is None) or (a is not None and (
                    a.dtype != np.asarray(b).dtype or a.shape != np.shape(b)
                    or a.tobytes() != np.ascontiguousarray(b).tobytes())):
                raise ValueError(f"the stacked docvalues [{fld}].{name} differ from the source's")
        if (got.vmin, got.vmax, got.ord_terms) != (_get(col, "vmin"), _get(col, "vmax"),
                                                    _get(col, "ord_terms")):
            raise ValueError(f"the stacked docvalues [{fld}] bounds or terms differ")
    src_vectors = _get(src, "vectors") or {}
    if set(src_vectors) != set(sp.vectors):
        raise ValueError("the stacked pack's vector fields differ from the source's")
    for fld, col in src_vectors.items():
        vc = sp.vectors[fld]
        for name, got, want in (("values", vc.values, _get(col, "values")),
                                ("has_value", vc.has_value, _get(col, "has_value"))):
            if got.tobytes() != np.ascontiguousarray(want).tobytes():
                raise ValueError(f"the stacked vectors [{fld}].{name} differ from the source's")
        ann = _get(col, "ann")
        if (ann is None) != (vc.ann is None):
            raise ValueError(f"the stacked ANN index of [{fld}] differs from the source's")
        if ann is not None:
            for key in (*_ANN_ARRAYS, "nlist", "tile", "built_n"):
                got, want = np.asarray(vc.ann[key]), np.asarray(ann[key])
                if got.dtype != want.dtype or got.shape != want.shape or \
                        got.tobytes() != want.tobytes():
                    raise ValueError(f"the stacked ANN [{fld}].{key} differs from the source's")
    return sp
