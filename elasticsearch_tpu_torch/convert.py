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
the reference's own partitions. Positions, which this package does not
serve yet, are left behind.
"""

from __future__ import annotations

import numpy as np

from .index.pack import BLOCK, IMPACT_QMAX, DocValuesColumn, ShardPack, VectorColumn


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
        ord_terms = _get(col, "ord_terms")
        docvalues[fld] = DocValuesColumn(
            kind,
            _array(col, "values", _DV_DTYPES[kind], (n,)),
            _array(col, "has_value", np.bool_, (n,)),
            list(ord_terms) if ord_terms is not None else None,
        )
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
    )
