"""Field sorting and search_after (reference behavior: search/sort/
FieldSortBuilder.java -> Lucene SortField over doc values, merged at the
coordinator by SearchPhaseController in (key..., shard, doc) order).

This package's copy of the JAX package's `query/sort.py`. Every sort key
becomes an ascending-sortable tensor (the transformed key space): a
descending key negates, keyword ordinals double (2 * ord) so that a
search_after value absent from the dictionary lands between two ordinals as
an odd number, and a missing value takes a +/- sentinel (`_last` /
`_first`) or the transformed `missing` value.

`sorted_top` selects the page: the candidates (matching, live, strictly
after the search_after cursor) in ascending docid order, then one stable
sort per key from the last key to the first, so full-key ties stay in
docid order; on several shards the lanes are shard-major, so ties order
by (shard, docid), Elasticsearch's `_shard_doc`. The JAX package sorts
with `lax.sort(..., num_keys)` and documents no order among full-key ties.
A float key sorts as IEEE numbers compare, -0.0 equal to +0.0 (so those
ties too order by docid), which is how `lax.sort` orders them on the CPU:
the key is sorted through an order-preserving int64 encoding of its bits
with -0.0 folded onto +0.0, one order on the CPU and on the card (whose
radix sort would otherwise put -0.0 first). Hit values keep their sign.
The search_after comparison is the IEEE `>` / `==` of the JAX package.

An ip column's ordinals follow address order (`mappings.ip_sort_key`), so
a sort on it is numeric ip order and a search_after address bisects the
address keys (the JAX package bisects the strings, which is wrong past the
first page where string and address orders differ). A date_nanos key is
int64 nanos end to end, never a float.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass

import numpy as np
import torch

from ..index.mappings import IP_TYPES, ip_keys, ip_sort_key
from ..utils.errors import IllegalArgumentError, QueryParsingError

F64_SENTINEL = np.float64(np.finfo(np.float64).max)
I64_SENTINEL = np.int64(2**62)
_SIGN_FLIP = 0x7FFFFFFFFFFFFFFF


@dataclass
class SortField:
    field: str  # a field name, or "_score" / "_doc"
    order: str = "asc"
    missing: object = "_last"

    @property
    def desc(self) -> bool:
        return self.order == "desc"


def parse_sort(spec) -> list[SortField]:
    """["f", {"f": "desc"}, {"f": {"order": "desc", "missing": "_first"}},
    "_score", ...] -> [SortField]."""
    if spec is None:
        return []
    if not isinstance(spec, list):
        spec = [spec]
    out = []
    for s in spec:
        if isinstance(s, str):
            out.append(SortField(s, "desc" if s == "_score" else "asc"))
        elif isinstance(s, dict) and len(s) == 1:
            (fld, body), = s.items()
            if isinstance(body, str):
                out.append(SortField(fld, body))
            elif isinstance(body, dict):
                out.append(SortField(fld, body.get("order", "desc" if fld == "_score" else "asc"),
                                     body.get("missing", "_last")))
            else:
                raise QueryParsingError(f"malformed sort clause for [{fld}]")
        else:
            raise QueryParsingError(f"malformed sort clause {s!r}")
    for sf in out:
        if sf.order not in ("asc", "desc"):
            raise QueryParsingError(f"unknown sort order [{sf.order}]")
    return out


def is_score_only(sort: list[SortField]) -> bool:
    return not sort or (len(sort) == 1 and sort[0].field == "_score" and sort[0].desc)


def sort_key_i64(k: torch.Tensor) -> torch.Tensor:
    """f64 -> int64 in the same ascending order, -0.0 and +0.0 equal."""
    b = (k + 0.0).view(torch.int64)  # -0.0 + 0.0 == +0.0
    return torch.where(b < 0, b ^ _SIGN_FLIP, b)


def sorted_top(keys: list, sel: torch.Tensor, k: int):
    """-> (lanes [<= k] int64, keys at those lanes): the first k lanes of
    `sel` in the order of `keys` (each a tensor over the lanes), full-key
    ties by lane ascending."""
    lanes = torch.nonzero(sel).reshape(-1)
    for key in reversed(keys):
        kk = key[lanes]
        if kk.dtype == torch.float64:
            kk = sort_key_i64(kk)
        lanes = lanes[torch.sort(kk, stable=True).indices]
    lanes = lanes[:k]
    return lanes, [key[lanes] for key in keys]


def after_mask(keys: list, after: tuple) -> torch.Tensor:
    """Lanes strictly after the search_after cursor, lexicographically."""
    gt = torch.zeros(keys[0].shape, dtype=torch.bool, device=keys[0].device)
    eq = torch.ones_like(gt)
    for kk, aa in zip(keys, after):
        a = aa.item()
        gt = gt | (eq & (kk > a))
        eq = eq & (kk == a)
    return gt


class SortPlan:
    """Host-side plan: per sort field, how to build its transformed key,
    convert search_after values into that space and hit keys back out."""

    def __init__(self, sort: list[SortField], pack, mappings):
        self.sort = sort
        self.fields = []  # (SortField, kind, col); kind: score|doc|int|float|ord|absent
        self.needs_scores = False
        self._ip_fields: set[str] = set()
        for sf in sort:
            if sf.field == "_score":
                self.fields.append((sf, "score", None))
                self.needs_scores = True
                continue
            if sf.field == "_doc":
                self.fields.append((sf, "doc", None))
                continue
            ft = mappings.fields.get(sf.field) if mappings else None
            if ft is not None and ft.type in ("text",):
                raise IllegalArgumentError(
                    f"Text fields are not optimised for operations that require "
                    f"per-document field data like sorting: [{sf.field}]")
            col = pack.docvalues.get(sf.field)
            if col is None:
                # unmapped or absent column: every doc is missing
                self.fields.append((sf, "absent", None))
                continue
            if ft is not None and ft.type in IP_TYPES:
                self._ip_fields.add(sf.field)
            self.fields.append((sf, col.kind, col))

    # ---- transformed key space ------------------------------------------

    def _sentinels(self, sf, kind):
        sent = F64_SENTINEL if kind in ("float", "absent") else I64_SENTINEL
        # missing sorts last by default whatever the order (ES default)
        if sf.missing == "_last":
            return sent
        if sf.missing == "_first":
            return -sent
        v = sf.missing  # a concrete missing value transforms like a value
        if kind == "ord":
            raise IllegalArgumentError("custom missing on keyword sort not supported")
        v = float(v) if kind in ("float", "absent") else int(v)
        return -v if sf.desc else v

    def device_keys(self, dev, scores, num_docs) -> list:
        """-> one [N] ascending-sortable key per sort field: f64 for scores
        and floats, int64 otherwise."""
        keys = []
        for sf, kind, _col in self.fields:
            dvc = scores.device
            if kind == "score":
                k = -scores[:num_docs] if sf.desc else scores[:num_docs]
                keys.append(k.to(torch.float64))
                continue
            if kind == "doc":
                d = torch.arange(num_docs, dtype=torch.int64, device=dvc)
                keys.append(-d if sf.desc else d)
                continue
            if kind == "absent":
                keys.append(torch.full((num_docs,), float(self._sentinels(sf, kind)),
                                       dtype=torch.float64, device=dvc))
                continue
            if kind == "ord":
                vals, has = dev["dv_ord"][sf.field]
                k = vals.to(torch.int64) * 2
            elif kind == "float":
                vals, has = dev["dv_float"][sf.field]
                k = vals.to(torch.float64)
            else:
                vals, has = dev["dv_int"][sf.field]
                k = vals.to(torch.int64)
            if sf.desc:
                k = -k
            sent = self._sentinels(sf, kind)
            keys.append(torch.where(has, k, torch.tensor(sent, dtype=k.dtype, device=dvc)))
        return keys

    # ---- search_after conversion ----------------------------------------

    def after_keys(self, after_values, pack) -> tuple:
        """Search_after values in the original space -> transformed key
        scalars. A None value (a missing value's `sort` entry) is the
        field's missing key, so a page can start after a doc without the
        field (the JAX package raises a TypeError there)."""
        if len(after_values) != len(self.fields):
            raise IllegalArgumentError(
                f"search_after has {len(after_values)} values, sort has {len(self.fields)}")
        out = []
        for v, (sf, kind, col) in zip(after_values, self.fields):
            if v is None and kind not in ("score", "doc"):
                sent = self._sentinels(sf, kind)
                out.append(np.float64(sent) if kind in ("float", "absent") else np.int64(sent))
            elif kind == "score":
                k = np.float64(v)
                out.append(-k if sf.desc else k)
            elif kind == "doc":
                k = np.int64(v)
                out.append(-k if sf.desc else k)
            elif kind == "absent":
                out.append(np.float64(self._sentinels(sf, kind)))
            elif kind == "ord":
                terms = col.ord_terms or []
                if sf.field in self._ip_fields:
                    i = bisect_left(ip_keys(col), ip_sort_key(str(v)))
                else:
                    i = bisect_left(terms, str(v))
                exact = i < len(terms) and terms[i] == str(v)
                k = np.int64(2 * i if exact else 2 * i - 1)
                out.append(-k if sf.desc else k)
            elif kind == "float":
                out.append(np.float64(-float(v) if sf.desc else float(v)))
            else:
                out.append(np.int64(-int(v) if sf.desc else int(v)))
        return tuple(out)

    # ---- hit keys back to the original space ----------------------------

    def hit_values(self, key_arrays, positions) -> list:
        """Transformed keys at the hit positions -> the response `sort`
        arrays; a sentinel key (a missing value) comes back as None."""
        out = []
        for pos in positions:
            row = []
            for (sf, kind, col), karr in zip(self.fields, key_arrays):
                k = karr[pos]
                if kind in ("float", "absent", "score"):
                    kv = float(k)
                    if abs(kv) >= float(F64_SENTINEL):
                        row.append(None)
                        continue
                    row.append(-kv if sf.desc else kv)
                    continue
                ki = int(k)
                if abs(ki) >= int(I64_SENTINEL):
                    row.append(None)
                    continue
                ki = -ki if sf.desc else ki
                if kind == "ord":
                    terms = col.ord_terms or []
                    row.append(terms[ki // 2] if 0 <= ki // 2 < len(terms) else None)
                else:
                    row.append(ki)
            out.append(row)
        return out
