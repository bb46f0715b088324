"""ESQL sharded SORT|LIMIT: per-shard top-n and the merge of the shards'
winners, as one torch program on the index's device.

The reference's TopNOperator keeps a bounded row heap per driver and the
exchange merges per-shard top-n pages at the coordinator
(x-pack/plugin/esql/compute/src/main/java/org/elasticsearch/compute/
operator/topn/TopNOperator.java:1, operator/exchange/ExchangeService.java:49).
The JAX package's `esql/topn.py` encodes every sort key on the host into an
ORDER-PRESERVING int64 (IEEE-754 total-order bits for doubles, dictionary
ordinals for keywords, the value itself for longs), ranks each shard's rows
lexicographically with `lax.sort(num_keys=K+1)` under `vmap`, gathers the
winners and sorts them again. Here the same [S, K+1, R] keys go to the
device once; each shard's rows are ordered by stable `torch.sort` passes
from the last key to the first (an LSD sort: lexicographic by construction),
the first n of each shard are kept, the S*n candidates are ordered the same
way, and the first n row indices come back in one copy. The last key is the
global row index, so no two rows tie and the selection equals
`lax.sort(num_keys=K+1)`'s and the host evaluator's stable multi-key sort
(engine `_run_stage` "sort": lexicographic by (k1..kn, original row)).

Null ordering matches the host rule (nulls first on desc, last on asc,
unless overridden): nulls take an extreme sentinel AFTER the desc
inversion, and within the null group later keys + row index decide — the
same order the host's stable partition produces.
"""

from __future__ import annotations

import numpy as np

SUPPORTED_TYPES = {"long", "double", "keyword", "boolean"}

_I64_MIN = np.int64(np.iinfo(np.int64).min)
_I64_MAX = np.int64(np.iinfo(np.int64).max)


def supported_topn(sort_payload, t) -> bool:
    """True when every sort key is a plain column of an encodable type."""
    if t.nrows == 0:
        return False
    for name, _desc, _nf in sort_payload:
        c = t.columns.get(name)
        if c is None or c.type not in SUPPORTED_TYPES:
            return False
    return True


def _f64_order_bits(v: np.ndarray) -> np.ndarray:
    """IEEE-754 double -> int64 whose signed order equals float order.
    Classic total-order transform: flip all bits of negatives, flip only
    the sign bit of non-negatives. NaNs are mapped to sort after every
    real value (numpy argsort behavior in the host evaluator)."""
    b = np.asarray(v, np.float64).view(np.uint64)
    neg = (b >> np.uint64(63)) == 1
    enc_u = np.where(neg, ~b, b | np.uint64(1 << 63))
    # enc_u is UNSIGNED-ordered; xor the sign bit to shift the range into
    # signed int64 order (torch.sort and np.lexsort compare signed).
    # NaN is NOT handled here: it must be pinned after the desc inversion
    # (encode_sort_keys), or desc would rank NaN rows first while the host
    # evaluator's np.argsort always ranks them last.
    return (enc_u ^ np.uint64(1 << 63)).view(np.int64).astype(np.int64)


def encode_sort_keys(t, sort_payload) -> list[np.ndarray]:
    """-> one order-encoded int64 array per sort key (null sentinels and
    desc inversion applied), ascending-lexicographic == the host order."""
    keys = []
    for name, desc, nulls_first in sort_payload:
        c = t.columns[name]
        nan = np.zeros(t.nrows, bool)
        if c.type == "keyword":
            sv = np.array(["" if x is None else str(x) for x in c.values])
            uniq = np.unique(sv)
            enc = np.searchsorted(uniq, sv).astype(np.int64)
        elif c.type == "boolean":
            enc = np.asarray(c.values, bool).astype(np.int64)
        elif c.type == "long" and np.asarray(c.values).dtype.kind in "iu":
            enc = np.asarray(c.values, np.int64).copy()
        else:
            fv = np.asarray(c.values, np.float64)
            enc = _f64_order_bits(fv)
            nan = np.isnan(fv)
        if desc:
            enc = ~enc  # bitwise-not exactly reverses int64 order
        # NaN pins after the inversion: the host evaluator's np.argsort
        # ranks NaN last among non-null values in BOTH directions
        enc = np.where(nan, _I64_MAX - 1, enc)
        nf = nulls_first if nulls_first is not None else desc
        null = np.asarray(c.null, bool)
        enc = np.where(null, _I64_MIN if nf else _I64_MAX, enc)
        keys.append(enc)
    return keys


def _lex_order(keys, first: int):
    """[..., K+1, M] int64 -> the [..., M] permutation that orders the last
    axis lexicographically by lanes 0..K: stable sorts from lane `first`
    down to lane 0 (lanes above `first` are already in order)."""
    import torch

    perm = torch.arange(keys.shape[-1], device=keys.device).expand(keys.shape[:-2] + keys.shape[-1:])
    for lane in range(first, -1, -1):
        vals = torch.gather(keys[..., lane, :], -1, perm)
        perm = torch.gather(perm, -1, torch.sort(vals, dim=-1, stable=True).indices)
    return perm


def topn_exchange(
    t,
    shard_of: np.ndarray,  # [nrows] owning shard of each row
    sort_payload,  # [(col, desc, nulls_first)]
    limit: int,
    device,
) -> np.ndarray:
    """-> global row indices of the top-`limit` rows in final order.

    Device program per shard: a lexicographic sort over the encoded keys +
    global row index, keep the first n. Exchange: the S*n winners sorted
    the same way, keep n."""
    import torch

    from ..telemetry import time_kernel

    n = int(min(limit, t.nrows))
    if n <= 0:
        return np.array([], np.int64)
    keys = encode_sort_keys(t, sort_payload)
    S = int(shard_of.max()) + 1 if len(shard_of) else 1
    # each shard's rows in ascending row order (the reference's
    # flatnonzero per shard), at positions 0..len-1 of its lane
    order = np.argsort(shard_of, kind="stable")
    counts = np.bincount(shard_of, minlength=S)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    sh = shard_of[order]
    pos = np.arange(len(order)) - starts[sh]
    R = max(int(counts.max(initial=1)), n, 1)
    K = len(keys)
    # pad rows sort last: every key operand takes I64_MAX and so does the
    # row index (no real row index reaches 2^63)
    kpad = np.full((S, K + 1, R), _I64_MAX, np.int64)
    for ki, karr in enumerate(keys):
        kpad[sh, ki, pos] = karr[order]
    kpad[sh, K, pos] = order
    n_eff = min(n, R)
    device = torch.device(device)
    with time_kernel("esql.topn_exchange", device, shards=S, rows=R, keys=K, n=n_eff):
        dk = torch.from_numpy(kpad).to(device)
        # lane K (the row index) ascends within each shard by construction,
        # so the per-shard sort starts at lane K-1
        perm = _lex_order(dk, K - 1)[:, :n_eff]  # [S, n_eff]
        top = torch.gather(dk, 2, perm[:, None, :].expand(S, K + 1, n_eff))
        cand = top.transpose(0, 1).reshape(K + 1, S * n_eff)  # shard-major
        win = torch.gather(cand[K], 0, _lex_order(cand, K)[:n_eff])
        sel = win.cpu().numpy()
    return sel[sel != _I64_MAX][:n]
