"""The two ES|QL exchanges of the port (`esql/topn.py`, `esql/exchange.py`)
against the JAX package's and against the host evaluator, on CPU tensors.

- `encode_sort_keys` is the reference's, array for array, and order-exact
  (NaN, +-0.0, denormals, infinities, nulls first and last, desc);
- `topn_exchange` selects exactly the reference's `topn_exchange` rows and
  the host sort's first `limit` rows, over every key type, 1-8 shards;
- `stats_exchange` equals the reference's and `engine._run_stats`: counts,
  longs and min/max exact, double sums and averages within 1e-12 relative
  (the port sums each segment in row order, the reference in its one-hot
  dot's order, the host in numpy's pairwise order);
- long sums are exact above 2^53, and a sum outside int64 raises;
- a high-cardinality BY runs with no [R, G] tensor (every tensor the
  program makes is recorded).
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from elasticsearch_tpu.esql.exchange import stats_exchange as ref_stats_exchange
from elasticsearch_tpu.esql.topn import encode_sort_keys as ref_encode_sort_keys
from elasticsearch_tpu.esql.topn import topn_exchange as ref_topn_exchange
from elasticsearch_tpu.utils.jax_env import ensure_x64
from elasticsearch_tpu_torch.esql.engine import Column, Table, _run_stage, _run_stats
from elasticsearch_tpu_torch.esql.exchange import stats_exchange, supported_stats
from elasticsearch_tpu_torch.esql.topn import encode_sort_keys, supported_topn, topn_exchange
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

CPU = torch.device("cpu")
RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _x64():
    """The JAX package's exchanges need its int64 device arrays, which its
    Engine turns on (`utils/jax_env.ensure_x64`); no Engine is made here."""
    ensure_x64()


def _table(rng, n: int) -> Table:
    """Every exchange key type, nulls sprinkled in: a double with NaN,
    +-0.0 and infinities, a long with values past 2^53, a keyword with
    ties, a boolean, and the row number."""
    d = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)
    d[rng.random(n) < 0.05] = np.nan
    d[rng.random(n) < 0.05] = -0.0
    d[rng.random(n) < 0.05] = 0.0
    d[rng.random(n) < 0.02] = np.inf
    d[rng.random(n) < 0.02] = -np.inf
    big = rng.integers(-5, 6, n).astype(np.int64) * (10 ** 17)
    small = rng.integers(-50, 50, n).astype(np.int64)
    lv = np.where(rng.random(n) < 0.1, big, small)
    kw = np.array([f"k{int(x)}" for x in rng.integers(0, 9, n)], object)
    kw_null = rng.random(n) < 0.1
    kw[kw_null] = None
    return Table({
        "d": Column(d, rng.random(n) < 0.1, "double"),
        "l": Column(lv, rng.random(n) < 0.1, "long"),
        "k": Column(kw, kw_null, "keyword"),
        "b": Column(rng.random(n) < 0.5, rng.random(n) < 0.1, "boolean"),
        "row": Column(np.arange(n, dtype=np.int64), np.zeros(n, bool), "long"),
    }, n)


def test_encode_keys_equal_the_reference_and_are_order_exact():
    rng = np.random.default_rng(3)
    t = _table(rng, 500)
    for payload in ([("d", False, None)], [("d", True, None)], [("d", False, True)],
                    [("l", True, False)], [("k", False, None), ("b", True, True)],
                    [("k", True, None), ("d", True, False), ("l", False, None)]):
        got, want = encode_sort_keys(t, payload), ref_encode_sort_keys(t, payload)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int64 and np.array_equal(g, w), payload
    vals = np.array([-np.inf, -1e300, -1.5, -1e-310, -0.0, 0.0, 5e-324, 2.5, 1e300, np.inf])
    t = Table({"x": Column(vals, np.zeros(len(vals), bool), "double")}, len(vals))
    enc = encode_sort_keys(t, [("x", False, None)])[0]
    for i in range(len(vals) - 1):
        if vals[i] != vals[i + 1]:
            assert enc[i] < enc[i + 1], (vals[i], vals[i + 1])
    desc = encode_sort_keys(t, [("x", True, None)])[0]
    assert np.array_equal(np.argsort(desc, kind="stable"), np.arange(len(vals))[::-1])
    # NaN after every value in both directions; nulls first on desc, last on asc
    vals = np.array([1.0, np.nan, -2.0, 3.0])
    null = np.array([False, False, False, True])
    t = Table({"x": Column(vals, null, "double")}, 4)
    assert list(np.argsort(encode_sort_keys(t, [("x", False, None)])[0],
                           kind="stable")) == [2, 0, 1, 3]
    assert list(np.argsort(encode_sort_keys(t, [("x", True, None)])[0],
                           kind="stable")) == [3, 0, 2, 1]
    assert list(np.argsort(encode_sort_keys(t, [("x", False, True)])[0],
                           kind="stable")) == [3, 2, 0, 1]


PAYLOADS = [
    [("d", False, None)],
    [("d", True, None)],
    [("d", False, True)],
    [("l", True, None)],
    [("l", False, False), ("d", True, None)],
    [("k", False, None), ("l", True, None)],
    [("k", True, None), ("b", False, None), ("d", False, True)],
    [("b", True, False), ("k", False, True)],
]


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("payload", PAYLOADS, ids=lambda p: ",".join(f"{c}{int(d)}"
                                                                   for c, d, _ in p))
def test_topn_exchange_equals_reference_and_host_sort(shards, payload):
    rng = np.random.default_rng(shards * 7 + len(payload))
    n = 700
    t = _table(rng, n)
    shard_of = rng.integers(0, shards, n).astype(np.int32)
    assert supported_topn(payload, t)
    for limit in (1, 17, 300, 2 * n):
        got = topn_exchange(t, shard_of, payload, limit, CPU)
        want = ref_topn_exchange(t, shard_of, payload, limit)
        assert np.array_equal(got, want), (payload, limit)
    # the host sort orders -0.0 and 0.0 as one value and the null rows by
    # the values under them, where both packages' exchanges order -0.0
    # first and the nulls by row: held to it on a table as FROM collects
    # one (a missing doc value reads 0), without -0.0
    for c in t.columns.values():
        if c.type != "keyword":
            c.values = np.where(c.null, np.zeros_like(c.values), c.values)
    t.columns["d"].values = t.columns["d"].values + 0.0  # -0.0 + 0.0 == 0.0
    host, _ = _run_stage(None, "sort", "sort", payload, t, shard_of.copy(), None)
    for limit in (1, 17, 300, 2 * n):
        got = topn_exchange(t, shard_of, payload, limit, CPU)
        assert np.array_equal(got, host.columns["row"].values[:limit]), (payload, limit)


AGGS = [("n", ("call", "count", [("star",)])),
        ("nd", ("call", "count", [("col", "d")])),
        ("sd", ("call", "sum", [("col", "d")])),
        ("ad", ("call", "avg", [("col", "d")])),
        ("lo", ("call", "min", [("col", "d")])),
        ("hi", ("call", "max", [("col", "d")])),
        ("nl", ("call", "count", [("col", "l")])),
        ("sl", ("call", "sum", [("col", "l")])),
        ("al", ("call", "avg", [("col", "l")])),
        ("ll", ("call", "min", [("col", "l")])),
        ("hl", ("call", "max", [("col", "l")]))]


def _finite_table(rng, n: int) -> Table:
    """_table without NaN or infinities (the reference's one-hot dot turns
    an infinity into NaN for every other group: inf * 0)."""
    t = _table(rng, n)
    d = t.columns["d"]
    bad = ~np.isfinite(d.values)
    d.values = np.where(bad, 1.25, d.values)
    return t


def _same_column(got: Column, want: Column, what: str) -> None:
    assert got.type == want.type, (what, got.type, want.type)
    assert np.array_equal(np.asarray(got.null, bool), np.asarray(want.null, bool)), what
    ok = ~np.asarray(want.null, bool)
    for g, w in zip(np.asarray(got.values)[ok], np.asarray(want.values)[ok]):
        if want.type == "double":
            g, w = float(g), float(w)
            assert g == w or abs(g - w) <= RTOL * max(abs(g), abs(w)), (what, g, w)
        elif want.type == "long":
            assert int(g) == int(w), (what, g, w)
        else:
            assert g == w, (what, g, w)


@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("by", [[], ["k"], ["b", "k"], ["l"]])
def test_stats_exchange_equals_reference_and_host_stats(shards, by):
    rng = np.random.default_rng(100 + shards)
    n = 600
    t = _finite_table(rng, n)
    t.columns["l"].values = np.where(np.abs(t.columns["l"].values) > 1000, 7,
                                     t.columns["l"].values)  # the host's f64 mean: exact
    if by == ["l"]:
        # no null key: the host types an aggregate by its last group's
        # value, and sum(l) of the null-l group is a null "double"
        t.columns["l"].null = np.zeros(n, bool)
    shard_of = rng.integers(0, shards, n).astype(np.int32)
    assert supported_stats({"aggs": AGGS, "by": by}, t)
    got = stats_exchange(t, shard_of, AGGS, by, CPU)
    want = ref_stats_exchange(t, shard_of, AGGS, by)
    host = _run_stats(t, AGGS, by)
    assert got.nrows == want.nrows == host.nrows
    assert list(got.columns) == list(want.columns)
    for name in got.columns:
        _same_column(got.columns[name], want.columns[name], f"{name} against the reference")
        _same_column(got.columns[name], host.columns[name], f"{name} against _run_stats")


def test_long_sums_exact_above_2_53():
    rng = np.random.default_rng(9)
    n = 2000
    vals = rng.integers(-(1 << 61), 1 << 61, n).astype(np.int64)
    vals[::7] = (1 << 62) - rng.integers(0, 1000, len(vals[::7]))
    g = np.array([f"g{int(x)}" for x in rng.integers(0, 4, n)], object)
    null = rng.random(n) < 0.05
    t = Table({"v": Column(vals, null, "long"), "g": Column(g, np.zeros(n, bool), "keyword")},
              n)
    aggs = [("s", ("call", "sum", [("col", "v")])), ("a", ("call", "avg", [("col", "v")])),
            ("lo", ("call", "min", [("col", "v")])), ("hi", ("call", "max", [("col", "v")]))]
    shard_of = rng.integers(0, 3, n).astype(np.int32)
    exact = {}
    for i in range(n):
        if not null[i]:
            exact.setdefault(g[i], []).append(int(vals[i]))
    fits = {k: -(1 << 63) <= sum(v) < (1 << 63) for k, v in exact.items()}
    if not all(fits.values()):
        with pytest.raises(IllegalArgumentError, match="long overflow"):
            stats_exchange(t, shard_of, aggs, ["g"], CPU)
        aggs = aggs[1:]
    out = stats_exchange(t, shard_of, aggs, ["g"], CPU)
    for i in range(out.nrows):
        key = out.columns["g"].values[i]
        want = exact[key]
        if "s" in out.columns:
            assert int(out.columns["s"].values[i]) == sum(want)
        assert out.columns["a"].values[i] == sum(want) / len(want)
        assert int(out.columns["lo"].values[i]) == min(want)
        assert int(out.columns["hi"].values[i]) == max(want)
    # a sum past 2^53 that f64 accumulation would round
    v = np.array([(1 << 53) + 1, (1 << 53) + 1, 3], np.int64)
    t = Table({"v": Column(v, np.zeros(3, bool), "long")}, 3)
    out = stats_exchange(t, np.array([0, 1, 0], np.int32),
                         [("s", ("call", "sum", [("col", "v")]))], [], CPU)
    assert int(out.columns["s"].values[0]) == (1 << 54) + 5


def test_long_sum_overflow_raises():
    big = (1 << 62) + 7
    t = Table({"x": Column(np.array([big, big, big], np.int64), np.zeros(3, bool), "long")}, 3)
    with pytest.raises(IllegalArgumentError, match="long overflow"):
        stats_exchange(t, np.zeros(3, np.int32), [("s", ("call", "sum", [("col", "x")]))],
                       [], CPU)
    t = Table({"x": Column(np.array([-big, -big, -big], np.int64), np.zeros(3, bool),
                           "long")}, 3)
    with pytest.raises(IllegalArgumentError, match="long overflow"):
        stats_exchange(t, np.array([0, 1, 2], np.int32),
                       [("s", ("call", "sum", [("col", "x")]))], [], CPU)


class _Sizes(TorchDispatchMode):
    """Records the largest tensor any op of the block makes."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.largest = max(self.largest, o.numel())
        return out


def test_high_cardinality_by_makes_no_rows_by_groups_tensor():
    rng = np.random.default_rng(21)
    n, groups = 40_000, 20_000
    t = Table({"ip": Column(np.array([f"ip{int(x)}" for x in rng.integers(0, groups, n)],
                                     object), np.zeros(n, bool), "keyword"),
               "size": Column(rng.integers(0, 1000, n).astype(np.int64), np.zeros(n, bool),
                              "long"),
               "w": Column(rng.random(n), np.zeros(n, bool), "double")}, n)
    aggs = [("c", ("call", "count", [("star",)])), ("b", ("call", "sum", [("col", "size")])),
            ("m", ("call", "max", [("col", "w")])), ("a", ("call", "avg", [("col", "w")]))]
    shard_of = rng.integers(0, 4, n).astype(np.int32)
    with _Sizes() as sizes:
        out = stats_exchange(t, shard_of, aggs, ["ip"], CPU)
    G = out.nrows
    assert G > 15_000
    # the largest tensors are the [2, R] inputs and the [5, S * G + 1]
    # partials, far below an [R, G] one-hot (~8e8 elements here)
    assert sizes.largest <= max(2 * n, 5 * (4 * G + 1)), sizes.largest
    assert out.columns["c"].values.sum() == n
    assert int(out.columns["b"].values.sum()) == int(t.columns["size"].values.sum())


def test_an_infinity_stays_in_its_group():
    """Queue C: the JAX package's one-hot dot multiplies every row by every
    group's 0/1 lane, so one infinite double makes every other group's sum
    NaN (inf * 0); the port sums each group's own values."""
    t = Table({"v": Column(np.array([np.inf, 1.0, 2.0]), np.zeros(3, bool), "double"),
               "g": Column(np.array(["a", "b", "b"], object), np.zeros(3, bool), "keyword")}, 3)
    aggs = [("s", ("call", "sum", [("col", "v")]))]
    got = stats_exchange(t, np.zeros(3, np.int32), aggs, ["g"], CPU)
    want = ref_stats_exchange(t, np.zeros(3, np.int32), aggs, ["g"])
    host = _run_stats(t, aggs, ["g"])
    assert list(got.columns["s"].values) == [np.inf, 3.0] == list(host.columns["s"].values)
    assert np.isnan(want.columns["s"].values[1])


def test_stats_exchange_is_priced_as_its_own_program():
    """Queue C: the cost model prices the port's segmented reductions (work
    linear in the rows), not the JAX package's [R, G] one-hot matmul; the
    top-n exchange's sort work is priced alike in both."""
    from elasticsearch_tpu.monitoring import costmodel as ref_costmodel
    from elasticsearch_tpu_torch.monitoring import costmodel

    fields = {"shards": 4, "rows": 250_000, "groups": 60_000, "dbl_cols": 1, "long_cols": 1,
              "keys": 2, "n": 10}
    port = costmodel.kernel_cost("esql.stats_exchange", fields)
    ref = ref_costmodel.kernel_cost("esql.stats_exchange", fields)
    assert port["flops"] < 1e-3 * ref["flops"]
    assert port["flops"] == 250_000 * (1 + 4 + 5) + 250_000 * math.log2(250_000)
    assert costmodel.kernel_cost("esql.topn_exchange", fields) == \
        ref_costmodel.kernel_cost("esql.topn_exchange", fields)
