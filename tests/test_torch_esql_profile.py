"""The port's ES|QL operator profiles, materialization accounting and REST
routes (`esql/profile.py`, `rest/app.py`), on device="cpu".

- operator walls sum to the query wall EXACTLY (`==`: the wall is the
  fsum of contiguous boundary segments) over every pipe shape, and the
  operators are the JAX package's on the same query;
- column bytes follow the documented convention exactly (the JAX package's
  `column_nbytes`, value for value), and `peak_live_bytes` bounds the
  largest column;
- an undersized `esql.materialization` breaker trips a 429 naming the
  dominant operator and releases its whole reservation;
- a task passed to `execute` is checked between operators;
- the recorder's ring and stats shapes, and the `es.esql.*` metrics;
- `POST /_query`, `/_esql/query`, `/_sql`, `GET|POST /{index}/_eql/search`
  and `GET /_esql/profile` through the REST app, with serving off and on:
  the answers equal the library calls' and the JAX package's, and the
  error envelopes are the reference's 400 and 429.
"""

import json
import math

import numpy as np
import pytest

from elasticsearch_tpu.engine import Engine as RefEngine
from elasticsearch_tpu.esql import esql_query as ref_esql
from elasticsearch_tpu.esql.eql import eql_search as ref_eql
from elasticsearch_tpu.esql.profile import column_nbytes as ref_column_nbytes
from elasticsearch_tpu.esql.sql import sql_query as ref_sql
from elasticsearch_tpu_torch.common.breaker import CircuitBreakingError
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.esql import esql_query
from elasticsearch_tpu_torch.esql.engine import Column, execute
from elasticsearch_tpu_torch.esql.profile import (DRIVER_OPERATOR, column_nbytes,
                                                  default_recorder, reservation_leaks)
from elasticsearch_tpu_torch.rest import make_app
from elasticsearch_tpu_torch.telemetry import metrics

EMP_MAPPING = {"properties": {"name": {"type": "keyword"}, "dept": {"type": "keyword"},
                              "salary": {"type": "integer"}, "age": {"type": "integer"}}}
EMP = [("1", {"name": "ann", "dept": "eng", "salary": 100, "age": 30}),
       ("2", {"name": "bob", "dept": "eng", "salary": 80, "age": 25}),
       ("3", {"name": "cat", "dept": "ops", "salary": 60, "age": 40}),
       ("4", {"name": "dan", "dept": "ops", "salary": 70, "age": 35}),
       ("5", {"name": "eve", "dept": "sales", "salary": 90})]


def _fill(e, shards: int = 1):
    idx = e.create_index("emp", EMP_MAPPING, {"number_of_shards": shards})
    for i, src in EMP:
        idx.index_doc(i, src)
    idx.refresh()
    return e


def _engine(shards: int = 1) -> Engine:
    return _fill(Engine(device="cpu"), shards)


def _ops(profile):
    return profile["drivers"][0]["operators"]


PIPE_SHAPES = [
    'FROM emp | WHERE salary >= 70 | EVAL bonus = salary * 0.1 '
    '| SORT salary DESC | LIMIT 3 | KEEP name, salary, bonus',
    'FROM emp | STATS c = COUNT(*), avg_sal = AVG(salary) BY dept | SORT dept',
    'FROM emp | STATS n = COUNT(age), m = MAX(age)',
    'FROM emp | WHERE age IS NULL | KEEP name',
    'FROM emp | SORT name | LIMIT 2 | DROP age',
    'FROM emp | RENAME salary AS pay | KEEP name, pay | LIMIT 1',
    'ROW a = 1, b = "x" | EVAL c = a + 2',
    'ROW line = "GET /a 200" | DISSECT line "%{method} %{path} %{status}"',
    'FROM emp | STATS m = MEDIAN(salary) BY dept',
]


@pytest.mark.parametrize("shards", [1, 3])
def test_operator_walls_sum_exactly_to_query_wall_all_shapes(shards):
    e, ref = _engine(shards), RefEngine(None)
    _fill(ref, shards)
    try:
        for q in PIPE_SHAPES:
            out = esql_query(e, {"query": q, "profile": True})
            prof = out["profile"]
            ops = _ops(prof)
            assert math.fsum(o["took_ms"] for o in ops) == prof["wall_ms"], q
            assert all(o["took_ms"] >= 0.0 for o in ops), q
            assert ops[-1]["operator"] == DRIVER_OPERATOR, q
            assert ops[0]["operator"] in ("collect", "row"), q
            assert prof["rows"] == len(out["values"]), q
            assert out["took"] == int(prof["wall_ms"]), q
            for prev, cur in zip(ops, ops[1:-1]):
                assert cur["rows_in"] == prev["rows_out"], q
            want = _ops(ref_esql(ref, {"query": q, "profile": True})["profile"])
            assert [o["operator"] for o in ops] == [o["operator"] for o in want], q
            assert [(o["rows_in"], o["rows_out"]) for o in ops] == \
                [(o["rows_in"], o["rows_out"]) for o in want], q
        out = esql_query(e, {"query": "FROM emp | LIMIT 1"})
        assert "profile" not in out
        st = e.esql_recorder.stats()
        assert st["queries"] == len(PIPE_SHAPES) + 1 and st["rows_total"] > 0
    finally:
        e.close()
        ref.close()


def test_exchange_operator_names():
    e = _engine()
    try:
        out = esql_query(e, {"query": 'FROM emp | SORT salary DESC | LIMIT 2 | KEEP name',
                             "profile": True})
        names = [o["operator"] for o in _ops(out["profile"])]
        assert "topn_exchange" in names and "sort" not in names and "limit" not in names
        out = esql_query(e, {"query": 'FROM emp | STATS c = COUNT(*) BY dept', "profile": True})
        assert "stats_exchange" in [o["operator"] for o in _ops(out["profile"])]
        # median is host-only: the host evaluator's operator
        out = esql_query(e, {"query": 'FROM emp | STATS m = MEDIAN(salary)', "profile": True})
        assert "stats" in [o["operator"] for o in _ops(out["profile"])]
    finally:
        e.close()


def test_column_bytes_match_documented_convention_exactly():
    e = _engine()
    try:
        out = esql_query(e, {"query": 'ROW a = 1, b = "xy"', "profile": True})
        row_op = _ops(out["profile"])[0]
        assert row_op["operator"] == "row"
        assert row_op["columns"]["a"] == 8 + 1
        assert row_op["columns"]["b"] == 1 + 8 + len(b"xy")
        assert row_op["bytes_materialized"] == sum(row_op["columns"].values())
    finally:
        e.close()
    rng = np.random.default_rng(4)
    words = ["", "a", "théta", "日本語", "\ud800x", "grün", "x" * 40]
    for n in (0, 1, 57):
        vals = np.array([None if rng.random() < 0.2 else words[int(rng.integers(0, 7))]
                         for _ in range(n)], object)
        col = Column(vals, np.array([v is None for v in vals], bool), "keyword")
        assert column_nbytes(col) == ref_column_nbytes(col)
        num = Column(rng.random(n), rng.random(n) < 0.3, "double")
        assert column_nbytes(num) == ref_column_nbytes(num) == 9 * n


def test_peak_live_bytes_bounds_largest_materialized_column():
    e = _engine()
    try:
        prof = esql_query(e, {"query": 'FROM emp | KEEP name, salary', "profile": True})["profile"]
        largest = max(max(o["columns"].values(), default=0) for o in _ops(prof))
        assert largest > 0 and prof["peak_live_bytes"] >= largest
        keep_op = [o for o in _ops(prof) if o["operator"] == "keep"][-1]
        assert keep_op["columns"]["name"] == 5 * (1 + 8) + 5 * 3
        assert prof["dominant_operator"] == "collect"
    finally:
        e.close()


def test_breaker_trip_names_dominant_operator_and_releases():
    e = _engine()
    try:
        e.settings.update({"persistent": {"indices.breaker.esql.materialization.limit": "64b"}})
        with pytest.raises(CircuitBreakingError) as ei:
            esql_query(e, {"query": 'FROM emp | STATS c = COUNT(*) BY dept'})
        assert ei.value.status == 429
        assert "esql.materialization" in str(ei.value)
        assert "esql operator [collect]" in str(ei.value)
        assert ei.value.durability == "TRANSIENT"
        st = e.breakers.stats()["esql.materialization"]
        assert st["tripped"] >= 1 and st["estimated_size_in_bytes"] == 0
        assert not reservation_leaks()
        assert e.esql_recorder.stats()["breaker_trips"] >= 1
        e.settings.update({"persistent": {"indices.breaker.esql.materialization.limit": "40%"}})
        assert e.breakers.stats()["esql.materialization"]["limit_size_in_bytes"] == \
            int(e.breakers.total * 0.4)
        out = esql_query(e, {"query": 'FROM emp | STATS c = COUNT(*) BY dept'})
        assert len(out["values"]) == 3
        assert e.breakers.stats()["esql.materialization"]["estimated_size_in_bytes"] == 0
    finally:
        e.close()


def test_task_is_checked_between_operators():
    class Cancelled(Exception):
        pass

    class Task:
        calls = 0

        def ensure_not_cancelled(self):
            self.calls += 1
            if self.calls == 2:
                raise Cancelled()

    e = _engine()
    try:
        task = Task()
        with pytest.raises(Cancelled):
            esql_query(e, {"query": 'FROM emp | WHERE salary >= 70 | EVAL b = salary * 2 '
                                    '| STATS c = COUNT(*)'}, task=task)
        last = e.esql_recorder.profiles(1)["profiles"][-1]
        names = [o["operator"] for o in last["drivers"][0]["operators"]]
        assert names == ["collect", DRIVER_OPERATOR]
        assert math.fsum(o["took_ms"] for o in last["drivers"][0]["operators"]) == \
            last["wall_ms"]
        assert not reservation_leaks()
        assert execute(e, "FROM emp | LIMIT 2", task=None).nrows == 2
    finally:
        e.close()


def test_recorder_ring_stats_and_metrics():
    default_recorder().reset_for_tests()
    metrics.reset()
    e = _engine()
    try:
        for _ in range(3):
            esql_query(e, {"query": 'FROM emp | LIMIT 2'})
        body = e.esql_recorder.profiles(2)
        assert body["recorded_total"] == 3 and len(body["profiles"]) == 2
        assert body["capacity"] == 128 and body["retained"] == 2
        for p in body["profiles"]:
            assert p["query"] == 'FROM emp | LIMIT 2' and "@timestamp" in p and "seq" in p
        st = e.esql_recorder.stats()
        assert st["queries"] == 3 and st["rows_total"] == 6
        assert st["dominant_operator"] in st["operator_ms"]
        assert st["peak_bytes_hwm"] >= st["peak_bytes_last"] > 0
        assert {"collect", "limit", DRIVER_OPERATOR} <= set(st["operator_ms"])
        assert default_recorder().stats()["queries"] == 0
        snap = metrics.snapshot()
        assert snap["counters"]["es.esql.queries"] == 3
        assert "es.esql.operator_ms.collect" in snap["counters"]
        assert snap["histograms"]["es.esql.query_ms"]["count"] == 3
    finally:
        e.close()


def _call(app, method, path, body=None, query=None):
    raw = b"" if body is None else json.dumps(body).encode()
    status, _headers, out = app.handle(method, path, query or {}, {}, raw)
    return status, json.loads(out) if out else None


def _strip(out: dict) -> dict:
    return {k: v for k, v in out.items() if k not in ("took", "profile")}


@pytest.mark.parametrize("serving", [False, True], ids=["serving_off", "serving_on"])
def test_rest_routes(serving):
    app = make_app(device="cpu")
    ref = _fill(RefEngine(None))
    try:
        _fill(app.engine, 2)
        _call(app, "PUT", "/_cluster/settings", {"transient": {"serving.enabled": serving}})
        q = 'FROM emp | STATS c = COUNT(*), s = SUM(salary) BY dept | SORT dept'
        for path in ("/_query", "/_esql/query"):
            status, out = _call(app, "POST", path, {"query": q, "profile": True})
            assert status == 200, out
            assert _strip(out) == _strip(ref_esql(ref, {"query": q}))
            assert math.fsum(o["took_ms"] for o in _ops(out["profile"])) == \
                out["profile"]["wall_ms"]
        sql = "SELECT dept, COUNT(*) AS c FROM emp GROUP BY dept ORDER BY dept"
        status, out = _call(app, "POST", "/_sql", {"query": sql})
        assert status == 200 and out == ref_sql(ref, {"query": sql}) and len(out["rows"]) == 3
        eql = {"query": 'any where salary >= 80', "timestamp_field": "salary"}
        for method in ("GET", "POST"):
            status, out = _call(app, method, "/emp/_eql/search", eql)
            assert status == 200 and out == ref_eql(ref, "emp", eql), out
            assert out["hits"]["total"]["value"] == 3
        status, out = _call(app, "GET", "/_esql/profile", query={"n": "2"})
        assert status == 200
        assert out["recorded_total"] == 2 and out["retained"] == 2
        assert [p["query"] for p in out["profiles"]] == [q, q]
        assert out["stats"]["queries"] == 2
        # the error envelopes: 400 for a parse error, an unknown column and
        # ENRICH; 429 for a breaker trip
        for bad in ("FROM emp | SORT", "FROM emp | WHERE nosuch > 1",
                    "FROM emp | ENRICH p ON name"):
            status, out = _call(app, "POST", "/_query", {"query": bad})
            assert status == 400, out
            assert out["error"]["type"] == "illegal_argument_exception" and out["status"] == 400
        status, out = _call(app, "POST", "/_query", {})
        assert status == 400 and "[query] string is required" in out["error"]["reason"]
        status, out = _call(app, "GET", "/_esql/profile", query={"n": "x"})
        assert status == 400
        status, out = _call(app, "PUT", "/_cluster/settings", {
            "persistent": {"indices.breaker.esql.materialization.limit": "64b"}})
        assert status == 200, out
        status, out = _call(app, "POST", "/_query", {"query": "FROM emp | STATS c = COUNT(*)"})
        assert status == 429 and out["error"]["type"] == "circuit_breaking_exception"
        assert "esql operator [collect]" in out["error"]["reason"]
        assert out["error"]["durability"] == "TRANSIENT"
    finally:
        app.close()
        ref.close()
