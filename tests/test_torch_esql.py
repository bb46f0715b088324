"""ES|QL, SQL and EQL of the port against the JAX package.

Every query of the JAX package's `tests/test_esql.py` (ENRICH excepted: the
port answers a 400 "not yet ported" until the enrich policies are ported),
and bench.py C10's four query shapes plus the top-clients panel on a
5,000-doc C3 corpus with nulls sprinkled in, through the reference's
`Engine(None)` and the port's `Engine(device="cpu")` on the same docs, on 1
and on 3 shards. Tolerance: column names and types equal; keywords, longs,
booleans and counts equal (and of the same Python type); doubles equal or
within 1e-12 relative, where the port's f64 sums add in another order than
the JAX package's one-hot dot.
"""

import numpy as np
import pytest

from elasticsearch_tpu.engine import Engine as RefEngine
from elasticsearch_tpu.esql import esql_query as ref_esql
from elasticsearch_tpu.esql.eql import eql_search as ref_eql
from elasticsearch_tpu.esql.sql import sql_query as ref_sql
from elasticsearch_tpu_torch.corpus import C3_MAPPINGS, c3_corpus
from elasticsearch_tpu_torch.engine import Engine
from elasticsearch_tpu_torch.esql import esql_query
from elasticsearch_tpu_torch.esql.eql import eql_search
from elasticsearch_tpu_torch.esql.sql import sql_query
from elasticsearch_tpu_torch.utils.errors import IllegalArgumentError

SHARDS = (1, 3)
RTOL = 1e-12


def same_value(got, want, what: str) -> None:
    if isinstance(want, float) or isinstance(got, float):
        assert type(got) is type(want), (what, got, want)
        assert got == want or abs(got - want) <= RTOL * max(abs(got), abs(want)), \
            (what, got, want)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (what, got, want)
        for g, w in zip(got, want):
            same_value(g, w, what)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (what, got, want)
        for k in want:
            same_value(got[k], want[k], f"{what}.{k}")
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


def same_answer(got: dict, want: dict, what: str) -> None:
    """Two ES|QL / SQL / EQL responses agree (the `took` and `profile`
    timings aside)."""
    strip = ("took", "profile")
    same_value({k: v for k, v in got.items() if k not in strip},
               {k: v for k, v in want.items() if k not in strip}, what)


class EnginePair:
    """The same docs in both packages' engines, `name` on `shards` shards."""

    def __init__(self, indices: dict, shards: int):
        self.ref, self.port = RefEngine(None), Engine(device="cpu")
        for name, (mapping, docs) in indices.items():
            for eng in (self.ref, self.port):
                idx = eng.create_index(name, mapping, {"number_of_shards": shards})
                for i, d in docs:
                    idx.index_doc(i, d)
                idx.refresh()

    def close(self):
        self.ref.close()
        self.port.close()


EMP = ({"properties": {"name": {"type": "keyword"}, "dept": {"type": "keyword"},
                       "salary": {"type": "integer"}, "age": {"type": "integer"}}},
       [("1", {"name": "ann", "dept": "eng", "salary": 100, "age": 30}),
        ("2", {"name": "bob", "dept": "eng", "salary": 80, "age": 25}),
        ("3", {"name": "cat", "dept": "ops", "salary": 60, "age": 40}),
        ("4", {"name": "dan", "dept": "ops", "salary": 70, "age": 35}),
        ("5", {"name": "eve", "dept": "sales", "salary": 90})])  # age missing
EV = ({"properties": {"@timestamp": {"type": "date"}, "event.category": {"type": "keyword"},
                      "host": {"type": "keyword"}, "pid": {"type": "integer"}}},
      [(str(i), {"@timestamp": ts, "event.category": cat, "host": host, "pid": pid})
       for i, (ts, cat, host, pid) in enumerate([
           (1000, "process", "h1", 5), (2000, "network", "h1", 5), (3000, "file", "h1", 5),
           (1500, "process", "h2", 9), (9000, "network", "h2", 9)])])
RAW = ({"properties": {"line": {"type": "text"}, "host": {"type": "keyword"}}},
       [("1", {"line": "GET /api/users 200", "host": "web1"}),
        ("2", {"line": "POST /api/orders 503", "host": "web2"})])


def c3_docs(n: int = 5000) -> list:
    """bench.py C3's docs, with `size` missing from every 17th doc and
    `clientip` from every 23rd."""
    docs = []
    for i, (doc_id, src) in enumerate(c3_corpus(np.random.default_rng(11), n)):
        src = dict(src)
        if i % 17 == 5:
            src.pop("size")
        if i % 23 == 7:
            src.pop("clientip")
        docs.append((doc_id, src))
    return docs


@pytest.fixture(scope="module", params=SHARDS, ids=lambda s: f"{s}shards")
def pair(request):
    p = EnginePair({"emp": EMP, "ev": EV, "raw": RAW, "c3": (C3_MAPPINGS, c3_docs())},
                   request.param)
    yield p
    p.close()


# the JAX package's tests/test_esql.py, query for query
ESQL = [
    'FROM emp | WHERE salary >= 70 | EVAL bonus = salary * 0.1 '
    '| SORT salary DESC | LIMIT 3 | KEEP name, salary, bonus',
    'FROM emp | STATS c = COUNT(*), avg_sal = AVG(salary) BY dept | SORT dept',
    'FROM emp | STATS n = COUNT(age), m = MAX(age)',
    'FROM emp | WHERE age IS NULL | KEEP name',
    'FROM emp | WHERE name LIKE "a*" OR name == "bob" '
    '| EVAL u = UPPER(name), tag = CONCAT(dept, "-", name) | SORT name | KEEP u, tag',
    'ROW a = 1, b = "x" | EVAL c = a + 2',
    'FROM emp | EVAL band = CASE(salary >= 90, "high", salary >= 70, "mid", "low") '
    '| SORT name | KEEP name, band',
    'FROM emp | SORT dept DESC, salary ASC | KEEP dept, salary',
    'FROM raw | DISSECT line "%{method} %{path} %{status}" '
    '| WHERE status == "503" | KEEP host, method, path',
    'FROM raw | GROK line "%{WORD:method} %{URIPATH:path} %{INT:status}" '
    '| KEEP method, status | SORT method',
    # the other stages and host aggregates of the engine
    'FROM emp METADATA _id | STATS m = MEDIAN(salary), d = COUNT_DISTINCT(dept), '
    'v = VALUES(dept), s = SUM(age), lo = MIN(name) BY dept | SORT dept',
    'FROM emp METADATA _id | RENAME salary AS pay | DROP age | SORT _id | LIMIT 4',
    'FROM emp | EVAL r = ROUND(salary / 3, 2), f = FLOOR(salary / 3), l = LENGTH(name), '
    'x = COALESCE(age, 0) + salary % 7 | WHERE dept IN ("eng", "ops") AND NOT age IS NULL '
    '| SORT r DESC NULLS FIRST | KEEP name, r, f, l, x',
]
# bench.py C10's four shapes (`bench.py:2281-2293`) and the top-clients panel
C10 = [
    'FROM c3 | WHERE size >= 50000 | STATS c = COUNT(*), b = SUM(size) BY status | SORT status',
    'FROM c3 | SORT size DESC | LIMIT 10 | KEEP clientip, size',
    'FROM c3 | WHERE status == "404" | SORT size DESC | LIMIT 10 | KEEP clientip, size',
    'FROM c3 | EVAL kb = size / 1024 | STATS m = MAX(kb), a = AVG(kb)',
    'FROM c3 | STATS c = COUNT(*), b = SUM(size) BY clientip | SORT c DESC, clientip | LIMIT 10',
    'FROM c3 | STATS n = COUNT(size), lo = MIN(size), hi = MAX(size), m = AVG(size) BY status '
    '| SORT status',
    'FROM c3 | SORT clientip DESC NULLS LAST, @timestamp | LIMIT 25 | KEEP clientip, @timestamp',
]


@pytest.mark.parametrize("query", ESQL + C10)
def test_esql_equals_reference(pair, query):
    got = esql_query(pair.port, {"query": query, "profile": True})
    want = ref_esql(pair.ref, {"query": query, "profile": True})
    same_answer(got, want, query)
    names = [o["operator"] for o in got["profile"]["drivers"][0]["operators"]]
    assert names == [o["operator"] for o in want["profile"]["drivers"][0]["operators"]], query


SQL = [
    "SELECT dept, COUNT(*) AS c, AVG(salary) AS avg_sal FROM emp "
    "WHERE salary > 50 GROUP BY dept ORDER BY 2 DESC, dept LIMIT 10",
    "SELECT name, salary FROM emp WHERE dept = 'eng' ORDER BY salary DESC",
    "SELECT dept, COUNT(*) FROM emp GROUP BY dept HAVING COUNT(*) > 1 ORDER BY dept",
    "SELECT status, COUNT(*), SUM(size) FROM c3 GROUP BY status",
    "SHOW TABLES",
    "DESCRIBE c3",
]


@pytest.mark.parametrize("query", SQL)
def test_sql_equals_reference(pair, query):
    same_answer(sql_query(pair.port, {"query": query}), ref_sql(pair.ref, {"query": query}),
                query)


EQL = [
    ("ev", 'process where pid == 5'),
    ("ev", 'sequence by host with maxspan=5s [process where true] [network where true]'),
    ("ev", 'sequence by host [process where true] [network where true] until [file where true]'),
    ("ev", 'sequence by pid [process where true] [network where true] '
           'until [network where true]'),
    ("ev", 'sequence by host [process where true] with runs=2 [network where true]'),
    ("c3", 'any where status == "404" and size > 90000'),
    ("c3", 'sequence by clientip with maxspan=10d [any where status == "404"] '
           '[any where status == "500"]'),
]


@pytest.mark.parametrize("index,query", EQL)
def test_eql_equals_reference(pair, index, query):
    body = {"query": query, "size": 20}
    same_answer(eql_search(pair.port, index, body), ref_eql(pair.ref, index, body), query)


def test_eql_answers_as_the_reference_tests_expect(pair):
    out = eql_search(pair.port, "ev", {"query": 'process where pid == 5'})
    assert out["hits"]["total"]["value"] == 1
    assert out["hits"]["events"][0]["_source"]["host"] == "h1"
    out = eql_search(pair.port, "ev", {"query": 'sequence by host with maxspan=5s '
                                                '[process where true] [network where true]'})
    assert out["hits"]["total"]["value"] == 1
    assert out["hits"]["sequences"][0]["join_keys"] == ["h1"]


@pytest.mark.parametrize("query", ["FROM emp | WHERE nosuch > 1", "WHERE x > 1",
                                   "FROM emp | SORT", "FROM emp | LIMIT x"])
def test_esql_errors_are_the_reference_errors(pair, query):
    from elasticsearch_tpu.utils.errors import IllegalArgumentError as RefIllegalArgumentError

    with pytest.raises(RefIllegalArgumentError) as want:
        ref_esql(pair.ref, {"query": query})
    with pytest.raises(IllegalArgumentError) as got:
        esql_query(pair.port, {"query": query})
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value) and got.value.status == 400


def test_enrich_is_not_yet_ported(pair):
    with pytest.raises(IllegalArgumentError, match="not yet ported") as ex:
        esql_query(pair.port, {"query": 'FROM raw | ENRICH host-dc ON host WITH dc '
                                        '| KEEP host, dc | SORT host'})
    assert ex.value.status == 400


def test_writes_then_query_sees_the_merged_tiers():
    """FROM merges tail segments into one base first (the searcher
    property), as the reference's `idx.searcher.sp` does: an update and a
    delete after the base are seen by the next query."""
    eng = Engine(device="cpu")
    ref = RefEngine(None)
    try:
        q = 'FROM emp | STATS c = COUNT(*), s = SUM(salary) BY dept | SORT dept'
        for e in (eng, ref):
            idx = e.create_index("emp", EMP[0], {"number_of_shards": 2})
            for i, d in EMP[1]:
                idx.index_doc(i, d)
            idx.refresh()
            idx.index_doc("2", {"name": "bob", "dept": "ops", "salary": 85})
            idx.delete_doc("5")
            idx.index_doc("6", {"name": "fay", "dept": "sales", "salary": 95, "age": 50})
            idx.refresh()
        assert len(eng.indices["emp"]._tails) == 2  # one segment per refresh
        got, want = esql_query(eng, {"query": q}), ref_esql(ref, {"query": q})
        same_answer(got, want, q)
        assert got["values"] == [[1, 100, "eng"], [3, 215, "ops"], [1, 95, "sales"]]
    finally:
        eng.close()
        ref.close()
