"""The ip, date_nanos, flattened, rank_feature, object, nested and
percolator field types of the port, against the JAX package on the same
numpy-seeded docs.

Mirrors tests/test_field_types.py (ip term, CIDR, range and terms; numeric
ip sort; date_nanos precision and format; flattened root and keyed terms;
ip terms-agg keys), on a bare pack through each package's ShardSearcher,
then seeded bodies beyond them on 1 and 3 shards: CIDR edges, v4 against
v6 order, nanos at sub-millisecond bounds, sort and search_after on ip and
date_nanos, a tiered index and REST.

A multi-valued ip doc's CIDR and range matches read its first value (the
single-value ordinal column, as in the reference), its exact-address terms
every value (the postings). The reference side scores sparse terms from its
impact tier (`ES_TPU_IMPACT=force`), as the port does.

Tolerances: scores within 1e-6 relative and ids up to fp-ties at 1e-5
(`torch_parity.same_hits`); match sets `==`. Where the reference's engine
answers on its stacked route, which sorts an ip column's global ordinals as
strings (ROADMAP queue C: its ip sort is then lexicographic and its ip
range and CIDR planning bisects an unsorted key list), the port is held to
the reference's bare-pack ShardSearcher (address order) and to a Python
oracle over `ipaddress`.
"""

import ipaddress
import json

import numpy as np
import pytest

from elasticsearch_tpu.index import mappings as ref_mappings
from elasticsearch_tpu.index.pack import PackBuilder as RefBuilder
from elasticsearch_tpu.query import ShardSearcher as RefSearcher
from elasticsearch_tpu.query.dsl import parse_query as ref_parse
from elasticsearch_tpu_torch.convert import pack_from_reference
from elasticsearch_tpu_torch.index.mappings import (Mappings, format_date_nanos, ip_sort_key,
                                                    parse_date_to_nanos)
from elasticsearch_tpu_torch.index.pack import PackBuilder
from elasticsearch_tpu_torch.query.dsl import parse_query
from elasticsearch_tpu_torch.query.executor import ShardSearcher
from elasticsearch_tpu_torch.query.sort import parse_sort
from elasticsearch_tpu_torch.rest import make_app
from torch_parity import Pair, pages_of, same_hits

@pytest.fixture(autouse=True)
def _reference_impact(monkeypatch):
    monkeypatch.setenv("ES_TPU_IMPACT", "force")
    from elasticsearch_tpu.planner import reset_for_tests as ref_planner_reset
    from elasticsearch_tpu_torch.planner import reset_for_tests as planner_reset

    planner_reset()
    ref_planner_reset()


REF_DOCS = [
    {"ip": "192.168.1.7", "ts": "2015-01-01T12:10:30.123456789Z",
     "flat": {"a": "x", "b": {"c": "y"}}},
    {"ip": "10.0.0.1", "ts": "2015-01-01T12:10:30.123456788Z", "flat": {"a": "z"}},
    {"ip": "2001:db8::1", "ts": "2015-01-02T00:00:00Z", "flat": {"a": "x"}},
]
REF_MAPPING = {"properties": {"ip": {"type": "ip"}, "ts": {"type": "date_nanos"},
                              "flat": {"type": "flattened"}}}


def _bare(docs, mapping):
    """The same docs as a bare pack in both packages: (port searcher, its
    mappings, reference searcher, its mappings)."""
    m, rm = Mappings(mapping), ref_mappings.Mappings(mapping)
    b, rb = PackBuilder(m), RefBuilder(rm)
    for d in docs:
        b.add_document(m.parse_document(d))
        rb.add_document(rm.parse_document(d))
    return ShardSearcher(b.build(), device="cpu", mappings=m), m, RefSearcher(rb.build(), mappings=rm), rm


@pytest.fixture(scope="module")
def bare():
    return _bare(REF_DOCS, REF_MAPPING)


REFERENCE_BODIES = [
    ({"term": {"ip": "10.0.0.1"}}, [1]),
    ({"term": {"ip": "2001:0db8:0000::0001"}}, [2]),
    ({"term": {"ip": "192.168.0.0/16"}}, [0]),
    ({"term": {"ip": "2001:db8::/32"}}, [2]),
    ({"range": {"ip": {"gte": "10.0.0.0", "lte": "192.168.255.255"}}}, [0, 1]),
    ({"terms": {"ip": ["10.0.0.1", "192.168.0.0/16"]}}, [0, 1]),
    ({"range": {"ts": {"gt": "2015-01-01T12:10:30.123456788Z"}}}, [0, 2]),
    ({"term": {"ts": "2015-01-01T12:10:30.123456789Z"}}, [0]),
    ({"term": {"flat": "x"}}, [0, 2]),
    ({"term": {"flat": "y"}}, [0]),
    ({"term": {"flat.a": "x"}}, [0, 2]),
    ({"term": {"flat.b.c": "y"}}, [0]),
    ({"term": {"flat.a": "y"}}, []),
]


@pytest.mark.parametrize("body,want", REFERENCE_BODIES, ids=[json.dumps(b) for b, _ in REFERENCE_BODIES])
def test_reference_type_bodies(bare, body, want):
    s, m, rs, rm = bare
    got = s.search(parse_query(body, m), size=10)
    ref = rs.search(ref_parse(body, rm), size=10)
    assert sorted(int(x) for x in got.doc_ids) == sorted(int(x) for x in ref.doc_ids) == want
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-6)


def test_reference_ip_sort_and_terms_agg_keys(bare):
    s, m, rs, rm = bare
    hits, _total, _aggs = s.search_sorted(parse_query(None, m), parse_sort([{"ip": "asc"}]),
                                          size=10)
    from elasticsearch_tpu.query.sort import parse_sort as ref_sort

    ref_hits, _t, _a = rs.search_sorted(ref_parse(None, rm), ref_sort([{"ip": "asc"}]), size=10)
    # 10.0.0.1 < 192.168.1.7 < 2001:db8::1 (v4 below v6)
    assert [d for d, _ in hits] == [d for d, _ in ref_hits] == [1, 0, 2]
    aggs = {"ips": {"terms": {"field": "ip"}}}
    got = s.search(parse_query(None, m), size=0, aggs=aggs).aggregations
    want = rs.search(ref_parse(None, rm), size=0, aggs=aggs).aggregations
    assert got == want
    assert {b["key"] for b in got["ips"]["buckets"]} == {"10.0.0.1", "192.168.1.7", "2001:db8::1"}


@pytest.mark.parametrize("value", [
    "2015-01-01T12:10:30.123456789Z", "2015-01-01T12:10:30.1234Z", "2015-01-01T12:10:30Z",
    "2015-01-01 12:10:30.000000001+01:00", "2015-01-01", "2015-01", "1420070400123", 1420070400123,
    "1970-01-01T00:00:00.000000001Z", "1969-12-31T23:59:59.999999999Z"])
def test_date_nanos_parse_and_format_match_reference(value):
    n = parse_date_to_nanos(value)
    assert n == ref_mappings.parse_date_to_nanos(value)
    assert format_date_nanos(n) == ref_mappings.format_date_nanos(n)


def test_ip_sort_key_orders_v4_below_v6():
    ips = ["::1", "10.0.0.2", "10.0.0.10", "255.255.255.255", "::ffff:1.2.3.4", "2001:db8::",
           "1.2.3.5", "::", "0.0.0.0", "fe80::1"]
    got = sorted(ips, key=ip_sort_key)
    assert got == sorted(ips, key=ref_mappings.ip_sort_key)
    assert got.index("10.0.0.10") > got.index("10.0.0.2")
    assert max(got.index(i) for i in ips if ":" not in i) < got.index("2001:db8::")


# ---------------------------------------------------------------------------
# seeded docs: mappings, parsing and the pack's columns
# ---------------------------------------------------------------------------

MAPPING = {"properties": {
    "ip": {"type": "ip"}, "ts": {"type": "date_nanos"}, "flat": {"type": "flattened"},
    "rank": {"type": "rank_feature"}, "body": {"type": "text"},
    "obj": {"type": "object", "properties": {"k": {"type": "keyword"}, "n": {"type": "long"}}},
    "kids": {"type": "nested", "properties": {"name": {"type": "keyword"},
                                              "age": {"type": "integer"}}},
    "q": {"type": "percolator"}, "loc": {"type": "geo_point"}}}
T0_NS = 1_700_000_000_000_000_000


def typed_docs(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        v6 = i % 5 == 0
        ip = (f"2001:db8:{int(rng.integers(0, 4)):x}::{int(rng.integers(0, 4096)):x}" if v6
              else f"10.{int(rng.integers(0, 3))}.{int(rng.integers(0, 256))}."
                   f"{int(rng.integers(0, 256))}")
        ns = T0_NS + int(rng.integers(0, 5_000_000))  # a 5 ms window: sub-ms spacing
        src = {"ip": ip, "ts": format_date_nanos(ns) if i % 3 else ns // 1_000_000,
               "flat": {"env": f"e{i % 3}", "tier": {"name": f"t{int(rng.integers(0, 4))}"}},
               "rank": float(rng.uniform(0.5, 100.0)), "body": f"w{i % 5} w{int(rng.integers(0, 7))}",
               "obj": {"k": f"k{i % 4}", "n": int(rng.integers(0, 100))},
               "kids": [{"name": f"c{int(rng.integers(0, 6))}", "age": int(rng.integers(1, 18))}
                        for _ in range(int(rng.integers(1, 4)))]}
        if i % 11 == 0:
            src["q"] = {"match": {"body": f"w{i % 5}"}}
        if i % 4:
            src["loc"] = {"lat": float(rng.uniform(-50, 50)), "lon": float(rng.uniform(-170, 170))}
        if i % 13 == 0:
            src["ip"] = [ip, "10.0.0.1"]  # multi-valued
        docs.append((f"t{i}", src))
    return docs


def test_mappings_and_documents_match_reference():
    docs = typed_docs(1, 60)
    m, rm = Mappings(MAPPING), ref_mappings.Mappings(MAPPING)
    for _i, d in docs:
        assert m.parse_document(d) == rm.parse_document(d)
    assert {f: ft.type for f, ft in m.fields.items()} == {f: ft.type for f, ft in rm.fields.items()}
    assert m.nested_paths == rm.nested_paths == {"kids"}


def test_pack_columns_byte_equal_and_convert_round_trip():
    """The pack's new columns (ip ordinals in address order, int64 nanos,
    float32 geo columns, flattened keyed fields), the term dictionary and
    the percolator map equal the reference's; `convert.pack_from_reference`
    carries a reference pack across with all of them."""
    docs = typed_docs(2, 200)
    m, rm = Mappings(MAPPING), ref_mappings.Mappings(MAPPING)
    b, rb = PackBuilder(m), RefBuilder(rm)
    b.add_documents_batch([m.parse_document(d) for _i, d in docs], [i for i, _d in docs])
    for i, d in docs:
        rb.add_document(rm.parse_document(d), doc_id=i)
    got, want = b.build(), rb.build()
    conv = pack_from_reference(want)
    assert got.term_dict == want.term_dict
    assert set(got.docvalues) == set(want.docvalues) >= {"ip", "ts", "loc#lat", "loc#lon",
                                                          "flat.env", "flat.tier.name", "rank"}
    for pk in (got, conv):
        for fld, col in want.docvalues.items():
            g = pk.docvalues[fld]
            assert g.kind == col.kind and g.ord_terms == col.ord_terms, fld
            assert g.values.dtype == col.values.dtype and g.values.tobytes() == col.values.tobytes()
            assert g.has_value.tobytes() == col.has_value.tobytes(), fld
        assert pk.percolator == want.percolator
    assert got.docvalues["ts"].values.dtype == np.int64
    assert got.docvalues["ip"].ord_terms == sorted(got.docvalues["ip"].ord_terms, key=ip_sort_key)


# ---------------------------------------------------------------------------
# queries through the engine on 1 and 3 shards
# ---------------------------------------------------------------------------

@pytest.fixture(params=[1, 3], ids=["1shard", "3shards"], scope="module")
def typed(request):
    docs = typed_docs(10 + request.param, 400)
    p = Pair(MAPPING, {"number_of_shards": request.param})
    p.index(docs)
    p.refresh()
    one = Pair(MAPPING)  # the reference's one-shard answers on the same docs
    one.index(docs)
    one.refresh()
    yield p, one, docs
    p.close()
    one.close()


def _ips_of(src) -> list:
    v = src["ip"]
    return [str(ipaddress.ip_address(x)) for x in (v if isinstance(v, list) else [v])]


def _oracle(docs, pred) -> set:
    """The docs whose first address (the ordinal column's) satisfies pred."""
    return {i for i, src in docs if pred(ipaddress.ip_address(_ips_of(src)[0]))}


CIDRS = ["10.1.0.0/16", "10.1.7.0/24", "10.2.255.0/24", "10.0.0.1/32", "10.0.0.0/8",
         "2001:db8:1::/48", "2001:db8::/32", "0.0.0.0/0", "10.1.7.128/25", "::/0"]


@pytest.mark.parametrize("cidr", CIDRS)
def test_cidr_terms_and_edges(typed, cidr):
    p, one, docs = typed
    net = ipaddress.ip_network(cidr, strict=False)
    # a block is the address-key interval of its ends (v4 keys are their
    # v6-mapped form, so ::/0 holds every v4 address too, as in Elasticsearch)
    klo, khi = ip_sort_key(str(net.network_address)), ip_sort_key(str(net.broadcast_address))
    want = _oracle(docs, lambda a: klo <= ip_sort_key(str(a)) <= khi)
    q = {"term": {"ip": cidr}}
    got = p.port.search(q, size=len(docs))
    assert {h["_id"] for h in got["hits"]["hits"]} == want
    assert got["hits"]["total"]["value"] == len(want)
    # the edges: the network and broadcast addresses are in, their
    # neighbours out
    lo, hi = net.network_address, net.broadcast_address
    edge = [(f"{cidr}-lo", {"ip": str(lo)}), (f"{cidr}-hi", {"ip": str(hi)})]
    if int(lo) > 0:
        edge.append((f"{cidr}-below", {"ip": str(lo - 1)}))
    if int(hi) < (1 << (32 if net.version == 4 else 128)) - 1:
        edge.append((f"{cidr}-above", {"ip": str(hi + 1)}))
    e = Pair({"properties": {"ip": {"type": "ip"}}})
    try:
        e.index(edge)
        e.refresh()
        ids = {h["_id"] for h in e.port.search(q, size=10)["hits"]["hits"]}
        assert ids == {f"{cidr}-lo", f"{cidr}-hi"}
    finally:
        e.close()


@pytest.mark.parametrize("q", [
    {"term": {"ip": "10.0.0.1"}}, {"term": {"ip": "2001:0db8:0001:0000::0001"}},
    {"match": {"ip": "10.1.2.3"}},
    {"terms": {"ip": ["10.1.0.0/16", "2001:db8:2::/48", "10.0.0.1"]}},
    {"range": {"ip": {"gte": "10.1.0.0", "lt": "10.2.0.0"}}},
    {"range": {"ip": {"gt": "10.2.128.0"}}},
    {"range": {"ip": {"gte": "10.2.0.0", "lte": "2001:db8:1::"}}},
    {"bool": {"must": [{"match": {"body": "w1"}}], "filter": [{"term": {"ip": "10.1.0.0/16"}}]}},
], ids=lambda q: json.dumps(q))
def test_ip_queries_match_reference_one_shard(typed, q):
    """Held to the reference's one-shard index of the same docs (its answers
    there bisect address-ordered keys when the pack is one shard of a
    stacked pack of one... which sorts them as strings: so ranges are also
    held to the `ipaddress` oracle)."""
    p, one, docs = typed
    got = p.port.search(q, size=len(docs))
    if "range" in q:
        (spec,) = q["range"].values()
        key = lambda a: ip_sort_key(str(a))  # noqa: E731
        lo = spec.get("gte", spec.get("gt"))
        hi = spec.get("lte", spec.get("lt"))
        want = _oracle(docs, lambda a: (lo is None or (key(a) >= ip_sort_key(lo) if "gte" in spec
                                                       else key(a) > ip_sort_key(lo)))
                       and (hi is None or (key(a) <= ip_sort_key(hi) if "lte" in spec
                                           else key(a) < ip_sort_key(hi))))
        assert {h["_id"] for h in got["hits"]["hits"]} == want
        return
    want = one.ref.search(query=q, size=len(docs))
    same_hits(got, want, json.dumps(q))


@pytest.mark.parametrize("q", [
    {"range": {"ts": {"gt": "2023-11-14T22:13:20.000500000Z"}}},
    {"range": {"ts": {"gte": "2023-11-14T22:13:20.001000001Z", "lt": "2023-11-14T22:13:20.0025Z"}}},
    {"range": {"ts": {"lte": "2023-11-14T22:13:20.000000999Z"}}},
    {"range": {"ts": {"gte": 1700000000001, "lte": 1700000000003}}},
    {"terms": {"ts": ["2023-11-14T22:13:20.000000000Z", 1700000000002]}},
    {"term": {"flat": "e1"}}, {"term": {"flat.tier.name": "t2"}}, {"terms": {"flat.env": ["e0", "e2"]}},
    {"term": {"obj.k": "k2"}}, {"range": {"obj.n": {"gte": 50}}},
    {"term": {"kids.name": "c3"}}, {"rank_feature": {"field": "rank"}},
    {"exists": {"field": "loc"}},
], ids=lambda q: json.dumps(q))
def test_nanos_flattened_object_queries_match_reference(typed, q):
    p, _one, docs = typed
    p.check(json.dumps(q), query=q, size=20)


def test_nanos_sub_millisecond_bounds_against_oracle(typed):
    p, _one, docs = typed
    ns = {i: parse_date_to_nanos(src["ts"]) for i, src in docs}
    for lo in (T0_NS + 1, T0_NS + 999_999, T0_NS + 1_000_000, T0_NS + 2_500_001):
        q = {"range": {"ts": {"gt": format_date_nanos(lo), "lte": format_date_nanos(lo + 750_000)}}}
        got = {h["_id"] for h in p.port.search(q, size=len(docs))["hits"]["hits"]}
        assert got == {i for i, v in ns.items() if lo < v <= lo + 750_000}, q


def test_sort_and_search_after_on_ip_and_nanos(typed):
    """ip sorts in address order (v4 below v6), date_nanos by int64 nanos;
    10 search_after pages of 20 give the one sorted page's hits."""
    p, _one, docs = typed
    n = len(docs)
    for sort in ([{"ip": "asc"}, {"ts": "asc"}], [{"ts": "desc"}], [{"ip": "desc"}, "_doc"]):
        one = p.port.search({"match_all": {}}, size=n, sort=sort)["hits"]["hits"]
        paged, after = [], None
        for _ in range(10):
            kw = {"search_after": after} if after is not None else {}
            page = p.port.search({"match_all": {}}, size=20, sort=sort, **kw)["hits"]["hits"]
            if not page:
                break
            paged += page
            after = page[-1]["sort"]
        assert [h["_id"] for h in paged] == [h["_id"] for h in pages_of(one, 20, 10)]
        if sort[0] == {"ts": "desc"}:
            vals = [h["sort"][0] for h in one]
            assert all(isinstance(v, int) for v in vals) and vals == sorted(vals, reverse=True)
            assert vals == sorted((parse_date_to_nanos(s["ts"]) for _i, s in docs), reverse=True)
            want = p.ref.search(query={"match_all": {}}, size=n, sort=sort)["hits"]["hits"]
            assert [h["sort"] for h in one] == [h["sort"] for h in want]
        else:
            keys = [ip_sort_key(h["sort"][0]) for h in one]
            desc = sort[0] == {"ip": "desc"}
            assert keys == sorted(keys, reverse=desc)
            # each hit's key: the doc's first value, its single-value column
            assert all(h["sort"][0] == _ips_of(dict(docs)[h["_id"]])[0] for h in one)


def test_fields_option_formats_date_nanos_like_reference():
    from elasticsearch_tpu.search.fetch import fields_option as ref_fields

    docs = typed_docs(3, 30)
    app = make_app(device="cpu")
    try:
        assert app.handle("PUT", "/t", {}, {}, json.dumps({"mappings": MAPPING}).encode())[0] == 200
        nd = "".join(json.dumps({"index": {"_index": "t", "_id": i}}) + "\n" + json.dumps(s) + "\n"
                     for i, s in docs).encode()
        assert app.handle("POST", "/_bulk", {"refresh": "true"}, {}, nd)[0] == 200
        rm = ref_mappings.Mappings(MAPPING)
        for fields in (["ts", "ip"], [{"field": "ts", "format": "epoch_millis"}], ["flat.*", "t*"]):
            body = {"query": {"range": {"ts": {"gte": "2023-11-14T22:13:20.0001Z"}}},
                    "fields": fields, "size": 30}
            st, _h, out = app.handle("POST", "/t/_search", {}, {}, json.dumps(body).encode())
            assert st == 200
            hits = json.loads(out)["hits"]["hits"]
            assert hits
            for h in hits:
                assert h["fields"] == ref_fields(h["_source"], fields, rm), fields
    finally:
        app.close()


def test_types_on_a_tiered_index():
    """Base + two tail segments: ip terms, nanos ranges and flattened terms
    run on each tier (tier-safe) and merge as the reference's do."""
    docs = typed_docs(21, 600)
    p = Pair(MAPPING)
    try:
        p.index(docs[:450])
        p.refresh()
        p.index(docs[450:530])
        p.refresh()
        p.index(docs[530:] + [("t4", {"ip": "10.9.9.9", "ts": "2023-11-14T22:13:20.000000007Z",
                                      "body": "w1"})])
        p.refresh()
        assert len(p.port._tails) == 2
        for q in ({"term": {"ip": "10.9.9.9"}}, {"term": {"flat.env": "e1"}},
                  {"range": {"ts": {"lt": "2023-11-14T22:13:20.000100Z"}}},
                  {"bool": {"should": [{"match": {"body": "w1"}}, {"term": {"ip": "10.0.0.1"}}]}}):
            p.check(json.dumps(q), query=q, size=15)
        assert len(p.port._tails) == 2  # these kinds are tier-safe
        got = {h["_id"] for h in p.port.search({"term": {"ip": "10.1.0.0/16"}}, size=600)["hits"]["hits"]}
        live = dict(docs[:530] + docs[530:])
        live["t4"] = {"ip": "10.9.9.9"}
        assert got == _oracle(list(live.items()), lambda a: a.version == 4 and
                              a in ipaddress.ip_network("10.1.0.0/16"))
    finally:
        p.close()
