"""Synthetic BM25 corpus and search traffic, made with numpy from a seed.

The corpus shape of the JAX package's headline benchmark (bench.py
`build_corpus`): a Zipf vocabulary of `t<rank>` terms, Poisson(mean) doc
lengths clipped below at 4, plus one `long` field `n` uniform in
[0, N_MAX) for range filters. Queries draw their terms from real
documents, deduplicated within a query (bench.py `sample_queries`).
`sample_queries` gives the headline `_msearch` traffic (bench.py config
C1): lists of (term, 1.0) for `ShardSearcher.msearch`.

`vector_corpus` gives bench.py config C4's clustered dense vectors and its
near-data queries; `c5_corpus` and `c5_shard_docs` give config C5's
8-shard corpus; `c3_corpus` gives config C3's http_logs-like aggregation
corpus and `C3_AGGS` its request.

The traffic mix:
  - `match` of TERMS_PER_QUERY terms with operator `or`;
  - the same with operator `and`;
  - `bool`: a `must` match, a `filter` range on `n` selecting ~40% of the
    docs, and one `must_not` term among the 1,000 most frequent terms.
"""

from __future__ import annotations

import numpy as np

VOCAB = 100_000
DOC_LEN_MEAN = 40
TERMS_PER_QUERY = 4
N_MAX = 1_000_000
MAPPINGS = {"properties": {"body": {"type": "text"}, "n": {"type": "long"}}}


def make_corpus(rng: np.random.Generator, n_docs: int, vocab: int = VOCAB,
                mean_len: int = DOC_LEN_MEAN):
    """-> (lens [n_docs] int64, tok [sum(lens)] int64 term ranks, n [n_docs])."""
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    lens = rng.poisson(mean_len, size=n_docs).clip(4, None)
    tok = rng.choice(vocab, size=int(lens.sum()), p=zipf)
    nums = rng.integers(0, N_MAX, size=n_docs)
    return lens, tok, nums


def doc_texts(lens, tok, vocab: int = VOCAB, step: int = 1 << 18) -> list[str]:
    """Each doc's terms joined by single spaces ("t3 t17 ..."), built as
    bytes with numpy `step` docs at a time: every token's "t<rank> " row of
    a zero-padded byte table, the padding dropped, each doc's last space
    made a newline to split on. Every doc needs at least one token."""
    lens = np.asarray(lens, np.int64)
    if (lens < 1).any():
        raise ValueError("doc_texts needs at least one token per doc")
    words = [f"t{i} ".encode() for i in range(vocab)]
    table = np.zeros((vocab, max(map(len, words))), np.uint8)
    for i, w in enumerate(words):
        table[i, :len(w)] = np.frombuffer(w, np.uint8)
    wlen = np.array([len(w) for w in words], np.int64)
    tstart = np.concatenate([[0], np.cumsum(lens)])
    out: list[str] = []
    for d0 in range(0, len(lens), step):
        d1 = min(d0 + step, len(lens))
        t = tok[tstart[d0]: tstart[d1]]
        rows = np.take(table, t, axis=0)
        data = rows[rows != 0]
        # the byte after each doc's last token: its trailing space
        data[np.cumsum(wlen[t])[tstart[d0 + 1: d1 + 1] - tstart[d0] - 1] - 1] = ord("\n")
        out.extend(data.tobytes().decode("ascii").split("\n")[:-1])
    return out


def corpus_docs(lens, tok, nums, vocab: int = VOCAB) -> list[dict]:
    """The corpus as `{"body": "t3 t17 ...", "n": int}` sources."""
    return [{"body": text, "n": n}
            for text, n in zip(doc_texts(lens, tok, vocab), nums.tolist())]


# bench.py config C5 (`config5_8shard`, bench.py:1003-1059): C1's model on
# one corpus of 8 x 1M docs split into 8 shards by doc range, text only
C5_SHARDS = 8
C5_DOCS_PER_SHARD = 1_000_000
C5_MAPPINGS = {"properties": {"body": {"type": "text"}}}


def c5_corpus(n_per_shard: int = C5_DOCS_PER_SHARD, shards: int = C5_SHARDS,
              vocab: int = VOCAB, mean_len: int = DOC_LEN_MEAN):
    """bench.py C5's corpus on its own stream `default_rng(4242)`
    (bench.py:1022-1025): lens and tokens of shards·n_per_shard docs from
    C1's generator. -> (lens, tok, rng); rng continues the stream, so its
    next `sample_queries` batches are bench.py's two timed batches, then
    its warm-up batch (bench.py:1030-1031)."""
    rng = np.random.default_rng(4242)
    zipf = 1.0 / np.arange(1, vocab + 1)
    zipf /= zipf.sum()
    lens = rng.poisson(mean_len, size=shards * n_per_shard).clip(4, None)
    tok = rng.choice(vocab, size=int(lens.sum()), p=zipf)
    return lens, tok, rng


def c5_shard_docs(lens, tok, s: int, n_per_shard: int = C5_DOCS_PER_SHARD,
                  vocab: int = VOCAB) -> list[tuple[str, dict]]:
    """Shard s of C5: docs [s·n, (s+1)·n) of the corpus (bench.py:1059),
    as (id, {"body": text}) with the doc's corpus number as its id."""
    lo, hi = s * n_per_shard, (s + 1) * n_per_shard
    t0 = int(np.sum(lens[:lo]))
    texts = doc_texts(lens[lo:hi], tok[t0: t0 + int(np.sum(lens[lo:hi]))], vocab)
    return [(str(lo + j), {"body": text}) for j, text in enumerate(texts)]


def sample_queries(rng: np.random.Generator, lens, tok, n_queries: int,
                   terms_per_query: int = TERMS_PER_QUERY) -> list[list[tuple[str, float]]]:
    """Query terms drawn from real documents, deduplicated within a query
    (bench.py `sample_queries`)."""
    starts = np.concatenate([[0], np.cumsum(lens[:-1])])
    docs = rng.integers(0, len(lens), size=n_queries)
    out = []
    for d in docs:
        s, ln = starts[d], lens[d]
        terms = tok[s + rng.integers(0, ln, size=terms_per_query)]
        out.append([(f"t{t}", 1.0) for t in dict.fromkeys(terms)])
    return out


def _query_text(rng, starts, lens, tok) -> str:
    d = rng.integers(0, len(lens))
    terms = tok[starts[d] + rng.integers(0, lens[d], size=TERMS_PER_QUERY)]
    return " ".join(f"t{t}" for t in dict.fromkeys(terms.tolist()))


def traffic(rng: np.random.Generator, lens, tok, n_or: int, n_and: int,
            n_bool: int) -> list[dict]:
    """-> query bodies: n_or `or` matches, n_and `and` matches, n_bool bools."""
    starts = np.concatenate([[0], np.cumsum(lens[:-1])])
    top = min(1000, int(tok.max()) + 1)
    out = []
    for _ in range(n_or):
        out.append({"match": {"body": {"query": _query_text(rng, starts, lens, tok),
                                       "operator": "or"}}})
    for _ in range(n_and):
        out.append({"match": {"body": {"query": _query_text(rng, starts, lens, tok),
                                       "operator": "and"}}})
    for _ in range(n_bool):
        lo = int(rng.integers(0, N_MAX - 400_000))
        out.append({"bool": {
            "must": {"match": {"body": _query_text(rng, starts, lens, tok)}},
            "filter": {"range": {"n": {"gte": lo, "lt": lo + 400_000}}},
            "must_not": {"term": {"body": f"t{int(rng.integers(0, top))}"}},
        }})
    return out


def vector_corpus(rng: np.random.Generator, n: int, dims: int, ncl: int,
                  n_queries: int = 0):
    """bench.py C4's clustered corpus (`bench.py:940-943`): ncl centers
    ~ N(0, 1) * 4, a uniform cluster per row, noise N(0, 1) * 0.6; and
    n_queries near-data queries (`bench.py:969-970`): random rows plus
    N(0, 1) * 0.1. -> (vecs [n, dims] f32, queries [n_queries, dims] f32)."""
    centers = rng.standard_normal((ncl, dims)).astype(np.float32) * 4.0
    assign = rng.integers(0, ncl, size=n)
    vecs = centers[assign] + rng.standard_normal((n, dims)).astype(np.float32) * 0.6
    queries = (vecs[rng.integers(0, n, n_queries)]
               + rng.standard_normal((n_queries, dims)).astype(np.float32) * 0.1)
    return vecs.astype(np.float32), queries.astype(np.float32)


# bench.py C3 (`bench.py:729-831`): an http_logs-like corpus and the request
# its dashboards send, terms(status) > {date_histogram(day), sum(size)}
C3_MAPPINGS = {"properties": {
    "status": {"type": "keyword"},
    "clientip": {"type": "keyword"},
    "@timestamp": {"type": "date"},
    "size": {"type": "long"},
}}
C3_AGGS = {
    "by_status": {
        "terms": {"field": "status"},
        "aggs": {
            "over_time": {"date_histogram": {"field": "@timestamp", "calendar_interval": "day"}},
            "bytes": {"sum": {"field": "size"}},
        },
    }
}
C3_T0_MS = 1_420_070_400_000


def c3_corpus(rng: np.random.Generator, n: int) -> list[tuple[str, dict]]:
    """bench.py C3's docs, draw for draw (`bench.py:729-756`): `clientip`
    over 60,000 values, 30 days of `@timestamp` from 2015-01-01, `size` in
    [100, 100,000), `status` one of 8 draws over 5 distinct codes.
    -> [(id, source)]."""
    statuses = np.array(["200", "200", "200", "200", "304", "404", "500", "301"])
    ips = rng.integers(0, 60_000, size=n)
    times = C3_T0_MS + rng.integers(0, 30 * 86_400_000, size=n)
    sizes = rng.integers(100, 100_000, size=n)
    st = statuses[rng.integers(0, len(statuses), size=n)].tolist()
    ips, times, sizes = ips.tolist(), times.tolist(), sizes.tolist()
    return [(str(i), {"status": st[i],
                      "clientip": f"10.{ips[i] >> 8 & 255}.{ips[i] & 255}.{ips[i] % 251}",
                      "@timestamp": times[i], "size": sizes[i]})
            for i in range(n)]


# ---- slice 18: the other field types and query kinds ---------------------
# Rally's `geonames` track (geonames/index.json): name text, location
# geo_point, population long, feature_class and country_code keyword,
# elevation integer; `pop_rank` is a rank_feature copy of the population and
# `codes` / `required_matches` the terms_set pair of Elasticsearch's
# terms_set documentation
GEONAMES_MAPPINGS = {"properties": {
    "name": {"type": "text"},
    "location": {"type": "geo_point"},
    "population": {"type": "long"},
    "pop_rank": {"type": "rank_feature"},
    "feature_class": {"type": "keyword"},
    "country_code": {"type": "keyword"},
    "elevation": {"type": "integer"},
    "codes": {"type": "keyword"},
    "required_matches": {"type": "integer"},
}}
GEO_NAME_VOCAB = 20_000
GEO_CENTERS = 3_000


def geonames_corpus(rng: np.random.Generator, n: int):
    """A geonames-shaped corpus: "populated place" points clustered around
    GEO_CENTERS centers (uniform over latitudes -60..72, every longitude;
    a point N(0, 0.4 deg) around its center, longitudes wrapped), names of
    1-3 Zipf words `t<rank>`, a Zipf-like population, 9 feature classes and
    250 country codes. -> (docs [(id, source)], lat [n] f64, lon [n] f64)."""
    cen_lat = rng.uniform(-60.0, 72.0, GEO_CENTERS)
    cen_lon = rng.uniform(-180.0, 180.0, GEO_CENTERS)
    c = rng.integers(0, GEO_CENTERS, size=n)
    lat = np.clip(cen_lat[c] + rng.normal(0.0, 0.4, n), -89.5, 89.5)
    lon = (cen_lon[c] + rng.normal(0.0, 0.4, n) + 180.0) % 360.0 - 180.0
    zipf = 1.0 / np.arange(1, GEO_NAME_VOCAB + 1)
    zipf /= zipf.sum()
    nwords = rng.integers(1, 4, size=n)
    words = rng.choice(GEO_NAME_VOCAB, size=int(nwords.sum()), p=zipf)
    names = doc_texts(nwords, words, GEO_NAME_VOCAB)
    pop = (rng.pareto(1.2, n) * 200).astype(np.int64)
    fclass = np.array(list("PAHLRSTUV"))[rng.integers(0, 9, size=n)]
    cc = rng.integers(0, 250, size=n)
    elev = rng.integers(-50, 4500, size=n)
    ncodes = rng.integers(1, 4, size=n)
    codes = rng.integers(0, 12, size=(n, 3))
    req = rng.integers(1, 4, size=n)
    lat_l, lon_l, pop_l = lat.tolist(), lon.tolist(), pop.tolist()
    el_l, req_l, fc_l = elev.tolist(), req.tolist(), fclass.tolist()
    cc_names = [f"c{c:03d}" for c in range(250)]
    cc_l = [cc_names[c] for c in cc.tolist()]
    k_names = [f"k{c}" for c in range(12)]
    code_l = [[k_names[c] for c in row[:m]] for row, m in zip(codes.tolist(), ncodes.tolist())]
    docs = [(str(i), {
        "name": names[i], "location": {"lat": lat_l[i], "lon": lon_l[i]},
        "population": pop_l[i], "pop_rank": float(pop_l[i] + 1),
        "feature_class": fc_l[i], "country_code": cc_l[i], "elevation": el_l[i],
        "codes": code_l[i], "required_matches": req_l[i]}) for i in range(n)]
    return docs, lat, lon


# bench.py C3's corpus under the mapping Rally's `http_logs` track gives it:
# clientip `ip`, @timestamp `date_nanos` (corpus.C3_MAPPINGS keeps keyword
# and date)
C3_TYPED_MAPPINGS = {"properties": {
    "status": {"type": "keyword"},
    "clientip": {"type": "ip"},
    "@timestamp": {"type": "date_nanos"},
    "size": {"type": "long"},
}}


def c3_typed_docs(docs: list, rng: np.random.Generator, every: int = 10) -> list:
    """C3's docs for C3_TYPED_MAPPINGS: one doc in `every` gets its
    @timestamp as an ISO string with sub-millisecond digits (the others stay
    epoch millis, which date_nanos reads as millis)."""
    out = list(docs)
    sel = np.arange(0, len(docs), every)
    sub = rng.integers(0, 1_000_000, size=len(sel)).tolist()
    for j, i in enumerate(sel.tolist()):
        doc_id, src = docs[i]
        ms = int(src["@timestamp"])
        secs, msr = divmod(ms, 1000)
        stamp = np.datetime64(secs, "s").astype(str)
        out[i] = (doc_id, {**src, "@timestamp": f"{stamp}.{msr * 1_000_000 + sub[j]:09d}Z"})
    return out


# Rally's `nested` track (StackOverflow questions with nested answers)
QA_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "qa_date": {"type": "date"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"}, "date": {"type": "date"}, "score": {"type": "integer"}}}}}


def qa_corpus(rng: np.random.Generator, n: int, users: int = 20_000) -> list:
    """n questions, each with 1-5 nested answers (user, date, score)."""
    na = rng.integers(1, 6, size=n)
    tot = int(na.sum())
    au = rng.integers(0, users, size=tot).tolist()
    ad = (1_230_768_000_000 + rng.integers(0, 8 * 365, size=tot) * 86_400_000).tolist()
    sc = (rng.poisson(3, size=tot) - 1).tolist()
    tw = rng.integers(0, 5_000, size=(n, 4)).tolist()
    starts = np.concatenate([[0], np.cumsum(na)]).tolist()
    docs = []
    for i in range(n):
        ans = [{"user": f"u{au[j]}", "date": ad[j], "score": sc[j]}
               for j in range(starts[i], starts[i + 1])]
        docs.append((str(i), {"title": " ".join(f"q{w}" for w in tw[i]), "tag": f"g{i % 50}",
                              "qa_date": ad[starts[i]], "answers": ans}))
    return docs


# Rally's `percolator` track: stored queries over a document's text
PERCOLATOR_MAPPINGS = {"properties": {
    "query": {"type": "percolator"}, "body": {"type": "text"}, "tag": {"type": "keyword"}}}


def percolator_queries(rng: np.random.Generator, n: int, vocab: int = 2_000) -> list:
    """n stored queries over the BM25 vocabulary's `t<rank>` terms: a third
    `match` of two terms, a third `term` on a tag, a third a `bool` of a
    match and a must_not term. -> [(id, {"query": ...})]."""
    out = []
    for i in range(n):
        a, b = (f"t{int(x)}" for x in rng.integers(0, vocab, size=2))
        kind = i % 3
        if kind == 0:
            q = {"match": {"body": f"{a} {b}"}}
        elif kind == 1:
            q = {"term": {"tag": f"g{int(rng.integers(0, 20))}"}}
        else:
            q = {"bool": {"must": [{"match": {"body": a}}],
                          "must_not": [{"term": {"body": b}}]}}
        out.append((f"pq{i}", {"query": q}))
    return out
