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
