"""Synthetic BM25 corpus and search traffic, made with numpy from a seed.

The corpus shape of the JAX package's headline benchmark (bench.py
`build_corpus`): a Zipf vocabulary of `t<rank>` terms, Poisson(mean) doc
lengths clipped below at 4, plus one `long` field `n` uniform in
[0, N_MAX) for range filters. Queries draw their terms from real
documents, deduplicated within a query (bench.py `sample_queries`).
`sample_queries` gives the headline `_msearch` traffic (bench.py config
C1): lists of (term, 1.0) for `ShardSearcher.msearch`.

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


def corpus_docs(lens, tok, nums, vocab: int = VOCAB) -> list[dict]:
    """The corpus as `{"body": "t3 t17 ...", "n": int}` sources."""
    words = [f"t{i}" for i in range(vocab)]
    flat = [words[t] for t in tok.tolist()]
    ends = np.cumsum(lens).tolist()
    docs, start = [], 0
    for end, n in zip(ends, nums.tolist()):
        docs.append({"body": " ".join(flat[start:end]), "n": n})
        start = end
    return docs


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
