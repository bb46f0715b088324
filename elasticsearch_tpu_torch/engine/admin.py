"""The search-side admin APIs: `_analyze`, `_validate/query`, `_termvectors`.

Counterpart of the first three functions of the JAX package's
`engine/admin.py` (behavior: rest-api-spec indices.analyze.json,
indices.validate_query.json, termvectors.json). None of them launches a
kernel: analysis and query parsing run on the host, and term vectors
re-analyze a document's stored source (as Elasticsearch does for a field
without stored term vectors, TermVectorsService). With `term_statistics`,
each term's `doc_freq` is the index's df over every tier: the tiers merge
into one base first, as the reference's `idx.searcher` merges them, and the
df is read from the merged pack's statistics.
"""

from __future__ import annotations

from ..analysis.analyzers import get_analyzer
from ..query.dsl import parse_query
from ..utils.errors import ElasticsearchTpuError, IllegalArgumentError

# the errors a query body can raise while it is parsed on the host: the
# port's query errors, and the Python errors of a malformed or mistyped
# body (a non-numeric value for a numeric field raises ValueError, reference
# queue C); parsing launches nothing on the card
_PARSE_ERRORS = (ElasticsearchTpuError, ValueError, TypeError, KeyError, AttributeError)


def analyze(engine, index: str | None, body: dict) -> dict:
    """POST /_analyze: the tokens an analyzer makes of `text` (a string or
    a list; positions of each later text start 100 past the last)."""
    texts = body.get("text")
    if texts is None:
        raise IllegalArgumentError("[text] is missing")
    if isinstance(texts, str):
        texts = [texts]
    analyzer = None
    if body.get("field") and index:
        ft = engine.get_index(index).mappings.fields.get(body["field"])
        if ft is not None:
            try:
                analyzer = ft.get_analyzer()
            except ElasticsearchTpuError:  # no analyzer of that name: the default
                analyzer = None
    if analyzer is None:
        analyzer = get_analyzer(body.get("analyzer", "standard"))
    tokens = []
    pos_base = 0
    for text in texts:
        last = -1
        for tok in analyzer.analyze(text):
            tokens.append({"token": tok.term, "start_offset": tok.start_offset,
                           "end_offset": tok.end_offset, "type": "<ALPHANUM>",
                           "position": pos_base + tok.position})
            last = max(last, tok.position)
        pos_base += last + 1 + 100
    return {"tokens": tokens}


def validate_query(engine, expression: str | None, body: dict, explain: bool = False) -> dict:
    """POST /_validate/query: parse the query against each target index's
    mappings; with `explain`, each index's parsed plan or its error."""
    query = (body or {}).get("query") or {"match_all": {}}
    targets = engine.resolve_search(expression or "_all", allow_no_indices=True)
    valid = True
    error = None
    explanations = []
    for idx, _ in targets:
        try:
            node = parse_query(query, idx.mappings)
            if explain:
                explanations.append({"index": idx.name, "valid": True,
                                     "explanation": repr(node)})
        except _PARSE_ERRORS as ex:
            valid = False
            error = str(ex)
            if explain:
                explanations.append({"index": idx.name, "valid": False, "error": str(ex)})
    out = {"valid": valid, "_shards": {"total": 1, "successful": 1, "failed": 0}}
    if explain:
        out["explanations"] = explanations
    if error and not explain:
        out["error"] = error
    return out


def _doc_freq(searcher, fld: str, term: str) -> int:
    """A term's df in a merged searcher's statistics."""
    sp = getattr(searcher, "sp", None)
    if sp is not None:
        return int(sp.eff_global_df.get((fld, term), 0))
    if searcher.stats_override is not None:
        return int(searcher.stats_override["global_df"].get((fld, term), 0))
    tid = searcher.pack.term_dict.get((fld, term))
    return 0 if tid is None else int(searcher.pack.term_df[tid])


def termvectors(engine, index: str, doc_id: str, body: dict | None,
                fields: str | None = None) -> dict:
    """GET /{index}/_termvectors/{id}: each text field's terms of the
    stored source with their frequencies, positions and offsets, and with
    `term_statistics` their df."""
    idx = engine.get_index(index)
    entry = idx._docs.get(doc_id)
    if entry is None or not entry.alive:
        return {"_index": index, "_id": doc_id, "found": False}
    body = body or {}
    want = None
    if fields:
        want = [f.strip() for f in fields.split(",")]
    elif body.get("fields"):
        want = list(body["fields"])
    term_stats = bool(body.get("term_statistics"))
    idx._maybe_refresh()
    parsed = idx.mappings.parse_document(entry.source)
    tv = {}
    for fld, values in parsed.items():
        ft = idx.mappings.fields.get(fld)
        if ft is None or ft.type not in ("text", "match_only_text"):
            continue
        if want is not None and fld not in want:
            continue
        analyzer = ft.get_analyzer()
        terms: dict[str, dict] = {}
        pos_base = 0
        for v in values:
            last = -1
            for tok in analyzer.analyze(v):
                t = terms.setdefault(tok.term, {"term_freq": 0, "tokens": []})
                t["term_freq"] += 1
                t["tokens"].append({"position": pos_base + tok.position,
                                    "start_offset": tok.start_offset,
                                    "end_offset": tok.end_offset})
                last = max(last, tok.position)
            pos_base += last + 1 + 100
        if term_stats and idx._searcher is not None:
            searcher = idx.searcher  # the tiers merge first: every tier counts in df
            for term, t in terms.items():
                t["doc_freq"] = _doc_freq(searcher, fld, term)
        tv[fld] = {"field_statistics": {"sum_doc_freq": sum(t["term_freq"]
                                                            for t in terms.values()),
                                        "doc_count": 1, "sum_ttf": -1},
                   "terms": terms}
    return {"_index": index, "_id": doc_id, "_version": entry.version, "found": True,
            "took": 0, "term_vectors": tv}
