"""The unified-style highlighter: re-analyze a hit's text, mark the query's
terms (reference `search/highlight.py`; behavior:
search/fetch/subphase/highlight/, the unified highlighter over Lucene's
UnifiedHighlighter).

`extract_query_terms` walks the raw query DSL and collects, per field, the
analyzed terms it matches (prefix and wildcard terms as patterns). Each
hit's text goes through the field's own analyzer (custom analyzers and
synonym filters included), and the tokens whose term is wanted give the
(start_offset, end_offset) spans that are marked. Up to
`number_of_fragments` fragments of about `fragment_size` characters come
back, with `pre_tags` / `post_tags` around each match, by score on
`order: "score"`; `number_of_fragments: 0` returns the whole value.
`require_field_match` (default true) keeps a field to the terms that the
query addressed to it.

It runs on the host: it reads the page's final hits only and is string
work, as the reference keeps it off the accelerator.
"""

from __future__ import annotations

import fnmatch

from ..utils.errors import IllegalArgumentError
from .fetch import flatten_source

_TEXT_TYPES = ("text", "match_only_text", "search_as_you_type")


def extract_query_terms(query, mappings) -> dict[str, set]:
    """-> {field: wanted terms}; a prefix or wildcard term is a
    ("__pattern__", pattern) pair matched against the doc's tokens."""
    terms: dict[str, set] = {}

    def add(fld, values):
        terms.setdefault(fld, set()).update(values)

    def analyze(fld, text):
        ft = mappings.fields.get(fld)
        if ft is None or ft.type not in _TEXT_TYPES:
            return [str(text)]
        return [t.term for t in ft.get_search_analyzer().analyze(str(text))]

    def walk(q):
        if not isinstance(q, dict) or len(q) != 1:
            return
        (kind, body), = q.items()
        if kind == "bool":
            for sect in ("must", "should", "filter"):
                clauses = body.get(sect) or []
                if isinstance(clauses, dict):
                    clauses = [clauses]
                for c in clauses:
                    walk(c)
        elif kind == "dis_max":
            for c in body.get("queries") or []:
                walk(c)
        elif kind == "constant_score":
            walk(body.get("filter"))
        elif kind == "function_score":
            walk(body.get("query"))
        elif kind in ("match", "match_phrase", "match_phrase_prefix"):
            (fld, spec), = body.items()
            add(fld, analyze(fld, spec.get("query") if isinstance(spec, dict) else spec))
        elif kind == "multi_match":
            text = body.get("query")
            for f in body.get("fields") or []:
                f = f.split("^")[0]
                add(f, analyze(f, text))
        elif kind == "term":
            (fld, spec), = body.items()
            add(fld, [str(spec.get("value") if isinstance(spec, dict) else spec)])
        elif kind == "terms":
            for fld, vals in body.items():
                if fld != "boost" and isinstance(vals, list):
                    add(fld, [str(v) for v in vals])
        elif kind in ("prefix", "wildcard", "fuzzy"):
            # a fuzzy term marks its exact spelling only, a regexp nothing
            (fld, spec), = body.items()
            pat = str(spec.get("value") if isinstance(spec, dict) else spec).lower()
            if kind == "prefix":
                pat += "*"
            terms.setdefault(fld, set()).add(("__pattern__", pat))
        elif kind == "regexp":
            (_fld, _spec), = body.items()

    walk(query)
    return terms


def _token_matches(term: str, wanted: set) -> bool:
    for w in wanted:
        if isinstance(w, tuple):  # ("__pattern__", pattern)
            if fnmatch.fnmatchcase(term, w[1]):
                return True
        elif term == w:
            return True
    return False


def _fragment_spans(text: str, matches: list[tuple[int, int]],
                    fragment_size: int) -> list[tuple[int, int, list[tuple[int, int]]]]:
    """Greedy windows of about fragment_size characters over the match
    spans -> [(fragment start, fragment end, the matches it holds)]."""
    frags = []
    i = 0
    while i < len(matches):
        s0 = matches[i][0]
        # leading context, the window's start snapped after a space
        start = max(0, s0 - max((fragment_size - (matches[i][1] - s0)) // 2, 0))
        sp = text.rfind(" ", 0, start + 1)
        if sp >= 0 and start > 0:
            start = sp + 1
        end = min(len(text), start + fragment_size)
        group = []
        while i < len(matches) and matches[i][1] <= end:
            group.append(matches[i])
            i += 1
        if not group:
            # a match that ends past its window (longer than fragment_size,
            # or after a far snap back): the fragment holds it whole, where
            # the reference's loop makes no progress
            group.append(matches[i])
            end = matches[i][1]
            i += 1
        if i < len(matches) and matches[i][0] < end:
            end = matches[i][0]  # never cut a match in half
        else:
            sp = text.find(" ", end)
            end = sp if sp >= 0 else len(text)
        frags.append((start, end, group))
    return frags


def _render(text: str, start: int, end: int, group, pre: str, post: str) -> str:
    out = []
    cur = start
    for ms, me in group:
        out += [text[cur:ms], pre, text[ms:me], post]
        cur = me
    out.append(text[cur:end])
    return "".join(out)


def highlight_field(text: str, wanted: set, ft, opts: dict) -> list[str]:
    """One text value's fragments."""
    fragment_size = int(opts.get("fragment_size", 100))
    number_of_fragments = int(opts.get("number_of_fragments", 5))
    pre = (opts.get("pre_tags") or ["<em>"])[0]
    post = (opts.get("post_tags") or ["</em>"])[0]
    if ft is None:
        return []
    matches = [(t.start_offset, t.end_offset) for t in ft.get_analyzer().analyze(text)
               if _token_matches(t.term, wanted)]
    if not matches:
        return []
    if number_of_fragments == 0:  # the whole value as one fragment
        return [_render(text, 0, len(text), matches, pre, post)]
    frags = _fragment_spans(text, matches, fragment_size)
    if opts.get("order", "none") == "score":
        frags.sort(key=lambda f: -len(f[2]))
    return [_render(text, s, e, g, pre, post) for s, e, g in frags[:number_of_fragments]]


def highlight_hit(source: dict, spec: dict, query, mappings) -> dict[str, list[str]]:
    """-> {field: [fragments]} for one hit's source."""
    if not isinstance(spec, dict) or "fields" not in spec:
        raise IllegalArgumentError("[highlight] requires [fields]")
    fields_spec = spec["fields"]
    if isinstance(fields_spec, list):  # the explicit-order array form
        merged = {}
        for entry in fields_spec:
            merged.update(entry)
        fields_spec = merged
    query_terms = extract_query_terms(query, mappings)
    require_field_match = spec.get("require_field_match", True)
    flat = flatten_source(source or {})
    out: dict[str, list[str]] = {}
    global_opts = {k: v for k, v in spec.items() if k != "fields"}
    for pattern, f_opts in fields_spec.items():
        opts = {**global_opts, **(f_opts or {})}
        hl_query = opts.get("highlight_query")
        local_terms = (extract_query_terms(hl_query, mappings) if hl_query is not None
                       else query_terms)
        for path, values in flat.items():
            if not fnmatch.fnmatchcase(path, pattern):
                continue
            ft = mappings.fields.get(path)
            if ft is None or ft.type not in ("text", "match_only_text", "keyword"):
                continue
            if opts.get("require_field_match", require_field_match):
                wanted = local_terms.get(path, set())
            else:
                wanted = set().union(*local_terms.values()) if local_terms else set()
            if not wanted:
                continue
            frags: list[str] = []
            for v in values:
                if isinstance(v, str):
                    frags.extend(highlight_field(v, wanted, ft, opts))
            if frags:
                n = int(opts.get("number_of_fragments", 5))
                out[path] = frags[:n] if n > 0 else frags
    return out
