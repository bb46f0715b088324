"""The suggesters: term, phrase and completion (reference
`search/suggest.py`; behavior: search/suggest/term/TermSuggester.java,
phrase/PhraseSuggester.java, completion/CompletionSuggester.java).

- `term`: per analyzed token of the text, the dictionary terms within
  `max_edits` (Damerau-Levenshtein, `query.dsl._edit_distance_within`)
  that share its first `prefix_length` characters, scored 1 - d / the
  shorter length and ordered by (score desc, df desc, term);
- `phrase`: each token's best corrections combined, the reference's
  simplification without the n-gram language model;
- `completion`: two bisects into the index's input-sorted (input, weight,
  shard, docid) list give the prefix's run, whose entries are taken in
  (weight desc, input, shard, docid) order, one option per doc
  (`skip_duplicates`: per input text too), as the reference's sort of the
  run orders them.

All of it runs on the host over the merged searcher's dictionary and
global document frequencies, as in the reference: a suggest reads no
device array. `SuggestView` groups a field's terms by length once per
searcher, their characters as int32 code points (the reference sorts the
whole dictionary for every token and checks each term in a Python loop);
a token's edit-distance table then runs over the terms of each length
that can qualify at once, as numpy vectors (`query.dsl.edits_within_many`). It also
orders a completion list by weight once (`by_weight`; the reference sorts
the prefix's run on every request). The candidates, options and their
order are the reference's.
"""

from __future__ import annotations

import bisect
import itertools

import numpy as np

from ..query.dsl import _edit_distance_within, bucket_by_length, edits_within_many
from ..utils.errors import IllegalArgumentError


class SuggestView:
    """What the suggesters read of one searcher: `global_df` {(field,
    term): df} over every shard, `completion` {field: sorted [(input,
    weight, shard, docid)]}, and each field's terms by length, made at
    first use."""

    def __init__(self, global_df: dict, completion: dict):
        self.global_df = global_df
        self.completion = completion
        self._buckets: dict[str, dict] = {}
        self._by_weight: dict[str, np.ndarray] = {}

    @classmethod
    def of(cls, searcher) -> "SuggestView":
        """The searcher's view, made once (a refresh makes a new searcher)."""
        view = getattr(searcher, "_suggest_view", None)
        if view is None:
            sp = getattr(searcher, "sp", None)
            if sp is not None:  # several shards: the stacked pack's lists
                view = cls(sp.global_df, sp.completion)
            else:
                pack = searcher.pack
                view = cls({key: int(pack.term_df[tid]) for key, tid in pack.term_dict.items()},
                           {f: [(inp, w, 0, d) for inp, w, d in v]
                            for f, v in pack.completion.items()})
            searcher._suggest_view = view
        return view

    def by_weight(self, fld: str) -> np.ndarray:
        """The positions of a completion field's input-sorted list in
        (weight desc, input, shard, docid) order: by weight, stably, as the
        list already orders each weight's entries by (input, shard,
        docid)."""
        got = self._by_weight.get(fld)
        if got is None:
            weights = np.fromiter((w for _i, w, _s, _d in self.completion.get(fld, ())),
                                  np.int64)
            got = self._by_weight[fld] = np.argsort(-weights, kind="stable")
        return got

    def field_buckets(self, fld: str) -> tuple[list, np.ndarray, dict]:
        """One field's terms, their dfs and the terms by length
        (`query.dsl.bucket_by_length`)."""
        got = self._buckets.get(fld)
        if got is None:
            pairs = [(t, df) for (f, t), df in self.global_df.items() if f == fld]
            terms = [t for t, _ in pairs]
            got = self._buckets[fld] = (terms, np.array([df for _, df in pairs], np.int64),
                                        bucket_by_length(terms))
        return got


def _similarity(a: str, b: str) -> float:
    """DirectSpellChecker-style similarity: 1 - d / the shorter length."""
    for d in (0, 1, 2):
        if _edit_distance_within(a, b, d):
            return 1.0 - d / max(min(len(a), len(b)), 1)
    return 0.0


def _analyzer_for(mappings, fld: str):
    ft = mappings.fields.get(fld)
    if ft is None:
        raise IllegalArgumentError(f"no mapping found for field [{fld}]")
    return ft.get_search_analyzer()


def _term_candidates(view: SuggestView, fld, token, *, max_edits, prefix_length, size,
                     suggest_mode, own_df):
    """The reference's candidates: terms other than the token that share its
    first prefix_length characters, of a length within max_edits of its,
    within max_edits edits (popular mode: of a higher df), by (score desc,
    df desc, term). Only the lengths that can qualify are walked."""
    tok = np.fromiter(map(ord, token), np.int32, count=len(token))
    pre = min(prefix_length, len(token))
    cands = []
    terms, field_dfs, buckets = view.field_buckets(fld)
    for n_chars, (pos, codes) in buckets.items():
        if abs(n_chars - len(token)) > max_edits:
            continue
        if prefix_length and (n_chars < prefix_length or len(token) < prefix_length):
            continue  # term[:p] == token[:p] asks both for p characters (or term == token)
        dfs = field_dfs[pos]
        keep = np.all(codes[:, :pre] == tok[:pre], axis=1)
        if n_chars == len(token):
            keep &= ~np.all(codes == tok, axis=1)
        if suggest_mode == "popular":
            keep &= dfs > own_df
        rows = np.nonzero(keep)[0]
        if not len(rows):
            continue
        for r in rows[edits_within_many(codes[rows], tok, max_edits)].tolist():
            term = terms[pos[r]]
            cands.append({"text": term, "score": round(_similarity(token, term), 6),
                          "freq": int(dfs[r])})
    cands.sort(key=lambda c: (-c["score"], -c["freq"], c["text"]))
    return cands[:size]


def term_suggest(view: SuggestView, mappings, text: str, spec: dict) -> list[dict]:
    fld = spec.get("field")
    if not fld:
        raise IllegalArgumentError("[term] suggester requires [field]")
    size = int(spec.get("size", 5))
    max_edits = int(spec.get("max_edits", 2))
    prefix_length = int(spec.get("prefix_length", 1))
    mode = spec.get("suggest_mode", "missing")
    entries = []
    for tok in _analyzer_for(mappings, fld).analyze(text):
        own_df = view.global_df.get((fld, tok.term), 0)
        options = []
        if not (mode == "missing" and own_df > 0):
            options = _term_candidates(view, fld, tok.term, max_edits=max_edits,
                                       prefix_length=prefix_length, size=size,
                                       suggest_mode=mode, own_df=own_df)
        entries.append({"text": tok.term, "offset": tok.start_offset,
                        "length": tok.end_offset - tok.start_offset, "options": options})
    return entries


def phrase_suggest(view: SuggestView, mappings, text: str, spec: dict) -> list[dict]:
    fld = spec.get("field")
    if not fld:
        raise IllegalArgumentError("[phrase] suggester requires [field]")
    size = int(spec.get("size", 5))
    max_errors = spec.get("max_errors", 1.0)
    highlight = spec.get("highlight") or {}
    pre, post = highlight.get("pre_tag", ""), highlight.get("post_tag", "")
    toks = list(_analyzer_for(mappings, fld).analyze(text))
    if not toks:
        return [{"text": text, "offset": 0, "length": len(text), "options": []}]
    max_fix = max(1, int(max_errors if max_errors >= 1 else max_errors * len(toks)))
    per_tok = []
    for tok in toks:
        own_df = view.global_df.get((fld, tok.term), 0)
        per_tok.append((tok, own_df, _term_candidates(
            view, fld, tok.term, max_edits=2, prefix_length=1, size=3,
            suggest_mode="always", own_df=own_df)))
    # the phrases that correct the max_fix most suspect tokens (df 0 first)
    suspects = sorted((i for i, (_, _df, cs) in enumerate(per_tok) if cs),
                      key=lambda i: (per_tok[i][1], -per_tok[i][2][0]["score"]))[:max_fix]
    choice_sets = []
    for i, (tok, df, cands) in enumerate(per_tok):
        if i in suspects and df == 0 and cands:
            choice_sets.append([(c["text"], c["score"], True) for c in cands[:2]])
        elif i in suspects and cands and cands[0]["score"] >= 0.5:
            choice_sets.append([(tok.term, 1.0, False)]
                               + [(c["text"], c["score"], True) for c in cands[:1]])
        else:
            choice_sets.append([(tok.term, 1.0, False)])
    options = []
    for combo in itertools.product(*choice_sets):
        if not any(changed for _, _, changed in combo):
            continue
        score = 1.0
        parts, hparts = [], []
        for t, s, changed in combo:
            score *= s
            parts.append(t)
            hparts.append(f"{pre}{t}{post}" if changed and (pre or post) else t)
        opt = {"text": " ".join(parts), "score": round(score / len(toks), 6)}
        if pre or post:
            opt["highlighted"] = " ".join(hparts)
        options.append(opt)
    options.sort(key=lambda o: (-o["score"], o["text"]))
    seen, uniq = set(), []
    for o in options:
        if o["text"] not in seen:
            seen.add(o["text"])
            uniq.append(o)
    return [{"text": text, "offset": 0, "length": len(text), "options": uniq[:size]}]


def completion_suggest(view: SuggestView, shard_docs, index_name, prefix: str,
                       spec: dict) -> list[dict]:
    fld = spec.get("field")
    if not fld:
        raise IllegalArgumentError("[completion] suggester requires [field]")
    size = int(spec.get("size", 5))
    skip_dup = bool(spec.get("skip_duplicates", False))
    entries = view.completion.get(fld, [])
    # the inputs that start with the prefix are one run [lo, hi) of the
    # input-sorted list; its entries come in weight order from by_weight
    lo, hi = 0, len(entries)
    if prefix:
        lo = bisect.bisect_left(entries, (prefix,))
        last = ord(prefix[-1])
        if last < 0x10FFFF:
            hi = bisect.bisect_left(entries, (prefix[:-1] + chr(last + 1),), lo)
    order = view.by_weight(fld)
    options, seen_ids, seen_text = [], set(), set()
    for pos in order[(order >= lo) & (order < hi)]:
        if len(options) >= size:
            break
        inp, w, s, d = entries[pos]
        if (s, d) in seen_ids or (skip_dup and inp in seen_text):
            continue
        seen_ids.add((s, d))
        seen_text.add(inp)
        doc_id, src = shard_docs[s][d]
        options.append({"text": inp, "_index": index_name, "_id": doc_id,
                        "_score": float(w), "_source": src})
    return [{"text": prefix, "offset": 0, "length": len(prefix), "options": options}]


def run_suggest(idx, body: dict) -> dict:
    """A search body's `suggest` section over one index: each named
    suggestion's entries. An index with tail tiers merges them first (the
    merged searcher), as the reference's does."""
    idx._maybe_refresh()
    view = SuggestView.of(idx.searcher)
    global_text = body.get("text")
    out = {}
    for name, spec in body.items():
        if name == "text":
            continue
        if not isinstance(spec, dict):
            raise IllegalArgumentError(f"suggestion [{name}] must be an object")
        text = spec.get("text", global_text)
        if "term" in spec:
            out[name] = term_suggest(view, idx.mappings, text or "", spec["term"])
        elif "phrase" in spec:
            out[name] = phrase_suggest(view, idx.mappings, text or "", spec["phrase"])
        elif "completion" in spec:
            out[name] = completion_suggest(view, idx.shard_docs, idx.name,
                                           spec.get("prefix") or text or "", spec["completion"])
        else:
            raise IllegalArgumentError(
                f"suggestion [{name}] requires one of [term, phrase, completion]")
    return out
