"""Custom analysis chains: char filters → tokenizer → token filters.

This package's copy of the JAX package's `analysis/custom.py`, the reference's
analysis registry built from index settings
`analysis.{char_filter,tokenizer,filter,analyzer}` (reference behavior:
index/analysis/AnalysisRegistry.java + modules/analysis-common
CommonAnalysisPlugin — custom analyzers assemble named components).

Components here: tokenizers standard/whitespace/letter/keyword/pattern;
token filters lowercase/uppercase/stop/stemmer(porter)/asciifolding/
synonym/trim/length/unique/edge_ngram/ngram/shingle; char filters
html_strip/mapping/pattern_replace. The stemmer is the classic Porter
algorithm (what `stemmer: english` selects). A synonym filter's rules come
from its `synonyms`, or from the named set (`synonyms_set`) that the engine
resolves into `_resolved_set` (`PUT /_synonyms/{set}`). Expanded tokens
(synonyms, n-grams) share their source token's position. Analysis runs on
the host, token by token, as there; a field with such an analyzer takes the
host route of the refresh (`analysis.batched`)."""

from __future__ import annotations

import functools
import re
import unicodedata

from ..utils.errors import IllegalArgumentError
from .analyzers import ENGLISH_STOP_WORDS, Analyzer, Token, get_analyzer

# ---- Porter stemmer -------------------------------------------------------

_V = "aeiou"


def _cons(w, i):
    c = w[i]
    if c in _V:
        return False
    if c == "y":
        return i == 0 or not _cons(w, i - 1)
    return True


def _measure(stem):
    n = 0
    prev_v = False
    for i in range(len(stem)):
        v = not _cons(stem, i)
        if prev_v and not v:
            n += 1
        prev_v = v
    return n


def _has_vowel(stem):
    return any(not _cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w):
    return len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)


def _cvc(w):
    if len(w) < 3:
        return False
    if not (_cons(w, len(w) - 3) and not _cons(w, len(w) - 2) and _cons(w, len(w) - 1)):
        return False
    return w[-1] not in "wxy"


@functools.lru_cache(maxsize=1 << 18)
def porter_stem(w: str) -> str:
    """The classic Porter (1980) stemmer, as Lucene's PorterStemFilter
    (memoized: a pure function of the word, called once per token)."""
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                "ive", "ize"):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 1:
                w = w[: -len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and _measure(w[:-3]) > 1:
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _cvc(w[:-1])):
            w = w[:-1]
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---- tokenizers -----------------------------------------------------------

_STD_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)?", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)
_WS_RE = re.compile(r"\S+")


def _make_tokenizer(name: str, spec: dict):
    if name == "standard" or spec.get("type") == "standard":
        return lambda text: [(m.group(0), m.start(), m.end())
                             for m in _STD_RE.finditer(text)]
    if name == "whitespace" or spec.get("type") == "whitespace":
        return lambda text: [(m.group(0), m.start(), m.end())
                             for m in _WS_RE.finditer(text)]
    if name == "letter" or spec.get("type") == "letter":
        return lambda text: [(m.group(0), m.start(), m.end())
                             for m in _LETTER_RE.finditer(text)]
    if name == "keyword" or spec.get("type") == "keyword":
        return lambda text: ([(text, 0, len(text))] if text else [])
    if spec.get("type") == "pattern" or name == "pattern":
        pat = re.compile(spec.get("pattern", r"\W+"))
        # pattern tokenizer SPLITS on the pattern

        def tok(text):
            out = []
            last = 0
            for m in pat.finditer(text):
                if m.start() > last:
                    out.append((text[last:m.start()], last, m.start()))
                last = m.end()
            if last < len(text):
                out.append((text[last:], last, len(text)))
            return out

        return tok
    raise IllegalArgumentError(f"unknown tokenizer [{name}]")


# ---- token filters --------------------------------------------------------

def per_token(fn):
    """A token filter that maps each token's text alone to its output texts
    (0..k, in order), keeping the token's offsets: the list filter, with
    `fn` kept as `.per_token` so an analyzer of such filters can memoize
    their composition per distinct token (`CustomAnalyzer.analyze`)."""
    def filt(toks):
        return [(t, a, b) for s, a, b in toks for t in fn(s)]

    filt.per_token = fn
    return filt


def _make_filter(name: str, spec: dict):
    t = spec.get("type", name)
    if t == "lowercase":
        return per_token(lambda s: [s.lower()])
    if t == "uppercase":
        return per_token(lambda s: [s.upper()])
    if t == "trim":
        return per_token(lambda s: [s.strip()])
    if t == "unique":
        def uniq(toks):
            seen = set()
            out = []
            for s, a, b in toks:
                if s not in seen:
                    seen.add(s)
                    out.append((s, a, b))
            return out

        return uniq
    if t == "stop":
        words = spec.get("stopwords", "_english_")
        if words == "_english_" or words == ["_english_"]:
            stopset = ENGLISH_STOP_WORDS
        elif isinstance(words, list):
            stopset = frozenset(x.lower() for x in words)
        else:
            stopset = ENGLISH_STOP_WORDS
        return per_token(lambda s: [] if s.lower() in stopset else [s])
    if t in ("stemmer", "porter_stem", "kstem"):
        lang = spec.get("language", spec.get("name", "english"))
        if lang not in ("english", "porter", "porter2", "light_english",
                       "minimal_english", "lovins", None):
            raise IllegalArgumentError(f"unsupported stemmer language [{lang}]")
        return per_token(lambda s: [porter_stem(s)])
    if t == "asciifolding":
        def fold(s):
            folded = unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode()
            return [folded or s]

        return per_token(fold)
    if t == "length":
        lo = int(spec.get("min", 0))
        hi = int(spec.get("max", 2**31 - 1))
        return per_token(lambda s: [s] if lo <= len(s) <= hi else [])
    if t == "synonym" or t == "synonym_graph":
        # "a, b => c" replaces; "a, b, c" expands to all
        replace: dict[str, list[str]] = {}
        expand: dict[str, list[str]] = {}
        rules = spec.get("synonyms", [])
        if not rules and spec.get("_resolved_set"):
            rules = spec["_resolved_set"]
        for rule in rules:
            if "=>" in rule:
                lhs, rhs = rule.split("=>", 1)
                targets = [x.strip().lower() for x in rhs.split(",") if x.strip()]
                for src in lhs.split(","):
                    replace[src.strip().lower()] = targets
            else:
                group = [x.strip().lower() for x in rule.split(",") if x.strip()]
                for src in group:
                    expand[src] = group

        def syn(s):
            low = s.lower()
            if low in replace:
                return replace[low]
            if low in expand:
                return expand[low]
            return [s]

        return per_token(syn)
    if t == "edge_ngram":
        lo = int(spec.get("min_gram", 1))
        hi = int(spec.get("max_gram", 2))
        return per_token(lambda s: [s[:n] for n in range(lo, min(hi, len(s)) + 1)])
    if t == "ngram":
        lo = int(spec.get("min_gram", 1))
        hi = int(spec.get("max_gram", 2))

        return per_token(lambda s: [s[i:i + n] for n in range(lo, hi + 1)
                                    for i in range(0, len(s) - n + 1)])
    if t == "shingle":
        lo = int(spec.get("min_shingle_size", 2))
        hi = int(spec.get("max_shingle_size", 2))
        keep_unigrams = bool(spec.get("output_unigrams", True))
        sep = spec.get("token_separator", " ")

        def sh(toks):
            out = list(toks) if keep_unigrams else []
            for n in range(lo, hi + 1):
                for i in range(0, len(toks) - n + 1):
                    grp = toks[i:i + n]
                    out.append((sep.join(s for s, _, _ in grp),
                                grp[0][1], grp[-1][2]))
            return out

        return sh
    raise IllegalArgumentError(f"unknown token filter [{name}]")


# ---- char filters ---------------------------------------------------------

_HTML_RE = re.compile(r"<[^>]*>")


def _make_char_filter(name: str, spec: dict):
    t = spec.get("type", name)
    if t == "html_strip":
        return lambda text: _HTML_RE.sub(" ", text)
    if t == "mapping":
        pairs = []
        for rule in spec.get("mappings", []):
            src, _, dst = rule.partition("=>")
            pairs.append((src.strip(), dst.strip()))

        def mp(text):
            for src, dst in pairs:
                text = text.replace(src, dst)
            return text

        return mp
    if t == "pattern_replace":
        pat = re.compile(spec.get("pattern", ""))
        rep = spec.get("replacement", "")
        return lambda text: pat.sub(rep, text)
    raise IllegalArgumentError(f"unknown char filter [{name}]")


class CustomAnalyzer(Analyzer):
    """Assembled chain. Token filters may change token text; offsets keep
    pointing at the originating input span (like the reference)."""

    name = "custom"

    def __init__(self, tokenizer, token_filters, char_filters,
                 max_token_length=255):
        self._tokenize = tokenizer
        self._filters = token_filters
        self._char_filters = char_filters
        self.max_token_length = max_token_length
        self.lowercase = False
        self.stopwords = frozenset()
        # a chain of per-token filters is one function of the token's text:
        # its outputs memoized per distinct token
        self._per_token = (None if not all(hasattr(f, "per_token") for f in token_filters)
                           else [f.per_token for f in token_filters])
        self._memo: dict[str, tuple] = {}

    def _outputs(self, s: str) -> tuple:
        got = self._memo.get(s)
        if got is None:
            got = [s]
            for fn in self._per_token:
                got = [t for x in got for t in fn(x)]
            got = tuple(t for t in got if t)
            if len(self._memo) >= 1 << 18:
                self._memo.clear()
            self._memo[s] = got
        return got

    def analyze(self, text: str) -> list[Token]:
        for cf in self._char_filters:
            text = cf(text)
        raw = self._tokenize(unicodedata.normalize("NFC", text))
        if self._per_token is not None:
            # each output keeps its source token's position (its index in
            # the raw stream): what the general path below gives
            return [Token(t, i, a, b) for i, (s, a, b) in enumerate(raw)
                    for t in self._outputs(s)]
        # positions come from the pre-filter stream: dropped tokens leave
        # gaps (Lucene StopFilter position increments); filter-expanded
        # tokens (synonyms, ngrams) share their source token's position
        pos_of = {a: i for i, (_, a, _b) in enumerate(raw)}
        toks = raw
        for f in self._filters:
            toks = f(toks)
        out = []
        fallback = 0
        for s, a, b in toks:
            if not s:
                continue
            pos = pos_of.get(a)
            if pos is None:
                pos = fallback
            out.append(Token(s, pos, a, b))
            fallback = pos + 1
        return out

    def tokenize(self, text: str):  # pragma: no cover - Analyzer iface
        for cf in self._char_filters:
            text = cf(text)
        yield from self._tokenize(text)


_BUILTIN_FILTERS = {"lowercase", "uppercase", "stop", "stemmer", "porter_stem",
                    "kstem", "asciifolding", "trim", "unique", "length",
                    "edge_ngram", "ngram", "shingle"}


def build_analysis_registry(analysis: dict) -> dict[str, Analyzer]:
    """index settings `analysis` section -> {analyzer_name: Analyzer}."""
    analysis = analysis or {}
    tokenizer_defs = analysis.get("tokenizer") or {}
    filter_defs = analysis.get("filter") or {}
    char_defs = analysis.get("char_filter") or {}
    out: dict[str, Analyzer] = {}
    for name, spec in (analysis.get("analyzer") or {}).items():
        atype = spec.get("type", "custom")
        if atype != "custom":
            out[name] = get_analyzer(atype)
            continue
        tok_name = spec.get("tokenizer", "standard")
        tokenizer = _make_tokenizer(tok_name, tokenizer_defs.get(tok_name, {}))
        filters = []
        for fname in spec.get("filter", []) or []:
            filters.append(_make_filter(fname, filter_defs.get(fname, {})))
        char_filters = []
        for cname in spec.get("char_filter", []) or []:
            char_filters.append(_make_char_filter(cname, char_defs.get(cname, {})))
        out[name] = CustomAnalyzer(tokenizer, filters, char_filters)
    return out
