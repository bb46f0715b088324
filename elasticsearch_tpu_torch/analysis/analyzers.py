"""Text analysis: the built-in analyzers `standard`, `whitespace`, `simple`,
`stop`, `keyword` and `english`.

ES `standard` = Unicode word-boundary tokenizer + lowercase filter, no
stopwords (reference: modules/analysis-common CommonAnalysisPlugin,
server/.../index/analysis/AnalysisRegistry.java). Analysis is host work at
index time and once per query string; tokens become integer term ids before
anything reaches the device.

The tokenizers, lowercasing, stopword gaps, position and overlong-token
rules are those of the JAX package's `analysis/analyzers.py`, so both
packages produce the same terms, positions and doc lengths. `english` is a
`custom.CustomAnalyzer` chain (lowercase, possessive, english stopwords,
Porter stemmer); custom analyzers from index settings are `custom.py`'s.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Iterable

from ..utils.errors import IllegalArgumentError

# the `_english_` stop set (Lucene EnglishAnalyzer.ENGLISH_STOP_WORDS_SET)
ENGLISH_STOP_WORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split())

# runs of word characters minus underscore, with one interior apostrophe
# ("don't" stays one token); numbers are tokens
_WORD_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)?", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)
_WS_RE = re.compile(r"\S+")


class Token:
    __slots__ = ("term", "position", "start_offset", "end_offset")

    def __init__(self, term: str, position: int, start: int, end: int):
        self.term = term
        self.position = position
        self.start_offset = start
        self.end_offset = end

    def __repr__(self):
        return f"Token({self.term!r}@{self.position})"


class Analyzer:
    """Base analyzer: `tokenize` gives (text, start, end); lowercasing and
    stopwords apply after it. A dropped stopword leaves a position gap
    (Lucene StopFilter); an overlong token splits at max_token_length."""

    name = "base"
    lowercase = False
    stopwords: frozenset = frozenset()
    max_token_length = 255

    def tokenize(self, text: str):
        raise NotImplementedError

    def analyze(self, text: str) -> list[Token]:
        out: list[Token] = []
        pos = 0
        for term, start, end in self.tokenize(text):
            if len(term) > self.max_token_length:
                for i in range(0, len(term), self.max_token_length):
                    piece = term[i: i + self.max_token_length]
                    low = piece.lower() if self.lowercase else piece
                    if low not in self.stopwords:
                        out.append(Token(low, pos, start + i, start + i + len(piece)))
                    pos += 1
                continue
            if self.lowercase:
                term = term.lower()
            if term not in self.stopwords:
                out.append(Token(term, pos, start, end))
            pos += 1
        return out

    def terms(self, text: str) -> list[str]:
        return [t.term for t in self.analyze(text)]


class StandardAnalyzer(Analyzer):
    """ES `standard`: standard tokenizer + lowercase, no stopwords."""

    name = "standard"
    lowercase = True

    def __init__(self, stopwords: Iterable[str] | None = None,
                 max_token_length: int = 255):
        self.stopwords = frozenset(s.lower() for s in stopwords or ())
        self.max_token_length = max_token_length

    def tokenize(self, text: str):
        text = unicodedata.normalize("NFC", text)
        for m in _WORD_RE.finditer(text):
            yield m.group(0), m.start(), m.end()

    def terms(self, text: str) -> list[str]:
        """The terms of `analyze`, without Token objects. ASCII text takes
        one regex pass over the lowercased string: NFC is the identity on
        ASCII and lowercasing moves no ASCII word boundary, so the terms
        are those of `analyze`."""
        if text.isascii():
            toks = _WORD_RE.findall(text.lower())
            if max(map(len, toks), default=0) <= self.max_token_length:
                if self.stopwords:
                    return [t for t in toks if t not in self.stopwords]
                return toks
        return [t.term for t in self.analyze(text)]


class WhitespaceAnalyzer(Analyzer):
    name = "whitespace"

    def tokenize(self, text: str):
        for m in _WS_RE.finditer(text):
            yield m.group(0), m.start(), m.end()


class SimpleAnalyzer(Analyzer):
    """Letters-only tokenizer + lowercase (ES `simple`)."""

    name = "simple"
    lowercase = True

    def tokenize(self, text: str):
        for m in _LETTER_RE.finditer(text):
            yield m.group(0), m.start(), m.end()


class StopAnalyzer(SimpleAnalyzer):
    name = "stop"
    stopwords = ENGLISH_STOP_WORDS


class KeywordAnalyzer(Analyzer):
    """The whole input as one token (ES `keyword` analyzer)."""

    name = "keyword"

    def tokenize(self, text: str):
        if text:
            yield text, 0, len(text)


def _english_analyzer():
    """ES `english`: standard tokenizer, lowercase, possessive strip,
    english stopwords, Porter stemmer (reference behavior: Lucene
    EnglishAnalyzer wired by modules/analysis-common)."""
    from .custom import CustomAnalyzer, _make_tokenizer, per_token, porter_stem

    lower = per_token(lambda t: [t.lower()])
    possessive = per_token(lambda t: [t[:-2] if t.endswith(("'s", "\u2019s")) else t])
    stop = per_token(lambda t: [] if t in ENGLISH_STOP_WORDS else [t])
    stem = per_token(lambda t: [porter_stem(t)])
    return CustomAnalyzer(_make_tokenizer("standard", {}), [lower, possessive, stop, stem], [])


_BUILTIN = {
    "standard": StandardAnalyzer,
    "whitespace": WhitespaceAnalyzer,
    "simple": SimpleAnalyzer,
    "stop": StopAnalyzer,
    "keyword": KeywordAnalyzer,
    "english": _english_analyzer,
}


def get_analyzer(name: str, **kwargs) -> Analyzer:
    cls = _BUILTIN.get(name)
    if cls is None:
        raise IllegalArgumentError(f"unknown analyzer [{name}]")
    return cls(**kwargs) if kwargs else cls()
