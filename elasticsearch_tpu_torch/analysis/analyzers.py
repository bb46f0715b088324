"""Text analysis: the `standard` analyzer used by `text` fields with default
analysis.

ES `standard` = Unicode word-boundary tokenizer + lowercase filter, no
stopwords (reference: modules/analysis-common CommonAnalysisPlugin,
server/.../index/analysis/AnalysisRegistry.java). Analysis is host work at
index time and once per query string; tokens become integer term ids before
anything reaches the device.

The tokenizer, lowercasing, position and overlong-token rules are those of
the JAX package's `analysis/analyzers.py`, so both packages produce the same
terms, positions and doc lengths. Other analyzers are not ported yet.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Iterable

from ..utils.errors import IllegalArgumentError

# runs of word characters minus underscore, with one interior apostrophe
# ("don't" stays one token); numbers are tokens
_WORD_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)?", re.UNICODE)


class Token:
    __slots__ = ("term", "position", "start_offset", "end_offset")

    def __init__(self, term: str, position: int, start: int, end: int):
        self.term = term
        self.position = position
        self.start_offset = start
        self.end_offset = end

    def __repr__(self):
        return f"Token({self.term!r}@{self.position})"


class StandardAnalyzer:
    """ES `standard`: standard tokenizer + lowercase, no stopwords."""

    name = "standard"

    def __init__(self, stopwords: Iterable[str] | None = None,
                 max_token_length: int = 255):
        self.stopwords = frozenset(s.lower() for s in stopwords or ())
        self.max_token_length = max_token_length

    def tokenize(self, text: str):
        text = unicodedata.normalize("NFC", text)
        for m in _WORD_RE.finditer(text):
            yield m.group(0), m.start(), m.end()

    def analyze(self, text: str) -> list[Token]:
        """-> positioned tokens. Stopword removal leaves position gaps
        (Lucene StopFilter); overlong tokens split at max_token_length."""
        out: list[Token] = []
        pos = 0
        for term, start, end in self.tokenize(text):
            if len(term) > self.max_token_length:
                for i in range(0, len(term), self.max_token_length):
                    piece = term[i: i + self.max_token_length]
                    low = piece.lower()
                    if low not in self.stopwords:
                        out.append(Token(low, pos, start + i, start + i + len(piece)))
                    pos += 1
                continue
            term = term.lower()
            if term not in self.stopwords:
                out.append(Token(term, pos, start, end))
            pos += 1
        return out

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


_BUILTIN = {"standard": StandardAnalyzer}


def get_analyzer(name: str, **kwargs) -> StandardAnalyzer:
    cls = _BUILTIN.get(name)
    if cls is None:
        raise IllegalArgumentError(f"analyzer [{name}] is not yet ported")
    return cls(**kwargs)
