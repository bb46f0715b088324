"""match_phrase_prefix: a phrase whose last term expands over the dictionary.

The last term expands against the field's term dictionary at prepare time
(at most max_expansions terms, as the reference's MultiPhrasePrefixQuery
bounds it); the node evaluates one phrase per expansion and keeps the best
score per doc (dis_max over complete phrases). On several shards the
expansions are global, taken over every shard's dictionary, so each shard
runs the same phrases (reference `prefix_phrase.py:28-40`).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field as dc_field

from .nodes import DisMaxNode, MatchNoneNode, PhraseNode, QueryNode


@dataclass
class PhrasePrefixNode(QueryNode):
    fld: str = ""
    terms: list = dc_field(default_factory=list)  # [(term, position)] before the prefix
    prefix: str = ""
    prefix_position: int = 0
    max_expansions: int = 50
    boost: float = 1.0
    _inner: QueryNode | None = None

    def prepare(self, pack):
        stacked = getattr(pack, "stacked", None)
        all_terms = (stacked if stacked is not None else pack).terms_for_field(self.fld)
        expansions = []
        for t in all_terms[bisect.bisect_left(all_terms, self.prefix):]:
            if not t.startswith(self.prefix) or len(expansions) >= self.max_expansions:
                break
            expansions.append(t)
        if not expansions:
            self._inner = MatchNoneNode()
        else:
            self._inner = DisMaxNode(children=[
                PhraseNode(self.fld, self.terms + [(t, self.prefix_position)], boost=self.boost)
                for t in expansions])
        return self._inner.prepare(pack)

    def device_eval(self, dev, params, ctx):
        return self._inner.device_eval(dev, params, ctx)
