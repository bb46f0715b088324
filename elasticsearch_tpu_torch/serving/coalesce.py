"""Plan-shape classification for batched serving.

Only `term_disjunction_of` is ported: it decides which parsed queries the
batched `_msearch` arms serve.
"""

from __future__ import annotations

from ..query.nodes import BoolNode, TermNode


def term_disjunction_of(node):
    """(field, [(term, boost), ...]) when `node` is a pure OR-of-terms the
    batched msearch arms serve exactly (match / term / bool-should-of-terms
    on ONE field, minimum_should_match 1, every boost > 0: the arms'
    'matches == score > 0' contract), else None."""
    if isinstance(node, TermNode):
        if node.boost > 0:
            return node.fld, [(node.term, float(node.boost))]
        return None
    if isinstance(node, BoolNode):
        if node.must or node.filter or node.must_not:
            return None
        if node._msm() != 1 or node.boost != 1.0:
            return None
        fld, terms = None, []
        for c in node.should:
            if not isinstance(c, TermNode) or c.boost <= 0:
                return None
            if fld is None:
                fld = c.fld
            elif c.fld != fld:
                return None
            terms.append((c.term, float(c.boost)))
        if fld is None:
            return None
        return fld, terms
    return None
