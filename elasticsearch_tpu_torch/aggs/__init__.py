"""Aggregations: the JAX package's `aggs` package in PyTorch.

`parse_aggs` turns the request's `aggs` object into AggNode trees, which
the searchers evaluate under the query's match mask
(`query.executor.ShardSearcher`, `parallel.StackedSearcher`);
`pipeline.strip_pipeline_aggs` / `apply_pipeline_aggs` are the host-side
pipeline aggs of `engine.EsIndex.search`.
"""

from .parse import parse_aggs
from .nodes import AggNode


def two_pass_plan(agg_nodes) -> dict:
    """Top-level agg nodes needing the two-pass candidate scheme (set by
    TermsAgg.prepare for high-cardinality vocab + sub-aggs). Candidates are
    orchestrated by the searcher for TOP-LEVEL nodes only; a nested
    high-cardinality terms agg cannot be deferred and is rejected."""
    from ..utils.errors import IllegalArgumentError

    def check_nested(node):
        for c in node.children.values():
            if getattr(c, "two_pass", False):
                raise IllegalArgumentError(
                    f"high-cardinality terms agg [{c.name}] with sub-aggs "
                    f"must be top-level"
                )
            check_nested(c)

    top = {}
    for name, a in (agg_nodes or {}).items():
        check_nested(a)
        if getattr(a, "two_pass", False):
            top[name] = a
    return top
