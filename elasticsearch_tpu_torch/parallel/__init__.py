"""Multi-shard indices on one device. The searcher (torch) is imported on
first use, so `parallel.stacked` (host numpy) loads without torch."""

from .stacked import StackedPack, build_stacked_pack, build_stacked_pack_routed, route_docs

__all__ = ["StackedPack", "StackedResult", "StackedSearcher", "build_stacked_pack",
           "build_stacked_pack_routed", "merge_topk_rows", "msearch_sharded", "route_docs"]


def __getattr__(name):
    if name in ("StackedResult", "StackedSearcher", "msearch_sharded"):
        from . import sharded

        return getattr(sharded, name)
    if name == "merge_topk_rows":
        from .spmd import merge_topk_rows

        return merge_topk_rows
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
