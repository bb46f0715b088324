"""Per-query profile trees (`"profile": true`; reference `search/profile.py`,
behavior: search/profile/query/QueryProfiler and SearchProfileResults).

Every node of the parsed query reports its type, a description, a timing
breakdown and its children. Each subtree runs as a search of its own
(`searcher.search(node, size=1)`), twice: cold, then warm. `score` is the
warm run's wall; `create_weight` is the cold run less the warm one. In
this package that difference is first-launch cost: a kernel library loaded
and built on its first use, the caching allocator's first blocks, lazy
uploads; there is no trace or XLA compile. `next_doc` and `advance` are 0:
no per-document iteration exists, the scoring is a handful of device
launches and one `scan_topk` selection. At most MAX_PROFILED_NODES nodes
are walked.

The `device` section of each shard reads the request's profile events
(`telemetry.collect_profile_events`): the `kernel` events that
`telemetry.time_kernel` records, and one per `scan_topk` call
(`ops.kernels.scan_topk`). The
main search's events decide `tier`, `tiers` and `request_cache`, as in the
reference. The profile walk's own launches are listed after them, each
marked `"phase": "profile"`, so the section holds an event for every
selection the request made. The reference's `xla_drift` stamp has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import time

from ..query.nodes import QueryNode
from ..telemetry import collect_profile_events

# each profiled node runs two searches of its own: bound the walk
MAX_PROFILED_NODES = 24
# fields this package's nodes keep that the reference's do not: left out
# of a description, so the two packages describe a node alike
_UNDESCRIBED = {"literal_prefix"}


def _children(node: QueryNode) -> list[tuple[str, QueryNode]]:
    out = []
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name, None)
            if isinstance(v, QueryNode):
                out.append((f.name, v))
            elif isinstance(v, (list, tuple)):
                out.extend((f.name, x) for x in v if isinstance(x, QueryNode))
    return out


def _describe(node: QueryNode) -> str:
    parts = []
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name, None)
            if (isinstance(v, (str, int, float, bool)) and f.name != "boost"
                    and f.name not in _UNDESCRIBED):
                parts.append(f"{f.name}={v}")
    return f"{type(node).__name__}({', '.join(parts)})"


def profile_node(node: QueryNode, searcher, _budget=None) -> dict:
    """-> the profile entry of one subtree, its children first."""
    if _budget is None:
        _budget = [MAX_PROFILED_NODES]
    _budget[0] -= 1
    children = [profile_node(c, searcher, _budget)
                for _name, c in (_children(node) if _budget[0] > 0 else [])]
    t0 = time.monotonic()
    searcher.search(node, size=1)  # cold: first-launch cost + the run
    t1 = time.monotonic()
    searcher.search(node, size=1)  # warm
    t2 = time.monotonic()
    first_ns = max(int((t1 - t0 - (t2 - t1)) * 1e9), 0)
    score_ns = int((t2 - t1) * 1e9)
    out = {
        "type": type(node).__name__,
        "description": _describe(node),
        "time_in_nanos": first_ns + score_ns,
        "breakdown": {
            "create_weight": first_ns, "create_weight_count": 1,
            "score": score_ns, "score_count": 1,
            "build_scorer": 0, "build_scorer_count": 0,
            "next_doc": 0, "next_doc_count": 0,
            "advance": 0, "advance_count": 0,
            "match": 0, "match_count": 0,
            "compute_max_score": 0, "compute_max_score_count": 0,
        },
    }
    if children:
        out["children"] = children
    return out


def _kernel_entry(e: dict, s) -> dict:
    entry = {"name": e.get("kernel"), "time_in_nanos": int(float(e.get("ms", 0.0)) * 1e6),
             "scope": "shard" if isinstance(s, int) else "mesh"}
    for key in ("tier", "queries", "k", "shards", "num_docs", "flops", "bytes", "mfu",
                "bw_util"):
        if key in e:
            entry[key] = e[key]
    return entry


def device_sections(events: list[dict] | None, num_shards: int,
                    walk_events: list[dict] | None = None) -> list[dict]:
    """The main search's events -> one device section per shard: its tier,
    the tiers' query counts, its kernel entries and request-cache counts.
    An event with a `shard` goes to that shard; the others (one program
    over every shard) go to each section with scope "mesh". The profile
    walk's kernel events follow, marked `"phase": "profile"`."""
    shards = [{"tier": None, "tiers": {}, "kernels": [],
               "request_cache": {"hits": 0, "misses": 0}}
              for _ in range(max(num_shards, 1))]
    # an escalation outranks everything (the fast arm's rows were
    # replaced); otherwise the last tier event of the main arm wins
    precedence = {"exact_escalation": 3, "fused": 2, "fast": 1, "exact": 1,
                  "fused_scan": 1, "xla_topk": 0}
    best, dominant = -1, None
    for e in events or ():
        kind = e.get("kind")
        s = e.get("shard")
        targets = [shards[s]] if isinstance(s, int) and 0 <= s < len(shards) else shards
        if kind == "kernel":
            entry = _kernel_entry(e, s)
            for t in targets:
                t["kernels"].append(entry)
            tier = e.get("tier")
            if tier and precedence.get(tier, 0) > best:
                best, dominant = precedence.get(tier, 0), tier
        elif kind == "tier":
            tier = e.get("tier")
            n = int(e.get("queries", 1))
            for t in targets:
                t["tiers"][tier] = t["tiers"].get(tier, 0) + n
            if tier and precedence.get(tier, 0) > best:
                best, dominant = precedence.get(tier, 0), tier
        elif kind == "cache":
            for t in targets:
                t["request_cache"]["hits"] += int(e.get("hits", 0))
                t["request_cache"]["misses"] += int(e.get("misses", 0))
    for e in walk_events or ():
        if e.get("kind") == "kernel":
            s = e.get("shard")
            entry = {**_kernel_entry(e, s), "phase": "profile"}
            for t in ([shards[s]] if isinstance(s, int) and 0 <= s < len(shards) else shards):
                t["kernels"].append(entry)
    for t in shards:
        t["tier"] = dominant or "xla_topk"
    return shards


def empty_shard(idx, node_id: str) -> dict:
    """The shard entry of an index with no searcher yet."""
    return {"id": f"[{node_id}][{idx.name}][0]",
            "searches": [{"query": [], "rewrite_time": 0, "collector": []}],
            "aggregations": []}


def profile_shards(idx, node: QueryNode, took_ns: int, node_id: str,
                   device_events: list | None = None, phases: dict | None = None) -> list:
    """The `profile.shards` entries of one index, one per shard. Every
    shard of an index runs in one program, so each entry holds the same
    measured tree; each has its own `device` section, and `phases` the
    coordinator's query and fetch split."""
    searcher = idx.searcher
    t0 = time.monotonic()
    with collect_profile_events() as walk_events:
        tree = profile_node(node, searcher)
    rewrite_ns = int((time.monotonic() - t0) * 1e9)
    n_shards = max(int(getattr(idx, "num_shards", 1) or 1), 1)
    devices = device_sections(device_events, n_shards, walk_events)
    out = []
    for s in range(n_shards):
        entry = {
            "id": f"[{node_id}][{idx.name}][{s}]",
            "searches": [{
                "query": [tree],
                # the profiled walk's own time, outside the scoring
                "rewrite_time": rewrite_ns,
                "collector": [{"name": "FusedTopKCollector", "reason": "search_top_hits",
                               "time_in_nanos": took_ns}],
            }],
            "aggregations": [],
            "device": devices[s],
        }
        if phases:
            entry["phases"] = dict(phases)
        out.append(entry)
    return out
