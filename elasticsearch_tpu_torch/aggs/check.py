"""Compare two `aggregations` objects value by value.

The tolerance is stated per value: ints, strings, bools and None equal
(counts, keys, exact long sums, cardinalities); floats within `rel` of
max(|a|, |b|) plus `atol` (for a value made by subtracting sums, such as a
derivative, the caller gives the sums' scale), or equal. The values an
extended_stats result derives from its sums by subtraction (variance,
std_deviation and their bounds: sum_of_squares / count - avg^2) are held
to `rel` carried through that formula from its inputs (sum_of_squares /
count and avg^2), not to their own magnitude, which the cancellation makes
arbitrarily small. Dict keys and list lengths must match. Used by the tests
(the port against the JAX package) and by `chip_smoke.py` (the card against
the CPU, the shards against one shard).
"""

from __future__ import annotations

import math

_DERIVED = ("variance", "variance_population", "std_deviation", "std_deviation_population",
            "std_deviation_bounds")


def _derived_tolerances(want: dict, rel: float) -> dict:
    """extended_stats' derived keys -> their absolute tolerance: rel on
    each input of var = sq/c - avg^2, carried to var, to std = sqrt(var)
    and to avg ± sigma·std."""
    c, sq, avg = want.get("count"), want.get("sum_of_squares"), want.get("avg")
    var, std = want.get("variance"), want.get("std_deviation")
    if not c or sq is None or avg is None or var is None:
        return {}
    d_avg = rel * abs(avg)
    d_var = rel * (abs(sq) / c + avg * avg) + 2 * abs(avg) * d_avg
    d_std = min(d_var / (2 * std), math.sqrt(d_var)) if std else math.sqrt(d_var)
    bounds = want.get("std_deviation_bounds") or {}
    sigma = (bounds["upper"] - avg) / std if std and "upper" in bounds else 0.0
    return {"variance": d_var, "variance_population": d_var, "std_deviation": d_std,
            "std_deviation_population": d_std,
            "std_deviation_bounds": d_avg + abs(sigma) * d_std}


def without_floats(tree):
    """An aggregations tree with every float as None: what equals byte for
    byte across shard layouts (counts, keys, exact long sums,
    cardinalities)."""
    if isinstance(tree, dict):
        return {k: without_floats(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [without_floats(v) for v in tree]
    return None if isinstance(tree, float) else tree


def agg_mismatches(got, want, rel: float = 1e-6, path: str = "", atol: float = 0.0) -> list[str]:
    """-> the paths where `got` and `want` differ (empty when they agree)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path}: keys {sorted(got) if isinstance(got, dict) else got!r} "
                    f"!= {sorted(want)}"]
        derived = _derived_tolerances(want, rel) if "sum_of_squares" in want else {}
        out = []
        for k in want:
            if k in derived:
                out += agg_mismatches(got[k], want[k], 0.0, f"{path}.{k}", atol + derived[k])
            else:
                out += agg_mismatches(got[k], want[k], rel, f"{path}.{k}", atol)
        return out
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{path}: {len(got) if isinstance(got, list) else got!r} items "
                    f"!= {len(want)}"]
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            out += agg_mismatches(g, w, rel, f"{path}[{i}]", atol)
        return out
    if isinstance(want, float) and isinstance(got, float):
        if got == want or abs(got - want) <= rel * max(abs(got), abs(want)) + atol:
            return []
        return [f"{path}: {got!r} != {want!r}"]
    if type(got) is not type(want) or got != want:
        return [f"{path}: {got!r} ({type(got).__name__}) != {want!r} ({type(want).__name__})"]
    return []
