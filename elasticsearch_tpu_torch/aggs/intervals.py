"""Interval string parsing for date_histogram.

This package's copy of the JAX package's `aggs/intervals.py`. Parity
target: fixed_interval units ms/s/m/h/d and calendar_interval
minute/hour/day/week/month/quarter/year (reference behavior:
server/.../common/Rounding.java + DateHistogramAggregationBuilder).
"""

from __future__ import annotations

import re

from ..utils.errors import IllegalArgumentError

_FIXED_UNITS = {
    "ms": 1,
    "s": 1000,
    "m": 60_000,
    "h": 3_600_000,
    "d": 86_400_000,
}

# calendar units that are fixed-length in UTC -> treated as fixed intervals
_CALENDAR_FIXED = {
    "minute": 60_000,
    "1m": 60_000,
    "hour": 3_600_000,
    "1h": 3_600_000,
    "day": 86_400_000,
    "1d": 86_400_000,
    "week": 7 * 86_400_000,
    "1w": 7 * 86_400_000,
}

# variable-length calendar units -> months per bucket
_CALENDAR_MONTHS = {
    "month": 1,
    "1M": 1,
    "quarter": 3,
    "1q": 3,
    "year": 12,
    "1y": 12,
}


def parse_fixed_interval(s: str) -> int:
    m = re.fullmatch(r"(\d+)(ms|s|m|h|d)", str(s))
    if not m:
        raise IllegalArgumentError(f"failed to parse fixed interval [{s}]")
    return int(m.group(1)) * _FIXED_UNITS[m.group(2)]


def parse_calendar_interval(s: str) -> tuple[str, int]:
    """-> ("fixed", millis) or ("months", n_months)."""
    s = str(s)
    if s in _CALENDAR_FIXED:
        return "fixed", _CALENDAR_FIXED[s]
    if s in _CALENDAR_MONTHS:
        return "months", _CALENDAR_MONTHS[s]
    raise IllegalArgumentError(f"unknown calendar interval [{s}]")
