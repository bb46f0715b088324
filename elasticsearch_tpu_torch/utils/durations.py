"""ES time-value parsing (reference behavior: core TimeValue.parseTimeValue:
units nanos/micros/ms/s/m/h/d; "-1" means disabled). A copy of the JAX
package's `utils/durations.parse_duration_seconds`."""

from __future__ import annotations

import re

from .errors import IllegalArgumentError

_UNITS_SECONDS = {"nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0,
                  "h": 3600.0, "d": 86400.0}


def parse_duration_seconds(value, default: float | None = None) -> float | None:
    """-> seconds, or None for "-1"/disabled; a bare number is millis."""
    if value is None:
        return default
    if isinstance(value, (int, float)):
        if value == -1:
            return None
        if value < 0:
            raise IllegalArgumentError(f"negative time value [{value}] is not supported")
        return float(value) / 1000.0
    s = str(value).strip()
    if s == "-1":
        return None
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(nanos|micros|ms|s|m|h|d)", s)
    if not m:
        raise IllegalArgumentError(f"failed to parse time value [{value}]")
    return float(m.group(1)) * _UNITS_SECONDS[m.group(2)]


def parse_duration_millis(value, default: int = 0) -> int:
    """-> whole milliseconds (0 for None/disabled). A copy of the JAX
    package's `utils/durations.parse_duration_millis`."""
    sec = parse_duration_seconds(value, default / 1000.0)
    return int((sec or 0) * 1000)
