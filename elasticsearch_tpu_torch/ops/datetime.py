"""Civil-calendar math on epoch-millis columns, as int64 tensors.

This package's copy of the JAX package's `ops/datetime.py`. The reference
rounds calendar intervals host-side per value (reference behavior:
server/.../common/Rounding.java, date_histogram calendar_interval
month/quarter/year); here epoch days decompose into (year, month, day) with
Howard Hinnant's civil-from-days algorithm: integer arithmetic only, over
the whole column. `torch.div(..., rounding_mode="floor")` floors as
`jnp.floor_divide` does, and every step stays int64.
"""

from __future__ import annotations

import torch

MS_PER_DAY = 86_400_000


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_millis(ms: torch.Tensor):
    """epoch millis (int64, UTC) -> (year, month 1..12, day 1..31), int64."""
    days = _fdiv(ms, MS_PER_DAY)
    z = days + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)  # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1  # [1, 31]
    m = mp + 3 - 12 * _fdiv(mp, 10)  # [1, 12]
    y = y + _fdiv(mp, 10)
    return y, m, d


def month_index_from_millis(ms: torch.Tensor) -> torch.Tensor:
    """epoch millis -> months since year 0 (y*12 + m-1); monotone in time."""
    y, m, _ = civil_from_millis(ms)
    return y * 12 + (m - 1)


def days_from_civil(y: int, m: int, d: int) -> int:
    """Host-side inverse (scalar): civil date -> epoch days."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def millis_of_month_index(idx: int) -> int:
    """Host-side: month index (y*12+m-1) -> epoch millis of month start."""
    y, m = divmod(idx, 12)
    return days_from_civil(y, m + 1, 1) * MS_PER_DAY
