"""Tenant superpacks and per-tenant metering (reference `tenancy/`).

  - kernels.py    the tenant-gather term disjunction: the exact arm's body
                  over lane-indexed gathers, byte-equal rows per tenant
  - superpack.py  SuperpackManager: size classes, lane folds (as the
                  serving `_merge` tenant), the duck-typed serving-wave job
  - metering.py   the shared tenant normalizer, exact apportionment of a
                  wave's device segment, the bounded TenantMeter ledger and
                  budget-fed fair-share weights
"""

from .metering import (
    DEFAULT_TENANT, OTHER_TENANT, TenantMeter, apportion,
    fairshare_weights, normalize_tenant, shares_sum,
)
from .superpack import SuperpackManager, size_class_of, superpack_enabled

__all__ = [
    "SuperpackManager", "size_class_of", "superpack_enabled",
    "TenantMeter", "apportion", "fairshare_weights", "normalize_tenant",
    "shares_sum", "DEFAULT_TENANT", "OTHER_TENANT",
]
