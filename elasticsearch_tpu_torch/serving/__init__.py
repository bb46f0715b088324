"""The serving front end: admission, coalescing of concurrent searches into
device waves, tenant fairness, deadlines and backpressure (reference
`serving/`). `service.ServingService` is imported where it is used."""

from .coalesce import classify_request, term_disjunction_of
from .queue import PendingSearch, ServingRejectedError, TenantQueues, parse_tenant_weights

__all__ = ["PendingSearch", "ServingRejectedError", "TenantQueues", "classify_request",
           "parse_tenant_weights", "term_disjunction_of"]
