"""The adaptive execution planner: cost-model-driven arm selection.

Predicted wall time per eligible arm = analytic cost
(`monitoring.costmodel`) over that kernel's measured achieved-roofline EMA
(fed by every `telemetry.time_kernel` observation on the card); the argmin
wins, and the predicted-against-actual residual is exported. See
`planner/core.py`.
"""

from .core import (  # noqa: F401
    ARM_SITES,
    ExecutionPlanner,
    execution_planner,
    reset_for_tests,
)
