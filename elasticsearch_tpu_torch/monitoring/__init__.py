"""Measurement for the port: the analytic per-kernel cost model
(`costmodel.py`) that `telemetry.time_kernel` and the execution planner
read."""
