"""PyTorch/CUDA port of elasticsearch_tpu for NVIDIA Hopper.

A second package beside the JAX one: the same pack layout, query plans and
BM25 arithmetic on torch tensors, with the TPU's Pallas kernels rewritten
by hand in CUDA (`csrc/`). It imports neither JAX nor the JAX package.
Entry points run on the CUDA card unless the caller passes device="cpu";
without a card they raise.

Ported so far: index -> refresh -> BM25 `_search`, batched `_msearch` and
kNN through `engine.EsIndex`, on one shard or several (`parallel/`), with
the five kernels of `csrc/`; the REST server (`rest/`, standard library
only) over `engine.Engine`, with the serving front end (`serving/`) that
coalesces concurrent searches into device waves; the execution planner
(`planner/`) that routes each `_msearch` batch by the cost model
(`monitoring/costmodel.py`) over the kernels' timed efficiency
(`telemetry.time_kernel`); ES|QL, SQL and EQL (`esql/`) over the packs,
with the sharded SORT | LIMIT and STATS as torch programs on the device.

`EsIndex` and `Engine` are imported on first use: the host-only modules (mappings,
analysis, pack building, routing, `parallel.stacked`) load without torch,
so worker processes that build shard packs do not pay for it.
"""

__all__ = ["Engine", "EsIndex"]


def __getattr__(name):
    if name in ("Engine", "EsIndex"):
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
