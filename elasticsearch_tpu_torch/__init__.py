"""PyTorch/CUDA port of elasticsearch_tpu for NVIDIA Hopper.

A second package beside the JAX one: the same pack layout, query plans and
BM25 arithmetic on torch tensors, with the TPU's Pallas kernels rewritten
by hand in CUDA (`csrc/`). It imports neither JAX nor the JAX package.
Entry points run on the CUDA card unless the caller passes device="cpu";
without a card they raise.

Ported so far: index -> refresh -> BM25 `_search` on one shard
(`engine.EsIndex`), with the `scan_topk` kernel.
"""

from .engine import EsIndex

__all__ = ["EsIndex"]
