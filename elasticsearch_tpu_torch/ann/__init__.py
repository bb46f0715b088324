"""Device-resident quantized ANN: the IVF partition index.

Counterpart of the JAX package's `ann/`: k-means-trained IVF partitions
packed into padded cluster tiles on the card, scanned by ONE batched
gather-scan per query batch (`csrc/ann_gather_scan.cu`) over an int8
(per-vector scale/offset) or split-bf16 tier, with an f32 rescore of the
survivors restoring exact scores on the candidates.

    quantize.py  int8 scalar quantization (per-vector scale/offset)
    index.py     refresh-time build: partitions -> padded tiles + tiers
    kernels.py   the centroid probe and the gather-scan (kernel + twin)
    search.py    AnnSearcher: probe -> scan -> rescore -> (tail) merge
"""

from .index import AnnBuildError, ann_to_device, build_ann
from .quantize import dequantize_int8, scalar_quantize_int8
from .search import AnnSearcher

__all__ = [
    "AnnBuildError",
    "AnnSearcher",
    "ann_to_device",
    "build_ann",
    "dequantize_int8",
    "scalar_quantize_int8",
]
