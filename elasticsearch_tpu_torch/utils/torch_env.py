"""Device resolution and numeric settings for the PyTorch package.

Every entry point takes an explicit `device`. The default is the CUDA card;
with no card present the entry points raise instead of running on the host,
unless the caller asks for `device="cpu"` (the tests do).

The scoring matmuls of the JAX package run at Precision.HIGHEST, i.e. full
f32. TF32 keeps ~10 mantissa bits, so it is switched off for both matmuls
and cuDNN before any device work.
"""

from __future__ import annotations

import numpy as np
import torch


def configure_numerics() -> None:
    """Full-f32 matmuls: no TF32 anywhere (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """-> the torch.device to run on. None means the CUDA card, and raises
    when there is none; "cpu" must be asked for explicitly."""
    configure_numerics()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device [{device}] requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{device}]")
    return dev


def host_tensor(a, dtype, device="cpu") -> torch.Tensor:
    """numpy data (or a tensor) -> a tensor of numpy `dtype` on `device`,
    copying on the host only when `a` is not a writable C-contiguous array
    of that dtype (arrays handed back by other libraries may be read-only)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype)
    return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(device)
