"""Device and precision resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and a missing CUDA runtime is an error, never
a silent fall back to the CPU.  On CUDA the engine computes in float32
(as the JAX reference does); on the CPU float32 and float64 are both
allowed, float64 being the oracle mode.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card by default; pass device='cpu' to run on "
                           "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(dev: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if dev.type == "cuda" and dtype != torch.float32:
        raise ValueError("the CUDA engine computes in float32")
    return dtype


def full_fp32_matmul() -> None:
    """Keep float32 products in full float32 on the card.  The fabric tick
    scatters class and PFC state through one-hot ``matmul``s; TF32 would
    round their operands to 10 mantissa bits and break the float32
    parity with the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("could not disable TF32 matmuls")
