"""Symmetric int8 compression (``repro.parallel.compression``): blockwise
over a flattened tensor, and row-wise with one scale per last-dim row,
which keeps the tensor's shape (the 8-bit AdamW moments use it).

Elementwise work that the reference does outside any Pallas kernel, so
plain PyTorch here.  Every step is float32 and rounds half to even, as
the reference's does.  ``compressed_psum`` (the error-feedback int8
all-reduce over a process group) is ROADMAP Queue 1 A4: the port runs on
one card.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


def _pad_flat(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8.  Returns (q [N/B, B] int8, scale [N/B])."""
    flat, _ = _pad_flat(x)
    blocks = flat.reshape(-1, BLOCK).float()
    scale = blocks.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def quantize_int8_rowwise(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per last-dim row: q keeps ``x``'s
    shape, the scale its leading dims."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-12)[..., None]
    q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_rowwise(q: torch.Tensor, scale: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def compression_ratio(shape) -> float:
    n = 1
    for s in shape:
        n *= s
    raw = n * 4
    comp = n * 1 + (-(-n // BLOCK)) * 4
    return raw / comp
