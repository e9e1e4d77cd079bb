"""Symmetric int8 compression (``repro.parallel.compression``): blockwise
over a flattened tensor, and row-wise with one scale per last-dim row,
which keeps the tensor's shape (the 8-bit AdamW moments use it), and
:func:`compressed_psum`, the error-feedback int8 mean over a process
group (the cross-pod gradient sync of ``train.steps``).  A row-wise
scale is the max over the whole row: where a rank holds a block whose
last dim is sharded, the max is all-reduced over the groups of those
axes (:func:`row_groups`).

Elementwise work that the reference does outside any Pallas kernel, so
plain PyTorch here.  Every step is float32 and rounds half to even, as
the reference's does.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .collectives import all_gather
from .sharding import _axes

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


def row_groups(ctx, spec) -> tuple:
    """The process groups of the axes that shard a leaf's last dim (a
    row's max is all-reduced over them)."""
    if not spec:
        return ()
    return tuple(ctx.mesh.group(a) for a in _axes(spec[-1]))


def quantize_int8_rowwise(x: torch.Tensor, groups=()
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per last-dim row: q keeps ``x``'s
    shape, the scale its leading dims.  ``groups``: where ``x`` is a
    block whose rows are cut over ranks, the groups that hold the rest
    of each row (the max is taken over the whole row)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    for g in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
    scale = amax / 127.0
    safe = torch.clamp(scale, min=1e-12)[..., None]
    q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_rowwise(q: torch.Tensor, scale: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def compressed_psum(x: torch.Tensor, err: torch.Tensor, group,
                    rows=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed all-reduce (mean) over ``group``.

    Returns (mean_of_dequantized, new_error).  The wire format is int8:
    each rank all-gathers its int8 codes plus one float32 scale a last-dim
    row (~3.9x less traffic than a float32 all-reduce), then dequantizes
    and averages locally.  Error feedback keeps the long-run mean
    unbiased.  ``rows``: :func:`quantize_int8_rowwise`'s ``groups``
    (:func:`row_groups` gives them for a block)."""
    target = x + err
    q, scale = quantize_int8_rowwise(target, rows)
    new_err = target - dequantize_int8_rowwise(q, scale)
    q_all = all_gather(q, group, tiled=False)           # [n, ...] int8
    s_all = all_gather(scale, group, tiled=False)       # [n, ...] f32 rows
    deq_all = q_all.float() * s_all[..., None]
    return torch.mean(deq_all, dim=0), new_err


def compression_ratio(shape) -> float:
    n = 1
    for s in shape:
        n *= s
    raw = n * 4
    comp = n * 1 + (-(-n // BLOCK)) * 4
    return raw / comp
