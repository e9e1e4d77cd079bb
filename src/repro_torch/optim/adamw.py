"""AdamW with optional row-wise int8 moments (``repro.optim.adamw``).

The state is ``{"m", "v", "count"}``: moments of the parameter tree's
structure (dicts and tuples of tensors, the layout of
``models.convert``), float32, or with ``int8_moments`` one
``{"q": int8 of the parameter's shape, "s": float32 of its leading dims}``
per parameter (``parallel.compression.quantize_int8_rowwise``); ``count``
a 0-d int32 tensor.  The learning rate, the bias corrections and the
update are float32, as the reference computes them.

This is elementwise work that the reference leaves to XLA outside any
Pallas kernel, so it is plain PyTorch here (a fused optimizer kernel is
later speed work).  :func:`update` returns new trees and leaves its
inputs as they were.

On a mesh (``ctx`` with a mesh, ``specs`` the parameters' specs) every
leaf is this rank's block: the update is elementwise, the global norm
all-reduces each leaf's sum of squares over exactly the axes the leaf is
sharded on (a replicated leaf counts once), and an int8 moment's row
scale takes its max over the whole row, all-reduced over the axes its
last dim is sharded on, so the codes are the single-device ones.
``compressed_pod_grads`` (the int8 cross-pod gradient mean) is the
train step's (``train.steps``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import _tree
from ..parallel.compression import (dequantize_int8_rowwise,
                                    quantize_int8_rowwise, row_groups)
from ..parallel.sharding import ParallelCtx


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    int8_moments: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # the int8 + error-feedback gradient mean over a mesh's ``pod`` axis
    compressed_pod_grads: bool = False


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``, in float32."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio
                            + (1 - cfg.min_lr_ratio) * cos)


def _q(x: torch.Tensor, groups=()) -> Dict[str, torch.Tensor]:
    q, s = quantize_int8_rowwise(x, groups)
    return {"q": q, "s": s}


def _dq(m: Dict[str, torch.Tensor]) -> torch.Tensor:
    return dequantize_int8_rowwise(m["q"], m["s"])


def init(params, cfg: OptConfig) -> Dict[str, Any]:
    dev = _tree.leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if cfg.int8_moments:
        m = _tree.tree_map(lambda p: _q(zeros(p)), params)
        v = _tree.tree_map(lambda p: _q(zeros(p)), params)
    else:
        m, v = _tree.tree_map(zeros, params), _tree.tree_map(zeros, params)
    return {"m": m, "v": v,
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, specs=None,
                ctx: Optional[ParallelCtx] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, summed in
    the reference's leaf order.  On a mesh (``specs`` and ``ctx``) each
    leaf's sum over its block is all-reduced over the axes it is sharded
    on, the leaves sharded alike in one all-reduce."""
    if ctx is None or not ctx.have_mesh:
        total = None
        for g in _tree.leaves(tree):
            sq = torch.sum(g.float() ** 2)
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    by_axes: Dict[Tuple[str, ...], list] = {}
    for g, s in zip(_tree.leaves(tree), _tree.flatten_up_to(tree, specs)):
        by_axes.setdefault(tuple(sorted(ctx.spec_axes(s))), []).append(
            torch.sum(g.float() ** 2))
    total = None
    for axes, sums in by_axes.items():
        part = torch.stack(sums).sum()
        for a in axes:
            dist.all_reduce(part, group=ctx.mesh.group(a))
        total = part if total is None else total + part
    return torch.sqrt(total)


def update(grads, state, params, cfg: OptConfig, specs=None,
           ctx: Optional[ParallelCtx] = None
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step -> (new_params, new_state, ``{"lr", "grad_norm"}``);
    gradients are clipped to a global norm of ``grad_clip`` first, and
    ``grad_norm`` reports the norm before clipping.  On a mesh
    (``specs``, the parameters' specs, and ``ctx``) every tree holds this
    rank's blocks (module docstring)."""
    mesh = ctx is not None and ctx.have_mesh
    count = state["count"] + 1
    lr = schedule(state["count"], cfg)
    gnorm = global_norm(grads, specs, ctx)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    countf = count.float()
    bc1 = 1 - cfg.b1 ** countf
    bc2 = 1 - cfg.b2 ** countf
    decay = 1 - lr * cfg.weight_decay
    is_q = cfg.int8_moments

    def leafwise(p, g, m, v, spec=None):
        rows = row_groups(ctx, spec) if mesh else ()
        g = g.float() * scale
        m_n = cfg.b1 * (_dq(m) if is_q else m) + (1 - cfg.b1) * g
        v_n = cfg.b2 * (_dq(v) if is_q else v) + (1 - cfg.b2) * g * g
        upd = (m_n / bc1) / (torch.sqrt(v_n / bc2) + cfg.eps)
        p_new = (p.float() * decay - lr * upd).to(p.dtype)
        return p_new, (_q(m_n, rows) if is_q else m_n), \
            (_q(v_n, rows) if is_q else v_n)

    rest = (grads, state["m"], state["v"]) + ((specs,) if mesh else ())
    out = _tree.tree_map(leafwise, params, *rest)
    pick = lambda i: _tree.tree_map(lambda p, o: o[i], params, out)
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, \
        {"lr": lr, "grad_norm": gnorm}
