"""Train and eval steps (``repro.train.steps``): loss, gradient and
AdamW on one card, and the sharding rules of the train state.

The rules (``_RULES``, :func:`param_spec`, :func:`param_specs`,
:func:`opt_state_specs`, :func:`batch_specs`, :func:`state_specs`) give
each leaf's spec over a mesh, as the reference's do; a rank takes its
block with ``ParallelCtx.shard`` (the reference's ``param_shardings``
places a global array instead).  The step itself runs eagerly on one
device: the sharded step and the compressed cross-pod gradient sync are
ROADMAP Queue 1 A4b, and every mesh knob of the step raises
``ValueError``.

Gradients come from autograd through the model's forward: the card's
flash attention through ``kernels.jet_flash_attention.FlashAttention``
(its backward is the kernel ``flash_attention_bwd``) and its SSD scan
through ``kernels.mamba2_ssd.SSDScan`` (the kernel ``ssd_scan_bwd``), so
every family trains on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import _tree
from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..models import transformer
from ..optim import adamw
from ..parallel.sharding import P, ParallelCtx

METRICS = ("loss", "lb_loss", "overflow")

# (tp_dim, fsdp_dim) by leaf name, negative indices from the end
_RULES = {
    "wq": (-1, -2), "wk": (-1, -2), "wv": (-1, -2),
    "w_in": (-1, -2), "w_gate": (-1, -2), "w_x": (-1, -2),
    "w_xbc": (-1, -2), "w_z": (-1, -2), "w_dt": (-1, -2),
    "w_if": (-1, -2),
    "wo": (-2, -1), "w_out": (-2, -1),
    "e_in": (-3, -2), "e_gate": (-3, -2), "e_out": (-3, -1),
    "embed": (-2, -1), "unembed": (-1, -2),
}


def param_spec(path, leaf, ctx: ParallelCtx) -> P:
    """The spec of the leaf at ``path`` (dict keys and sequence indices,
    as ``_tree.flatten`` gives them), by the last key's rule: the model
    axis on its TP dim and ``data`` on its FSDP dim, each where it
    divides; ``P()`` for a leaf with no rule or with no mesh."""
    name = next((k for k in reversed(path) if isinstance(k, str)), None)
    rule = _RULES.get(name)
    if rule is None or not ctx.have_mesh:
        return P()
    tp, fs = rule
    nd = len(leaf.shape)
    parts: list = [None] * nd
    tp_i, fs_i = tp % nd, fs % nd
    if leaf.shape[tp_i] % ctx.model_size == 0 and leaf.shape[tp_i] > 1:
        parts[tp_i] = ctx.model_axis
    if (ctx.fsdp and fs_i != tp_i and "data" in ctx.mesh.axis_names
            and leaf.shape[fs_i] % ctx.mesh.shape["data"] == 0
            and leaf.shape[fs_i] > 1):
        parts[fs_i] = "data"
    return P(*parts)


def param_specs(params, ctx: ParallelCtx):
    return _tree.tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, ctx), params)


def opt_state_specs(opt_state, params_specs, ctx: ParallelCtx):
    """Moments inherit their parameter's spec (ZeRO).  Row-wise int8
    moments: ``q`` keeps the parameter's exact shape (same spec); ``s``
    drops the last dim (the same spec truncated) — no reshape, so the
    parameter's sharding carries over."""
    def match(path, leaf):
        is_scale = path[-1] == "s"
        trimmed = [k for k in path if k not in ("q", "s")]
        if len(leaf.shape) == 0:
            return P()
        if is_scale:
            # the parent parameter's spec, truncated to the scale's dims
            parent = torch.empty(tuple(leaf.shape) + (1,), device="meta")
            return P(*param_spec(trimmed, parent, ctx)[:len(leaf.shape)])
        return param_spec(trimmed, leaf, ctx)
    return {"m": _tree.tree_map_with_path(match, opt_state["m"]),
            "v": _tree.tree_map_with_path(match, opt_state["v"]),
            "count": P()}


def batch_specs(batch, ctx: ParallelCtx):
    def one(x):
        ax = ctx.batch_axes_for(x.shape[0])
        return P(ax if ax else None, *([None] * (len(x.shape) - 1)))
    return _tree.tree_map(one, batch)


def state_specs(state, ctx: ParallelCtx):
    p_specs = param_specs(state["params"], ctx)
    specs = {"params": p_specs,
             "opt": opt_state_specs(state["opt"], p_specs, ctx),
             "step": P()}
    if "err" in state:
        specs["err"] = p_specs       # residuals mirror the param sharding
    return specs


def loss_and_grads(cfg: ArchConfig, params, batch,
                   compute_dtype=torch.float32, impl: str = "auto",
                   remat: str = "full", cap_factor: Optional[float] = None):
    """(grads, loss, metrics) of one batch: the gradients of the loss in
    the parameters' tree (their type), the loss and ``{"loss",
    "lb_loss", "overflow"}`` detached.  The first half of a train step;
    the second is ``adamw.update``."""
    flat = _tree.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = transformer.loss_fn(
            _tree.unflatten(params, live), cfg, batch, compute_dtype, impl,
            remat, cap_factor)
        grads = torch.autograd.grad(loss, live)
    return _tree.unflatten(params, list(grads)), loss.detach(), \
        {k: metrics[k].detach() for k in METRICS}


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.OptConfig,
                    compute_dtype=torch.float32, accum_steps: int = 1,
                    remat: str = "full", impl: str = "auto",
                    cap_factor: Optional[float] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are ``loss``, ``lb_loss``, ``overflow``, ``lr`` and ``grad_norm``
    (0-d tensors).  The state passed in is left as it was.

    ``accum_steps > 1``: the batch arrives split ``[A, B/A, ...]`` and
    the float32 gradients of the A microbatches are summed and scaled by
    1/A (as the reference's ``lax.scan``), so activation memory divides
    by A.  ``remat``: the activation-checkpoint policy of each pattern
    unit (``transformer.REMATS``; ``"layer_out"`` is a mesh knob and
    raises).  ``impl`` goes to the kernels; ``cap_factor`` is the MoE
    capacity factor (None: the config's)."""
    adamw.check_config(opt_cfg)
    transformer.check_remat(remat)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def compute_grads(params, batch):
        if accum_steps == 1:
            return loss_and_grads(cfg, params, batch, compute_dtype, impl,
                                  remat, cap_factor)
        g_acc = loss = aux = None
        for a in range(accum_steps):
            mb = {k: v[a] for k, v in batch.items()}
            g, l, m = loss_and_grads(cfg, params, mb, compute_dtype, impl,
                                     remat, cap_factor)
            g = _tree.tree_map(lambda t: t.float(), g)
            if g_acc is None:
                g_acc, loss, aux = g, l, m
            else:
                g_acc = _tree.tree_map(torch.add, g_acc, g)
                loss = loss + l
                aux = {k: aux[k] + m[k] for k in METRICS}
        inv = 1.0 / accum_steps
        return _tree.tree_map(lambda t: t * inv, g_acc), loss * inv, \
            {k: v * inv for k, v in aux.items()}

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        grads, _, metrics = compute_grads(params, batch)
        new_params, new_opt, stats = adamw.update(grads, state["opt"],
                                                  params, opt_cfg)
        del grads
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, {**metrics, **stats})

    return train_step


def make_eval_step(cfg: ArchConfig, compute_dtype=torch.float32,
                   impl: str = "auto", cap_factor: Optional[float] = None):
    """Returns ``eval_step(params, batch) -> metrics`` (no gradient)."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = transformer.loss_fn(params, cfg, batch,
                                             compute_dtype, impl,
                                             cap_factor=cap_factor)
        return metrics
    return eval_step


def init_state(cfg: ArchConfig, opt_cfg: adamw.OptConfig,
               generator: Optional[torch.Generator],
               device: DeviceLike = None,
               dtype=torch.float32) -> Dict[str, Any]:
    """``{"params", "opt", "step"}``: parameters drawn from ``generator``
    (which lives on ``device``: CUDA unless the caller asks for the CPU),
    the AdamW state and a 0-d int32 step."""
    adamw.check_config(opt_cfg)
    dev = resolve_device(device)
    params = transformer.init_params(cfg, generator, dtype, dev)
    return {"params": params, "opt": adamw.init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_state(cfg: ArchConfig, opt_cfg: adamw.OptConfig,
                   dtype=torch.float32) -> Dict[str, Any]:
    """The train state's tree on the ``meta`` device: shapes and types,
    no memory (the reference's ``ShapeDtypeStruct``s)."""
    return init_state(cfg, opt_cfg, None, "meta", dtype)
