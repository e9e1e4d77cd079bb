"""Train and eval steps (``repro.train.steps``): loss, gradient and
AdamW on one card.

The reference builds its step for ``jit`` under a mesh: sharding rules
per leaf (``param_spec``, ``param_specs``, ``param_shardings``,
``opt_state_specs``, ``batch_specs``, ``state_specs``) and the
compressed cross-pod gradient sync.  Those are mesh layouts, ROADMAP
Queue 1 A4; here the step runs eagerly on one device and every mesh
knob raises ``ValueError``.

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

METRICS = ("loss", "lb_loss", "overflow")


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
