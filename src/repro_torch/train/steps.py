"""Train and eval steps (``repro.train.steps``): loss, gradient and
AdamW, on one card or sharded over a process mesh, and the sharding
rules of the train state.

The rules (``_RULES``, :func:`param_spec`, :func:`param_specs`,
:func:`opt_state_specs`, :func:`batch_specs`, :func:`state_specs`) give
each leaf's spec over a mesh, as the reference's do; a rank takes its
blocks with :func:`shard_state` and :func:`shard_batch` (the reference's
``param_shardings`` places a global array instead).

``make_train_step(..., ctx=)`` is the reference's step under a mesh, one
process a rank (SPMD over ``torch.distributed``): each rank holds its
blocks of ``params``, ``opt`` and ``err`` and its batch block, runs the
forward and backward on them (FSDP gathers over ``data``, tensor-parallel
attention and MLP over the model axis, the MoE under expert
parallelism: ``models.transformer``), reduces the gradients to their
mean over the data axes and updates its blocks.  The loss is the mean
over the data blocks of each block's loss, CE + 0.01 * lb_loss / L for
an MoE model, where a block's ``lb_loss`` is the one ``moe.moe_ep``
returns on it (the mean over the model ranks of each rank's share).
For equal blocks that is the global CE plus the mean block ``lb_loss``.
With ``OptConfig.compressed_pod_grads`` on a mesh with a ``pod`` axis
the gradients are reduced inside the pod and then averaged over ``pod``
through the int8 error-feedback ``compressed_psum``, each block keeping
its bfloat16 residual in ``state["err"]`` (the reference's
``pod_body``); without a ``pod`` axis the flag leaves the step exact.

Gradients come from autograd through the model's forward: the card's
flash attention through ``kernels.jet_flash_attention.FlashAttention``
(its backward is the kernel ``flash_attention_bwd``) and its SSD scan
through ``kernels.mamba2_ssd.SSDScan`` (the kernel ``ssd_scan_bwd``), so
every family trains on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import _tree
from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..models import transformer
from ..optim import adamw
from ..parallel.compression import compressed_psum, row_groups
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


def shard_state(state, ctx: ParallelCtx):
    """This rank's blocks of a whole train state (views)."""
    return ctx.shard_tree(state, state_specs(state, ctx))


def shard_batch(batch, ctx: ParallelCtx, accum_steps: int = 1):
    """This rank's block of a global batch: the batch dim over the data
    axes that divide it, or with ``accum_steps > 1`` the micro dim of
    the ``[A, B/A, ...]`` batch (the accumulation dim stays whole)."""
    if not ctx.have_mesh:
        return batch
    if accum_steps == 1:
        return ctx.shard_tree(batch, batch_specs(batch, ctx))

    def one(x):
        ax = ctx.batch_axes_for(x.shape[1])
        return ctx.shard(x, P(None, ax or None, *([None] * (x.ndim - 2))))
    return _tree.tree_map(one, batch)


def _sum_grads(grads, specs, ctx: ParallelCtx, axes: Tuple[str, ...]):
    """Each leaf's gradient summed over the ``axes`` it is not sharded on
    (a sharded leaf's was summed by its gather's reduce-scatter): the
    leaves that share their axes in one all-reduce a type."""
    flat = _tree.leaves(grads)
    buckets: Dict[tuple, list] = {}
    for i, (g, s) in enumerate(zip(flat, _tree.flatten_up_to(grads,
                                                              specs))):
        todo = tuple(a for a in axes if a not in ctx.spec_axes(s))
        if todo:
            buckets.setdefault((todo, g.dtype), []).append(i)
    out = list(flat)
    for (todo, _), idx in buckets.items():
        buf = torch.cat([flat[i].reshape(-1) for i in idx])
        for a in todo:
            dist.all_reduce(buf, group=ctx.mesh.group(a))
        for i, part in zip(idx, buf.split([flat[i].numel() for i in idx])):
            out[i] = part.view_as(flat[i])
    return _tree.unflatten(grads, out)


def _data_mean(values: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """The mean of per-rank figures over the data axes (one all-reduce
    an axis)."""
    out = values.clone()
    for a in ctx.data_axes:
        dist.all_reduce(out, group=ctx.mesh.group(a))
    return out / ctx.dp_size


def _local_grads(cfg, params, batch, compute_dtype, impl, remat, cap_factor,
                 ctx, specs):
    """(grads, metrics) of this rank's batch block: no reduction across
    ranks beyond what the forward's gathers transpose to."""
    flat = _tree.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = transformer.loss_fn(
            _tree.unflatten(params, live), cfg, batch, compute_dtype, impl,
            remat, cap_factor, ctx, specs)
        grads = torch.autograd.grad(loss, live)
    return _tree.unflatten(params, list(grads)), \
        {k: metrics[k].detach() for k in METRICS}


def _reduce(grads, metrics, specs, ctx: Optional[ParallelCtx],
            axes: Tuple[str, ...]):
    """Gradients to their mean over the data ``axes`` and the figures to
    their mean over every data axis (identity without a mesh)."""
    if ctx is None or not ctx.have_mesh:
        return grads, metrics
    n = 1
    for a in axes:
        n *= ctx.axis_size(a)
    grads = _sum_grads(grads, specs, ctx, axes)
    grads = _tree.tree_map(lambda g: g / n, grads)
    figs = _data_mean(torch.stack([metrics[k].float() for k in METRICS]),
                      ctx)
    return grads, dict(zip(METRICS, figs.unbind()))


def loss_and_grads(cfg: ArchConfig, params, batch,
                   compute_dtype=torch.float32, impl: str = "auto",
                   remat: str = "full", cap_factor: Optional[float] = None,
                   ctx: Optional[ParallelCtx] = None, specs=None):
    """(grads, loss, metrics) of one batch: the gradients of the loss in
    the parameters' tree (their type), the loss and ``{"loss",
    "lb_loss", "overflow"}`` detached.  The first half of a train step;
    the second is ``adamw.update``.  On a mesh ``params`` and ``batch``
    are this rank's blocks (``specs``: the parameters'), the gradients
    this rank's blocks of their mean over the data axes and the loss and
    figures the mean over the data blocks (module docstring)."""
    grads, metrics = _local_grads(cfg, params, batch, compute_dtype, impl,
                                  remat, cap_factor, ctx, specs)
    grads, metrics = _reduce(grads, metrics, specs, ctx,
                             ctx.data_axes if ctx is not None else ())
    return grads, metrics["loss"], metrics


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.OptConfig,
                    compute_dtype=torch.float32, accum_steps: int = 1,
                    remat: str = "full", impl: str = "auto",
                    cap_factor: Optional[float] = None,
                    ctx: Optional[ParallelCtx] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are ``loss``, ``lb_loss``, ``overflow``, ``lr`` and ``grad_norm``
    (0-d tensors).  The state passed in is left as it was.

    ``accum_steps > 1``: the batch arrives split ``[A, B/A, ...]`` and
    the float32 gradients of the A microbatches are summed and scaled by
    1/A (as the reference's ``lax.scan``), so activation memory divides
    by A.  ``remat``: the activation-checkpoint policy of each pattern
    unit (``transformer.REMATS``).  ``impl`` goes to the kernels;
    ``cap_factor`` is the MoE capacity factor (None: the config's).
    ``ctx`` with a mesh: the sharded step on this rank's blocks
    (``shard_state``, ``shard_batch``; module docstring)."""
    transformer.check_remat(remat)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    mesh = ctx is not None and ctx.have_mesh
    specs = state_specs(abstract_state(cfg, opt_cfg), ctx)["params"] \
        if mesh else None
    pod = (opt_cfg.compressed_pod_grads and mesh
           and "pod" in ctx.mesh.axis_names)
    # the pod path reduces inside the pod and averages over it compressed
    axes = tuple(a for a in ctx.data_axes if not (pod and a == "pod")) \
        if mesh else ()

    def compute_grads(params, batch):
        def one(mb):
            return _local_grads(cfg, params, mb, compute_dtype, impl, remat,
                                cap_factor, ctx, specs)
        if accum_steps == 1:
            grads, metrics = one(batch)
        else:
            grads = metrics = None
            for a in range(accum_steps):
                g, m = one({k: v[a] for k, v in batch.items()})
                g = _tree.tree_map(lambda t: t.float(), g)
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = _tree.tree_map(torch.add, grads, g)
                    metrics = {k: metrics[k] + m[k] for k in METRICS}
            inv = 1.0 / accum_steps
            grads = _tree.tree_map(lambda t: t * inv, grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        return _reduce(grads, metrics, specs, ctx, axes)

    def pod_mean(grads, err):
        """The gradient blocks' int8 error-feedback mean over ``pod``."""
        group = ctx.mesh.group("pod")

        def one(g, e, s):
            mean, new_e = compressed_psum(g.float(), e.float(), group,
                                          row_groups(ctx, s))
            return mean, new_e.to(torch.bfloat16)
        pairs = _tree.tree_map(one, grads, err, specs)
        pick = lambda i: _tree.tree_map(lambda g, o: o[i], grads, pairs)
        return pick(0), pick(1)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        grads, metrics = compute_grads(params, batch)
        out = {"step": state["step"] + 1}
        if pod:
            grads, out["err"] = pod_mean(grads, state["err"])
        elif "err" in state:
            out["err"] = state["err"]
        new_params, new_opt, stats = adamw.update(grads, state["opt"],
                                                  params, opt_cfg, specs,
                                                  ctx)
        del grads
        return ({"params": new_params, "opt": new_opt, **out},
                {**metrics, **stats})

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
    the AdamW state and a 0-d int32 step; with
    ``compressed_pod_grads``, also ``err``, the bfloat16 error-feedback
    residuals of the cross-pod gradient mean (zeros)."""
    dev = resolve_device(device)
    params = transformer.init_params(cfg, generator, dtype, dev)
    state = {"params": params, "opt": adamw.init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if opt_cfg.compressed_pod_grads:
        state["err"] = _tree.tree_map(
            lambda t: torch.zeros(t.shape, dtype=torch.bfloat16,
                                  device=t.device), params)
    return state


def abstract_state(cfg: ArchConfig, opt_cfg: adamw.OptConfig,
                   dtype=torch.float32) -> Dict[str, Any]:
    """The train state's tree on the ``meta`` device: shapes and types,
    no memory (the reference's ``ShapeDtypeStruct``s)."""
    return init_state(cfg, opt_cfg, None, "meta", dtype)
