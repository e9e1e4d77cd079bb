"""Decoder LM structure, parameters and the full-sequence forward pass
(``repro.models.transformer``).

Layer *kinds* per position repeat with a pattern period; the parameters of
one pattern unit are stacked over the repeat count (leaves
``[n_units, ...]``, as in the reference's tree, so carrying weights across
is a plain mapping), and a remainder segment takes the layers a period
does not divide (zamba2: 38 = 6 * 6 + 2).  zamba2's *shared* attention +
MLP block has unstacked weights used at every ``mamba_attn`` position.

Every kind of the reference runs: dense and MoE attention blocks, the
cross-attention block over image patches (``attn_cross``), the Mamba2
kinds and the xLSTM blocks; tokens are ``[B, T]`` ids, or ``[B, K, T]``
codebook ids whose embeddings are summed (musicgen).  ``forward`` returns
the logits of every position and the MoE aux, ``loss_fn`` the mean
next-token cross-entropy; prefill and decode are in
:mod:`repro_torch.models.decoding`.

Activation checkpointing (the reference's ``_remat``) is applied per
pattern unit with ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``: ``remat="none"`` keeps every activation,
``"full"`` keeps a unit's input and replays the unit in the backward,
``"dots"`` also keeps the outputs of its matrix products (a selective
checkpoint policy).  Every policy gives the same gradients.  The
reference's ``"layer_out"`` saves the tensor-parallel all-reduced
sublayer outputs, and ``bf16_weight_gather`` casts before the FSDP
gathers: both are mesh knobs of the sharded train step (ROADMAP Queue 1
A4b), and ``"layer_out"`` raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import DeviceLike, resolve_device
from .._tree import tree_map
from ..configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from . import ssm, xlstm
from .layers import (cross_entropy, embed_init, init_rms, mlp_apply,
                     mlp_init, rms_norm)

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# structure
# --------------------------------------------------------------------------- #
def layer_kinds(cfg: ArchConfig) -> List[str]:
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.xlstm:
            kinds.append("slstm" if cfg.slstm_every and
                         (i + 1) % cfg.slstm_every == 0 else "mlstm")
        elif cfg.family in ("ssm", "hybrid"):
            kinds.append("mamba_attn" if cfg.attn_every and
                         (i + 1) % cfg.attn_every == 0 else "mamba")
        elif cfg.cross_attn_every and (i + 1) % cfg.cross_attn_every == 0:
            kinds.append("attn_cross")
        elif cfg.is_moe_layer(i):
            kinds.append("attn_moe")
        else:
            kinds.append("attn_dense")
    return kinds


def pattern_period(cfg: ArchConfig) -> int:
    for c in (cfg.moe_every if cfg.num_experts else 0, cfg.attn_every,
              cfg.slstm_every, cfg.cross_attn_every):
        if c and c > 1:
            return c
    return 1


def segments(cfg: ArchConfig) -> Tuple[List[str], int, List[str]]:
    """(pattern_kinds, n_units, remainder_kinds)."""
    kinds = layer_kinds(cfg)
    period = pattern_period(cfg)
    n_units = cfg.num_layers // period
    return kinds[:period], n_units, kinds[n_units * period:]


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def _init_layer(kind: str, generator: torch.Generator, cfg: ArchConfig,
                dtype, device, lead: tuple = ()) -> Params:
    d = cfg.d_model
    p: Params = {"ln1": init_rms(d, dtype, device, lead)}
    if kind.startswith("attn"):
        p["attn"] = attn.attn_init(generator, cfg, dtype, device, lead)
        if kind == "attn_cross":
            p["ln_x"] = init_rms(d, dtype, device, lead)
            p["xattn"] = attn.attn_init(generator, cfg, dtype, device, lead)
        p["ln2"] = init_rms(d, dtype, device, lead)
        p["ffn"] = (moe_mod.moe_init(generator, cfg, dtype, device, lead)
                    if kind == "attn_moe"
                    else mlp_init(generator, d, cfg.d_ff, cfg.mlp, dtype,
                                  device, lead))
    elif kind in ("mamba", "mamba_attn"):
        p["mamba"] = ssm.mamba_init(generator, cfg, dtype, device, lead)
    elif kind == "mlstm":
        p["mlstm"] = xlstm.mlstm_init(generator, cfg, dtype, device, lead)
    elif kind == "slstm":
        p["slstm"] = xlstm.slstm_init(generator, cfg, dtype, device, lead)
    else:
        raise ValueError(kind)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Random parameters of the same tree, shapes and scales as the
    reference's ``init_params``, drawn from ``generator`` (which lives on
    ``device``: CUDA unless the caller asks for the CPU).  The numbers
    differ from JAX's; to compute what the reference computes, carry its
    parameters across with
    :func:`repro_torch.models.convert.params_from_jax`."""
    device = resolve_device(device)
    pattern, n_units, rem = segments(cfg)
    if cfg.num_codebooks:
        # one draw of K * V rows, as the reference's, reshaped [K, V, D]
        embed = embed_init(generator, cfg.num_codebooks * cfg.vocab_size,
                           cfg.d_model, dtype, device).reshape(
            cfg.num_codebooks, cfg.vocab_size, cfg.d_model)
    else:
        embed = embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                           device)
    params: Params = {"embed": embed}
    params["pattern"] = tuple(
        _init_layer(kind, generator, cfg, dtype, device, (n_units,))
        for kind in pattern)
    params["remainder"] = tuple(
        _init_layer(kind, generator, cfg, dtype, device) for kind in rem)
    if "mamba_attn" in pattern + rem:
        # zamba2's shared transformer block (attn + mlp), weights shared
        params["shared_attn"] = {
            "ln1": init_rms(cfg.d_model, dtype, device),
            "attn": attn.attn_init(generator, cfg, dtype, device),
            "ln2": init_rms(cfg.d_model, dtype, device),
            "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                            device),
        }
    params["final_norm"] = init_rms(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(generator, cfg.vocab_size,
                                       cfg.d_model, dtype, device).T
    return params


# --------------------------------------------------------------------------- #
# tree helpers (dicts and tuples of tensors; ``tree_map`` is ``_tree``'s)
# --------------------------------------------------------------------------- #
def unit(tree, u: int):
    """Unit ``u`` of a pattern-stacked tree (views, no copy)."""
    return tree_map(lambda leaf: leaf[u], tree)


def unstack(tree, n: int) -> list:
    """The ``n`` units of a pattern-stacked tree, each a tree of views:
    one ``unbind`` a leaf, whose gradient is one ``stack`` (indexing each
    unit apart would fill a zero tensor of the whole stack per unit)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][u] for k in tree} for u in range(n)]
    if isinstance(tree, tuple):
        parts = [unstack(v, n) for v in tree]
        return [tuple(p[u] for p in parts) for u in range(n)]
    return list(tree.unbind(0))


# --------------------------------------------------------------------------- #
# per-layer application, embedding, unembedding
# --------------------------------------------------------------------------- #
def _shared_block(shared: Params, x: torch.Tensor, cfg: ArchConfig,
                  impl: str = "auto") -> torch.Tensor:
    x = x + attn.self_attention(shared["attn"],
                                rms_norm(x, shared["ln1"]), cfg, impl=impl)
    x = x + mlp_apply(shared["ffn"], rms_norm(x, shared["ln2"]), cfg.mlp)
    return x


def _apply_layer(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig,
                 shared: Optional[Params], patches: Optional[torch.Tensor],
                 aux: Dict[str, torch.Tensor], impl: str = "auto",
                 cap_factor: Optional[float] = None):
    """One layer of the forward pass -> (x, aux), the MoE aux added.
    ``cap_factor``: the MoE capacity factor (None: the config's)."""
    h = rms_norm(x, p["ln1"])
    if kind.startswith("attn"):
        x = x + attn.self_attention(p["attn"], h, cfg, impl=impl)
        if kind == "attn_cross":
            x = x + attn.cross_attention(p["xattn"], rms_norm(x, p["ln_x"]),
                                         patches, cfg, impl=impl)
        h2 = rms_norm(x, p["ln2"])
        if kind == "attn_moe":
            y, a = moe_mod.moe_apply(p["ffn"], h2, cfg, cap_factor)
            aux = {k: aux[k] + a[k] for k in aux}
            x = x + y
        else:
            x = x + mlp_apply(p["ffn"], h2, cfg.mlp)
    elif kind in ("mamba", "mamba_attn"):
        x = x + ssm.mamba_apply(p["mamba"], h, cfg, impl=impl)
        if kind == "mamba_attn":
            x = _shared_block(shared, x, cfg, impl)
    elif kind == "mlstm":
        x = x + xlstm.mlstm_apply(p["mlstm"], h, cfg)
    else:
        x = x + xlstm.slstm_apply(p["slstm"], h, cfg)
    return x, aux


AUX0 = {"lb_loss": 0.0, "overflow": 0.0}


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                 dtype) -> torch.Tensor:
    """tokens [B, T] -> [B, T, D]; with codebooks, [B, K, T] -> the sum
    of the K codebooks' embeddings, in codebook order."""
    tokens = tokens.long()
    if cfg.num_codebooks:
        parts = [params["embed"][k][tokens[:, k]]
                 for k in range(cfg.num_codebooks)]
        return sum(parts).to(dtype)
    return params["embed"][tokens].to(dtype)


def unembed(params: Params, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """The final norm and the vocabulary head: one ``[B, T, V]`` head; a
    tied codebook table unembeds through its first codebook."""
    x = rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        table = params["embed"]
        if cfg.num_codebooks:
            table = table[0]
        return x @ table.T.to(x.dtype)
    return x @ params["unembed"].to(x.dtype)


def cast_tree(tree: Optional[Any], dtype) -> Optional[Any]:
    """Float32 leaves to ``dtype`` (the reference's per-call ``cast``);
    a no-op at float32, the engine's compute type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


# --------------------------------------------------------------------------- #
# activation checkpointing
# --------------------------------------------------------------------------- #
REMATS = ("none", "full", "dots")
# the matrix products whose outputs "dots" keeps (jax's checkpoint_dots)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def check_remat(remat: str) -> None:
    if remat == "layer_out":
        raise ValueError("remat='layer_out' saves the tensor-parallel "
                         "all-reduced sublayer outputs: a mesh knob of "
                         "the sharded train step, which the port does not "
                         "have yet (ROADMAP Queue 1 A4b)")
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r} ({' | '.join(REMATS)})")


def _remat(fn, remat: str):
    """``fn`` under the policy ``remat`` (the reference's ``_remat``); a
    pass without grad keeps nothing anyway and runs ``fn`` itself."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"context_fn": _dots_context} if remat == "dots" else {}
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


# --------------------------------------------------------------------------- #
# forward and loss
# --------------------------------------------------------------------------- #
def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            compute_dtype=torch.float32, impl: str = "auto",
            remat: str = "none",
            cap_factor: Optional[float] = None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (logits [B, T, V], aux ``{"lb_loss",
    "overflow"}`` summed over the MoE layers).  ``patches`` [B, P, D]
    feed the cross-attention layers.  ``impl`` goes to the kernels
    (``"ref"``: their plain versions).  ``remat`` checkpoints each
    pattern unit (:data:`REMATS`); ``cap_factor`` is the MoE capacity
    factor (None: the config's).  Runs where ``tokens`` and ``params``
    lie."""
    check_remat(remat)
    dev = resolve_device(tokens.device)
    pattern, n_units, rem = segments(cfg)
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    if patches is not None:
        patches = patches.to(compute_dtype)
    shared = cast_tree(params.get("shared_attn"), compute_dtype)

    def unit_body(x, unit_params):
        aux = dict(AUX0)    # Python floats: a unit without MoE copies none
        for pos, kind in enumerate(pattern):
            x, aux = _apply_layer(kind, cast_tree(unit_params[pos],
                                                  compute_dtype),
                                  x, cfg, shared, patches, aux, impl,
                                  cap_factor)
        return x, aux["lb_loss"], aux["overflow"]

    body = _remat(unit_body, remat)
    aux = {k: torch.tensor(v, device=dev) for k, v in AUX0.items()}
    units = list(zip(*(unstack(p, n_units) for p in params["pattern"])))
    for unit_params in units:
        x, lb, of = body(x, unit_params)
        aux = {"lb_loss": aux["lb_loss"] + lb,
               "overflow": aux["overflow"] + of}
    for p_l, kind in zip(params["remainder"], rem):
        x, aux = _apply_layer(kind, cast_tree(p_l, compute_dtype), x, cfg,
                              shared, patches, aux, impl, cap_factor)
    return unembed(params, x, cfg), aux


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            compute_dtype=torch.float32, impl: str = "auto",
            remat: str = "none",
            cap_factor: Optional[float] = None) -> Tuple[torch.Tensor, Dict]:
    """``batch``: ``tokens``, ``targets`` [B, T], and ``patches`` where
    the model reads them -> (loss, metrics ``{"loss", "lb_loss",
    "overflow"}``).  MoE models add ``0.01 * lb_loss / num_layers``.
    ``remat`` and ``cap_factor`` as :func:`forward`."""
    logits, aux = forward(params, cfg, batch["tokens"], batch.get("patches"),
                          compute_dtype, impl, remat, cap_factor)
    loss = cross_entropy(logits, batch["targets"])
    if cfg.num_experts:
        loss = loss + 0.01 * aux["lb_loss"] / max(1, cfg.num_layers)
    return loss, {"loss": loss, **aux}
