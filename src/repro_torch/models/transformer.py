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
:mod:`repro_torch.models.decoding`.  The reference's remat policies and
``bf16_weight_gather`` are training and mesh knobs and are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
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
# tree helpers (dicts and tuples of tensors)
# --------------------------------------------------------------------------- #
def tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def unit(tree, u: int):
    """Unit ``u`` of a pattern-stacked tree (views, no copy)."""
    return tree_map(lambda leaf: leaf[u], tree)


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
                 aux: Dict[str, torch.Tensor], impl: str = "auto"):
    """One layer of the forward pass -> (x, aux), the MoE aux added."""
    h = rms_norm(x, p["ln1"])
    if kind.startswith("attn"):
        x = x + attn.self_attention(p["attn"], h, cfg, impl=impl)
        if kind == "attn_cross":
            x = x + attn.cross_attention(p["xattn"], rms_norm(x, p["ln_x"]),
                                         patches, cfg, impl=impl)
        h2 = rms_norm(x, p["ln2"])
        if kind == "attn_moe":
            y, a = moe_mod.moe_apply(p["ffn"], h2, cfg)
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
# forward and loss
# --------------------------------------------------------------------------- #
def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            compute_dtype=torch.float32,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (logits [B, T, V], aux ``{"lb_loss",
    "overflow"}`` summed over the MoE layers).  ``patches`` [B, P, D]
    feed the cross-attention layers.  ``impl`` goes to the kernels
    (``"ref"``: their plain versions).  Runs where ``tokens`` and
    ``params`` lie."""
    dev = resolve_device(tokens.device)
    pattern, n_units, rem = segments(cfg)
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    if patches is not None:
        patches = patches.to(compute_dtype)
    shared = cast_tree(params.get("shared_attn"), compute_dtype)
    aux = {k: torch.tensor(v, device=dev) for k, v in AUX0.items()}
    for u in range(n_units):
        for pos, kind in enumerate(pattern):
            p = cast_tree(unit(params["pattern"][pos], u), compute_dtype)
            x, aux = _apply_layer(kind, p, x, cfg, shared, patches, aux,
                                  impl)
    for p_l, kind in zip(params["remainder"], rem):
        x, aux = _apply_layer(kind, cast_tree(p_l, compute_dtype), x, cfg,
                              shared, patches, aux, impl)
    return unembed(params, x, cfg), aux


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            compute_dtype=torch.float32,
            impl: str = "auto") -> Tuple[torch.Tensor, Dict]:
    """``batch``: ``tokens``, ``targets`` [B, T], and ``patches`` where
    the model reads them -> (loss, metrics ``{"loss", "lb_loss",
    "overflow"}``).  MoE models add ``0.01 * lb_loss / num_layers``."""
    logits, aux = forward(params, cfg, batch["tokens"], batch.get("patches"),
                          compute_dtype, impl)
    loss = cross_entropy(logits, batch["targets"])
    if cfg.num_experts:
        loss = loss + 0.01 * aux["lb_loss"] / max(1, cfg.num_layers)
    return loss, {"loss": loss, **aux}
