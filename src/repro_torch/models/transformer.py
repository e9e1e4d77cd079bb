"""Decoder LM structure and parameters (``repro.models.transformer``).

Layer *kinds* per position repeat with a pattern period; the parameters of
one pattern unit are stacked over the repeat count (leaves
``[n_units, ...]``, as in the reference's tree, so carrying weights across
is a plain mapping), and a remainder segment takes the layers a period
does not divide (zamba2: 38 = 6 * 6 + 2).  zamba2's *shared* attention +
MLP block has unstacked weights used at every ``mamba_attn`` position.

The port serves every kind the engine feeds with token prompts: dense
and MoE attention blocks (``attn_dense``, ``attn_moe``), the Mamba2 kinds
(``mamba``, ``mamba_attn``) and the xLSTM blocks (``mlstm``, ``slstm``).
``attn_cross`` (image patches) and codebook embeddings raise
``NotImplementedError`` naming what is missing.  The training forward
pass and loss are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from . import ssm, xlstm
from .layers import embed_init, init_rms, mlp_apply, mlp_init, rms_norm

Params = Dict[str, Any]
SERVED_KINDS = ("attn_dense", "attn_moe", "mamba", "mamba_attn", "mlstm",
                "slstm")


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


def check_served(kind: str) -> None:
    if kind not in SERVED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (the port serves "
            f"{', '.join(SERVED_KINDS)})")


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def _init_layer(kind: str, generator: torch.Generator, cfg: ArchConfig,
                dtype, device, lead: tuple = ()) -> Params:
    check_served(kind)
    d = cfg.d_model
    p: Params = {"ln1": init_rms(d, dtype, device, lead)}
    if kind.startswith("attn"):
        p["attn"] = attn.attn_init(generator, cfg, dtype, device, lead)
        p["ln2"] = init_rms(d, dtype, device, lead)
        p["ffn"] = (moe_mod.moe_init(generator, cfg, dtype, device, lead)
                    if kind == "attn_moe"
                    else mlp_init(generator, d, cfg.d_ff, cfg.mlp, dtype,
                                  device, lead))
    elif kind in ("mamba", "mamba_attn"):
        p["mamba"] = ssm.mamba_init(generator, cfg, dtype, device, lead)
    elif kind == "mlstm":
        p["mlstm"] = xlstm.mlstm_init(generator, cfg, dtype, device, lead)
    else:
        p["slstm"] = xlstm.slstm_init(generator, cfg, dtype, device, lead)
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
        raise NotImplementedError("codebook embeddings are not ported yet")
    params: Params = {"embed": embed_init(generator, cfg.vocab_size,
                                          cfg.d_model, dtype, device)}
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
# shared pieces of prefill and decode
# --------------------------------------------------------------------------- #
def _shared_block(shared: Params, x: torch.Tensor, cfg: ArchConfig,
                  impl: str = "auto") -> torch.Tensor:
    x = x + attn.self_attention(shared["attn"],
                                rms_norm(x, shared["ln1"]), cfg, impl=impl)
    x = x + mlp_apply(shared["ffn"], rms_norm(x, shared["ln2"]), cfg.mlp)
    return x


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                 dtype) -> torch.Tensor:
    if cfg.num_codebooks:
        raise NotImplementedError("codebook embeddings are not ported yet")
    return params["embed"][tokens.long()].to(dtype)


def unembed(params: Params, x: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(x.dtype)
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
