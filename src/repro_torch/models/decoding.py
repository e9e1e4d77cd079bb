"""Prefill and decode (``repro.models.decoding``): KV caches, Mamba2 and
xLSTM states, ring buffers.

The decode state mirrors the parameter layout: pattern leaves are stacked
``[n_units, B, ...]``, remainder leaves ``[B, ...]``.  The reference's
``lax.scan`` over units becomes a Python loop over the unit index.  KV
caches are ring buffers of ``min(max_len, sliding_window)`` slots.

Unlike the reference, ``decode_step`` updates the state it is given in
place (one token's KV slot, the new conv and SSM states) and returns that
same state: the functional form would copy every cache on every step.
Attention decode runs the plain ring decode (``ref.decode_attention_naive``)
as the reference does, and a cross-attention layer decodes the same way
over the patch K/V its prefill cached (``xkv``, every patch valid); an
MoE block runs the capacity dispatch over every lane of the step, idle
lanes included (the reference's capacity counts them too).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..kernels import ref as kref
from . import attention as attn
from . import moe, ssm, xlstm
from .layers import mlp_apply, rms_norm
from .transformer import (cast_tree, embed_tokens, segments, tree_map,
                          unembed, unit)

State = Dict[str, Any]


def cache_len_for(cfg: ArchConfig, max_len: int) -> int:
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


# --------------------------------------------------------------------------- #
# tree helpers (dicts and tuples of tensors)
# --------------------------------------------------------------------------- #
def _stack(trees: List):
    return tree_map(lambda *leaves: torch.stack(leaves, 0), *trees)


def _assign(dst, src) -> None:
    """Copy ``src`` into ``dst`` leaf by leaf; a leaf already updated in
    place (the same memory) is left alone."""
    def put(d: torch.Tensor, s: torch.Tensor) -> None:
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)
    tree_map(put, dst, src)


# --------------------------------------------------------------------------- #
# state init
# --------------------------------------------------------------------------- #
def _layer_state(kind: str, cfg: ArchConfig, batch: int, s_cache: int,
                 dtype, device, lead: tuple = ()) -> State:
    st: State = {}
    if kind.startswith("attn") or kind == "mamba_attn":
        kv_shape = lead + (batch, s_cache, cfg.num_kv_heads, cfg.hd)
        st["kv"] = (torch.zeros(kv_shape, dtype=dtype, device=device),
                    torch.zeros(kv_shape, dtype=dtype, device=device))
    if kind == "attn_cross":
        x_shape = lead + (batch, cfg.num_patches, cfg.num_kv_heads, cfg.hd)
        st["xkv"] = (torch.zeros(x_shape, dtype=dtype, device=device),
                     torch.zeros(x_shape, dtype=dtype, device=device))
    if kind in ("mamba", "mamba_attn"):
        st["mamba"] = ssm.mamba_state_init(cfg, batch, dtype, device, lead)
    elif kind == "mlstm":
        st["mlstm"] = xlstm.mlstm_state_init(cfg, batch, device, lead)
    elif kind == "slstm":
        st["slstm"] = xlstm.slstm_state_init(cfg, batch, device, lead)
    return st


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.float32,
                      device: DeviceLike = None) -> State:
    """Zero decode state of ``batch`` lanes on ``device`` (CUDA unless
    the caller asks for the CPU; ``"meta"``: shapes and types only)."""
    device = resolve_device(device)
    pattern, n_units, rem = segments(cfg)
    s_cache = cache_len_for(cfg, max_len)
    return {
        "pattern": tuple(_layer_state(k, cfg, batch, s_cache, dtype, device,
                                      (n_units,)) for k in pattern),
        "remainder": tuple(_layer_state(k, cfg, batch, s_cache, dtype,
                                        device) for k in rem),
    }


# --------------------------------------------------------------------------- #
# prefill
# --------------------------------------------------------------------------- #
def _ring_place(kv: torch.Tensor, s_cache: int) -> torch.Tensor:
    """Place the last ``s_cache`` tokens of [B,T,...] into ring slots such
    that token t sits at slot t % s_cache."""
    t = kv.shape[1]
    if t <= s_cache:
        pad = [0, 0] * (kv.dim() - 2) + [0, s_cache - t]
        return F.pad(kv, pad)
    return torch.roll(kv[:, -s_cache:], shifts=t % s_cache, dims=1)


def _ffn_block(kind: str, p, x, cfg,
               on_route: Optional[moe.RouteObserver] = None):
    """The feed-forward half of an attention block: the MLP, or for
    ``attn_moe`` the MoE capacity dispatch."""
    h = rms_norm(x, p["ln2"])
    if kind == "attn_moe":
        return x + moe.moe_apply(p["ffn"], h, cfg, on_route=on_route)[0]
    return x + mlp_apply(p["ffn"], h, cfg.mlp)


def _prefill_layer(kind: str, p, x, cfg, shared, patches, s_cache, impl,
                   on_route: Optional[moe.RouteObserver] = None):
    st: State = {}
    h = rms_norm(x, p["ln1"])
    if kind.startswith("attn"):
        y, (k, v) = attn.self_attention(p["attn"], h, cfg, return_kv=True,
                                        impl=impl)
        x = x + y
        st["kv"] = (_ring_place(k, s_cache), _ring_place(v, s_cache))
        if kind == "attn_cross":
            # the patch K/V the cross-attention computes are the state
            y, st["xkv"] = attn.cross_attention(
                p["xattn"], rms_norm(x, p["ln_x"]), patches, cfg,
                return_kv=True, impl=impl)
            x = x + y
        return _ffn_block(kind, p, x, cfg, on_route), st
    if kind == "mlstm":
        y, st["mlstm"] = xlstm.mlstm_apply(p["mlstm"], h, cfg,
                                           return_state=True)
        return x + y, st
    if kind == "slstm":
        y, st["slstm"] = xlstm.slstm_apply(p["slstm"], h, cfg,
                                           return_state=True)
        return x + y, st
    y, st["mamba"] = ssm.mamba_apply(p["mamba"], h, cfg, return_state=True,
                                     impl=impl)
    x = x + y
    if kind == "mamba_attn":
        hs = rms_norm(x, shared["ln1"])
        ys, (k, v) = attn.self_attention(shared["attn"], hs, cfg,
                                         return_kv=True, impl=impl)
        x = x + ys
        x = x + mlp_apply(shared["ffn"], rms_norm(x, shared["ln2"]),
                          cfg.mlp)
        st["kv"] = (_ring_place(k, s_cache), _ring_place(v, s_cache))
    return x, st


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None, max_len: int = 0,
            compute_dtype=torch.float32, impl: str = "auto",
            on_route: Optional[moe.RouteObserver] = None):
    """Process the prompt; returns (last-position logits [B,V], state,
    lengths [B]).  tokens: [B, T] (or [B, K, T] codebook ids);
    ``patches`` [B, P, D] feed the cross-attention layers.  ``max_len``
    sizes the decode cache (default: the prompt length).  ``impl`` goes
    to the kernels (``"ref"``: their plain versions).  ``on_route`` sees
    each MoE block's routing, layer by layer
    (:func:`repro_torch.models.moe.moe_apply`).  Runs where ``tokens``
    and ``params`` lie."""
    resolve_device(tokens.device)
    pattern, n_units, rem = segments(cfg)
    t = tokens.shape[-1]
    s_cache = cache_len_for(cfg, max_len or t)
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    if patches is not None:
        patches = patches.to(compute_dtype)
    shared = cast_tree(params.get("shared_attn"), compute_dtype)
    per_pos: List[List[State]] = [[] for _ in pattern]
    for u in range(n_units):
        for pos, kind in enumerate(pattern):
            x, st = _prefill_layer(
                kind, cast_tree(unit(params["pattern"][pos], u),
                                compute_dtype),
                x, cfg, shared, patches, s_cache, impl, on_route)
            per_pos[pos].append(st)
    rem_states = []
    for p_l, kind in zip(params["remainder"], rem):
        x, st = _prefill_layer(kind, cast_tree(p_l, compute_dtype), x, cfg,
                               shared, patches, s_cache, impl, on_route)
        rem_states.append(st)
    logits = unembed(params, x[:, -1:, :], cfg)[:, 0]
    lengths = torch.full((tokens.shape[0],), t, dtype=torch.int32,
                         device=tokens.device)
    state = {"pattern": tuple(_stack(sts) for sts in per_pos),
             "remainder": tuple(rem_states)}
    return logits, state, lengths


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def _decode_layer(kind: str, p, st: State, x, lengths, cfg, shared):
    new: State = {}
    h = rms_norm(x, p["ln1"])
    if kind.startswith("attn"):
        y, ck, cv = attn.decode_self_attention(p["attn"], h, st["kv"][0],
                                               st["kv"][1], lengths, cfg)
        x = x + y
        new["kv"] = (ck, cv)
        if kind == "attn_cross":
            xk, xv = st["xkv"]
            new["xkv"] = (xk, xv)
            b = x.shape[0]
            q = (rms_norm(x, p["ln_x"]) @ p["xattn"]["wq"]).reshape(
                b, cfg.num_heads, cfg.hd)
            every = torch.full((b,), xk.shape[1], dtype=torch.int32,
                               device=x.device)
            o, _ = kref.decode_attention_naive(q, xk, xv, every)
            x = x + o.reshape(b, 1, cfg.attn_dim) @ p["xattn"]["wo"]
        return _ffn_block(kind, p, x, cfg), new
    if kind == "mlstm":
        y, new["mlstm"] = xlstm.mlstm_decode(p["mlstm"], h, st["mlstm"], cfg)
        return x + y, new
    if kind == "slstm":
        y, new["slstm"] = xlstm.slstm_decode(p["slstm"], h, st["slstm"], cfg)
        return x + y, new
    y, new["mamba"] = ssm.mamba_decode(p["mamba"], h, st["mamba"], cfg)
    x = x + y
    if kind == "mamba_attn":
        hs = rms_norm(x, shared["ln1"])
        y2, ck, cv = attn.decode_self_attention(
            shared["attn"], hs, st["kv"][0], st["kv"][1], lengths, cfg)
        x = x + y2
        x = x + mlp_apply(shared["ffn"], rms_norm(x, shared["ln2"]),
                          cfg.mlp)
        new["kv"] = (ck, cv)
    return x, new


def decode_step(params, cfg: ArchConfig, state: State,
                tokens: torch.Tensor, lengths: torch.Tensor,
                compute_dtype=torch.float32):
    """One decode step. tokens: [B] (or [B, K] codebook ids); lengths:
    [B] tokens already in the cache.  Returns (logits [B,V], state), the
    state updated in place.  Runs where ``tokens`` and ``state`` lie."""
    resolve_device(tokens.device)
    pattern, n_units, rem = segments(cfg)
    x = embed_tokens(params, tokens[..., None], cfg, compute_dtype)
    shared = cast_tree(params.get("shared_attn"), compute_dtype)
    for u in range(n_units):
        for pos, kind in enumerate(pattern):
            st = unit(state["pattern"][pos], u)
            x, new = _decode_layer(
                kind, cast_tree(unit(params["pattern"][pos], u),
                                compute_dtype),
                st, x, lengths, cfg, shared)
            _assign(st, new)
    for p_l, st, kind in zip(params["remainder"], state["remainder"], rem):
        x, new = _decode_layer(kind, cast_tree(p_l, compute_dtype), st, x,
                               lengths, cfg, shared)
        _assign(st, new)
    logits = unembed(params, x, cfg)[:, 0]
    return logits, state
