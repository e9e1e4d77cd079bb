"""Attention (``repro.models.attention``): causal self-attention and
non-causal cross-attention over image patches, both through the flash
attention kernel (each can return the KV to cache), and one-token decode
over a ring KV cache.

The reference's ``ParallelCtx`` argument is dropped: the port runs on one
card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops, ref
from .layers import apply_rope, normal


def attn_init(generator: torch.Generator, cfg: ArchConfig,
              dtype=torch.float32, device=None, lead: tuple = ()) -> dict:
    d, ad, kvd = cfg.d_model, cfg.attn_dim, cfg.kv_dim
    s = d ** -0.5
    return {
        "wq": normal(lead + (d, ad), s, generator, dtype, device),
        "wk": normal(lead + (d, kvd), s, generator, dtype, device),
        "wv": normal(lead + (d, kvd), s, generator, dtype, device),
        "wo": normal(lead + (ad, d), ad ** -0.5, generator, dtype, device),
    }


def _project_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, rope: bool = True):
    b, t, _ = x.shape
    q = (x @ params["wq"]).reshape(b, t, cfg.num_heads, cfg.hd)
    k = (x @ params["wk"]).reshape(b, t, cfg.num_kv_heads, cfg.hd)
    v = (x @ params["wv"]).reshape(b, t, cfg.num_kv_heads, cfg.hd)
    if rope:
        q = apply_rope(q, positions, cfg.hd, cfg.rope_fraction,
                       cfg.rope_theta)
        k = apply_rope(k, positions, cfg.hd, cfg.rope_fraction,
                       cfg.rope_theta)
    return q, k, v


def self_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                   return_kv: bool = False, impl: str = "auto"):
    """Prefill self-attention. x: [B, T, D]."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    # [B, H, T, hd], contiguous, for the kernel
    o = ops.flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=True, window=cfg.sliding_window,
                            impl=impl)
    out = o.transpose(1, 2).reshape(b, t, cfg.attn_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)   # [B, T, Hkv, hd]: the prefill cache build
    return out


def cross_attention(params: dict, x: torch.Tensor, kv_src: torch.Tensor,
                    cfg: ArchConfig, return_kv: bool = False,
                    impl: str = "auto"):
    """x: [B, T, D] attends over kv_src: [B, P, D] (patch embeddings), no
    RoPE, no mask.  ``return_kv`` also returns the patch (k, v), each
    [B, P, Hkv, hd]: the prefill's cross-attention state."""
    b, t, _ = x.shape
    p = kv_src.shape[1]
    q = (x @ params["wq"]).reshape(b, t, cfg.num_heads, cfg.hd)
    k = (kv_src @ params["wk"]).reshape(b, p, cfg.num_kv_heads, cfg.hd)
    v = (kv_src @ params["wv"]).reshape(b, p, cfg.num_kv_heads, cfg.hd)
    o = ops.flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(),
                            causal=False, impl=impl)
    out = o.transpose(1, 2).reshape(b, t, cfg.attn_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


# --------------------------------------------------------------------------- #
# Decode (one token, KV cache)
# --------------------------------------------------------------------------- #
def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one token per sequence at ring slot ``len % S``.
    cache: [B, S, Hkv, hd].  Unlike the reference, which returns new
    arrays, the caches are written in place (a decode step would otherwise
    copy every cache whole) and returned."""
    b, s = cache_k.shape[0], cache_k.shape[1]
    pos = lengths.long() % s
    bidx = torch.arange(b, device=cache_k.device)
    cache_k.index_put_((bidx, pos), k_new[:, 0])
    cache_v.index_put_((bidx, pos), v_new[:, 0])
    return cache_k, cache_v


def decode_self_attention(params: dict, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          lengths: torch.Tensor, cfg: ArchConfig):
    """x: [B, 1, D]; cache: [B, S, Hkv, hd]; lengths: [B] tokens already in
    the cache.  Returns (out [B,1,D], cache_k, cache_v), the caches
    updated in place."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x, cfg, lengths[:, None])
    cache_k, cache_v = cache_update(cache_k, cache_v, k_new, v_new, lengths)
    s = cache_k.shape[1]
    # ring validity: before wrap-around slots [0, len+1) hold data, after
    # it every slot does (a sliding-window cache is sized to the window)
    valid_count = torch.clamp(lengths + 1, max=s)
    o, _lse = ref.decode_attention_naive(
        q.reshape(b, cfg.num_heads, cfg.hd), cache_k, cache_v, valid_count)
    out = o.reshape(b, 1, cfg.attn_dim) @ params["wo"]
    return out, cache_k, cache_v
