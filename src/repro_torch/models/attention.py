"""Attention (``repro.models.attention``): causal self-attention and
non-causal cross-attention over image patches, both through the flash
attention kernel (each can return the KV to cache), and one-token decode
over a ring KV cache.

Tensor parallelism (``tp``, a ``parallel.sharding.TP``): where the model
axis divides the query heads (:func:`tp_for`), ``wq`` is this rank's
column block (H/m heads), ``wo`` its row block, and the sublayer's
output is the all-reduce of the ranks' parts (``reduce_from_model``,
the reference's ``"layer_out"`` tensor); its input is
``copy_to_model``'d, so its gradient sums the ranks' parts.  ``wk`` and
``wv`` are column blocks where the axis divides the KV heads too;
otherwise they arrive whole and each rank takes the KV heads its query
heads read (query head h reads KV head h // (H / Hkv)).  Where the axis
does not divide the query heads, the caller gathers every weight whole
and passes no ``tp``: the layer then runs unsplit on every model rank.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops, ref
from ..parallel.collectives import copy_to_model, reduce_from_model
from .layers import apply_rope, normal


def tp_for(cfg: ArchConfig, tp):
    """``tp`` where the model axis divides the query heads, else None
    (the layer runs unsplit)."""
    return tp if tp is not None and cfg.num_heads % tp.size == 0 else None


def kv_heads_split(cfg: ArchConfig, tp) -> bool:
    """Whether ``wk`` / ``wv`` are used as column blocks under ``tp``
    (the model axis divides the KV heads) or arrive whole."""
    return cfg.num_kv_heads % tp.size == 0


def _local_kv(params: dict, cfg: ArchConfig, tp):
    """(params with ``wk`` / ``wv`` cut to the KV heads this rank's query
    heads read, and None or, where those heads do not read them in
    uniform groups, the KV head of each local query head)."""
    if kv_heads_split(cfg, tp):
        return params, None
    hq = cfg.num_heads // tp.size
    group = cfg.num_heads // cfg.num_kv_heads
    q0 = tp.rank * hq
    lo, hi = q0 // group, (q0 + hq - 1) // group + 1
    reads = [(q0 + i) // group - lo for i in range(hq)]
    n = hi - lo
    uniform = hq % n == 0 and reads == [i // (hq // n) for i in range(hq)]
    cols = slice(lo * cfg.hd, hi * cfg.hd)
    params = dict(params, wk=params["wk"][..., cols],
                  wv=params["wv"][..., cols])
    return params, None if uniform else reads


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
    """q, k, v [B, T, heads, hd]: as many heads as the weights' columns
    hold (all, or a tensor-parallel rank's)."""
    b, t, _ = x.shape
    q = (x @ params["wq"]).reshape(b, t, -1, cfg.hd)
    k = (x @ params["wk"]).reshape(b, t, -1, cfg.hd)
    v = (x @ params["wv"]).reshape(b, t, -1, cfg.hd)
    if rope:
        q = apply_rope(q, positions, cfg.hd, cfg.rope_fraction,
                       cfg.rope_theta)
        k = apply_rope(k, positions, cfg.hd, cfg.rope_fraction,
                       cfg.rope_theta)
    return q, k, v


def _heads_out(params: dict, o: torch.Tensor, tp) -> torch.Tensor:
    """o [B, heads, T, hd] through ``wo`` (summed over the model ranks
    under ``tp``)."""
    b, _, t, _ = o.shape
    out = o.transpose(1, 2).reshape(b, t, -1) @ params["wo"]
    return out if tp is None else reduce_from_model(out, tp.group)


def self_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                   return_kv: bool = False, impl: str = "auto", tp=None):
    """Prefill self-attention. x: [B, T, D].  ``tp``: tensor-parallel
    over the model axis (module docstring)."""
    t = x.shape[1]
    reads = None
    if tp is not None:
        x = copy_to_model(x, tp.group)
        params, reads = _local_kv(params, cfg, tp)
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    ka, va = (k, v) if reads is None else (k[:, :, reads], v[:, :, reads])
    # [B, H, T, hd], contiguous, for the kernel
    o = ops.flash_attention(q.transpose(1, 2).contiguous(),
                            ka.transpose(1, 2).contiguous(),
                            va.transpose(1, 2).contiguous(),
                            causal=True, window=cfg.sliding_window,
                            impl=impl)
    out = _heads_out(params, o, tp)
    if return_kv:
        return out, (k, v)   # [B, T, Hkv, hd]: the prefill cache build
    return out


def cross_attention(params: dict, x: torch.Tensor, kv_src: torch.Tensor,
                    cfg: ArchConfig, return_kv: bool = False,
                    impl: str = "auto", tp=None):
    """x: [B, T, D] attends over kv_src: [B, P, D] (patch embeddings), no
    RoPE, no mask.  ``return_kv`` also returns the patch (k, v), each
    [B, P, Hkv, hd]: the prefill's cross-attention state.  ``tp`` as
    :func:`self_attention`."""
    b, t, _ = x.shape
    p = kv_src.shape[1]
    reads = None
    if tp is not None:
        x = copy_to_model(x, tp.group)
        kv_src = copy_to_model(kv_src, tp.group)
        params, reads = _local_kv(params, cfg, tp)
    q = (x @ params["wq"]).reshape(b, t, -1, cfg.hd)
    k = (kv_src @ params["wk"]).reshape(b, p, -1, cfg.hd)
    v = (kv_src @ params["wv"]).reshape(b, p, -1, cfg.hd)
    ka, va = (k, v) if reads is None else (k[:, :, reads], v[:, :, reads])
    o = ops.flash_attention(q.transpose(1, 2).contiguous(),
                            ka.transpose(1, 2).contiguous(),
                            va.transpose(1, 2).contiguous(),
                            causal=False, impl=impl)
    out = _heads_out(params, o, tp)
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
