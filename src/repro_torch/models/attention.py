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

Decode on a mesh (:func:`decode_self_attention` with a ``ctx``) keeps
the KV cache split by slots over the model axis where the state's specs
say so (``models.decoding.decode_state_specs``): model rank r holds the
ring slots ``[r·S/m, (r+1)·S/m)``, writes the new token's K/V only where
its slot ``len % S`` falls in that block, attends over its block with
every query head (the plain ring decode) and merges the ranks' partial
(o, lse) with ``collectives.srq_combine``.  Under tensor parallelism the
projections keep their head blocks: q and the new k / v are all-gathered
over the model axis (one all-gather), and each rank takes its heads'
share of the merged o into its ``wo`` block.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels import ops, ref
from ..parallel.collectives import (all_gather, copy_to_model,
                                    reduce_from_model, srq_combine)
from .layers import apply_rope, normal


def tp_for(cfg: ArchConfig, tp):
    """``tp`` where the model axis divides the query heads, else None
    (the layer runs unsplit)."""
    return tp if tp is not None and cfg.num_heads % tp.size == 0 else None


def kv_heads_split(cfg: ArchConfig, tp) -> bool:
    """Whether ``wk`` / ``wv`` are used as column blocks under ``tp``
    (the model axis divides the KV heads) or arrive whole."""
    return cfg.num_kv_heads % tp.size == 0


def _local_kv(params: dict, cfg: ArchConfig, tp, keep_whole: bool = False):
    """(params, heads, reads) of a rank's attention where ``wk`` / ``wv``
    arrive whole: its query heads read the KV heads [lo, hi), which are
    ``wk`` / ``wv``'s columns in the returned ``params`` or, with
    ``keep_whole`` (a prefill whose cache keeps every KV head), the slice
    ``heads`` of the whole projection; ``reads`` is None or, where the
    query heads do not read those in uniform groups, the KV head (from
    lo) of each local query head."""
    if kv_heads_split(cfg, tp):
        return params, None, None
    hq = cfg.num_heads // tp.size
    group = cfg.num_heads // cfg.num_kv_heads
    q0 = tp.rank * hq
    lo, hi = q0 // group, (q0 + hq - 1) // group + 1
    reads = [(q0 + i) // group - lo for i in range(hq)]
    n = hi - lo
    uniform = hq % n == 0 and reads == [i // (hq // n) for i in range(hq)]
    reads = None if uniform else reads
    if keep_whole:
        return params, slice(lo, hi), reads
    cols = slice(lo * cfg.hd, hi * cfg.hd)
    params = dict(params, wk=params["wk"][..., cols],
                  wv=params["wv"][..., cols])
    return params, None, reads


def _kv_read(k: torch.Tensor, v: torch.Tensor, heads, reads):
    """The KV heads [B, T, ·, hd] a rank's query heads attend over
    (:func:`_local_kv`'s ``heads`` and ``reads``)."""
    if heads is not None:
        k, v = k[:, :, heads], v[:, :, heads]
    if reads is not None:
        k, v = k[:, :, reads], v[:, :, reads]
    return k, v


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
    over the model axis (module docstring); the K/V it returns are this
    rank's heads where the axis splits the KV heads, else every one."""
    t = x.shape[1]
    heads = reads = None
    if tp is not None:
        x = copy_to_model(x, tp.group)
        params, heads, reads = _local_kv(params, cfg, tp, return_kv)
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project_qkv(params, x, cfg, positions)
    ka, va = _kv_read(k, v, heads, reads)
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
    heads = reads = None
    if tp is not None:
        x = copy_to_model(x, tp.group)
        kv_src = copy_to_model(kv_src, tp.group)
        params, heads, reads = _local_kv(params, cfg, tp, return_kv)
    q = (x @ params["wq"]).reshape(b, t, -1, cfg.hd)
    k = (kv_src @ params["wk"]).reshape(b, p, -1, cfg.hd)
    v = (kv_src @ params["wv"]).reshape(b, p, -1, cfg.hd)
    ka, va = _kv_read(k, v, heads, reads)
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
def gather_heads(parts, group):
    """Tensors [B, T, h_i, hd], each this rank's block of heads (its
    columns of a head-split weight), -> every rank's heads in head order,
    each [B, T, m·h_i, hd]: one all-gather for them all."""
    sizes = [p.shape[2] for p in parts]
    both = all_gather(torch.cat(parts, dim=2), group, tiled=False)
    return [o.permute(1, 2, 0, 3, 4).flatten(2, 3)
            for o in both.split(sizes, dim=3)]


def whole_kv(k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, tp):
    """(k, v) [B, T, Hkv, hd] of every KV head from a prefill sublayer's
    own (``return_kv``): all-gathered over the model axis where it splits
    the KV heads, as they are otherwise."""
    if tp is not None and kv_heads_split(cfg, tp):
        return tuple(gather_heads([k, v], tp.group))
    return k, v


def _heads_share(o: torch.Tensor, wo: torch.Tensor, tp) -> torch.Tensor:
    """o [B, Hq, hd] of every head through ``wo``: under ``tp`` this
    rank's heads through its row block, summed over the model ranks."""
    b = o.shape[0]
    if tp is None:
        return o.reshape(b, 1, -1) @ wo
    hq = o.shape[1] // tp.size
    o = o[:, tp.rank * hq:(tp.rank + 1) * hq]
    return reduce_from_model(o.reshape(b, 1, -1) @ wo, tp.group)


def decode_self_attention(params: dict, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          lengths: torch.Tensor, cfg: ArchConfig,
                          ctx=None, slots_split: bool = False):
    """x: [B, 1, D]; cache: [B, S, Hkv, hd]; lengths: [B] tokens already in
    the cache.  The new token's K/V go to ring slot ``len % S``; returns
    (out [B,1,D], cache_k, cache_v).  Unlike the reference, which returns
    new arrays, the caches are written in place (a decode step would
    otherwise copy every cache whole).  With a ``ctx`` that has a mesh,
    ``params`` are :func:`repro_torch.models.transformer.gather_layer`'s
    and the caches this rank's block, its ring slots when ``slots_split``
    (module docstring)."""
    b = x.shape[0]
    tp = ctx.tp() if ctx is not None and ctx.have_mesh else None
    a_tp = tp_for(cfg, tp)
    q, k_new, v_new = _project_qkv(params, x, cfg, lengths[:, None])
    if a_tp is not None:
        if kv_heads_split(cfg, a_tp):
            q, k_new, v_new = gather_heads([q, k_new, v_new], tp.group)
        else:                 # wk / wv whole: every KV head is here
            (q,) = gather_heads([q], tp.group)
    s_loc = cache_k.shape[1]
    lo, s = (tp.rank * s_loc, s_loc * tp.size) if slots_split \
        else (0, s_loc)
    # ring slot len % S, written by the rank whose block holds it
    pos = lengths.long() % s - lo
    own = ((pos >= 0) & (pos < s_loc))[:, None, None]
    slot = pos.clamp(0, s_loc - 1)
    bidx = torch.arange(b, device=x.device)
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache.index_put_((bidx, slot), torch.where(
            own, new[:, 0].to(cache.dtype), cache[bidx, slot]))
    # ring validity: before wrap-around slots [0, len+1) hold data, after
    # it every slot does (a sliding-window cache is sized to the window);
    # a rank counts those that fall in its block
    valid = torch.clamp(torch.clamp(lengths + 1, max=s) - lo, 0, s_loc)
    o, lse = ref.decode_attention_naive(
        q.reshape(b, cfg.num_heads, cfg.hd), cache_k, cache_v, valid)
    if slots_split:
        # a block with no valid slot has lse -1e30 + log(S/m): weight 0
        o = srq_combine(o, lse, tp.group).to(q.dtype)
    return _heads_share(o, params["wo"], a_tp), cache_k, cache_v


def decode_cross_attention(params: dict, x: torch.Tensor, xk: torch.Tensor,
                           xv: torch.Tensor, cfg: ArchConfig, tp=None):
    """One token's cross-attention over the patch K/V its prefill cached
    (``xk`` / ``xv`` [B, P, Hkv, hd], every patch valid).  x: [B, 1, D],
    normed.  Under ``tp`` the query heads are all-gathered and each rank
    takes its heads' share into its ``wo`` block."""
    b = x.shape[0]
    q = (x @ params["wq"]).reshape(b, 1, -1, cfg.hd)
    if tp is not None:
        (q,) = gather_heads([q], tp.group)
    every = torch.full((b,), xk.shape[1], dtype=torch.int32,
                       device=x.device)
    o, _ = ref.decode_attention_naive(q.reshape(b, cfg.num_heads, cfg.hd),
                                      xk, xv, every)
    return _heads_share(o, params["wo"], tp)
