"""Prefill and decode (``repro.models.decoding``): KV caches, Mamba2 and
xLSTM states, ring buffers, on one card or over a process mesh.

The decode state mirrors the parameter layout: pattern leaves are stacked
``[n_units, B, ...]``, remainder leaves ``[B, ...]``.  The reference's
``lax.scan`` over units becomes a Python loop over the unit index.  KV
caches are ring buffers of ``min(max_len, sliding_window)`` slots.

Unlike the reference, ``decode_step`` updates the state it is given in
place (one token's KV slot, the new conv and SSM states) and returns that
same state: the functional form would copy every cache on every step
(the reference donates it).  Attention decode runs the plain ring decode
(``ref.decode_attention_naive``) as the reference does, and a
cross-attention layer decodes the same way over the patch K/V its
prefill cached (``xkv``, every patch valid); an MoE block runs the
capacity dispatch over every lane of the step, idle lanes included (the
reference's capacity counts them too).

On a mesh (``ctx`` with a mesh; ``params`` this rank's blocks by
``specs``, the tree of ``train.steps.param_specs``), each layer's
weights are gathered as the sharded train step gathers them
(``transformer.gather_layer``: FSDP over ``data``, tensor-parallel
attention and MLP over the model axis, the MoE under expert parallelism
through ``moe.moe_apply(..., ctx=)``; the vocabulary tables whole), and
the tokens are this rank's batch block.  The decode state is split by
one rule, :func:`decode_state_specs`: the prefill returns this rank's
block of it, ``decode_step`` takes and updates that block, and
:func:`shard_decode_state` / ``ctx.gather_tree`` move between the block
and the whole.  The prefill's self-attention K/V come out of the
tensor-parallel attention split by heads (whole where the model axis
does not divide the KV heads); each is ring-placed and sent to its slot
block's rank (one all-to-all over the model axis a layer), or
all-gathered where the slots stay whole.  Decode attention over a cache
split by slots is ``attention.decode_self_attention``'s: partial
softmaxes merged by ``srq_combine``.  The Mamba2 and xLSTM mixers run
whole on each rank's batch block, as in the train step.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from .. import _tree
from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from ..parallel.collectives import all_gather, all_to_all
from ..parallel.sharding import P, ParallelCtx
from . import attention as attn
from . import moe, ssm, xlstm
from .layers import mlp_apply, mlp_tp, rms_norm
from .transformer import (LayerWeights, embed_tokens, segments, tree_map,
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
# the decode state over a mesh
# --------------------------------------------------------------------------- #
def decode_state_specs(state, ctx: ParallelCtx):
    """The spec of every leaf of a whole decode state over ``ctx``'s mesh:
    a self-attention KV cache ``[(n_units,) B, S, Hkv, hd]`` follows
    ``ctx.kv_cache_spec(B, S)`` (the batch over the largest prefix of
    data axes that divides it, the ring slots over the model axis under
    ``seq_parallel_decode`` where it divides S); every other leaf (the
    patch K/V ``xkv``, the Mamba2 conv and SSM states, the mLSTM and
    sLSTM states) is split over the batch only.  A batch no data prefix
    divides is replicated (``long_500k``'s batch of 1).

    The reference's dry-run builds its own ``kv_spec``, which slot-splits
    a leaf of 4+ dims whose third-last dim is at least 4,096 and a
    multiple of 16, whatever its name; at every production cell the two
    give the same layout (S is 32,768, a 4,096-token window or 524,288,
    and ``xkv``'s 1,600 patches stay batch-split)."""
    def spec(path, leaf):
        lead = 1 if path[0] == "pattern" else 0
        b = leaf.shape[lead]
        if "kv" in path:        # ("pattern" | "remainder", i, "kv", k|v)
            return P(*([None] * lead), *ctx.kv_cache_spec(b, leaf.shape[
                lead + 1]))
        parts: list = [None] * len(leaf.shape)
        parts[lead] = ctx.batch_axes_for(b) or None
        return P(*parts)
    return _tree.tree_map_with_path(spec, state)


def shard_decode_state(state, ctx: ParallelCtx):
    """This rank's block of a whole decode state (views), by
    :func:`decode_state_specs`."""
    return ctx.shard_tree(state, decode_state_specs(state, ctx))


def _on_mesh(ctx: Optional[ParallelCtx]) -> bool:
    return ctx is not None and ctx.have_mesh


def _tp(ctx: Optional[ParallelCtx]):
    """The model axis as a tensor-parallel ``TP`` (None off a mesh)."""
    return ctx.tp() if _on_mesh(ctx) else None


def _slots_split(ctx: Optional[ParallelCtx], s_cache: int) -> bool:
    """Whether a cache of ``s_cache`` slots is split over the model axis
    (:func:`decode_state_specs`' rule; the batch does not enter it)."""
    return _on_mesh(ctx) and \
        ctx.kv_cache_spec(1, s_cache)[1] == ctx.model_axis


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


def _place_kv(k, v, cfg, s_cache: int, ctx, a_tp):
    """The prefill's (k, v) [B, T, heads, hd] (``self_attention``'s) as
    this rank's block of the cache [B, S(/m), Hkv, hd]: ring-placed
    (:func:`_ring_place`), every KV head gathered and, where the slots are
    split, this rank's slot block kept.  Heads split by the
    tensor-parallel attention go to their slot block's rank in one
    all-to-all (k and v together)."""
    tp = _tp(ctx)
    split = _slots_split(ctx, s_cache)
    if a_tp is not None and attn.kv_heads_split(cfg, a_tp):
        kv = torch.stack([_ring_place(k, s_cache), _ring_place(v, s_cache)])
        kv = all_to_all(kv, tp.group, 2, 3) if split \
            else all_gather(kv, tp.group, 3)
        kv = kv.contiguous()
        return kv[0], kv[1]
    k, v = _ring_place(k, s_cache), _ring_place(v, s_cache)
    if split:
        n = s_cache // tp.size
        k, v = (t[:, tp.rank * n:(tp.rank + 1) * n].clone() for t in (k, v))
    return k, v


def _ffn_block(kind: str, p, x, cfg,
               on_route: Optional[moe.RouteObserver] = None, ctx=None):
    """The feed-forward half of an attention block: the MLP, or for
    ``attn_moe`` the MoE capacity dispatch (under expert parallelism on a
    mesh)."""
    h = rms_norm(x, p["ln2"])
    if kind == "attn_moe":
        return x + moe.moe_apply(p["ffn"], h, cfg, on_route=on_route,
                                 ctx=ctx)[0]
    return x + mlp_apply(p["ffn"], h, cfg.mlp, mlp_tp(cfg.d_ff, _tp(ctx)))


def _prefill_layer(kind: str, p, x, cfg, shared, patches, s_cache, impl,
                   on_route: Optional[moe.RouteObserver] = None, ctx=None):
    st: State = {}
    a_tp = attn.tp_for(cfg, _tp(ctx))
    h = rms_norm(x, p["ln1"])
    if kind.startswith("attn"):
        y, (k, v) = attn.self_attention(p["attn"], h, cfg, return_kv=True,
                                        impl=impl, tp=a_tp)
        x = x + y
        st["kv"] = _place_kv(k, v, cfg, s_cache, ctx, a_tp)
        if kind == "attn_cross":
            # the patch K/V the cross-attention computes are the state
            y, (xk, xv) = attn.cross_attention(
                p["xattn"], rms_norm(x, p["ln_x"]), patches, cfg,
                return_kv=True, impl=impl, tp=a_tp)
            st["xkv"] = attn.whole_kv(xk, xv, cfg, a_tp)
            x = x + y
        return _ffn_block(kind, p, x, cfg, on_route, ctx), st
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
                                         return_kv=True, impl=impl, tp=a_tp)
        x = x + ys
        x = x + mlp_apply(shared["ffn"], rms_norm(x, shared["ln2"]),
                          cfg.mlp, mlp_tp(cfg.d_ff, _tp(ctx)))
        st["kv"] = _place_kv(k, v, cfg, s_cache, ctx, a_tp)
    return x, st


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None, max_len: int = 0,
            compute_dtype=torch.float32, impl: str = "auto",
            on_route: Optional[moe.RouteObserver] = None,
            ctx: Optional[ParallelCtx] = None, specs=None):
    """Process the prompt; returns (last-position logits [B,V], state,
    lengths [B]).  tokens: [B, T] (or [B, K, T] codebook ids);
    ``patches`` [B, P, D] feed the cross-attention layers.  ``max_len``
    sizes the decode cache (default: the prompt length).  ``impl`` goes
    to the kernels (``"ref"``: their plain versions).  ``on_route`` sees
    each MoE block's routing, layer by layer
    (:func:`repro_torch.models.moe.moe_apply`).  With a ``ctx`` that has a
    mesh, ``params`` are this rank's blocks by ``specs`` and ``tokens``
    (and ``patches``) its batch block; the logits, the state (its block
    by :func:`decode_state_specs`) and the lengths are this rank's
    (module docstring).  A Mamba2 or mLSTM prompt must be a multiple of
    its chunk, as in the reference.  Runs where ``tokens`` and
    ``params`` lie."""
    resolve_device(tokens.device)
    pattern, n_units, rem = segments(cfg)
    w = LayerWeights(params, cfg, ctx, specs, compute_dtype)
    t = tokens.shape[-1]
    s_cache = cache_len_for(cfg, max_len or t)
    top = w.top()
    x = embed_tokens(top, tokens, cfg, compute_dtype)
    if patches is not None:
        patches = patches.to(compute_dtype)
    shared = w.shared()
    unit_specs = [w.unit_specs(pos) for pos in range(len(pattern))]
    per_pos: List[List[State]] = [[] for _ in pattern]
    for u in range(n_units):
        for pos, kind in enumerate(pattern):
            x, st = _prefill_layer(kind, w.layer(kind, unit(
                params["pattern"][pos], u), unit_specs[pos]), x, cfg,
                shared, patches, s_cache, impl, on_route, ctx)
            per_pos[pos].append(st)
    rem_states = []
    for i, kind in enumerate(rem):
        x, st = _prefill_layer(kind, w.remainder(i, kind), x, cfg, shared,
                               patches, s_cache, impl, on_route, ctx)
        rem_states.append(st)
    logits = unembed(top, x[:, -1:, :], cfg)[:, 0]
    lengths = torch.full((tokens.shape[0],), t, dtype=torch.int32,
                         device=tokens.device)
    state = {"pattern": tuple(_stack(sts) for sts in per_pos),
             "remainder": tuple(rem_states)}
    return logits, state, lengths


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def _decode_layer(kind: str, p, st: State, x, lengths, cfg, shared,
                  ctx=None, slots_split: bool = False):
    new: State = {}
    a_tp = attn.tp_for(cfg, _tp(ctx))
    h = rms_norm(x, p["ln1"])
    if kind.startswith("attn"):
        y, ck, cv = attn.decode_self_attention(
            p["attn"], h, st["kv"][0], st["kv"][1], lengths, cfg, ctx,
            slots_split)
        x = x + y
        new["kv"] = (ck, cv)
        if kind == "attn_cross":
            new["xkv"] = st["xkv"]
            x = x + attn.decode_cross_attention(
                p["xattn"], rms_norm(x, p["ln_x"]), *st["xkv"], cfg, a_tp)
        return _ffn_block(kind, p, x, cfg, ctx=ctx), new
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
            shared["attn"], hs, st["kv"][0], st["kv"][1], lengths, cfg, ctx,
            slots_split)
        x = x + y2
        x = x + mlp_apply(shared["ffn"], rms_norm(x, shared["ln2"]),
                          cfg.mlp, mlp_tp(cfg.d_ff, _tp(ctx)))
        new["kv"] = (ck, cv)
    return x, new


def _split_of(state_specs, where: str, i: int, ctx) -> bool:
    """Whether layer ``i``'s KV cache in ``state_specs`` is split by slots
    over the model axis (False where the layer has none)."""
    spec = state_specs[where][i].get("kv") if _on_mesh(ctx) else None
    return spec is not None and spec[0][-3] == ctx.model_axis


def decode_step(params, cfg: ArchConfig, state: State,
                tokens: torch.Tensor, lengths: torch.Tensor,
                compute_dtype=torch.float32,
                ctx: Optional[ParallelCtx] = None, specs=None,
                state_specs=None):
    """One decode step. tokens: [B] (or [B, K] codebook ids); lengths:
    [B] tokens already in the cache.  Returns (logits [B,V], state), the
    state updated in place.  With a ``ctx`` that has a mesh, ``params``
    are this rank's blocks by ``specs``, ``state`` this rank's block by
    ``state_specs`` (:func:`decode_state_specs` of the whole state) and
    ``tokens``, ``lengths`` and the logits its batch block.  Runs where
    ``tokens`` and ``state`` lie."""
    resolve_device(tokens.device)
    if _on_mesh(ctx) and state_specs is None:
        raise ValueError("decode_step on a mesh needs the state's specs "
                         "(decode_state_specs)")
    pattern, n_units, rem = segments(cfg)
    w = LayerWeights(params, cfg, ctx, specs, compute_dtype)
    top = w.top()
    x = embed_tokens(top, tokens[..., None], cfg, compute_dtype)
    shared = w.shared()
    unit_specs = [w.unit_specs(pos) for pos in range(len(pattern))]
    for u in range(n_units):
        for pos, kind in enumerate(pattern):
            st = unit(state["pattern"][pos], u)
            x, new = _decode_layer(
                kind, w.layer(kind, unit(params["pattern"][pos], u),
                              unit_specs[pos]),
                st, x, lengths, cfg, shared, ctx,
                _split_of(state_specs, "pattern", pos, ctx))
            _assign(st, new)
    for i, (st, kind) in enumerate(zip(state["remainder"], rem)):
        x, new = _decode_layer(kind, w.remainder(i, kind), st, x, lengths,
                               cfg, shared, ctx,
                               _split_of(state_specs, "remainder", i, ctx))
        _assign(st, new)
    logits = unembed(top, x, cfg)[:, 0]
    return logits, state
