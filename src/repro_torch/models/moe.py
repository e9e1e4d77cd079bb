"""Mixture-of-Experts with SRQ-style capacity dispatch and escape
(``repro.models.moe``, paper §4.1).

Each expert owns a fixed-capacity slab ``[C, D]`` (the SRQ's pre-posted
WQEs).  Tokens are sorted into their expert's slab in token order; those
past its capacity take the *escape* path: they skip the expert (the
residual carries them) and are counted in ``overflow``.

Two implementations of one function:

* :func:`moe_apply` — the single-card capacity dispatch, the serving
  path: the reference's expert-parallel body (``_ep_body``) at one model
  rank, its two ``all_to_all``s removed.  The expert FFN runs as batched
  products ``[E, C, D] @ [E, D, F]``, which the reference computes outside
  any Pallas kernel too.
* :func:`moe_dense_ref` — the plain version: every expert on every
  token, masked by route and capacity.

* :func:`moe_ep` — expert parallelism over the model axis of a process
  mesh (the reference's ``shard_map`` body, one process a rank): each
  rank routes its share of its batch block's tokens, the slabs go to
  their experts' rank through an ``all_to_all`` (the READ large-message
  move) and back, and the outputs come together through an all-gather
  (the SRQ small-message path).  Expert weights sharded over ``data``
  (FSDP) are all-gathered first, or with ``jet_collectives`` ride a
  ring over ``data`` inside the expert FFN (:func:`_staged_expert_ffn`,
  the RDCA in-graph path).  Too few tokens to split over the model
  ranks (decode) take :func:`_ep_body_decode`.  ``moe_apply(...,
  ctx=...)`` takes this path when the context has a mesh and
  ``use_ep``.

All rank a token within its expert in token order (a stable sort, a
``cumsum`` in the plain version), so they keep the same tokens and
report the same ``overflow``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..parallel.collectives import (all_gather, all_reduce, all_to_all,
                                    copy_to_model, ppermute, ppermute_many,
                                    reduce_from_model)
from ..parallel.sharding import P, ParallelCtx
from .layers import _gelu, mlp_apply, mlp_init, normal

# on_route(expert ids [n], kept [n], top-2 router probability margin [n])
RouteObserver = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], None]


def moe_init(generator: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32, device=None, lead: tuple = ()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": normal(lead + (d, e), d ** -0.5, generator, dtype, device),
        "e_in": normal(lead + (e, d, f), d ** -0.5, generator, dtype,
                       device),
        "e_out": normal(lead + (e, f, d), f ** -0.5, generator, dtype,
                        device),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["e_gate"] = normal(lead + (e, d, f), d ** -0.5, generator, dtype,
                             device)
    if cfg.shared_expert:
        p["shared"] = mlp_init(generator, d, f, cfg.mlp, dtype, device, lead)
    return p


def _expert_ffn(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: [E, C, D] through per-expert stacked weights."""
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = act(torch.bmm(x, p["e_gate"])) * torch.bmm(x, p["e_in"])
    else:
        h = _gelu(torch.bmm(x, p["e_in"]))
    return torch.bmm(h, p["e_out"])


def _route_top1(logits: torch.Tensor):
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.max(probs, dim=-1)
    return idx, gate, probs


def _aux_losses(probs: torch.Tensor, idx: torch.Tensor,
                e: int) -> torch.Tensor:
    """Switch-style load-balance loss."""
    frac = torch.mean(F.one_hot(idx, e).float(), dim=0)
    mean_p = torch.mean(probs, dim=0)
    return e * torch.sum(frac * mean_p)


def capacity(cf: float, n_tokens: int, e: int) -> int:
    """Slots a slab.  ``n_tokens`` is every token of the call: in decode
    that counts the idle lanes too, as in the reference."""
    return max(1, int(cf * n_tokens / e))


def _observe(on_route: Optional[RouteObserver], idx, keep, probs) -> None:
    if on_route is not None:
        top = torch.topk(probs, 2, dim=-1).values
        on_route(idx, keep, top[:, 0] - top[:, 1])


# --------------------------------------------------------------------------- #
def moe_dense_ref(params: dict, x: torch.Tensor, cfg: ArchConfig,
                  cap_factor: float,
                  on_route: Optional[RouteObserver] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """The plain version: every expert on every token, masked by routing
    and capacity.  x: [B, T, D]."""
    b, t, d = x.shape
    e, n = cfg.num_experts, b * t
    xt = x.reshape(n, d)
    idx, gate, probs = _route_top1(xt @ params["router"])
    c = capacity(cap_factor, n, e)
    onehot = F.one_hot(idx, e)
    rank = torch.cumsum(onehot, dim=0) * onehot     # 1-based within expert
    keep = torch.gather(rank, 1, idx[:, None])[:, 0] <= c
    y_all = _expert_ffn(params, xt.expand(e, n, d), cfg.mlp)
    y = y_all[idx, torch.arange(n, device=x.device)]
    y = y * (gate * keep)[:, None].to(y.dtype)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, cfg.mlp)
    _observe(on_route, idx, keep, probs)
    aux = {"lb_loss": _aux_losses(probs, idx, e),
           "overflow": 1.0 - torch.mean(keep.float())}
    return y.reshape(b, t, d), aux


def moe_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
              cap_factor: Optional[float] = None,
              on_route: Optional[RouteObserver] = None,
              ctx: Optional[ParallelCtx] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """The capacity dispatch on one card.  x: [B, T, D].  Returns
    ``(y, {"lb_loss", "overflow"})``.  ``on_route``, when given, sees each
    token's expert, whether it kept its slot, and its router's top-2
    probability margin.  A ``ctx`` with a mesh and ``use_ep`` takes
    :func:`moe_ep` (``params`` and ``x`` are then this rank's share);
    the capacity factor is ``cap_factor``, else the context's, else the
    config's."""
    if ctx is not None and ctx.have_mesh and ctx.use_ep:
        return moe_ep(params, x, cfg, ctx, cap_factor, on_route)
    cf = cap_factor or (ctx.moe_capacity_factor if ctx else None) \
        or cfg.capacity_factor
    b, t, d = x.shape
    e, n = cfg.num_experts, b * t
    dev = x.device
    xt = x.reshape(n, d)
    idx, gate, probs = _route_top1(xt @ params["router"])
    c = capacity(cf, n, e)
    order = torch.sort(idx, stable=True).indices
    se = idx[order]                                  # sorted expert ids
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    rank = torch.arange(n, device=dev) - starts[se]
    kept = rank < c
    dest = torch.where(kept, se * c + rank, e * c)   # overflow -> trash slot
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=dev)
    buf[dest] = xt[order]
    out = _expert_ffn(params, buf[:-1].reshape(e, c, d), cfg.mlp)
    flat = torch.cat([out.reshape(e * c, d),
                      torch.zeros((1, d), dtype=out.dtype, device=dev)])
    y = torch.zeros_like(xt)
    y[order] = flat[dest] * kept[:, None].to(out.dtype)
    y = y * gate[:, None].to(y.dtype)
    keep = torch.empty_like(kept)
    keep[order] = kept
    _observe(on_route, idx, keep, probs)
    aux = {"lb_loss": _aux_losses(probs, idx, e),
           "overflow": 1.0 - torch.mean(keep.float())}
    # the shared expert last: a checkpoint's replay stops after the last
    # tensor the backward saves, so its down-projection is not replayed
    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, cfg.mlp)
    return y.reshape(b, t, d), aux


# --------------------------------------------------------------------------- #
def _fsdp_gather(ctx: ParallelCtx, d: int) -> bool:
    """Expert weights arrive sharded on D over ``data`` (ZeRO-3)."""
    return (ctx.fsdp and "data" in ctx.mesh.axis_names
            and d % ctx.mesh.shape["data"] == 0)


def ep_local(params: dict, x: torch.Tensor, ctx: ParallelCtx
             ) -> Tuple[dict, torch.Tensor]:
    """This rank's share of :func:`moe_ep`'s inputs, from the full
    parameters and batch (views), by the reference's ``in_specs``: the
    router whole, the expert stacks sharded on E over the model axis
    (and on D over ``data`` under FSDP), ``x``'s batch over the data axes
    that divide it.  The shared expert, which the reference applies
    outside the ``shard_map``, stays whole."""
    ax = ctx.model_axis
    fs = "data" if _fsdp_gather(ctx, x.shape[-1]) else None
    local = dict(params)
    for k, spec in (("router", P(None, None)), ("e_gate", P(ax, fs, None)),
                    ("e_in", P(ax, fs, None)), ("e_out", P(ax, None, fs))):
        local[k] = ctx.shard(params[k], spec)
    return local, ctx.shard(x, P(ctx.batch_axes_for(x.shape[0]) or None,
                                 None, None))


def _gather_experts(ctx: ParallelCtx, w_gate, w_in, w_out):
    """The expert stacks' FSDP shards gathered on D over ``data`` (their
    gradients reduce-scattered back in the backward)."""
    dg = ctx.mesh.group("data")
    return all_gather(w_gate, dg, 1), all_gather(w_in, dg, 1), \
        all_gather(w_out, dg, 2)


def _ep_body_decode(wr, w_gate, w_in, w_out, x_blk, *, cfg: ArchConfig,
                    cap_factor: float, ctx: ParallelCtx, fsdp_gather: bool,
                    on_route: Optional[RouteObserver] = None):
    """Decode-path EP: too few tokens to split across model ranks, so every
    rank routes all (replicated) tokens, serves only its local experts,
    and the combine is a sum over the model ranks — the SRQ
    small-message path (no all-to-all latency on the decode critical
    path)."""
    if fsdp_gather:
        w_gate, w_in, w_out = _gather_experts(ctx, w_gate, w_in, w_out)
    w_gate, w_in, w_out = (w.to(x_blk.dtype) for w in (w_gate, w_in, w_out))
    mg = ctx.mesh.group(ctx.model_axis)
    b_loc, t, d = x_blk.shape
    e = cfg.num_experts
    m = ctx.model_size
    e_loc = e // m
    r = ctx.mesh.coord(ctx.model_axis)
    n = b_loc * t
    dev = x_blk.device
    # each rank serves its experts' share of every token: a part of a sum
    xt = copy_to_model(x_blk, mg).reshape(n, d)
    idx, gate, probs = _route_top1(xt @ copy_to_model(wr, mg))
    c = capacity(cap_factor, n, e)
    local_idx = idx - r * e_loc
    is_local = (local_idx >= 0) & (local_idx < e_loc)
    key = torch.where(is_local, local_idx, e_loc)
    order = torch.sort(key, stable=True).indices
    se = key[order]
    starts = torch.searchsorted(se, torch.arange(e_loc, device=dev))
    rank = torch.arange(n, device=dev) - starts[torch.clamp(se,
                                                            max=e_loc - 1)]
    keep = (se < e_loc) & (rank < c)
    dest = torch.where(keep, se * c + rank, e_loc * c)
    buf = torch.zeros((e_loc * c + 1, d), dtype=xt.dtype, device=dev)
    buf[dest] = xt[order]
    out = _expert_ffn({"e_gate": w_gate, "e_in": w_in, "e_out": w_out},
                      buf[:-1].reshape(e_loc, c, d), cfg.mlp)
    flat = torch.cat([out.reshape(e_loc * c, d),
                      torch.zeros((1, d), dtype=out.dtype, device=dev)])
    y = torch.zeros_like(xt)
    y[order] = flat[dest] * keep[:, None].to(out.dtype)
    y = y * gate[:, None].to(y.dtype)
    y = reduce_from_model(y, mg)              # SRQ combine
    kept = torch.zeros(n, dtype=torch.float32, device=dev)
    kept[order] = keep.float()
    kept = all_reduce(kept, mg)               # each token kept by one rank
    _observe(on_route, idx, kept > 0, probs)
    overflow = 1.0 - kept.sum() / n
    # every rank routed every token: lb is whole on each, while the
    # router's gradient sums the ranks' parts, so each contributes 1/m
    lb = reduce_from_model(_aux_losses(probs, idx, e) / m, mg)
    return y.reshape(b_loc, t, d), lb, overflow


def _staged_expert_ffn(w_gate, w_in, w_out, x, kind: str, group):
    """RDCA in-graph (paper §4.1.2): the expert weights' FSDP shards ride
    a ring over the ``data`` group and each is consumed the hop it
    arrives — the gathered [E, D, F] weight never exists.  The two live
    ring slots are the cache-resident buffer pool; the ring depth is the
    in-flight window (one fragment in flight a tensor).

    x: [E, C, D] tokens (full D locally); w_gate/w_in: [E, D/m, F]
    shards; w_out: [E, F, D/m] shards.  The owner of the held shard after
    i hops is (r - i) % m, r this rank's ``data`` index.  The products
    are ``torch.bmm``, as the reference's ``einsum``s run outside any
    Pallas kernel."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    e, c, d = x.shape
    f = w_in.shape[-1]
    dk = d // m
    act = F.silu if kind == "swiglu" else _gelu

    # phase A: h = act(x @ Wg) * (x @ Wi), contraction over D fragments
    hg = torch.zeros((e, c, f), dtype=x.dtype, device=x.device)
    hi = torch.zeros_like(hg)
    wg, wi = w_gate, w_in
    for i in range(m):
        src = (r - i) % m                     # owner of the held fragment
        xs = x[:, :, src * dk:(src + 1) * dk]
        hg = hg + torch.bmm(xs, wg)
        hi = hi + torch.bmm(xs, wi)
        if i < m - 1:
            wg, wi = ppermute_many([wg, wi], group)
    h = act(hg) * hi

    # phase B: out[:, :, D_src] = h @ Wo_src as the Wo shards ride the ring
    out = torch.zeros((e, c, d), dtype=x.dtype, device=x.device)
    wo = w_out
    for i in range(m):
        src = (r - i) % m
        out[:, :, src * dk:(src + 1) * dk] = torch.bmm(h, wo)
        if i < m - 1:
            wo = ppermute(wo, group)
    return out


def _ep_body(wr, w_gate, w_in, w_out, x_blk, *, cfg: ArchConfig,
             cap_factor: float, ctx: ParallelCtx, fsdp_gather: bool,
             jet_staged: bool = False,
             on_route: Optional[RouteObserver] = None):
    """One rank's body.  x_blk: [B_loc, T, D] (the same on every model
    rank); expert weights sharded on E.  Model rank r routes rows
    [r·n, (r+1)·n) of its block."""
    m = ctx.model_size
    if x_blk.shape[0] * x_blk.shape[1] % m != 0:
        return _ep_body_decode(wr, w_gate, w_in, w_out, x_blk, cfg=cfg,
                               cap_factor=cap_factor, ctx=ctx,
                               fsdp_gather=fsdp_gather, on_route=on_route)
    staged = fsdp_gather and jet_staged
    if fsdp_gather and not staged:
        # ZeRO-3: expert weights arrive sharded on D over 'data'; gather
        # (this all-gather is the jet staged-collective hillclimb target)
        w_gate, w_in, w_out = _gather_experts(ctx, w_gate, w_in, w_out)
    w_gate, w_in, w_out = (w.to(x_blk.dtype) for w in (w_gate, w_in, w_out))
    mg = ctx.mesh.group(ctx.model_axis)
    b_loc, t, d = x_blk.shape
    e = cfg.num_experts
    r = ctx.mesh.coord(ctx.model_axis)
    n = b_loc * t // m
    dev = x_blk.device
    # the block is whole on every model rank and each routes its rows, so
    # the gradients of the block and of the router sum the ranks' parts
    mine = copy_to_model(x_blk, mg).reshape(b_loc * t, d)[r * n:(r + 1) * n]

    idx, gate, probs = _route_top1(mine @ copy_to_model(wr, mg))
    c = capacity(cap_factor, n, e)
    order = torch.sort(idx, stable=True).indices
    se = idx[order]                                  # sorted expert ids
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    rank = torch.arange(n, device=dev) - starts[se]
    keep = rank < c
    dest = torch.where(keep, se * c + rank, e * c)   # overflow -> trash slot
    buf = torch.zeros((e * c + 1, d), dtype=mine.dtype, device=dev)
    buf[dest] = mine[order]
    buf = buf[:-1].reshape(e, c, d)

    # ---- large-message path: all-to-all to expert shards ----------------- #
    recv = all_to_all(buf, mg, 0, 1)                 # [E_loc, m*C, D]
    if staged:
        out = _staged_expert_ffn(w_gate, w_in, w_out, recv, cfg.mlp,
                                 ctx.mesh.group("data"))
    else:
        out = _expert_ffn({"e_gate": w_gate, "e_in": w_in, "e_out": w_out},
                          recv, cfg.mlp)
    back = all_to_all(out, mg, 1, 0)                 # [E, C, D]
    flat = torch.cat([back.reshape(e * c, d),
                      torch.zeros((1, d), dtype=back.dtype, device=dev)])
    y_mine = torch.zeros_like(mine)
    y_mine[order] = flat[dest] * keep[:, None].to(back.dtype)
    y_mine = y_mine * gate[:, None].to(y_mine.dtype)
    if on_route is not None:
        kept = torch.empty_like(keep)
        kept[order] = keep
        _observe(on_route, idx, kept, probs)

    # ---- small-message path: combine across model ranks (SRQ) ------------ #
    # every model rank goes on with the whole block: its cotangent is the
    # same on each, and this rank's rows of it are its own
    y_all = all_gather(y_mine, mg, 0, backward="slice")
    # pmean of both figures in one all-reduce
    aux = reduce_from_model(torch.stack([_aux_losses(probs, idx, e),
                                         1.0 - torch.mean(keep.float())]),
                            mg) / m
    return y_all.reshape(b_loc, t, d), aux[0], aux[1]


def moe_ep(params: dict, x: torch.Tensor, cfg: ArchConfig,
           ctx: ParallelCtx, cap_factor: Optional[float] = None,
           on_route: Optional[RouteObserver] = None
           ) -> Tuple[torch.Tensor, Dict]:
    """Expert-parallel MoE on this rank of ``ctx``'s mesh.

    ``x``: this rank's batch block [B_loc, T, D] (the whole batch where
    the data axes do not divide it); ``params``: the router and shared
    expert whole, the expert stacks this rank's shards (``ep_local``
    slices both from the full ones).  Returns this rank's block of y and
    ``{"lb_loss", "overflow"}``, each the mean over the model ranks of
    this rank's data block.  The reference returns those from a
    ``shard_map`` with ``out_specs=P()`` and ``check_vma=False``, so each
    of its devices keeps its own block's figure and a read on the host
    gives the first device's, data coordinate 0's: the figure the ranks
    of data coordinate 0 return here.  Nothing is averaged over ``data``.

    Differentiable, for the sharded train step: the all-to-alls run in
    reverse in the backward, the expert stacks' FSDP gathers
    reduce-scatter their gradients over ``data``, and the block and the
    router, which each model rank uses for its share of the tokens, have
    their gradients summed over the model ranks.  The expert stacks are
    cast to ``x``'s type after their gather.  The shared expert runs on
    the whole block on every rank."""
    if not ctx.have_mesh:
        raise ValueError("moe_ep needs a context with a mesh")
    if "e_gate" not in params:
        raise ValueError("EP path expects gated experts (llama4)")
    if cfg.num_experts % ctx.model_size:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{ctx.model_size} model ranks")
    cf = cap_factor or ctx.moe_capacity_factor or cfg.capacity_factor
    b, t, d = x.shape
    fsdp_gather = _fsdp_gather(ctx, d)
    e_loc = cfg.num_experts // ctx.model_size
    d_loc = d // ctx.mesh.shape["data"] if fsdp_gather else d
    if tuple(params["e_in"].shape) != (e_loc, d_loc, cfg.d_ff):
        raise ValueError(f"e_in is {tuple(params['e_in'].shape)}; this "
                         f"rank's shard is {(e_loc, d_loc, cfg.d_ff)} "
                         f"(moe.ep_local slices it)")
    y, lb, overflow = _ep_body(
        params["router"], params["e_gate"], params["e_in"], params["e_out"],
        x, cfg=cfg, cap_factor=cf, ctx=ctx, fsdp_gather=fsdp_gather,
        jet_staged=ctx.jet_collectives, on_route=on_route)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x.reshape(b * t, d),
                          cfg.mlp).reshape(b, t, d)
    return y, {"lb_loss": lb, "overflow": overflow}
