"""Jet staged collectives: RDCA applied across ranks
(``repro.parallel.collectives``).

The paper's receive path keeps DRAM out of the datapath by having
consumers eat fragments straight from a small recycled cache pool.  The
image across ranks: never materialize the all-gathered operand — pass
shards around a ring (:func:`ppermute`) and consume each shard the hop it
arrives, with at most ``window`` fragments in flight.

Every function runs on each rank of a process group (SPMD, one process a
rank) and takes the axis's group where the reference takes its axis
name; the reference's ``lax.scan`` over ring hops is a Python loop here.

  * ring_allgather_matmul — y = x @ W, W sharded on the contraction dim
  * ring_reduce_scatter   — y_shard = (x @ W) reduce-scattered
  * windowed_allgather    — chunked all-gather with bounded in-flight bytes
  * srq_combine           — small-message combine for (o, lse) partials

and the collectives under them, autograd-aware where the sharded train
step differentiates through them:

  * :func:`all_gather` — the reference's ``all_gather``, tiled along any
    dim or stacked.  Its backward is chosen by what consumes the result:
    ``"sum"``, the reduce-scatter back to this rank's block (JAX's
    transpose: ranks that hold different tokens, as over a data axis),
    or ``"slice"``, this rank's block of the cotangent (every rank
    computed the same cotangent from the same tokens, as over the model
    axis for a weight a sublayer uses whole);
  * :func:`reduce_scatter` — the sum over the group, this rank's block;
  * :func:`all_to_all` — its tiled ``all_to_all``; backward, the reverse
    all-to-all;
  * Megatron's pair over the model axis: :func:`copy_to_model` (identity
    forward, all-reduce backward: the input of a sublayer whose ranks
    each compute a part) and :func:`reduce_from_model` (all-reduce
    forward, identity backward: that sublayer's summed output, which
    every rank then holds whole);
  * :func:`all_reduce` — ``psum``, not autograd-aware.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


# the name since torch 2.13; reduce_scatter_tensor before it
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _shift(xs: Sequence[torch.Tensor], group, step: int,
           cyclic: bool) -> List[torch.Tensor]:
    """Each rank r sends ``xs`` to r + step and receives from r - step, in
    one batch of point-to-point ops (every tensor in flight at once).
    Without ``cyclic`` the ring is cut at its ends: the rank with no
    sender receives zeros."""
    m, r = _size_rank(group)
    dst, src = r + step, r - step
    if cyclic:
        dst, src = dst % m, src % m
        if m == 1:
            return [x.clone() for x in xs]
    outs = [torch.empty_like(x) if 0 <= src < m else torch.zeros_like(x)
            for x in xs]
    ops = []
    for x, out in zip(xs, outs):
        if 0 <= dst < m:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  dist.get_global_rank(group, dst), group))
        if 0 <= src < m:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return outs


class _PPermute(torch.autograd.Function):
    """Forward: the shift to the next rank; backward: the shift back (the
    transpose of a permutation, as JAX transposes ``ppermute``).  Every
    rank must reach the backward of the same shifts in the same order,
    which the same program on every rank gives."""

    @staticmethod
    def forward(ctx, group, cyclic, *xs):
        ctx.group, ctx.cyclic = group, cyclic
        return tuple(_shift(xs, group, 1, cyclic))

    @staticmethod
    def backward(ctx, *grads):
        gs = [torch.zeros_like(g) if g is None else g for g in grads]
        return (None, None, *_shift(gs, ctx.group, -1, ctx.cyclic))


def ppermute(x: torch.Tensor, group, cyclic: bool = True) -> torch.Tensor:
    """Rank r's ``x`` to rank (r + 1) % m of ``group``; with
    ``cyclic=False`` the ring is cut (rank 0 receives zeros and the last
    rank's send is dropped), as the reference's pipeline hand-off."""
    return _PPermute.apply(group, cyclic, x)[0]


def ppermute_many(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """:func:`ppermute` of several tensors in one batch (all in flight)."""
    return list(_PPermute.apply(group, True, *xs))


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    m, _ = _size_rank(group)
    parts = [torch.empty_like(x) for _ in range(m)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _block(g: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``g`` along ``dim`` (a copy)."""
    m, r = _size_rank(group)
    n = g.shape[dim] // m
    return g.narrow(dim, r * n, n).contiguous()


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, cut into m blocks
    along ``dim``: this rank's block."""
    m, _ = _size_rank(group)
    if x.shape[dim] % m:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not split over "
                         f"{m} ranks")
    send = x.movedim(dim, 0).contiguous()
    out = torch.empty((send.shape[0] // m,) + tuple(send.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _reduce_scatter(out, send, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, backward):
        ctx.group, ctx.dim, ctx.backward = group, dim, backward
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "sum":
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return _block(g, ctx.group, ctx.dim), None, None, None


GATHER_BACKWARDS = ("sum", "slice")


def all_gather(x: torch.Tensor, group, dim: int = 0, tiled: bool = True,
               backward: str = "sum") -> torch.Tensor:
    """Every rank's ``x`` in rank order: concatenated along ``dim``
    (``tiled``) or stacked on a new dim 0.  ``backward``: ``"sum"``
    reduce-scatters the cotangent back to this rank's block, ``"slice"``
    keeps this rank's block of it (see the module docstring)."""
    if backward not in GATHER_BACKWARDS:
        raise ValueError(f"backward must be one of {GATHER_BACKWARDS}, "
                         f"got {backward!r}")
    if not tiled:
        return all_gather(x.unsqueeze(0), group, 0, True, backward)
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, group, dim, backward)
    return _gather(x, group, dim)


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    m, _ = _size_rank(group)
    n = x.shape[split_dim]
    if n % m:
        raise ValueError(f"dim {split_dim} ({n}) does not split over {m} "
                         f"ranks")
    # [m, ...] with the chunk for rank j at j: all_to_all_single moves
    # dim 0 only
    send = x.unflatten(split_dim, (m, n // m)).movedim(split_dim, 0)
    recv = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    # the chunk from rank i at i: move it next to concat_dim and merge
    return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The reference's tiled ``all_to_all``: ``x``'s ``split_dim`` cut
    into m chunks, chunk j to rank j, the chunks received concatenated
    along ``concat_dim`` in rank order.  Its backward is the reverse
    all-to-all (chunk i of the cotangent back to rank i)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, group, split_dim, concat_dim)
    return _all_to_all(x, group, split_dim, concat_dim)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``psum`` (or ``op``) over ``group``: a new tensor."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, all_reduce(g, ctx.group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward: ``x`` is replicated over
    ``group`` and each rank's use of it computes one part of a sum (its
    heads, its FFN columns, its share of the tokens), so its cotangent is
    the sum of the ranks' parts."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToModel.apply(group, x)
    return x


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, g


def psum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``psum`` whose output every rank then holds as one replicated
    value: its cotangent is that value's, whole on each rank, so the
    backward passes it through (JAX's transpose of ``psum`` into an
    unmapped output)."""
    return _PsumReplicated.apply(group, x)


reduce_from_model = psum_replicated     # Megatron's name for the same op


# --------------------------------------------------------------------------- #
def ring_allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor, group,
                          frags: int = 1) -> torch.Tensor:
    """y = x @ W_full where W is sharded on dim 0 (contraction) over
    ``group``.  x: [..., D] (full D locally); w_shard: [D/m, F].

    Each ring hop consumes the held W shard against the matching x slice
    while the next shard travels — W_full never exists.  ``frags``
    further fragments each shard (the paper's <= 256 KB READ fragments).
    """
    m, r = _size_rank(group)
    dk = w_shard.shape[0]
    y = torch.zeros(x.shape[:-1] + (w_shard.shape[1],),
                    dtype=torch.promote_types(x.dtype, w_shard.dtype),
                    device=x.device)
    w_cur = w_shard
    for i in range(m):
        src = (r - i) % m                     # owner of w_cur after i hops
        xs = x[..., src * dk:(src + 1) * dk]
        if frags > 1:
            fk = dk // frags
            for f in range(frags):            # fragment-granular recycle
                y = y + xs[..., f * fk:(f + 1) * fk] @ \
                    w_cur[f * fk:(f + 1) * fk]
        else:
            y = y + xs @ w_cur
        if i < m - 1:                         # the last hop is not needed
            w_cur = ppermute(w_cur, group)
    return y.to(x.dtype)


def ring_reduce_scatter(y_partial: torch.Tensor, group) -> torch.Tensor:
    """Ring reduce-scatter over the last dim.

    ``y_partial``: [..., F] this rank's partial sums.  Returns the summed
    shard [..., F/m] this rank owns; the accumulating fragment rides the
    ring, so the summed [..., F] never exists on any rank."""
    m, r = _size_rank(group)
    fk = y_partial.shape[-1] // m

    def contribution(c):
        return y_partial[..., c * fk:(c + 1) * fk]

    # chunk c starts at rank (c+1)%m and lands fully-summed at rank c
    acc = contribution((r - 1) % m).float()
    for i in range(m - 1):
        acc = ppermute(acc, group)
        acc = acc + contribution((r - 1 - (i + 1)) % m)
    return acc.to(y_partial.dtype)


def windowed_allgather(x_shard: torch.Tensor, group,
                       window: int = 4) -> torch.Tensor:
    """Chunked ring all-gather with at most ``window`` fragments in
    flight: each shard split into ``window`` fragments that travel one
    hop a step together and are written into the assembly buffer as
    they land.  Equal to a tiled all-gather on dim 0."""
    m, r = _size_rank(group)
    n0 = x_shard.shape[0]
    out = torch.zeros((m * n0,) + tuple(x_shard.shape[1:]),
                      dtype=x_shard.dtype, device=x_shard.device)
    out[r * n0:(r + 1) * n0] = x_shard
    frag = max(1, n0 // window)
    bufs = [x_shard[f * frag:f * frag + min(frag, n0 - f * frag)]
            for f in range(min(window, -(-n0 // frag)))]
    for i in range(m - 1):
        bufs = ppermute_many(bufs, group)
        src = (r - i - 1) % m
        for f, b in enumerate(bufs):
            at = src * n0 + f * frag
            out[at:at + b.shape[0]] = b
    return out


def srq_combine(o_part: torch.Tensor, lse_part: torch.Tensor,
                group) -> torch.Tensor:
    """Distributed-decode small-message combine: all-gather every rank's
    (o, lse) (a few KB — the SRQ path) and merge with stable softmax
    weights.  o_part: [B, H, D]; lse_part: [B, H]."""
    o_all = all_gather(o_part, group, tiled=False)        # [m, B, H, D]
    lse_all = all_gather(lse_part, group, tiled=False)    # [m, B, H]
    mx = lse_all.amax(dim=0, keepdim=True)
    w = torch.exp(lse_all - mx)
    w = w / torch.clamp(w.sum(dim=0, keepdim=True), min=1e-30)
    return (o_all * w[..., None]).sum(dim=0)
