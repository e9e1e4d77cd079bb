"""GPipe-style pipeline parallelism over the ``pod`` axis
(``repro.parallel.pipeline``).

The two pods of the multi-pod mesh can run as two pipeline stages: each
holds half the layer stack and microbatch activations hand off over the
cross-pod links through :func:`collectives.ppermute` — a far smaller
cross-pod payload than data parallelism's gradient all-reduce when
layers are wide (activations [B_micro, T, D] vs parameter-sized
gradients).  The inter-stage activation is the READ payload, the
pipeline register the single-slot staging buffer, and the microbatch
count bounds in-flight work like the in-flight-bytes window.

Autograd differentiates straight through the schedule (``ppermute``'s
backward is the reverse shift), which gives GPipe's synchronous backward,
as ``jax.grad`` gives the reference's.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .._tree import tree_map
from .collectives import ppermute, psum_replicated


def gpipe(stage_fn: Callable, x_micro: torch.Tensor, group,
          n_stages: int) -> torch.Tensor:
    """Run ``stage_fn`` as an ``n_stages``-deep pipeline over ``group``
    (one stage a rank).

    ``stage_fn(x) -> y`` applies THIS rank's stage (it closes over the
    local stage parameters; activations keep one shape across stages).
    ``x_micro``: [M, ...] microbatches, the same on every rank.  Returns
    [M, ...] final-stage outputs, valid on the last stage's rank (use
    :func:`broadcast_from_last` to make them uniform)."""
    m = x_micro.shape[0]
    first = torch.tensor(dist.get_rank(group) == 0, device=x_micro.device)
    reg = torch.zeros_like(x_micro[0])
    emits = []
    for t in range(m + n_stages - 1):
        # stage 0 ingests microbatch t, the others take the register; a
        # select, not a branch, so that every rank's backward runs the
        # same reverse shifts
        inp = torch.where(first, x_micro[min(t, m - 1)], reg)
        out = stage_fn(inp)
        # hand off to the next stage (the last stage's send is dropped)
        reg = ppermute(out, group, cyclic=False)
        emits.append(out)
    # the last stage emits microbatch k at tick k + (n_stages - 1)
    return torch.stack(emits[n_stages - 1:])


def broadcast_from_last(y: torch.Tensor, group,
                        n_stages: int) -> torch.Tensor:
    """Make the final-stage output uniform across the pipeline group."""
    last = dist.get_rank(group) == n_stages - 1
    return psum_replicated(y * float(last), group)


def stack_stages(params_tree, n_stages: int):
    """Split a [L, ...]-stacked layer tree into [S, L/S, ...] stage stacks
    (a rank takes its stage's ``[r]``)."""
    def split(leaf):
        lay = leaf.shape[0]
        if lay % n_stages:
            raise ValueError(f"layers {lay} % stages {n_stages} != 0")
        return leaf.reshape((n_stages, lay // n_stages) + tuple(
            leaf.shape[1:]))
    return tree_map(split, params_tree)
