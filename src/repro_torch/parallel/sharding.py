"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) over a process
mesh (``repro.parallel.sharding``).

Mesh axes:
  * ``pod``   — data parallel across pods (multi-pod mesh only)
  * ``data``  — data parallel + FSDP (ZeRO-3 parameter/optimizer sharding)
  * ``model`` — tensor parallel (heads/ff), expert parallel (MoE),
                sequence parallel (decode KV)

The port runs SPMD with one process a rank over ``torch.distributed``
(gloo on CPU processes, NCCL on cards).  A spec (:class:`P`) is the
counterpart of a ``PartitionSpec``: a tuple with one entry a dim, each an
axis name, a tuple of names or ``None``.  :class:`Mesh` holds the axis
names and sizes and, once a process group is up, a
``torch.distributed.device_mesh.DeviceMesh`` for the axes' groups; the
spec functions need only the names and sizes, so they run with no
process at production sizes, as the reference's run on an
``AbstractMesh``.

Where the reference places a global array on the mesh, a rank here holds
its local block: :meth:`ParallelCtx.shard` slices it from a full tensor
by its spec, :meth:`ParallelCtx.gather` puts the full tensor back
together from every rank's block (differentiably: see its docstring),
and :meth:`ParallelCtx.shard_tree` / :meth:`ParallelCtx.gather_tree` do
so leaf by leaf for a whole train state.  Spec trees mirror the tree
they describe; since a spec is a tuple, walk them through that tree
(``_tree.tree_map(fn, params, specs)``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .. import _tree
from .collectives import all_gather, copy_to_model


class P(tuple):
    """A partition spec: ``P("model", None)`` shards dim 0 over ``model``
    and keeps dim 1 whole; ``P()`` replicates.  As in ``PartitionSpec``,
    an entry of one axis is the bare name and an empty one ``None``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else p or None)
            if isinstance(p, tuple) else p for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``device_mesh`` is the process mesh once a
    process group is up (``launch.mesh.make_mesh``), ``None`` for a mesh
    of shapes only."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_mesh: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def _dm(self):
        if self.device_mesh is None:
            raise RuntimeError("this mesh holds shapes only; make it over "
                               "a process group (launch.mesh.make_mesh)")
        return self.device_mesh

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self._dm().get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self._dm().get_local_rank(axis)

    def coords(self) -> Dict[str, int]:
        return {a: self.coord(a) for a in self.axis_names}


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place on the model axis, for a tensor-parallel
    sublayer: the axis's process group, its size and this rank's index."""
    group: Any
    size: int
    rank: int


@dataclasses.dataclass
class ParallelCtx:
    """Everything the model needs to know about distribution.

    ``mesh=None`` means one device; the MoE then runs its single-card
    dispatch.  The fields are the reference's."""
    mesh: Optional[Mesh] = None
    data_axes: Tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    model_axis: str = "model"
    fsdp: bool = True                        # ZeRO-3 parameter sharding
    seq_parallel_decode: bool = True
    use_ep: bool = True                      # expert parallelism
    remat: str = "full"                      # full | dots | none
    moe_capacity_factor: Optional[float] = None
    # staged (jet) collectives toggle for the hillclimbed configs
    jet_collectives: bool = False
    jet_chunk_bytes: int = 256 << 10         # READ fragment size (paper)
    jet_window: int = 4                      # in-flight fragments
    bf16_weight_gather: bool = False         # cast params to compute dtype
    #                                          BEFORE FSDP gathers (2B wire)

    # ---- helpers -------------------------------------------------------- #
    @property
    def have_mesh(self) -> bool:
        return self.mesh is not None

    def axis_size(self, name: str) -> int:
        if not self.have_mesh:
            return 1
        return self.mesh.shape[name]

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis) if self.have_mesh else 1

    @property
    def dp_size(self) -> int:
        if not self.have_mesh:
            return 1
        s = 1
        for a in self.data_axes:
            s *= self.axis_size(a)
        return s

    def tp(self) -> Optional[TP]:
        """The model axis of a mesh over a process group (None without a
        mesh)."""
        if not self.have_mesh:
            return None
        return TP(self.mesh.group(self.model_axis), self.model_size,
                  self.mesh.coord(self.model_axis))

    def _div(self, n: int, axis: Optional[str]) -> bool:
        return axis is not None and self.have_mesh and \
            n % self.axis_size(axis) == 0

    # ---- specs ----------------------------------------------------------- #
    def batch_axes_for(self, b: int) -> Tuple[str, ...]:
        """Largest prefix-combination of data axes that divides batch ``b``
        (batch=1 long-context decode falls back to replication)."""
        if not self.have_mesh:
            return ()
        axes = []
        prod = 1
        for a in self.data_axes:
            prod *= self.axis_size(a)
            if b % prod == 0:
                axes.append(a)
            else:
                break
        return tuple(axes)

    def act_for(self, b: int, trailing: int = 2) -> P:
        """Activations [B, ..., D]: batch sharded where divisible."""
        ax = self.batch_axes_for(b)
        return P(ax if ax else None, *([None] * trailing))

    def spec_weight(self, shape: Tuple[int, ...], tp_dim: Optional[int],
                    fsdp_dim: Optional[int]) -> P:
        """Weight spec: TP on ``tp_dim`` over model axis, FSDP on
        ``fsdp_dim`` over data axis (when divisible)."""
        parts: list = [None] * len(shape)
        if tp_dim is not None and self._div(shape[tp_dim], self.model_axis):
            parts[tp_dim] = self.model_axis
        if (self.fsdp and fsdp_dim is not None and fsdp_dim != tp_dim
                and self.have_mesh and "data" in self.mesh.axis_names
                and self._div(shape[fsdp_dim], "data")):
            parts[fsdp_dim] = "data"
        return P(*parts)

    def kv_cache_spec(self, b: int, s: int) -> P:
        """Decode KV cache [B, S, Hkv, hd]: batch over data axes, sequence
        over the model axis (sequence parallelism — head-count agnostic)."""
        ax = self.batch_axes_for(b)
        bspec = ax if ax else None
        if self.seq_parallel_decode and self._div(s, self.model_axis):
            return P(bspec, self.model_axis, None, None)
        return P(bspec, None, None, None)

    def sharding(self, spec: P) -> Optional["NamedSharding"]:
        if not self.have_mesh:
            return None
        return NamedSharding(self.mesh, spec)

    def constrain(self, x, spec: P):
        """A no-op.  The reference hands GSPMD a layout hint here.  The
        sharded train step keeps every activation as this rank's batch
        block (whole over the model axis, which each tensor-parallel
        sublayer re-establishes with its all-reduce), so no activation is
        ever resharded and there is nothing to hint."""
        return x

    # ---- local blocks ---------------------------------------------------- #
    def shard(self, t, spec: P, coords: Optional[Dict[str, int]] = None):
        """This rank's block of the full tensor ``t`` (or ``coords``'
        block, with no process group): a view, or ``t`` when there is no
        mesh."""
        if not self.have_mesh:
            return t
        return NamedSharding(self.mesh, spec).shard(t, coords)

    def gather(self, t: torch.Tensor, spec: P, keep: Sequence[str] = (),
               partial: bool = False) -> torch.Tensor:
        """The full tensor from every rank's block ``t`` (all-gathers along
        each sharded dim; every rank returns the whole), except along the
        axes in ``keep``, whose blocks stay.

        Differentiable, with a backward that depends on the axis.  Over a
        data axis the ranks hold different tokens, so the cotangents are
        summed back to each block (a reduce-scatter).  Over the model axis
        every rank computed the same cotangent of a weight it used whole
        from the same tokens, so the backward takes this rank's block of
        it; with ``partial``, each model rank's use computed one part of a
        sum (a tensor-parallel sublayer that reads a weight whole), so the
        parts are summed there too, and a leaf the spec leaves whole over
        the model axis has its cotangent all-reduced over it."""
        if not self.have_mesh:
            return t
        model_sharded = False
        for dim, entry in enumerate(spec):
            for axis in reversed(_axes(entry)):   # innermost axis first
                if axis == self.model_axis:
                    model_sharded = True
                if axis in keep:
                    continue
                back = "slice" if axis == self.model_axis and not partial \
                    else "sum"
                t = all_gather(t, self.mesh.group(axis), dim, backward=back)
        if partial and not model_sharded:
            t = copy_to_model(t, self.mesh.group(self.model_axis))
        return t

    def shard_tree(self, tree, specs):
        """This rank's block of every leaf of a whole ``tree`` (a train
        state, say) by its ``specs`` (``train.steps.state_specs``)."""
        return _tree.tree_map(lambda t, s: self.shard(t, s), tree, specs)

    def gather_tree(self, tree, specs):
        """Every leaf of ``tree``, this rank's blocks, whole again (a
        collective: every rank of the mesh calls it)."""
        return _tree.tree_map(lambda t, s: self.gather(t, s), tree, specs)

    def spec_axes(self, spec: P) -> Tuple[str, ...]:
        """The mesh axes a leaf of ``spec`` is sharded over."""
        return tuple(a for entry in spec for a in _axes(entry))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which block of a full array each rank holds."""
    mesh: Mesh
    spec: P

    def index(self, shape: Sequence[int],
              coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
        """The slices of the block at ``coords`` (this rank's by
        default) in an array of ``shape``."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than "
                             f"{tuple(shape)}")
        sizes = self.mesh.shape
        out = []
        for dim, n in enumerate(shape):
            axes = _axes(self.spec[dim]) if dim < len(self.spec) else ()
            if not axes:
                out.append(slice(None))
                continue
            if coords is None:
                coords = self.mesh.coords()
            blocks, k = 1, 0
            for a in axes:                       # row-major over the axes
                k = k * sizes[a] + coords[a]
                blocks *= sizes[a]
            if n % blocks:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split into {blocks} blocks ({axes})")
            w = n // blocks
            out.append(slice(k * w, (k + 1) * w))
        return tuple(out)

    def shard(self, t, coords: Optional[Dict[str, int]] = None):
        return t[self.index(t.shape, coords)]


def single_device_ctx(**kw) -> ParallelCtx:
    return ParallelCtx(mesh=None, **kw)
