"""Op-trace analysis (``repro.launch.hlo_analysis``): the figures the
reference reads from a compiled step's optimized HLO, read here from a
trace of the ops one call dispatches.

The port compiles nothing, so there is no HLO.  :func:`trace` runs a
call under a ``TorchDispatchMode`` (:class:`Recorder`) and keeps every
op it dispatches with its operands' and results' shapes and types
(:class:`Op`); on ``meta`` tensors that is a step's whole program at
full size with no memory and no card.  Each hand kernel's wrapper calls
``_device.meta_launch`` on meta tensors in place of its launch, so the
trace holds each kernel call with its operation count.  A collective
(``c10d.*``) carries its process group's size, and collectives and
kernel calls carry the port's frames that issued them (``path``: the
``module.function`` chain, outermost first; the models are functions,
not ``nn.Module``s).  The recorder also follows the storages the call
allocates, as the card's allocator would hold them (a view counts once;
what autograd saves lives until the backward frees it), for the peak of
live bytes (:class:`Trace`).

:func:`analyze` returns the reference's keys: ``dot_flops`` (2·M·N·K of
each ``mm``, ``bmm``, ``addmm``, ``baddbmm``, as ``FlopCounterMode``
counts them, plus each kernel call's operation count), ``dot_bytes``
(those ops' operand and result bytes; a kernel's tensors read and
written), ``coll`` and ``coll_counts`` by the reference's collective
types with its ring model (:func:`ring_bytes`), ``coll_total`` and
``convs``.  The trace is unrolled, so a repeated op simply appears again:
the reference's ``trip_counts`` has nothing to hold and is left out.
The reference's ``_bf16_on_tpu`` has no counterpart either: a recorded
collective carries the type it really runs in.
"""
from __future__ import annotations

import dataclasses
import sys
import time
import weakref
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")
# c10d op -> the reference's collective type
COLL_KIND = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
DOTS = ("aten.mm.default", "aten.bmm.default", "aten.addmm.default",
        "aten.baddbmm.default")
CONVS = ("aten.convolution.default", "aten.convolution_backward.default")
KERNEL_OP = "repro_torch.meta_launch.default"

Shape = Tuple[Tuple[int, ...], str]          # (shape, dtype name)


@dataclasses.dataclass(frozen=True)
class Op:
    """One dispatched op.  ``inputs`` / ``outputs``: (shape, dtype) of
    its tensor operands and results, lists flattened in order; a
    collective's ``outputs`` are its first argument, the tensors it
    fills (all-gather: the gathered parts; reduce-scatter: this rank's
    shard), its ``inputs`` the rest.  ``group``: a collective's process
    group size; ``path``: the port's frames that issued a collective or a
    kernel call; ``kernel`` and ``flops``: a kernel call's name and
    operation count."""
    name: str
    inputs: Tuple[Shape, ...] = ()
    outputs: Tuple[Shape, ...] = ()
    group: int = 0
    path: str = ""
    kernel: str = ""
    flops: float = 0.0

    @property
    def coll(self) -> str:
        """The reference's collective type of a ``c10d`` op, else ''."""
        if not self.name.startswith("c10d."):
            return ""
        return COLL_KIND.get(self.name.split(".")[1], "")


@dataclasses.dataclass
class Trace:
    """A traced call: its ops, its wall seconds, and the allocator's
    view: ``arg_bytes`` (the storages of the arguments, live throughout),
    ``out_bytes`` (the result's storages), ``peak_bytes`` (the most bytes
    live at once, the arguments included)."""
    ops: List[Op]
    seconds: float
    arg_bytes: int
    out_bytes: int
    peak_bytes: int


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _shapes(ts) -> Tuple[Shape, ...]:
    return tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for t in ts)


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # a ReduceOp, not a group
                continue
    return 0


def _path() -> str:
    """The port's frames below this one, outermost first, as
    ``module.function`` (the package prefix and this module dropped)."""
    names = []
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and mod != __name__:
            names.append(f"{mod[len('repro_torch.'):]}.{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(names))


class Recorder(TorchDispatchMode):
    """Records every op dispatched while it is entered (:class:`Op`) and
    follows each storage the ops return until it is freed: ``live`` bytes
    now, ``peak`` the most at once.  ``hold(tree)`` counts a tree's
    storages live from now on (the arguments of a traced call)."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self.live = 0
        self.peak = 0
        self._held: Dict[int, weakref.ref] = {}

    def _free(self, key: int, nbytes: int, _ref) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= nbytes

    def hold(self, tree) -> int:
        """Follow the storages of ``tree``'s tensors; their new bytes."""
        before = self.live
        for t in _tensors(tree, []):
            st = t.untyped_storage()
            key = id(st)
            if key not in self._held:
                n = st.nbytes()
                self._held[key] = weakref.ref(
                    st, lambda r, k=key, n=n: self._free(k, n, r))
                self.live += n
        self.peak = max(self.peak, self.live)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        if name.startswith("c10d."):
            res = _tensors(args[0], []) if args else []
            rest = _tensors(list(args[1:]) + list(kwargs.values()), [])
            op = Op(name, _shapes(rest), _shapes(res), _group_size(args),
                    _path())
        elif name == KERNEL_OP:
            kernel, flops, tensors = args
            op = Op(name, _shapes(tensors), (), 0, _path(), kernel,
                    float(flops))
        else:
            op = Op(name, _shapes(_tensors([args, kwargs], [])),
                    _shapes(_tensors(out, [])))
        self.ops.append(op)
        self.hold(out)
        return out


def trace(fn, *args) -> Trace:
    """Run ``fn(*args)`` under a :class:`Recorder` (the arguments' storages
    held first) and return its :class:`Trace`."""
    rec = Recorder()
    arg_bytes = rec.hold(args)
    t0 = time.perf_counter()
    with rec:
        result = fn(*args)
    seconds = time.perf_counter() - t0
    seen, out_bytes = set(), 0
    for t in _tensors(result, []):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            out_bytes += st.nbytes()
    return Trace(rec.ops, seconds, arg_bytes, out_bytes, rec.peak)


def nbytes(shapes) -> int:
    total = 0
    for shape, dtype in shapes:
        n = 1
        for d in shape:
            n *= d
        total += n * getattr(torch, dtype).itemsize
    return total


def ring_bytes(kind: str, size: float, n: int) -> float:
    """Bytes a device moves for one collective of type ``kind`` whose
    result is ``size`` bytes, over a group of ``n`` (at least 2, as the
    reference counts), by the ring model: an all-gather receives
    (n-1)/n of the gathered result, an all-reduce moves 2(n-1)/n of it, a
    reduce-scatter (n-1) times its shard, an all-to-all (n-1)/n, a
    send or receive its whole tensor."""
    n = max(n, 2)
    return {"all-gather": size * (n - 1) / n,
            "all-reduce": 2.0 * size * (n - 1) / n,
            "reduce-scatter": size * (n - 1),
            "all-to-all": size * (n - 1) / n,
            "collective-permute": float(size)}[kind]


def dot_flops(op: Op) -> float:
    """2·M·N·K of a ``mm`` / ``bmm`` (``addmm`` / ``baddbmm``: of their
    product operands), 0 for any other op."""
    if op.name not in DOTS:
        return 0.0
    a, b = op.inputs[-2][0], op.inputs[-1][0]
    batch = a[0] if len(a) == 3 else 1
    return 2.0 * batch * a[-2] * a[-1] * b[-1]


def analyze(ops: List[Op]) -> Dict[str, object]:
    """The reference's figures of a traced call (module docstring)."""
    out = {"dot_flops": 0.0, "dot_bytes": 0.0,
           "coll": dict.fromkeys(COLL_OPS, 0.0),
           "coll_counts": dict.fromkeys(COLL_OPS, 0), "convs": 0}
    for op in ops:
        if op.name in DOTS:
            out["dot_flops"] += dot_flops(op)
            out["dot_bytes"] += nbytes(op.inputs[-2:] + op.outputs)
        elif op.name == KERNEL_OP:
            out["dot_flops"] += op.flops
            out["dot_bytes"] += nbytes(op.inputs)
        elif op.name in CONVS:
            out["convs"] += 1
        elif op.coll:
            out["coll"][op.coll] += ring_bytes(op.coll, nbytes(op.outputs),
                                               op.group)
            out["coll_counts"][op.coll] += 1
    out["coll_total"] = sum(out["coll"].values())
    return out
