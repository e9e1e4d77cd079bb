"""Fused priority water-fills of the vector fabric tick.

The two innermost sequential loops of the tick — the switch drain's
strict-priority budget grants and the receiver RNIC's QoS admission —
are priority water-fills over ``N_QOS`` classes.  Each has two
implementations:

* a plain PyTorch version (``*_ref``), op for op the reference's ref
  tier (``repro.fabric.fused``), hence ``OutputPort.drain`` /
  ``HostDatapath`` arithmetic.  The CPU engine runs it, and the chip
  smoke test holds the kernel against it on the card;
* a hand-written CUDA kernel (``csrc/fused_waterfill.cu``) that replaces
  the reference's Pallas TPU kernels ``_grants_call`` / ``_admit_call``:
  one launch for the whole grid, one thread per (grid point, column),
  the class loop in registers.  It is bitwise equal to the plain version.

The PFC-deadlock watchdog's helpers (:func:`pause_pair_onehot`,
:func:`cycle_flags`) are plain tensor code in both packages: {0,1}
matrix products, exact in float32 with TF32 off.

Dispatch (``_device.resolve_impl``, shared with the model kernels):
``impl="auto"`` launches the kernel on a CUDA tensor and runs the plain
version on a CPU one; ``impl="cuda"`` on a CPU tensor raises; ``"ref"``
forces the plain version.  Nothing falls back: a build or launch failure
propagates.  Each kernel launch adds one to :data:`LAUNCHES` under the
kernel's name.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import library
from .._device import LaunchCounts, resolve_impl

_SOURCE = "fused_waterfill"
LAUNCHES = LaunchCounts(priority_grants=0, priority_admit=0)
reset_launches = LAUNCHES.reset


# --------------------------------------------------------------------------- #
# Plain PyTorch versions (the reference's ref tier, op for op)
# --------------------------------------------------------------------------- #
def priority_grants_ref(demand, can, budget, crumb):
    """Strict-priority budget water-fill: per-class drain fractions.

    ``demand`` [.., Q, N] per-class byte totals, ``can`` [.., Q, N] bool
    (or {0,1}) eligibility, ``budget`` / ``crumb`` [.., N].  Each class in
    priority order takes ``min(1, left/demand)`` of its demand; leftovers
    below ``crumb`` are clamped to zero."""
    one = demand.new_ones(())
    zero = demand.new_zeros(())
    bl = budget
    rows = []
    for qi in range(demand.shape[-2]):
        qsum = demand[..., qi, :]
        cq = can[..., qi, :]
        ok = cq if cq.dtype == torch.bool else cq > 0.5
        frac = torch.where(ok, torch.minimum(
            one, bl / torch.where(qsum > zero, qsum, one)), zero)
        rows.append(frac)
        bl = bl - frac * qsum
        bl = torch.where(bl < crumb, zero, bl)
    return torch.stack(rows, -2)


def priority_admit_ref(demand, space):
    """QoS-priority admission: grant ``min(demand, space)`` per class in
    priority order.  ``demand`` [.., Q, N], ``space`` [.., N] ->
    accepted [.., Q, N]."""
    rows = []
    for qi in range(demand.shape[-2]):
        a = torch.minimum(demand[..., qi, :], space)
        space = space - a
        rows.append(a)
    return torch.stack(rows, -2)


# --------------------------------------------------------------------------- #
# CUDA dispatch
# --------------------------------------------------------------------------- #
def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.priority_grants_f32.argtypes = [p, p, p, p, p, i64, i32, i32, p]
        lib.priority_grants_f32.restype = ctypes.c_int
        lib.priority_admit_f32.argtypes = [p, p, p, i64, i32, i32, p]
        lib.priority_admit_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_setup(demand: torch.Tensor):
    dev = demand.device
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    if demand.dim() < 2:
        raise ValueError("demand must be [.., Q, N]")
    nq, n = demand.shape[-2], demand.shape[-1]
    rows = demand.numel() // max(nq * n, 1)
    return dev, rows, nq, n, torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _grants_cuda(demand, can, budget, crumb):
    dev, rows, nq, n, stream = _launch_setup(demand)
    _check("demand", demand, demand.shape, torch.float32, dev)
    _check("can", can, demand.shape, torch.bool, dev)
    _check("budget", budget, demand.shape[:-2] + (n,), torch.float32, dev)
    _check("crumb", crumb, demand.shape[:-2] + (n,), torch.float32, dev)
    out = torch.empty_like(demand)
    if out.numel():
        _raise_on(_lib().priority_grants_f32(
            demand.data_ptr(), can.data_ptr(), budget.data_ptr(),
            crumb.data_ptr(), out.data_ptr(), rows, nq, n, stream),
            "priority_grants")
        LAUNCHES["priority_grants"] += 1
    return out


def _admit_cuda(demand, space):
    dev, rows, nq, n, stream = _launch_setup(demand)
    _check("demand", demand, demand.shape, torch.float32, dev)
    _check("space", space, demand.shape[:-2] + (n,), torch.float32, dev)
    out = torch.empty_like(demand)
    if out.numel():
        _raise_on(_lib().priority_admit_f32(
            demand.data_ptr(), space.data_ptr(), out.data_ptr(), rows, nq,
            n, stream), "priority_admit")
        LAUNCHES["priority_admit"] += 1
    return out


def priority_grants(demand, can, budget, crumb, impl: str = "auto"):
    """Strict-priority drain water-fill (see :func:`priority_grants_ref`):
    the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_impl(impl, demand.device) == "cuda":
        return _grants_cuda(demand, can, budget, crumb)
    return priority_grants_ref(demand, can, budget, crumb)


def priority_admit(demand, space, impl: str = "auto"):
    """QoS admission water-fill (see :func:`priority_admit_ref`): the CUDA
    kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_impl(impl, demand.device) == "cuda":
        return _admit_cuda(demand, space)
    return priority_admit_ref(demand, space)


# --------------------------------------------------------------------------- #
# PFC-deadlock watchdog (faults.has_pause_cycle, vectorized)
# --------------------------------------------------------------------------- #
def pause_pair_onehot(port_keys) -> np.ndarray:
    """Static port -> (src-node, dst-node) scatter: [P, N*N] one-hot so
    ``link_paused @ E`` reshapes to the per-TC pause-dependency adjacency
    that :func:`repro_torch.fabric.faults.has_pause_cycle` walks."""
    nodes = sorted({a for a, _ in port_keys} | {b for _, b in port_keys})
    ni = {h: i for i, h in enumerate(nodes)}
    n = len(nodes)
    E = np.zeros((len(port_keys), n * n))
    for p, (a, b) in enumerate(port_keys):
        E[p, ni[a] * n + ni[b]] = 1.0
    return E


def cycle_flags(lp, E, n: int):
    """Per-point deadlock flag [..] from the pause mask ``lp`` [.., Q, P]
    ({0,1} floats) and ``E`` from :func:`pause_pair_onehot`.  Builds the
    per-TC node adjacency and closes it with ``ceil(log2 n)`` squarings
    of ``min(C + C @ C, 1)``; a nonzero diagonal in any class's closure
    is a cyclic pause dependency (the predicate of ``has_pause_cycle``,
    which looks for a cycle in any single-TC digraph).  Every product is
    of {0,1} matrices, so it is exact in any order."""
    one = lp.new_ones(())
    adj = torch.matmul(lp, E)
    C = torch.minimum(adj, one).reshape(adj.shape[:-1] + (n, n))
    hops = max(1, int(np.ceil(np.log2(max(n, 2)))))
    for _ in range(hops):
        C = torch.minimum(C + torch.matmul(C, C), one)
    diag = torch.diagonal(C, dim1=-2, dim2=-1)
    return diag.sum((-1, -2)) > 0.0          # any TC, any node
