"""Fused priority water-fills and the segment sum of the vector fabric
tick.

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

The sparse-incidence tick (3-level pod fabrics) reduces per-flow values
into (class, port) bins with a batched segment sum at static indices
(:func:`seg_sum`).  The reference writes it as an XLA scatter-add
(``_make_step_sparse.seg_sum``), not a Pallas kernel; on the card
PyTorch's float scatter-adds are atomic and change their summation order
from run to run, so the port sums through a hand-written deterministic
kernel (``csrc/seg_sum.cu``) over a plan built once at set-up
(:func:`seg_plan`: a stable sort of the entries by bin, CSR offsets, and
the bins of at least :data:`SEG_LONG_MIN` entries, which the kernel folds
a warp each).  Each bin adds its entries in entry order, as
``np.add.at`` and the CPU ``index_add_`` of the plain version
(:func:`seg_sum_ref`) do, so the kernel is bitwise equal to the plain
version run on the CPU in float32.  The source holds two kernels
(:data:`SEG_VARIANTS`): ``warp_fold``, which :func:`seg_sum` launches,
and ``bin_thread``, the first design (one thread a bin), which only a
timing forces (``_variant``).

The PFC-deadlock watchdog's helpers (:func:`pause_pair_onehot`,
:func:`cycle_flags`) are plain tensor code in both packages: {0,1}
matrix products, exact in float32 with TF32 off.  So is adaptive
time-stepping (:class:`AdaptiveConfig`, :func:`make_stride_fn`,
:func:`macro_advance`): the reference computes the stride and the macro
advance in plain array code outside any kernel, and so does the port.

Dispatch (``_device.resolve_impl``, shared with the model kernels):
``impl="auto"`` launches the kernel on a CUDA tensor and runs the plain
version on a CPU one; ``impl="cuda"`` on a CPU tensor raises; ``"ref"``
forces the plain version.  Nothing falls back: a build or launch failure
propagates.  Each kernel launch adds one to :data:`LAUNCHES` under the
kernel's name; a launch captured into a CUDA graph adds one on the card
at every replay (read the counts with ``LAUNCHES.read()``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .._build import library
from .._device import LaunchCounts, require_no_grad, resolve_impl

_SOURCE = "fused_waterfill"
_SEG_SOURCE = "seg_sum"
LAUNCHES = LaunchCounts(priority_grants=0, priority_admit=0, seg_sum=0)
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


SEG_VARIANTS = ("warp_fold", "bin_thread")
SEG_LONG_MIN = 32           # entries from which warp_fold folds a bin a
                            # warp (csrc/seg_sum.cu: kLongMin)


@dataclasses.dataclass(frozen=True)
class SegPlan:
    """A static segment-sum index, set up once (:func:`seg_plan`): each
    entry's bin ``idx`` [N] (int64, the plain version's index), the
    entries stably sorted by bin ``perm`` [N] and the bins' CSR offsets
    into it ``offsets`` [size + 1] (both int32, the kernel's), the number
    of bins ``size``, and the bins of at least :data:`SEG_LONG_MIN`
    entries, ascending, ``long_bins`` [L] (int32), which the kernel folds
    a warp each.  Checked once, when it is made (types, shapes, one
    device); a call checks only its values."""
    idx: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    size: int
    long_bins: torch.Tensor
    n: int = dataclasses.field(init=False)
    device: torch.device = dataclasses.field(init=False)
    ptrs: tuple = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        n, dev = self.idx.numel(), self.idx.device
        for name, t, shape, dtype in (
                ("idx", self.idx, (n,), torch.int64),
                ("perm", self.perm, (n,), torch.int32),
                ("offsets", self.offsets, (self.size + 1,), torch.int32),
                ("long_bins", self.long_bins, (self.long_bins.numel(),),
                 torch.int32)):
            _check(name, t, shape, dtype, dev)
        object.__setattr__(self, "n", n)
        object.__setattr__(self, "device", dev)
        # the kernel's arguments, fixed for the plan's life
        object.__setattr__(self, "ptrs", (
            self.perm.data_ptr(), self.offsets.data_ptr(),
            self.long_bins.data_ptr(), self.long_bins.numel()))


def seg_plan(idx, size: int, device=None) -> SegPlan:
    """The plan of a segment sum of ``[.., N]`` values into ``size`` bins
    at the static bin index ``idx`` [N] (numpy or a tensor), on
    ``device`` (default: ``idx``'s).  ``perm`` is a *stable* sort of the
    entries by bin, so each bin's entries keep their order; bins of at
    least :data:`SEG_LONG_MIN` entries are listed in ``long_bins``."""
    if device is None:
        device = idx.device if isinstance(idx, torch.Tensor) else "cpu"
    a = (idx.cpu().numpy() if isinstance(idx, torch.Tensor)
         else np.asarray(idx)).astype(np.int64).reshape(-1)
    if a.size and (a.min() < 0 or a.max() >= size):
        raise ValueError(f"segment index out of range [0, {size})")
    perm = np.argsort(a, kind="stable")
    counts = np.bincount(a, minlength=size)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return SegPlan(
        idx=torch.as_tensor(a, device=device),
        perm=torch.as_tensor(perm.astype(np.int32), device=device),
        offsets=torch.as_tensor(offsets.astype(np.int32), device=device),
        size=int(size),
        long_bins=torch.as_tensor(
            np.flatnonzero(counts >= SEG_LONG_MIN).astype(np.int32),
            device=device))


def seg_sum_ref(vals, idx, size: int):
    """Batched segment sum: ``vals`` [.., N] added at the bin index
    ``idx`` [N] into zeros [.., size] (``index_add_`` along the last
    axis).  On the CPU each bin adds its entries in entry order, as
    ``np.add.at`` does."""
    lead = vals.shape[:-1]
    v = vals.reshape(int(np.prod(lead)), vals.shape[-1])   # N may be 0
    out = v.new_zeros((v.shape[0], size))
    out.index_add_(1, idx, v)
    return out.reshape(lead + (size,))


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
        LAUNCHES.add("priority_grants", dev)
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
        LAUNCHES.add("priority_admit", dev)
    return out


def _seg_lib():
    lib = library(_SEG_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.seg_sum_f32.argtypes = [p, p, p, p, p, i64, i32, i32, i32, p]
        lib.seg_sum_f32.restype = ctypes.c_int
        lib.seg_sum_layout.argtypes = [i64, i32, i32, i32, i32,
                                       ctypes.POINTER(ctypes.c_longlong)]
        lib.seg_sum_layout.restype = ctypes.c_int
        lib.seg_sum_bin_thread_f32.argtypes = [p, p, p, p, i64, i32, i32, p]
        lib.seg_sum_bin_thread_f32.restype = ctypes.c_int
        lib._typed = True
    return lib


def seg_launch(rows: int, n: int, size: int, n_long: int = 0,
               sms: int = 0) -> dict:
    """The launch ``warp_fold`` makes for ``rows`` rows of ``n`` values
    into ``size`` bins, ``n_long`` of them long, on a card of ``sms``
    SMs (0: the current card), as ``csrc/seg_sum.cu`` computes it
    (builds the library): ``grid`` blocks (a row each, or with more
    rows than SMs one persistent block an SM) of ``threads`` (a warp a
    long bin and a thread a short one, 128 to 1,024), ``buffers`` rows
    in shared memory (0: read from device memory; 2: double-buffered),
    ``indices_staged`` (perm copied beside them), ``tma`` (rows arrive
    by a bulk copy) and the shared memory of a block."""
    out = (ctypes.c_longlong * 6)()
    _raise_on(_seg_lib().seg_sum_layout(rows, n, size, n_long, sms, out),
              "seg_sum_layout")
    return {"grid": out[0], "threads": out[1], "buffers": out[2],
            "indices_staged": bool(out[3]), "tma": bool(out[4]),
            "smem_bytes": out[5]}


def _seg_sum_cuda(vals, plan: SegPlan, variant: str):
    dev = vals.device
    if dev != plan.device:
        raise ValueError(f"vals is on {dev}, the plan on {plan.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev} but the current CUDA device "
                         f"is {torch.cuda.current_device()}")
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be torch.float32, got {vals.dtype}")
    n = plan.n
    if vals.dim() == 0 or vals.shape[-1] != n:
        raise ValueError(f"vals has shape {tuple(vals.shape)}, expected "
                         f"[.., {n}]")
    if not vals.is_contiguous():
        vals = vals.contiguous()
    out = torch.empty(vals.shape[:-1] + (plan.size,), dtype=torch.float32,
                      device=dev)
    if out.numel():
        perm, offsets, long_bins, n_long = plan.ptrs
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        lib = _seg_lib()
        if variant == "warp_fold":
            err = lib.seg_sum_f32(
                vals.data_ptr(), perm, offsets, long_bins, out.data_ptr(),
                out.numel() // plan.size, n, plan.size, n_long, stream)
        else:
            err = lib.seg_sum_bin_thread_f32(
                vals.data_ptr(), perm, offsets, out.data_ptr(),
                out.numel() // plan.size, n, plan.size, stream)
        _raise_on(err, "seg_sum")
        LAUNCHES.add("seg_sum", dev)
    return out


def seg_sum(vals, plan: SegPlan, impl: str = "auto",
            _variant: Optional[str] = None):
    """Deterministic batched segment sum (see :func:`seg_sum_ref`) at a
    plan from :func:`seg_plan`: the CUDA kernel for CUDA tensors
    (``warp_fold``), the plain version for CPU ones.  ``_variant`` forces
    a kernel of :data:`SEG_VARIANTS` (the chip smoke test times
    ``bin_thread`` beside ``warp_fold`` with it)."""
    if _variant is not None and _variant not in SEG_VARIANTS:
        raise ValueError(f"unknown seg_sum variant {_variant!r} "
                         f"({' | '.join(SEG_VARIANTS)})")
    if resolve_impl(impl, vals.device) == "cuda":
        require_no_grad("seg_sum", vals)
        return _seg_sum_cuda(vals, plan, _variant or "warp_fold")
    return seg_sum_ref(vals, plan.idx, plan.size)


def priority_grants(demand, can, budget, crumb, impl: str = "auto"):
    """Strict-priority drain water-fill (see :func:`priority_grants_ref`):
    the CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_impl(impl, demand.device) == "cuda":
        require_no_grad("priority_grants", demand, budget, crumb)
        return _grants_cuda(demand, can, budget, crumb)
    return priority_grants_ref(demand, can, budget, crumb)


def priority_admit(demand, space, impl: str = "auto"):
    """QoS admission water-fill (see :func:`priority_admit_ref`): the CUDA
    kernel for CUDA tensors, the plain version for CPU ones."""
    if resolve_impl(impl, demand.device) == "cuda":
        require_no_grad("priority_admit", demand, space)
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


# --------------------------------------------------------------------------- #
# Adaptive time-stepping (the reference's fused.py, in torch)
# --------------------------------------------------------------------------- #
_BIG = 1 << 30          # "no event" sentinel for integer gaps


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Macro-tick coarsening knobs + the documented equivalence bound.

    ``max_stride`` caps a single macro window (``k * dt``);
    ``guard_frac`` is the watermark guard band: a jet pool within
    ``guard_frac`` of its ``cache_safe`` spill fraction is treated as
    near-event and keeps fine ticks.  ``resident_eps_bytes`` is the
    steady-pool test (float accumulators jitter at ~1e-7 relative).

    The contract: per-flow delivered bytes within ``rel_bytes_bound`` of
    the fine run, timestamps (completion, message latency) within
    ``(max_stride + 1) * dt`` per crossed macro window.
    """
    max_stride: int = 16
    guard_frac: float = 0.05
    resident_eps_bytes: float = 1.0
    rel_bytes_bound: float = 0.01

    def key(self):
        return (self.max_stride, self.guard_frac,
                self.resident_eps_bytes)


# accumulators advanced in closed form over a macro window: the paired
# hi/lo split counters scale via the *sum* delta applied to the lo part
# (a fold between the two fine steps must not double), plain linear
# byte counters, and the us/byte timers (finite-delta guarded: pace_tus
# idles at +inf, and inf - inf must not poison the carry)
_SCALE_PAIRS = (("injected", "inj_lo"), ("delivered", "deliv_lo"))
_SCALE_SINGLE = ("drained", "miss_sum", "pool_sum", "nic_dram",
                 "mem_fb", "esc_dram", "tx", "resident", "strag_res")
_SCALE_TIMERS = ("t_us", "byts", "a_tus", "cnp_tus", "ecn_tus",
                 "pace_tus", "cc_tus")


def zero_of(a):
    """The zero of ``a``'s kind, as a Python scalar (keeps its dtype in
    ``torch.where``)."""
    return 0.0 if a.is_floating_point() else 0


def macro_advance(s, s1, km1):
    """Extrapolate the fine step ``s -> s1`` over ``km1`` further ticks
    (``km1 = k - 1``, a float or a 0-d tensor of the engine dtype).
    Everything not listed scales by construction of the quiet predicate
    (its delta is zero) or is a discrete carry the next fine step catches
    up exactly: message counts re-derive from the cumulative byte totals,
    completion stamps land on the next fine boundary, rings hold a steady
    value.

    The keys of one shape are stacked and advanced together (the same
    elementwise arithmetic, in a few kernels for all of them); the
    advanced values are views of that stack."""
    s2 = dict(s1)
    for hi, lo in _SCALE_PAIRS:
        d = (s1[hi] + s1[lo]) - (s[hi] + s[lo])
        s2[lo] = s1[lo] + km1 * d
    groups = {}
    for key in _SCALE_SINGLE + _SCALE_TIMERS:
        if key in s1:
            groups.setdefault((s1[key].shape, s1[key].dtype), []).append(key)
    for keys in groups.values():
        a1 = torch.stack([s1[k] for k in keys])
        a0 = torch.stack([s[k] for k in keys])
        # masked subtract: idle timers park at +inf and inf - inf must
        # not poison the carry
        ok = torch.isfinite(a1) & torch.isfinite(a0)
        z = zero_of(a1)
        d = torch.where(ok, a1, z) - torch.where(ok, a0, z)
        s2.update(zip(keys, torch.where(ok, a1 + km1 * d, a1).unbind(0)))
    # the peak tracker follows the (sub-eps) extrapolated pool drift, but
    # only where the step tracks residency at all (jet points; ddio
    # points keep pool_peak at zero)
    z = zero_of(s1["pool_peak"])
    s2["pool_peak"] = torch.where(s1["pool_peak"] > z,
                                  torch.maximum(s1["pool_peak"],
                                                s2["resident"]),
                                  s1["pool_peak"])
    return s2


def make_stride_fn(fsp, p, opts, cfg: AdaptiveConfig, dtype):
    """Build ``stride(s, s1, t) -> k`` for one packed sweep.

    Returns the whole-grid macro stride after the fine step ``s -> s1``
    at tick ``t`` (a 0-d integer tensor): a 0-d int32 tensor on the
    parameters' device, 1 unless every point is quiet, else
    the largest ``k <= min(max_stride, ticks - t)`` that stays short of
    the next event.  Nothing is read back to the host, so a captured
    iteration can compute it.
    """
    o = opts or {}
    dyn, flap, flt = o.get("dyn", False), o.get("flap", False), \
        o.get("flt", False)
    any_cc, any_msg = o.get("cc", False), o.get("msg", False)
    Sn = o.get("Sn", 0)
    dev = p["burst"].device

    def c(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    zero, one, tiny, bigf = c(0.0), c(1.0), c(1e-30), c(float(_BIG))
    dt = fsp.dt_us
    ticks = fsp.ticks
    unit = torch.ones((), dtype=torch.int32, device=dev)
    # static plan: on/off trains are per-tick duty cycles, with no closed
    # form that preserves the phase, so any such flow disables macros
    any_onoff = bool((fsp.pvals["off_us"] > 0).any())
    start_tick = torch.as_tensor(
        np.floor(fsp.pvals["start"] / dt).astype(np.int64), device=dev)
    if flt:
        thr_any = torch.as_tensor(
            ((fsp.pvals["f_thr"] > 0) | (fsp.pvals["f_cthr"] > 0))
            .any(-1), device=dev)                            # [G]
    max_stride = cfg.max_stride
    eps_res = c(cfg.resident_eps_bytes)
    guard = c(cfg.guard_frac)
    bias = c(1e-3)
    fdt = c(dt)

    def gap(live, ticks_to):
        """The nearest integer event gap where ``live`` holds."""
        return torch.where(live, ticks_to, _BIG).min()

    def fgap(live, gapf):
        """The nearest float tick gap where ``live`` holds (folded into
        the integer bound after the ``_BIG`` clamp, as the reference)."""
        return torch.where(live, gapf, bigf).min()

    def fire_gap(t0, t1, thr, rate):
        # exact fire landing: a window may end ON the tick a rate timer
        # fires, so the next fine step performs the fire with the state
        # the fine run had; ceil lands integral quotients on the right
        # tick and the small down-bias eats float noise in the division
        run = t1 > t0          # this timer advanced this fine step
        q = (thr - t1) / torch.maximum(rate, tiny)
        return fgap(run, torch.maximum(torch.ceil(q - bias), one))

    def stride(s, s1, t):
        if any_onoff or max_stride <= 1:
            return unit
        inj1 = s1["injected"] + s1["inj_lo"]
        dinj = inj1 - (s["injected"] + s["inj_lo"])
        del1 = s1["delivered"] + s1["deliv_lo"]
        ddel = del1 - (s["delivered"] + s["deliv_lo"])
        moving = dinj > zero
        # ---- quiet: every queue steady, nothing paused or mid-fire ---- #
        # a constant port/admission queue integrates in closed form
        # exactly like an empty one: every per-tick drain/admission
        # fraction repeats, the rings hold a constant value and the byte
        # accumulators advance linearly.  Each term is a 0-d bool; quiet
        # is their conjunction
        quiet = [(s1["qm"] - s["qm"]).abs().max() <= eps_res,
                 (s1["qos_q"] - s["qos_q"]).abs().max() <= eps_res,
                 ~s1["paused"].any(), ~s1["asserted"].any(),
                 ~s1["pfc"].any(), s1["backlog"].sum() == zero,
                 # ECN marking / switch drops accrue per tick against the
                 # live queue: only coarsen while neither made progress
                 (s1["ecn_marked"] == s["ecn_marked"]).all(),
                 (s1["sw_dropped"] == s["sw_dropped"]).all(),
                 s1["cring"].sum() == zero,
                 s1["esc_debt"].sum() == zero,
                 s1["repl_debt"].sum() == zero,
                 # per-flow rate balance: while a rate step is still in
                 # flight through the transit rings, injection and delivery
                 # deltas differ
                 (dinj - ddel).abs().max() <= eps_res,
                 # pool residency is a sliding-window sum of the delayed
                 # drain ring: quiet requires the pools steady too
                 (s1["resident"] - s["resident"]).abs().max() <= eps_res,
                 (s1["strag_res"] - s["strag_res"]).abs().max() <= eps_res]
        jet = p["jet"] > 0.5
        avail = torch.maximum(zero, p["pool"] - s1["resident"]) \
            / torch.maximum(p["pool"], tiny)
        quiet.append((~jet | (avail >= p["safe"] + guard)).all())
        # no timer fired during the fine step (a fire's reset makes the
        # step non-representative of the window it would be scaled over)
        quiet += [(s1[tk] >= s[tk]).all() for tk in _SCALE_TIMERS
                  if tk in s1]
        if flt:
            quiet += [s1["lost"].sum() == zero, ~s1["gapped"].any(),
                      # stochastic loss draws once per (link, tick): points
                      # with a live threshold may only coarsen while
                      # nothing is moving
                      ~(thr_any & moving.any(-1)).any()]
        # ---- stride: distance to the next event ----------------------- #
        # integer gaps (ticks to the next event) and float gaps, each
        # folded to its minimum
        gaps = [torch.clamp(ticks - t, max=max_stride),
                gap(start_tick > t, start_tick - t)]
        if dyn:
            gaps += [gap(p["fail_at"] > t, p["fail_at"] - t),
                     gap(p["fail_until"] > t, p["fail_until"] - t)]
            if flap:
                st_, per = p["flap_start"], p["flap_period"]
                dn = p["flap_down"]
                phase = (t - st_) % per
                nxt = torch.minimum(per - phase,
                                    torch.where(phase < dn, dn - phase,
                                                _BIG))
                gaps.append(torch.where(st_ > t, st_ - t, nxt).min())
        if flt:
            gaps += [gap(p["crash_at"] > t, p["crash_at"] - t),
                     gap(p["crash_until"] > t, p["crash_until"] - t)]
        # finite bursts: scaled injection must not overshoot the tap
        room = p["burst"] - inj1
        fgaps = [fgap(moving & torch.isfinite(room),
                      torch.floor(torch.maximum(room, zero)
                                  / torch.maximum(dinj, tiny)) + one)]
        if any_msg:
            # message-window room shrinks while injection outruns
            # delivery; never let a macro jam the window shut
            dout = torch.maximum(dinj - ddel, zero)
            wroom = p["m_win"] * p["m_bytes"] - (inj1 - del1)
            fgaps.append(fgap((dout > tiny) & torch.isfinite(wroom),
                              torch.floor(torch.maximum(wroom, zero)
                                          / torch.maximum(dout, tiny))
                              + one))
        if dyn and Sn:
            # weighted-ECMP flowlet bookkeeping gaps by k ticks under a
            # macro; keep k at or below the idle gap
            wec_move = (p["rmode"][..., None] == 1) & moving
            gaps.append(gap(wec_move, p["flet"][..., None]))
        fgaps += [fire_gap(s["t_us"], s1["t_us"], p["r_tmr"], fdt),
                  fire_gap(s["a_tus"], s1["a_tus"], p["a_tmr"], fdt),
                  fire_gap(s["byts"], s1["byts"], p["bctr"],
                           s1["byts"] - s["byts"])]
        if any_cc:
            fgaps.append(fire_gap(s["cc_tus"], s1["cc_tus"], p["cc_upd"],
                                  fdt))
        quiet = torch.stack(quiet).all()
        g = torch.minimum(torch.stack(gaps).min(),
                          torch.minimum(torch.stack(fgaps).min(), bigf)
                          .to(torch.int64))
        k = torch.clamp(g, min=1)
        return torch.where(quiet, k, 1).to(torch.int32)

    return stride
