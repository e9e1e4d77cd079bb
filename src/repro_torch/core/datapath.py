"""The shared host receive datapath (paper §3–§4): one state machine for
admission, QoS queueing, recycle release and the escape ladder, used by
every layer that models a receiving host.

``HostDatapath``
    The tick-driven *fluid* state machine: per-QoS RNIC buffer classes,
    drain to the cache pool (Jet) or through DDIO (baseline), release
    rings (the recycle model), the escape ladder, low-QoS DRAM spill
    (§5).  Wrapped by :class:`repro_torch.core.simulator.ReceiverHost`
    (and therefore by ``run_sim`` and the fabric's scalar driver
    ``run_fabric``).  The receiver sweep (:mod:`repro_torch.fabric.sweep`)
    and the fabric grid engine (:mod:`repro_torch.fabric.vector`) advance
    the same step in stacked-tensor form; this host-side machine, in
    Python floats, is their scalar oracle.

``AdmissionQueues``
    The event-driven *discrete* admission machinery: QoS-priority FIFO
    queues with the §3.2 pump order and the §5 low-QoS fallback.
    Wrapped by :class:`repro_torch.core.jet.JetService` (and therefore by
    the serving engine).

Both share this module's :class:`QoS` classes, priority order and the
``expected_footprint`` admission rule, so a QoS decision made by the
serving engine and one made inside a fabric sweep follow the same policy.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Callable, Deque, List, Optional, Sequence, Tuple, Union

import numpy as np


class QoS(enum.IntEnum):
    """Transfer service classes (paper §3.2); lower value = higher
    priority.  Priority order is the iteration order everywhere: queue
    pump, RNIC buffer space allocation, drain budget."""
    HIGH = 0
    NORMAL = 1
    LOW = 2


N_QOS = len(QoS)


def expected_footprint(nbytes: int, expected_timespan_us: float) -> int:
    """Admission rule (§3.2 step 2): expected throughput x timespan,
    capped by the transfer size itself (Little's law working set)."""
    rate_gbps = 8.0 * nbytes / max(expected_timespan_us, 1e-9) / 1e3
    little = rate_gbps * 1e9 / 8.0 * expected_timespan_us * 1e-6
    return min(nbytes, int(little))


# --------------------------------------------------------------------------- #
# Event-driven admission (wrapped by JetService)
# --------------------------------------------------------------------------- #
class Admit(enum.Enum):
    """Outcome of a ``try_admit`` probe during a queue pump."""
    OK = "ok"          # admitted; pop and continue with this class
    DEFER = "defer"    # resource pressure; LOW falls back, others wait
    STOP = "stop"      # global limit (e.g. max concurrent); stop pumping


class AdmissionQueues:
    """QoS-priority FIFO admission queues (paper §3.2 step 3).

    Generic over the admitted item type: the caller supplies a
    ``try_admit(item) -> Admit`` probe (pool allocation, lane
    availability, ...) and optionally a ``fallback(item)`` sink invoked
    when a LOW-class head cannot be admitted (§5: low-QoS transfers fall
    back to DRAM buffers instead of waiting for cache).
    """

    def __init__(self) -> None:
        self._queues: "collections.OrderedDict[QoS, Deque]" = \
            collections.OrderedDict((q, collections.deque()) for q in QoS)

    def push(self, item, qos: QoS) -> None:
        self._queues[QoS(qos)].append(item)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth(self, qos: QoS) -> int:
        return len(self._queues[QoS(qos)])

    def pump(self, try_admit: Callable[[object], "Admit"],
             fallback: Optional[Callable[[object], None]] = None) -> List:
        """Admit in QoS-priority, FIFO-within-class order.

        A ``DEFER`` head blocks only its own class (lower classes still
        get probed — small LOW transfers may fit where a big NORMAL one
        did not), except LOW itself, which falls back to ``fallback``
        and keeps draining.  ``STOP`` ends the pump entirely.
        """
        admitted: List = []
        for qos in QoS:
            q = self._queues[qos]
            while q:
                verdict = try_admit(q[0])
                if verdict is Admit.STOP:
                    return admitted
                if verdict is Admit.DEFER:
                    if qos is QoS.LOW and fallback is not None:
                        fallback(q.popleft())
                        continue
                    break
                admitted.append(q.popleft())
        return admitted


# --------------------------------------------------------------------------- #
# Tick-driven fluid datapath (wrapped by ReceiverHost / the fabric)
# --------------------------------------------------------------------------- #
def hold_us_baseline(c) -> float:
    """Message-granular post-NIC hold time (baseline, non-pipelined)."""
    return (c.consumer_latency_us +
            c.msg_bytes * 8.0 / (c.app_gbps * 1e9) * 1e6)


def hold_us_jet(c) -> float:
    """Slice-granular hold (Jet recycle pipeline): consumer latency
    dominates, the pipeline transit adds ~3 slice-times (paper §4.2.2)."""
    r = c.recycle
    per_byte_ns = r.get_ns_per_byte + r.process_ns_per_byte()
    transit = 3.0 * r.slice_bytes * per_byte_ns * 1e-3
    if not r.pipelined:
        # unpipelined Jet holds whole messages (ablation mode)
        return hold_us_baseline(c) + transit
    return c.consumer_latency_us + transit


ClassBytes = Union[float, Sequence[float]]


@dataclasses.dataclass
class DatapathFeedback:
    """One tick's outputs, routed back toward the network by the wrapper."""
    drained: float = 0.0        # bytes delivered to the host (goodput)
    pool_drained: float = 0.0   # subset that entered pool / DDIO residency
    fallback: float = 0.0       # LOW-QoS bytes spilled to DRAM (§5)
    ecn_fires: int = 0          # escape-ladder MARK_ECN count (rung 3)


class HostDatapath:
    """The receive datapath behind the RNIC, advanced one fluid tick at a
    time: per-QoS buffer classes -> pool/DDIO drain -> recycle release ->
    escape ladder.

    The single-host simulator and the multi-host scalar driver advance
    this machine; the grid engines advance the same step stacked.  With
    all traffic in the NORMAL class every per-class loop reduces to the
    plain scalar arithmetic (mins over classes with zero-byte classes are
    exact no-ops).  Host code: Python floats and two numpy float64
    release rings, no tensor.

    The RNIC buffer itself is modeled here as the three class queues
    (``qos_q``); :attr:`rnic_q` is their total, which is what PFC/ECN
    watermarks observe.  Buffer space and drain budget are granted in
    QoS-priority order; under pool pressure (< ``cache_safe`` available)
    the LOW class spills to DRAM instead of competing for cache slots —
    the fluid rendition of ``JetService``'s §5 memory fallback.
    """

    def __init__(self, cfg, sim_ticks: int, dt_us: Optional[float] = None):
        c = self.cfg = cfg
        self.dt = float(dt_us if dt_us is not None else c.dt_us)
        # release buckets (bytes becoming consumable at tick t);
        # 1 s slack past the end for straggler releases
        self.horizon = sim_ticks + int(1e6 / self.dt)
        self.rel_base = np.zeros(self.horizon, dtype=np.float64)
        self.rel_strag = np.zeros(self.horizon, dtype=np.float64)

        self.qos_q: List[float] = [0.0] * N_QOS   # RNIC buffer, by class
        self.resident = 0.0               # post-NIC bytes not yet consumed
        self.strag_resident = 0.0
        self.escape_debt = 0.0            # escaped bytes whose release is void
        self.replace_debt = 0.0           # portion of debt borrowed by REPLACE
        self.pool_cap = float(c.jet_pool_bytes)
        self.replace_mem = 0.0
        self.ecn_escape_accum_us = 0.0

        # accounting
        self.nic_dram_bytes = 0.0
        self.escape_dram_bytes = 0.0
        self.mem_fallback_bytes = 0.0
        self.miss_sum, self.miss_n = 0.0, 0
        self.pool_peak, self.pool_sum = 0.0, 0.0
        self.replaces = self.copies = self.ecns = 0

        hold_b, hold_j = hold_us_baseline(c), hold_us_jet(c)
        self.hold_us = hold_j if c.mode == "jet" else hold_b
        self.d_base = max(1, int(self.hold_us / self.dt))
        self.d_strag = max(1, int(self.hold_us * c.straggler_mult / self.dt))

    def crash_reset(self) -> None:
        """NIC/host crash (fault layer): every byte in flight through
        the datapath is gone — RNIC class queues, resident pool
        contents, straggler state, escape/replace debts, and all
        pending release buckets.  Cumulative accounting counters are
        deliberately preserved (they describe the run, not the
        machine)."""
        self.rel_base[:] = 0.0
        self.rel_strag[:] = 0.0
        for cls in range(N_QOS):
            self.qos_q[cls] = 0.0
        self.resident = 0.0
        self.strag_resident = 0.0
        self.escape_debt = 0.0
        self.replace_debt = 0.0
        self.replace_mem = 0.0
        self.ecn_escape_accum_us = 0.0

    # -- RNIC buffer ---------------------------------------------------------
    @property
    def rnic_q(self) -> float:
        return sum(self.qos_q)

    def admit_link(self, arriving: ClassBytes) \
            -> Tuple[float, List[float], float]:
        """Accept link arrivals into the RNIC buffer, allocating space in
        QoS-priority order.  ``arriving`` is a plain float (all NORMAL —
        the single-host fast path) or a per-class sequence.  Returns ``(accepted
        total, accepted per class, offered total)``; the offered-accepted
        remainder is dropped upstream (lossy) or was never sent (PFC
        gates arrivals at the caller)."""
        space = max(0.0, self.cfg.rnic_buffer_bytes - self.rnic_q)
        if not isinstance(arriving, (tuple, list, np.ndarray)):
            offered = float(arriving)
            take = min(offered, space)
            self.qos_q[QoS.NORMAL] += take
            per_class = [0.0] * N_QOS
            per_class[QoS.NORMAL] = take
            return take, per_class, offered
        per_class = [0.0] * N_QOS
        total = offered = 0.0
        for cls in QoS:
            offered += float(arriving[cls])
            take = min(float(arriving[cls]), space)
            space -= take
            self.qos_q[cls] += take
            per_class[cls] = take
            total += take
        return total, per_class, offered

    # -- the tick ------------------------------------------------------------
    def step(self, t: int, cpu_bw_gbps: float) -> DatapathFeedback:
        """Drain the RNIC buffer toward the host, process due releases and
        run the escape ladder for tick ``t``."""
        c = self.cfg
        dt = self.dt
        if t >= self.horizon:
            # past this point the release arrays would silently stop
            # cycling bytes and the pool would deadlock — fail loudly
            raise RuntimeError(
                f"HostDatapath stepped past its horizon ({self.horizon} "
                f"ticks); construct it with sim_ticks covering the run")
        bytes_per_gbps_tick = 1e9 / 8.0 * dt * 1e-6
        fb = DatapathFeedback()
        q = self.qos_q

        # ---- drain RNIC -> host ------------------------------------------ #
        if c.mode == "ddio":
            # posted per-QP receive buffers + unconsumed post-NIC bytes
            working_set = c.num_qps * c.msg_bytes + self.resident
            over = working_set - c.ddio_bytes
            miss = min(1.0, max(0.0, over / (c.miss_knee * c.ddio_bytes)))
            self.miss_sum += miss
            self.miss_n += 1
            avail_dram = max(0.0, c.membw_total_gbps - cpu_bw_gbps)
            drain_bw = c.pcie_gbps
            if miss > 1e-9:
                # each drained byte costs ~2*miss bytes of DRAM traffic
                drain_bw = min(drain_bw, avail_dram / (2.0 * miss))
            budget = drain_bw * bytes_per_gbps_tick
            drained = 0.0
            for cls in QoS:
                take = min(q[cls], budget)
                q[cls] -= take
                budget -= take
                drained += take
            self.nic_dram_bytes += drained * 2.0 * miss
            pool_drained = drained
            strag_share = 0.0
        else:  # jet
            pool_free = max(0.0, self.pool_cap - self.resident)
            spill_low = pool_free / self.pool_cap < c.cache_safe
            budget = min(c.pcie_gbps, c.line_rate_gbps * 4.0) \
                * bytes_per_gbps_tick
            pool_drained = 0.0
            fallback = 0.0
            for cls in QoS:
                if cls is QoS.LOW and spill_low:
                    # §5: under cache pressure LOW-QoS bytes land in DRAM
                    # buffers instead of competing for pool slots
                    take = min(q[cls], budget)
                    fallback += take
                else:
                    take = min(q[cls], budget, pool_free)
                    pool_free -= take
                    pool_drained += take
                q[cls] -= take
                budget -= take
            drained = pool_drained + fallback
            self.mem_fallback_bytes += fallback
            self.nic_dram_bytes += fallback   # spilled writes hit DRAM 1x
            fb.fallback = fallback
            strag_share = c.straggler_frac

        # schedule release (only bytes that actually took up residency)
        if pool_drained > 0.0:
            base_part = pool_drained * (1.0 - strag_share)
            strag_part = pool_drained * strag_share
            bt = min(self.horizon - 1, t + self.d_base)
            st = min(self.horizon - 1, t + self.d_strag)
            self.rel_base[bt] += base_part
            self.rel_strag[st] += strag_part
            self.resident += pool_drained
            self.strag_resident += strag_part

        # ---- post-NIC consumption ---------------------------------------- #
        for arr, is_strag in ((self.rel_base, False), (self.rel_strag, True)):
            r = arr[t]
            if r <= 0.0:
                continue
            if self.escape_debt > 0.0:
                void = min(r, self.escape_debt)
                self.escape_debt -= void
                r -= void
                # a released straggler that had been REPLACE-escaped
                # retires its DRAM borrow (re-arming the replace rung)
                repay = min(void, self.replace_debt)
                self.replace_debt -= repay
                self.replace_mem = max(0.0, self.replace_mem - repay)
            self.resident = max(0.0, self.resident - r)
            if is_strag:
                self.strag_resident = max(0.0, self.strag_resident - r)

        # ---- Jet escape ladder (paper Algorithm 1) ------------------------ #
        if c.mode == "jet":
            avail_frac = max(0.0, self.pool_cap - self.resident) \
                / self.pool_cap
            if avail_frac < c.cache_safe:
                if self.replace_mem < c.mem_esc_bytes:
                    x = min(self.strag_resident,
                            c.mem_esc_bytes - self.replace_mem)
                    if x > 0.0:
                        self.resident -= x
                        self.strag_resident -= x
                        self.escape_debt += x
                        self.replace_debt += x
                        self.replace_mem += x
                        self.replaces += 1
                        # background re-touch traffic, low frequency
                        self.escape_dram_bytes += x * 0.1
                else:
                    x = self.strag_resident
                    if x > 0.0:
                        self.resident -= x
                        self.strag_resident = 0.0
                        self.escape_debt += x
                        self.escape_dram_bytes += x  # the copy itself
                        self.copies += 1
                avail_frac = max(0.0, self.pool_cap - self.resident) \
                    / self.pool_cap
                if avail_frac < c.cache_danger:
                    self.ecn_escape_accum_us += dt
                    if self.ecn_escape_accum_us >= c.cnp_interval_us:
                        self.ecn_escape_accum_us = 0.0
                        self.ecns += 1
                        fb.ecn_fires += 1
            self.pool_sum += self.resident
            self.pool_peak = max(self.pool_peak, self.resident)

        fb.drained = drained
        fb.pool_drained = pool_drained
        return fb
