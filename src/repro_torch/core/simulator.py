"""Discrete-event (fluid, 1 us tick) simulator of the RDMA receiver host
datapath — the measurement substrate of the paper (§2, §6).

The paper's *measurement* results need RNIC and DRAM-contention hardware,
so they are reproduced with a calibrated simulator that models:

  sender (DCQCN rate machine, PFC pause)  ->  link  ->  RNIC FIFO buffer
      ->  drain to host, gated by
            - PCIe bandwidth
            - [ddio mode]   DRAM bandwidth left over by contending CPU cores,
                            x2 traffic on DDIO write-allocate miss (leaky DMA)
            - [jet  mode]   free space in the cache-resident buffer pool
      ->  post-NIC residence (consumer latency, message- or slice-granular
          release = the recycle controller), stragglers, escape ladder.

Everything observable in the paper's figures is surfaced in SimResult:
goodput, avg/P99 latency, PFC pause duration, CNP count, DDIO miss rate,
DRAM bandwidth consumed, pool occupancy, escape action counts.

Calibration constants mirror the paper's two testbeds:
  * 2x25 Gbps PFC-enabled, PCIe3 x8,  ~64 GB/s DRAM, DDIO 4 MB
  * 2x100 Gbps PFC-free,   PCIe4 x16, ~250 GB/s DRAM, DDIO 6 MB

``run_sim`` is host code in Python floats: it takes no device and makes
no tensor.  It is the scalar oracle of the receiver sweep
(:func:`repro_torch.fabric.run_sweep`), which advances the same tick for
a whole grid of configurations at once on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from .datapath import (ClassBytes, HostDatapath, N_QOS,  # noqa: F401
                       hold_us_baseline, hold_us_jet)
from .dcqcn import DcqcnConfig, DcqcnRate
from .recycle import RecycleModel, paper_default


# --------------------------------------------------------------------------- #
# Configuration
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class SimConfig:
    mode: str = "ddio"                 # "ddio" (baseline) | "jet"
    pfc_enabled: bool = False
    sim_time_s: float = 0.03
    dt_us: float = 1.0

    # network / workload
    line_rate_gbps: float = 200.0      # dual-port 100 Gbps
    num_qps: int = 32
    msg_bytes: int = 256 << 10
    incast_senders: int = 1            # >1 models in-cast (HPC all-to-all)
    offered_gbps: Optional[float] = None  # open-loop load cap (None=saturate)

    # host
    pcie_gbps: float = 2048.0          # PCIe 4.0 x16 ~ 32 GB/s
    membw_total_gbps: float = 2000.0   # 250 GB/s
    cpu_membw_gbps: float = 1760.0     # 220 GB/s of CPU-side contention
    cpu_membw_schedule: Optional[Callable[[float], float]] = None
    app_gbps: float = 3200.0           # app-side consumption bandwidth
    consumer_latency_us: float = 60.0  # SSD/GPU/compute hand-off latency

    # DDIO (baseline)
    ddio_bytes: int = 6 << 20
    miss_knee: float = 0.5             # miss ramps over knee*ddio_bytes

    # RNIC buffer & congestion signalling
    rnic_buffer_bytes: int = 2 << 20
    pfc_xoff: float = 0.80
    pfc_xon: float = 0.50
    # per-class receiver PFC: evaluate the xoff/xon watermarks on each
    # admission class's occupancy of its 1/N_QOS buffer partition and
    # pause only that class on the access link (mirrors the switch's
    # 802.1Qbb per-priority pause, whose watermarks are also fractions
    # of a per-class partition — evaluating against the *full* shared
    # buffer would assert too late and forfeit losslessness).  False =
    # legacy whole-link gate on total occupancy.
    host_pfc_per_tc: bool = False
    ecn_threshold: float = 0.15
    cnp_interval_us: float = 50.0
    # ConnectX-6 DX marks CNPs on an RNIC-buffer watermark (§2.1); older
    # CX-4 (25G testbed) lacks the feature and relies on PFC backpressure.
    rnic_ecn_cnp: bool = True

    # Jet
    jet_pool_bytes: int = 12 << 20
    recycle: RecycleModel = dataclasses.field(default_factory=paper_default)
    straggler_frac: float = 0.005
    straggler_mult: float = 20.0
    cache_safe: float = 0.20
    cache_danger: float = 0.05
    mem_esc_bytes: int = 2 << 20

    dcqcn: DcqcnConfig = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.dcqcn is None:
            self.dcqcn = DcqcnConfig(line_rate_gbps=self.line_rate_gbps *
                                     self.incast_senders)


def testbed_25g(mode: str = "ddio", **kw) -> SimConfig:
    """2x25 Gbps PFC-enabled testbed (§2.1): PCIe3 x8, 64 GB/s DRAM."""
    base = dict(pfc_enabled=True, line_rate_gbps=50.0, pcie_gbps=500.0,
                membw_total_gbps=512.0, cpu_membw_gbps=456.0,
                ddio_bytes=4 << 20, rnic_ecn_cnp=False)
    base.update(kw)
    return SimConfig(mode=mode, **base)


def testbed_100g(mode: str = "ddio", **kw) -> SimConfig:
    """2x100 Gbps PFC-free testbed (§2.1): PCIe4 x16, 250 GB/s DRAM."""
    base = dict(pfc_enabled=False, line_rate_gbps=200.0, pcie_gbps=2048.0,
                membw_total_gbps=2000.0, cpu_membw_gbps=1760.0,
                ddio_bytes=6 << 20)
    base.update(kw)
    return SimConfig(mode=mode, **base)


# --------------------------------------------------------------------------- #
# Results
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class SimResult:
    goodput_gbps: float
    avg_latency_us: float
    p99_latency_us: float
    p999_latency_us: float
    pfc_pause_us: float
    cnp_count: float
    ddio_miss_rate: float
    nic_dram_gbps: float          # DRAM bandwidth induced by the datapath
    pool_peak_bytes: int
    pool_avg_bytes: float
    escape_replaces: int
    escape_copies: int
    escape_ecn: int
    escape_dram_gbps: float
    dropped_bytes: int
    completed_messages: int
    mem_fallback_bytes: float = 0.0    # LOW-QoS bytes spilled to DRAM (§5)

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


# --------------------------------------------------------------------------- #
# The step-able receiver host (the tick body behind run_sim and the fabric)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class HostFeedback:
    """Per-tick receiver feedback routed back to the sender/fabric."""
    accepted: float = 0.0     # bytes taken into the RNIC buffer
    dropped: float = 0.0      # bytes lost at the RNIC (lossy mode)
    cnps: int = 0             # congestion notifications for the sender(s)
    pfc_paused: bool = False  # receiver asserts pause on its access link
    accepted_qos: Optional[List[float]] = None  # per-class split (QoS order)


class ReceiverHost:
    """The paper's receiver datapath advanced one fluid tick at a time.

    A thin network-facing wrapper around :class:`~repro_torch.core
    .datapath.HostDatapath` (the shared admission/QoS/recycle/escape state
    machine): this class owns what the *link* sees — PFC pause state,
    RNIC-watermark CNP pacing, drop accounting, per-message latency
    bookkeeping — and delegates everything behind the RNIC to the
    datapath.  The caller supplies the bytes arriving on the access link
    each tick (already gated by any PFC pause it honours), either as a
    plain float (all NORMAL QoS) or as a per-class ``[HIGH, NORMAL,
    LOW]`` sequence, and routes the returned CNPs to the
    congestion-controlled sender(s).  ``run_sim`` drives exactly one of
    these; ``repro_torch.fabric.run_fabric`` composes N of them behind a
    Clos fabric.
    """

    def __init__(self, cfg: SimConfig, sim_ticks: Optional[int] = None):
        c = self.cfg = cfg
        self.dt = c.dt_us
        ticks = (sim_ticks if sim_ticks is not None
                 else int(c.sim_time_s * 1e6 / self.dt))
        self.dp = HostDatapath(c, ticks, dt_us=self.dt)

        self.pfc_paused = False
        self.pfc_paused_cls = [False] * N_QOS  # per-class pause state
        self.pfc_pause_us = 0.0
        self.cnp_count = 0.0
        self.cnp_accum_us = c.cnp_interval_us  # allow an immediate first CNP

        self.total_arrived = 0.0          # accepted into RNIC buffer
        self.total_drained = 0.0          # delivered to host datapath
        self.dropped = 0.0

        # Message latency tracking.  The num_qps concurrent QPs stripe
        # their messages across the wire, so one "generation" = num_qps
        # messages that start and finish together; per-message latency is
        # the generation's transit time (round-robin interleave approx).
        self.msg = float(c.num_qps * c.msg_bytes)
        self.starts: List[float] = []     # t of first byte into RNIC
        self.dones: List[float] = []      # t of last byte drained
        self.n_started = 0
        self.n_drained_msgs = 0

        self.hold_b = hold_us_baseline(c)
        self.hold_j = hold_us_jet(c)
        self.t = 0

    def crash_reset(self) -> None:
        """NIC/host crash (fabric fault layer): zero the admission and
        pause state the link sees — the datapath's in-flight bytes and
        the PFC gate — keeping cumulative counters and message
        bookkeeping (a restarted host resumes the same run)."""
        self.dp.crash_reset()
        self.pfc_paused = False
        self.pfc_paused_cls = [False] * N_QOS

    # network-facing views of the shared datapath state
    @property
    def rnic_q(self) -> float:
        return self.dp.rnic_q

    @property
    def paused_classes(self) -> frozenset:
        """QoS classes currently paused on the access link.  Legacy
        whole-link mode reports every class while paused — the gate
        stalls them all."""
        if self.cfg.host_pfc_per_tc:
            return frozenset(i for i, p in enumerate(self.pfc_paused_cls)
                             if p)
        return frozenset(range(N_QOS)) if self.pfc_paused else frozenset()

    @property
    def resident(self) -> float:
        return self.dp.resident

    def step(self, arriving: ClassBytes) -> HostFeedback:
        """Advance one tick with ``arriving`` bytes offered on the link
        (a float = all NORMAL class, or a per-QoS-class sequence)."""
        c = self.cfg
        dt = self.dt
        t = self.t
        if t >= self.dp.horizon:
            # past this point the release arrays would silently stop
            # cycling bytes and the pool would deadlock — fail loudly
            raise RuntimeError(
                f"ReceiverHost stepped past its horizon ({self.dp.horizon} "
                f"ticks); construct it with sim_ticks covering the run")
        now_us = t * dt
        fb = HostFeedback()
        cpu_bw = (c.cpu_membw_schedule(now_us * 1e-6)
                  if c.cpu_membw_schedule else c.cpu_membw_gbps)

        # ---- link -> RNIC (QoS-classed admission) ------------------------- #
        accepted, per_class, total_in = self.dp.admit_link(arriving)
        self.dropped += total_in - accepted
        fb.dropped = total_in - accepted
        fb.accepted = accepted
        fb.accepted_qos = per_class
        # message start timestamps
        new_started = int((self.total_arrived + accepted) // self.msg) \
            - int(self.total_arrived // self.msg)
        if self.total_arrived == 0 and accepted > 0 and self.n_started == 0:
            new_started += 1
        for _ in range(new_started):
            self.starts.append(now_us)
            self.n_started += 1
        self.total_arrived += accepted

        # ---- the shared datapath tick: drain / release / escape ----------- #
        dfb = self.dp.step(t, cpu_bw)
        drained = dfb.drained
        # message drain-completion timestamps
        new_done = int((self.total_drained + drained) // self.msg) \
            - int(self.total_drained // self.msg)
        for _ in range(new_done):
            self.dones.append(now_us)
            self.n_drained_msgs += c.num_qps
        self.total_drained += drained
        # escape-ladder ECN (rung 3) surfaces as CNPs toward the sender
        if dfb.ecn_fires:
            self.cnp_count += dfb.ecn_fires
            fb.cnps += dfb.ecn_fires

        # ---- congestion signalling ---------------------------------------- #
        q_frac = self.dp.rnic_q / c.rnic_buffer_bytes
        if c.pfc_enabled:
            if c.host_pfc_per_tc:
                # per-class watermarks on each class's 1/N_QOS buffer
                # partition: the congested class pauses without stalling
                # the others, and the summed assert points leave the
                # same headroom as the legacy whole-buffer gate (pausing
                # on fractions of the *total* buffer would fire too late
                # and drop — the receiver-side twin of the switch's
                # partitioned per-priority watermarks)
                share = c.rnic_buffer_bytes / N_QOS
                for i in range(N_QOS):
                    fr = self.dp.qos_q[i] / share
                    if self.pfc_paused_cls[i]:
                        if fr < c.pfc_xon:
                            self.pfc_paused_cls[i] = False
                    elif fr > c.pfc_xoff:
                        self.pfc_paused_cls[i] = True
                self.pfc_paused = any(self.pfc_paused_cls)
            else:
                if self.pfc_paused:
                    if q_frac < c.pfc_xon:
                        self.pfc_paused = False
                elif q_frac > c.pfc_xoff:
                    self.pfc_paused = True
            if self.pfc_paused:
                self.pfc_pause_us += dt
        # RNIC-watermark CNPs (ConnectX-6 DX feature, §2.1)
        self.cnp_accum_us += dt
        if (c.rnic_ecn_cnp and q_frac > c.ecn_threshold
                and self.cnp_accum_us >= c.cnp_interval_us):
            self.cnp_accum_us = 0.0
            self.cnp_count += 1
            fb.cnps += 1

        fb.pfc_paused = self.pfc_paused
        self.t += 1
        return fb

    def finalize(self) -> SimResult:
        """Aggregate the per-tick state into the paper-facing SimResult."""
        c = self.cfg
        dp = self.dp
        ticks = max(1, self.t)
        sim_us = ticks * self.dt
        goodput = self.total_drained * 8.0 / (sim_us * 1e-6) / 1e9
        post = (self.hold_j if c.mode == "jet" else self.hold_b)
        lats = [d - s + post for s, d in zip(self.starts, self.dones)]
        lats = lats[len(lats) // 10:]      # drop warm-up decile
        if not lats:
            lats = [float("nan")]
        arr = np.array(lats)
        return SimResult(
            goodput_gbps=goodput,
            avg_latency_us=float(np.mean(arr)),
            p99_latency_us=float(np.percentile(arr, 99)),
            p999_latency_us=float(np.percentile(arr, 99.9)),
            pfc_pause_us=self.pfc_pause_us,
            cnp_count=self.cnp_count,
            ddio_miss_rate=(dp.miss_sum / dp.miss_n)
            if dp.miss_n else 0.0,
            nic_dram_gbps=dp.nic_dram_bytes * 8.0 / (sim_us * 1e-6) / 1e9,
            pool_peak_bytes=int(dp.pool_peak),
            pool_avg_bytes=dp.pool_sum / ticks,
            escape_replaces=dp.replaces,
            escape_copies=dp.copies,
            escape_ecn=dp.ecns,
            escape_dram_gbps=dp.escape_dram_bytes * 8.0
            / (sim_us * 1e-6) / 1e9,
            dropped_bytes=int(self.dropped),
            completed_messages=self.n_drained_msgs,
            mem_fallback_bytes=dp.mem_fallback_bytes,
        )


# --------------------------------------------------------------------------- #
# Simulator
# --------------------------------------------------------------------------- #
class ReceiverSim:
    """Single-host driver: one DCQCN sender feeding one ReceiverHost.

    The sender is gated by the receiver's PFC state and receives the
    receiver's CNPs within the same tick.
    """

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg

    def run(self) -> SimResult:
        c = self.cfg
        dt = c.dt_us                       # us
        ticks = int(c.sim_time_s * 1e6 / dt)
        bytes_per_gbps_tick = 1e9 / 8.0 * dt * 1e-6   # bytes per (Gbps*tick)

        rate = DcqcnRate(c.dcqcn)
        host = ReceiverHost(c, sim_ticks=ticks)
        for _ in range(ticks):
            offered = min(rate.advance(dt), c.line_rate_gbps *
                          c.incast_senders)
            if c.offered_gbps is not None:
                offered = min(offered, c.offered_gbps)
            arriving = (0.0 if host.pfc_paused
                        else offered * bytes_per_gbps_tick)
            fb = host.step(arriving)
            for _ in range(fb.cnps):
                rate.on_cnp()
        return host.finalize()


def run_sim(cfg: SimConfig) -> SimResult:
    return ReceiverSim(cfg).run()
