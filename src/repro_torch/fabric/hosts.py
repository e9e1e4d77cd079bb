"""Host components for the multi-host fabric.

:class:`ReceiverHost` — the network-facing wrapper around the shared
:class:`repro_torch.core.datapath.HostDatapath` state machine that also
powers ``run_sim`` — lives in :mod:`repro_torch.core.simulator` (core
stays the bottom layer; the fabric composes N of them) and is re-exported
here alongside
the fabric-only :class:`SenderHost`.  Fabric arrivals enter its QoS
admission classes (``Flow.qos``) and its escape-ladder ECN comes back as
CNPs that the driver routes to the offending DCQCN senders.  Its RNIC
PFC gate pauses the whole access link by default, or — with
``SimConfig.host_pfc_per_tc`` — only the congested admission classes
(``ReceiverHost.paused_classes``), mirroring the switch's per-priority
pause so a bulk class filling the RNIC buffer no longer stalls OLTP
traffic sharing the link.

:class:`SenderHost` wraps one DCQCN rate machine per flow, adding burst
(closed-flow) bookkeeping for the fabric driver.  PFC pause gating is the
driver's job: it pauses the host NIC egress queue (``run_fabric`` step 2),
so backpressure reaches the flow through queue space, not a sender flag.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from ..core.dcqcn import DcqcnConfig, DcqcnRate
from ..core.simulator import (HostFeedback, ReceiverHost,  # noqa: F401
                              hold_us_baseline, hold_us_jet)
from .cc import CcConfig, make_controller

__all__ = ["HostFeedback", "ReceiverHost", "SenderHost",
           "hold_us_baseline", "hold_us_jet"]


class SenderHost:
    """One rate-controlled flow source (per-QP rate machine, paper §2.1).

    The rate machine defaults to DCQCN; a :class:`~repro_torch.fabric
    .cc.CcConfig` swaps in any controller from the CC zoo (Timely, HPCC)
    behind the same ``advance``/``on_cnp``/``on_signal`` hooks.

    ``offer(dt_us)`` advances the rate machine and returns the bytes the
    flow wants to inject this tick.  Closed flows (``burst_bytes``) stop
    offering once the burst has been injected; the fabric re-credits
    ``injected`` for bytes lost downstream (fluid go-back-N), which
    re-opens the tap.  Message-layer flows add two more taps the driver
    controls: ``op_cap_gbps`` (per-op issue-gap rate ceiling — the Mops
    plateau) folds into the rate minimum, and ``offer``'s
    ``window_room`` argument clamps injection to the outstanding
    message window's remaining bytes.

    ``on_off_us=(on, off)`` makes the source a burst train (on-off OLTP
    client): after ``start_us`` the flow offers bytes only while
    ``(now - start) mod (on + off) < on``.  The DCQCN machine keeps
    advancing through off-phases (timers run; the tap is simply shut),
    mirroring the grid engine's gating.
    """

    def __init__(self, line_rate_gbps: float,
                 dcqcn: Optional[DcqcnConfig] = None,
                 offered_gbps: Optional[float] = None,
                 burst_bytes: Optional[float] = None,
                 start_us: float = 0.0,
                 on_off_us: Optional[Tuple[float, float]] = None,
                 cc: Optional[CcConfig] = None,
                 op_cap_gbps: Optional[float] = None):
        self.line_rate_gbps = line_rate_gbps
        if cc is None and dcqcn is not None:
            self.rate = DcqcnRate(dcqcn)
        else:
            self.rate = make_controller(cc, line_rate_gbps)
        self.offered_gbps = offered_gbps
        self.op_cap_gbps = op_cap_gbps
        self.burst_bytes = burst_bytes
        self.start_us = start_us
        if on_off_us is not None and (on_off_us[0] <= 0.0
                                      or on_off_us[1] < 0.0):
            raise ValueError("on_off_us needs on > 0 and off >= 0")
        self.on_off_us = on_off_us
        self.injected = 0.0
        self.now_us = 0.0

    @property
    def exhausted(self) -> bool:
        return (self.burst_bytes is not None
                and self.injected >= self.burst_bytes)

    def offer(self, dt_us: float,
              window_room: Optional[float] = None) -> float:
        """Bytes this flow injects into its NIC queue this tick.

        ``window_room`` (message layer) caps the injection at the
        outstanding window's remaining bytes; the rate machine still
        advances so its timers track wall clock even while the window
        is closed.
        """
        self.now_us += dt_us
        if self.now_us <= self.start_us:
            return 0.0
        gbps = min(self.rate.advance(dt_us), self.line_rate_gbps)
        if self.offered_gbps is not None:
            gbps = min(gbps, self.offered_gbps)
        if self.op_cap_gbps is not None:
            gbps = min(gbps, self.op_cap_gbps)
        if self.on_off_us is not None and self.on_off_us[1] > 0.0:
            on, off = self.on_off_us
            if math.fmod(self.now_us - self.start_us, on + off) >= on:
                return 0.0
        if self.exhausted:
            return 0.0
        b = gbps * 1e9 / 8.0 * dt_us * 1e-6
        if self.burst_bytes is not None:
            b = min(b, self.burst_bytes - self.injected)
        if window_room is not None:
            b = min(b, window_room)
        self.injected += b
        return b

    def credit(self, b: float) -> None:
        """Give back ``b`` injected bytes so the tap re-opens: either
        the fluid core's instant drop-re-credit, or — under the fault
        layer — a :class:`~repro_torch.fabric.faults.FlowRecovery` ledger
        firing a retransmission."""
        self.injected -= b

    def on_cnp(self) -> None:
        self.rate.on_cnp()

    def on_signal(self, rtt_us: float, util: float, dt_us: float) -> None:
        """Forward per-tick path telemetry to the rate machine (no-op
        for DCQCN; drives the Timely/HPCC control loops)."""
        self.rate.on_signal(rtt_us, util, dt_us)
