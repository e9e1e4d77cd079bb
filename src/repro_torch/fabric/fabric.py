"""Fabric scenario configuration: flows riding the Clos and the
fabric-wide knobs (tick, switch, receivers, CNP delay, routing).

Per 1 us fluid tick the engine (:mod:`repro_torch.fabric.vector`) lets
every flow's DCQCN machine offer bytes into its NIC queue, forwards in
tier order with cut-through inside the tick, advances each receiver's
datapath on the arrivals, routes its CNPs and the switches' ECN marks
back to the offending senders, and refreshes per-priority PFC pause
state.  ``msg``, ``cc`` and ``faults`` name layers of the reference
engine that this port does not run; they stay ``None`` here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from ..core.datapath import QoS
from ..core.simulator import SimConfig, testbed_100g
from .routing import RoutingConfig
from .switch import SwitchConfig


@dataclasses.dataclass
class Flow:
    """One sender->receiver transfer riding the fabric."""
    src: str
    dst: str
    offered_gbps: Optional[float] = None     # open-loop cap (None=saturate)
    burst_bytes: Optional[float] = None      # closed flow: stop after burst
    start_us: float = 0.0
    tag: str = ""                            # e.g. "incast" | "victim"
    qos: QoS = QoS.NORMAL                    # receiver admission class (§3.2)
    #                                          + switch traffic class
    # burst-train source: (on_us, off_us) duty cycle; None = always on
    on_off_us: Optional[Tuple[float, float]] = None
    # per-flow NP->RP CNP propagation delay override; None falls back to
    # FabricConfig.cnp_delay_us
    cnp_delay_us: Optional[float] = None
    # message layer / congestion-control override (reference-only layers)
    msg: Optional[object] = None
    cc: Optional[object] = None


def burst_done_bytes(burst_bytes: float) -> float:
    """Delivered-bytes threshold at which a closed flow counts as complete.

    Fluid go-back-N never delivers the *last* byte sharply, so a closed
    flow completes at 99.99% delivery — discrete wire traffic would have
    finished in one more MTU.
    """
    return burst_bytes - max(1e-6, 1e-4 * burst_bytes)


@dataclasses.dataclass
class FabricConfig:
    sim_time_s: float = 0.01
    dt_us: float = 1.0
    switch: SwitchConfig = dataclasses.field(default_factory=SwitchConfig)
    # SimConfig factory per receiver host (mode, pool, DDIO, PFC, ...)
    receiver_cfg: Callable[[str], SimConfig] = \
        lambda host: testbed_100g("jet")
    # CNP propagation delay NP -> RP (us); 0.0 = same-tick delivery
    cnp_delay_us: float = 0.0
    routing: RoutingConfig = dataclasses.field(default_factory=RoutingConfig)
    # message layer / congestion control / fault injection of the
    # reference engine; None keeps the fluid DCQCN semantics this port runs
    msg: Optional[object] = None
    cc: Optional[object] = None
    faults: Optional[object] = None
