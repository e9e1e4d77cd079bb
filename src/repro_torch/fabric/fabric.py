"""Fabric scenario configuration: flows riding the Clos and the
fabric-wide knobs (tick, switch, receivers, CNP delay, routing, the
message layer, congestion control and fault injection).

Per 1 us fluid tick the engine (:mod:`repro_torch.fabric.vector`) lets
every flow's DCQCN machine offer bytes into its NIC queue, forwards in
tier order with cut-through inside the tick, advances each receiver's
datapath on the arrivals, routes its CNPs and the switches' ECN marks
back to the offending senders, and refreshes per-priority PFC pause
state.  A flow's ``msg`` rides its byte stream as verbs messages
(:mod:`repro_torch.fabric.messages`), its ``cc`` picks DCQCN, Timely or
HPCC (:mod:`repro_torch.fabric.cc`), and ``FabricConfig.faults`` injects
loss, corruption and crashes and engages the recovery ledgers
(:mod:`repro_torch.fabric.faults`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from ..core.datapath import QoS
from ..core.simulator import SimConfig, testbed_100g
from .cc import CcConfig
from .faults import FaultConfig
from .messages import MessageConfig
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
    # message layer / congestion-control override; None falls back to
    # the FabricConfig defaults
    msg: Optional[MessageConfig] = None
    cc: Optional[CcConfig] = None


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
    # default message layer / congestion control of every flow without
    # its own; None keeps the fluid DCQCN semantics
    msg: Optional[MessageConfig] = None
    cc: Optional[CcConfig] = None
    # fault injection + loss recovery; None = no faults, bit-equal to an
    # engine without the layer
    faults: Optional[FaultConfig] = None
