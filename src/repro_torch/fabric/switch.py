"""Output-queued switch configuration: per-traffic-class queues, ECN
knees and per-priority PFC watermarks (802.1Qbb).

The queues themselves live stacked in the fabric step; this module keeps
the knobs.  With ``per_tc=False`` every flow rides TC 0 — the legacy
per-link pause (congestion spreading, §2.1).  Classes share a port's
budget by strict priority (HIGH first, the default) or by weighted round
robin (``scheduler="wrr"``: the budget water-filled across backlogged
classes in proportion to :meth:`SwitchConfig.quanta`, 4:2:1 unless
``wrr_quanta`` says otherwise).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..core.datapath import N_QOS

N_TC = N_QOS                      # switch queues mirror the QoS classes


@dataclasses.dataclass
class SwitchConfig:
    port_buffer_bytes: int = 4 << 20
    ecn_enabled: bool = True
    ecn_kmin_frac: float = 0.10       # mark departures once queue > kmin
    pfc_enabled: bool = False
    pfc_xoff_frac: float = 0.60       # assert pause above this occupancy
    pfc_xon_frac: float = 0.30        # release below this occupancy
    # classed queues (per-TC ECN knees + per-priority PFC).  False =
    # legacy per-link behaviour: every flow rides TC 0.
    per_tc: bool = True
    # inter-class drain discipline: "strict" (priority ladder) or "wrr"
    scheduler: str = "strict"
    wrr_quanta: Optional[Sequence[float]] = None   # len N_TC; default 4:2:1
    # optional per-TC overrides (len N_TC), falling back to the scalars
    tc_ecn_kmin_frac: Optional[Sequence[float]] = None
    tc_pfc_xoff_frac: Optional[Sequence[float]] = None
    tc_pfc_xon_frac: Optional[Sequence[float]] = None

    def __post_init__(self) -> None:
        if self.scheduler not in ("strict", "wrr"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.wrr_quanta is not None and (
                len(self.wrr_quanta) != N_TC
                or any(q <= 0.0 for q in self.wrr_quanta)):
            raise ValueError(f"wrr_quanta needs {N_TC} positive weights")

    def quanta(self) -> Tuple[float, ...]:
        q = self.wrr_quanta if self.wrr_quanta is not None \
            else (4.0, 2.0, 1.0)
        return tuple(float(x) for x in q)

    def kmin_frac(self, tc: int) -> float:
        return (self.tc_ecn_kmin_frac[tc]
                if self.tc_ecn_kmin_frac is not None else self.ecn_kmin_frac)

    def xoff_frac(self, tc: int) -> float:
        return (self.tc_pfc_xoff_frac[tc]
                if self.tc_pfc_xoff_frac is not None else self.pfc_xoff_frac)

    def xon_frac(self, tc: int) -> float:
        return (self.tc_pfc_xon_frac[tc]
                if self.tc_pfc_xon_frac is not None else self.pfc_xon_frac)
