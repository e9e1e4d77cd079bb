"""Routing policy of a fabric scenario.

``static_ecmp`` freezes every cross-leaf flow on the spine
:meth:`~repro_torch.fabric.topology.Topology.route` hashes it to — the
mode this port's engine runs.  The dynamic modes (flowlet-weighted
ECMP, adaptive least-congested, packet spray) are valid configurations
of the reference engine; the port raises ``NotImplementedError`` for
them.
"""
from __future__ import annotations

import dataclasses

ROUTING_MODES = ("static_ecmp", "weighted_ecmp", "adaptive", "spray")


@dataclasses.dataclass
class RoutingConfig:
    """Per-fabric routing policy (one mode per scenario / grid point)."""
    mode: str = "static_ecmp"
    flowlet_gap_us: float = 50.0
    hysteresis_frac: float = 0.05
    spray_settle_us: float = 8.0

    def __post_init__(self) -> None:
        if self.mode not in ROUTING_MODES:
            raise ValueError(f"unknown routing mode {self.mode!r}; "
                             f"pick one of {ROUTING_MODES}")
        if self.flowlet_gap_us <= 0.0:
            raise ValueError("flowlet_gap_us must be positive")
        if self.hysteresis_frac < 0.0:
            raise ValueError("hysteresis_frac must be >= 0")
        if self.spray_settle_us < 0.0:
            raise ValueError("spray_settle_us must be >= 0")

    @property
    def is_dynamic(self) -> bool:
        return self.mode != "static_ecmp"
