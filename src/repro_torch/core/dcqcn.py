"""DCQCN sender rate-controller knobs (Zhu et al., SIGCOMM'15; paper
§2.1).  The rate machine itself runs stacked inside the fabric step."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DcqcnConfig:
    line_rate_gbps: float = 100.0
    min_rate_gbps: float = 0.1
    g: float = 1.0 / 256.0          # alpha EWMA gain
    alpha_timer_us: float = 55.0    # alpha update period without CNPs
    rate_timer_us: float = 300.0    # rate-increase period T
    byte_counter_mb: float = 10.0   # rate-increase byte counter B
    ai_rate_gbps: float = 5.0       # additive increase R_AI
    hai_rate_gbps: float = 50.0     # hyper increase R_HAI
    f_threshold: int = 5            # fast-recovery stages before AI/HAI
