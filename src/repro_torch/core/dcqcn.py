"""DCQCN sender rate controller (Zhu et al., SIGCOMM'15; paper §2.1): its
knobs, and the per-sender state machine the CC zoo's controllers share a
calling convention with (:mod:`repro_torch.fabric.cc`).  The vector
fabric step runs the same machine stacked over ``[G, F]`` tensors."""
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


class DcqcnRate:
    """Per-sender DCQCN state machine (rate in Gbps)."""

    def __init__(self, cfg: DcqcnConfig = DcqcnConfig()):
        self.cfg = cfg
        self.rc = cfg.line_rate_gbps   # current rate
        self.rt = cfg.line_rate_gbps   # target rate
        self.alpha = 1.0
        self._t_us = 0.0               # since last rate decrease (timer)
        self._bytes = 0.0              # since last rate decrease (counter)
        self._alpha_t_us = 0.0
        self._t_stage = 0
        self._b_stage = 0
        self.cnp_count = 0

    def on_signal(self, rtt_us: float, util: float, dt_us: float) -> None:
        """Per-tick fabric telemetry (delay / utilization).  DCQCN is
        ECN-driven and ignores it — the hook exists so every controller
        behind :data:`repro_torch.fabric.cc.CongestionControl` shares one
        calling convention."""

    def on_cnp(self) -> None:
        """Rate decrease on congestion notification."""
        self.cnp_count += 1
        self.rt = self.rc
        self.rc = max(self.cfg.min_rate_gbps,
                      self.rc * (1.0 - self.alpha / 2.0))
        self.alpha = min(1.0, (1.0 - self.cfg.g) * self.alpha + self.cfg.g)
        self._t_us = 0.0
        self._bytes = 0.0
        self._t_stage = 0
        self._b_stage = 0
        self._alpha_t_us = 0.0

    def advance(self, dt_us: float) -> float:
        """Advance timers by ``dt_us``; returns the current rate (Gbps)."""
        cfg = self.cfg
        self._alpha_t_us += dt_us
        if self._alpha_t_us >= cfg.alpha_timer_us:
            self._alpha_t_us = 0.0
            self.alpha = max(0.0, (1.0 - cfg.g) * self.alpha)

        self._t_us += dt_us
        self._bytes += self.rc * 1e9 / 8.0 * dt_us * 1e-6
        fired = False
        if self._t_us >= cfg.rate_timer_us:
            self._t_us = 0.0
            self._t_stage += 1
            fired = True
        if self._bytes >= cfg.byte_counter_mb * (1 << 20):
            self._bytes = 0.0
            self._b_stage += 1
            fired = True
        if fired:
            stage = min(self._t_stage, self._b_stage)
            if stage < cfg.f_threshold:          # fast recovery
                pass
            elif stage == cfg.f_threshold:        # additive increase
                self.rt = min(cfg.line_rate_gbps, self.rt + cfg.ai_rate_gbps)
            else:                                 # hyper increase
                self.rt = min(cfg.line_rate_gbps, self.rt + cfg.hai_rate_gbps)
            self.rc = min(cfg.line_rate_gbps, 0.5 * (self.rc + self.rt))
        return self.rc
