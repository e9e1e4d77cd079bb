"""Pluggable congestion control: DCQCN lifted behind an interface, plus
Timely-style delay-gradient and HPCC-style utilization controllers.

Every sender-side controller exposes the same three hooks (duck-typed —
:class:`repro_torch.core.dcqcn.DcqcnRate` already satisfies them):

``advance(dt_us) -> gbps``
    Advance internal timers one tick; return the current sending rate.
``on_cnp()``
    Explicit congestion notification arrived (ECN-echo CNP).  DCQCN's
    multiplicative decrease lives here; the delay/INT controllers
    ignore CNPs (they sense congestion through their own signals).
``on_signal(rtt_us, util, dt_us)``
    Per-tick telemetry from the fabric: ``rtt_us`` is the flow's
    base RTT plus the queueing delay its path's queues currently imply,
    and ``util`` is the max per-hop utilization HPCC-style INT would
    report (``txRate/B + qlen/(B * T)``).  DCQCN ignores it.

The fabric drivers compute both signals from state they already carry —
queue occupancy and per-tick drained bytes along the flow's current
path — so no new wire machinery is needed, and the scalar and vector
engines can evaluate the identical arithmetic (the vector engines run
the update rules below as masked ``where`` lanes selected by
:meth:`CcConfig.code`).

Timely (Mittal et al., SIGCOMM'15) reacts to the *gradient* of the RTT:
rising delay cuts the rate multiplicatively before queues fill, falling
or low delay additively recovers; the HAI/low/high thresholds follow
the paper's structure.  HPCC (Li et al., SIGCOMM'19) drives per-hop
utilization toward a target ``eta < 1`` with multiplicative correction
plus a small additive probe — near-empty queues, hence the low tail
latency it is known for.  Both update on an ``update_us`` timer (one
control decision per RTT-scale window), not per tick.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from ..core.dcqcn import DcqcnConfig, DcqcnRate

CC_ALGOS = ("dcqcn", "timely", "hpcc")


@dataclasses.dataclass
class CcConfig:
    """Per-flow congestion-control selection + shared knob set.

    One dataclass covers all three algorithms so a sweep grid can vary
    ``algo`` per point while holding the rest fixed; irrelevant knobs
    are simply unread (DCQCN reads only ``dcqcn``/``min_rate_gbps``).
    """
    algo: str = "dcqcn"
    min_rate_gbps: float = 0.1
    # propagation-only RTT of the path (us): the floor the queueing
    # delay signal is added onto, and HPCC's T in qlen/(B*T)
    base_rtt_us: float = 8.0
    # control-decision period for the delay/INT loops (us)
    update_us: float = 16.0
    # -- Timely knobs --------------------------------------------------
    t_low_us: float = 12.0        # below: additive increase regardless
    t_high_us: float = 40.0       # above: multiplicative decrease
    timely_beta: float = 0.8      # MD strength
    timely_add_gbps: float = 2.0  # AI step
    timely_ewma: float = 0.5      # gradient EWMA gain
    # -- HPCC knobs ----------------------------------------------------
    hpcc_eta: float = 0.95        # target per-hop utilization
    hpcc_ai_gbps: float = 1.0     # additive probe (W_AI)
    # DCQCN parameter override; None = per-line-rate defaults
    dcqcn: Optional[DcqcnConfig] = None

    def __post_init__(self) -> None:
        if self.algo not in CC_ALGOS:
            raise ValueError(f"unknown cc algo {self.algo!r}; "
                             f"pick one of {CC_ALGOS}")
        if self.base_rtt_us <= 0.0 or self.update_us <= 0.0:
            raise ValueError("base_rtt_us and update_us must be positive")
        if not (0.0 < self.t_low_us <= self.t_high_us):
            raise ValueError("need 0 < t_low_us <= t_high_us")
        if not (0.0 < self.hpcc_eta <= 1.0):
            raise ValueError("hpcc_eta must be in (0, 1]")

    def code(self) -> int:
        """Integer algorithm code for stacked per-point parameters."""
        return CC_ALGOS.index(self.algo)


class TimelyRate:
    """Delay-gradient rate control (Timely-style).

    Once per ``update_us`` window the smoothed RTT gradient (normalized
    by ``base_rtt_us``) picks the branch — the exact arithmetic the
    vector engines replicate with ``where`` lanes:

    * ``rtt < t_low``: additive increase (no congestion possible);
    * ``rtt > t_high``: multiplicative decrease proportional to the
      overshoot, ``rc *= 1 - beta * (1 - t_high/rtt)``;
    * gradient <= 0: delay falling — additive increase;
    * gradient > 0: delay rising — ``rc *= max(0, 1 - beta * grad)``.
    """

    def __init__(self, cfg: CcConfig, line_rate_gbps: float):
        self.cfg = cfg
        self.line = line_rate_gbps
        self.rc = line_rate_gbps
        self.prev_rtt_us = cfg.base_rtt_us
        self.rtt_diff_us = 0.0
        self._t_us = 0.0

    def advance(self, dt_us: float) -> float:
        return self.rc

    def on_cnp(self) -> None:
        pass

    def on_signal(self, rtt_us: float, util: float, dt_us: float) -> None:
        c = self.cfg
        self._t_us += dt_us
        if self._t_us < c.update_us:
            return
        self._t_us = 0.0
        diff = rtt_us - self.prev_rtt_us
        self.prev_rtt_us = rtt_us
        self.rtt_diff_us = (1.0 - c.timely_ewma) * self.rtt_diff_us \
            + c.timely_ewma * diff
        grad = self.rtt_diff_us / c.base_rtt_us
        if rtt_us < c.t_low_us:
            r = self.rc + c.timely_add_gbps
        elif rtt_us > c.t_high_us:
            r = self.rc * (1.0 - c.timely_beta * (1.0 - c.t_high_us
                                                  / rtt_us))
        elif grad <= 0.0:
            r = self.rc + c.timely_add_gbps
        else:
            r = self.rc * max(0.0, 1.0 - c.timely_beta * grad)
        self.rc = min(self.line, max(c.min_rate_gbps, r))


class HpccRate:
    """Utilization-targeting rate control (HPCC-style INT).

    Once per ``update_us`` window the max per-hop utilization ``U``
    (from :meth:`on_signal`) is driven toward ``eta``: multiplicative
    correction ``rc *= clip(eta/U, 0.5, 2.0)`` plus the additive probe
    ``hpcc_ai_gbps``.  The clip bounds one decision's swing (HPCC's
    per-ack correction is similarly bounded by its reference window).
    """

    def __init__(self, cfg: CcConfig, line_rate_gbps: float):
        self.cfg = cfg
        self.line = line_rate_gbps
        self.rc = line_rate_gbps
        self._t_us = 0.0

    def advance(self, dt_us: float) -> float:
        return self.rc

    def on_cnp(self) -> None:
        pass

    def on_signal(self, rtt_us: float, util: float, dt_us: float) -> None:
        c = self.cfg
        self._t_us += dt_us
        if self._t_us < c.update_us:
            return
        self._t_us = 0.0
        mult = c.hpcc_eta / max(util, 0.01)
        mult = min(max(mult, 0.5), 2.0)
        self.rc = min(self.line,
                      max(c.min_rate_gbps, self.rc * mult + c.hpcc_ai_gbps))


CongestionControl = Union[DcqcnRate, TimelyRate, HpccRate]


def make_controller(cc: Optional[CcConfig],
                    line_rate_gbps: float) -> CongestionControl:
    """Build the per-flow rate machine a :class:`CcConfig` selects.

    ``None`` (or ``algo="dcqcn"`` without an override) keeps today's
    per-line-rate DCQCN defaults, so existing scenarios are untouched.
    """
    if cc is None or cc.algo == "dcqcn":
        dcfg = cc.dcqcn if cc is not None and cc.dcqcn is not None \
            else DcqcnConfig(line_rate_gbps=line_rate_gbps)
        return DcqcnRate(dcfg)
    if cc.algo == "timely":
        return TimelyRate(cc, line_rate_gbps)
    return HpccRate(cc, line_rate_gbps)
