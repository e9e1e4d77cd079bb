"""Routing policy of a fabric scenario: per-tick spine choice.

The spine choice of every cross-leaf flow is resolved per tick from a
:class:`RoutingConfig`:

``static_ecmp``
    spine = ``flow_id % n_spines``, frozen for the whole run.
``weighted_ecmp``
    Flowlet-level re-hash: when a flow resumes injecting after an idle
    gap longer than ``flowlet_gap_us``, or at once when its current path
    dies, it re-picks a spine by a deterministic hash weighted by each
    uplink's free buffer space.
``adaptive``
    Per-tick least-congested uplink with a hysteresis guard: the flow
    moves only when the best candidate's queue is more than
    ``hysteresis_frac * port_buffer`` bytes shorter than its current
    one's (or the current path is down).
``spray``
    Per-tick proportional byte split across all up spines (weights =
    free buffer space); sprayed arrivals wait ``spray_settle_us`` before
    receiver admission (the reorder cost).

The helpers below are pure and deterministic (integer hashing,
first-minimum tie-breaks), the scalar statement of each decision;
:mod:`repro_torch.fabric.vector` makes the same decisions in stacked
``[G, S, F]`` form every tick (``flowlet_hashes``, ``adaptive_choice``,
``weighted_choice``, ``spray_split``), and the tests hold each stacked
form to its helper here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

ROUTING_MODES = ("static_ecmp", "weighted_ecmp", "adaptive", "spray")


@dataclasses.dataclass
class RoutingConfig:
    """Per-fabric routing policy (one mode per scenario / grid point)."""
    mode: str = "static_ecmp"
    # weighted_ecmp: idle gap between injections that opens a flowlet
    flowlet_gap_us: float = 50.0
    # adaptive: move only when the best uplink queue is this fraction of
    # the port buffer shorter than the current one
    hysteresis_frac: float = 0.05
    # spray: reorder-settling delay before sprayed arrivals are admitted
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

    def mode_code(self) -> int:
        """Integer code for stacked per-point parameters (vector engine)."""
        return ROUTING_MODES.index(self.mode)


def flowlet_hash(fid: int, k: int) -> float:
    """Deterministic hash of (flow id, flowlet index) into [0, 1).

    Integer arithmetic that stays inside int32 for the engine's reduced
    ``k``; x / 65536 is a power-of-two scale, exact in float32 and
    float64 alike."""
    return (((fid + 1) * 40503 + k * 9973) % 65536) / 65536.0


def weighted_pick(weights: Sequence[float], h: float) -> int:
    """First index whose cumulative weight exceeds ``h * total``.

    ``h`` in [0, 1); the sequential cumulative sum hits the last
    positively weighted index even under rounding (the vector engine
    thresholds against its cumsum's own last element for the same
    reason).  The caller guarantees ``sum(weights) > 0``."""
    tot = 0.0
    for w in weights:
        tot += w
    thresh = h * tot
    acc = 0.0
    for i, w in enumerate(weights):
        acc += w
        if acc > thresh:
            return i
    return len(weights) - 1


def adaptive_pick(occ: Sequence[float], up: Sequence[bool], cur: int,
                  hyst_bytes: float) -> int:
    """Least-congested up candidate, with hysteresis against flapping:
    stays on ``cur`` unless it is down or the best candidate's queue is
    more than ``hyst_bytes`` shorter.  First minimum on ties, as
    ``argmin``."""
    best, bocc = -1, math.inf
    for i, o in enumerate(occ):
        if up[i] and o < bocc:
            best, bocc = i, o
    if best < 0:                       # every candidate is down: stuck
        return cur
    if up[cur] and not (bocc < occ[cur] - hyst_bytes):
        return cur
    return best


def spray_weights(occ: Sequence[float], up: Sequence[bool],
                  buffer_bytes: float, cur: int) -> List[float]:
    """Proportional byte split across up candidates by free buffer
    space; the current path alone when nothing is up or has room."""
    w = [max(buffer_bytes - occ[i], 0.0) if up[i] else 0.0
         for i in range(len(occ))]
    tot = 0.0
    for x in w:
        tot += x
    if tot <= 0.0:
        return [1.0 if i == cur else 0.0 for i in range(len(occ))]
    return [x / tot for x in w]
