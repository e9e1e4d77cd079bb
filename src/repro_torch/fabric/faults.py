"""Fault injection and loss recovery for the fabric.

Two halves, deliberately split:

**Injection** (`FaultConfig`, the hash helpers): per-link stochastic
loss and receiver-side corruption, link flap schedules (held on
:class:`~repro_torch.fabric.topology.Topology`, generalizing ``fail_link``),
and NIC/host crash--restart events that zero a receiver's admission
state mid-transfer.  All randomness is *counter-based*: a fault fires
iff ``hash(tick, link_salt) < floor(rate * 65536)``, where the salt is
derived from the link name and the config seed at setup time.  The
hash is pure modular int arithmetic (the vector engine evaluates it
in integer tensors with a split-modmul decomposition whose products
stay below 2**31 at any tick count), so these scalar helpers, the CPU
float64 run and the card's float32 run see bit-identical fault
realizations — fault runs stay
equivalence-testable, and per-point fault parameters ride the sweep
axes like every other knob.

**Recovery** (`FlowRecovery`): the sender-side ledger that replaces
the fluid core's instant drop-re-credit when a flow has a message
config and a :class:`FaultConfig` is attached.  Lost bytes accumulate
in the ledger and are re-credited to the sender only when a
retransmission fires: after an RTO with exponential backoff under
``go_back_n`` (where every byte arriving while the receiver window is
gapped is also discarded as a duplicate), or after a short NACK delay
under IRN-style ``selective`` (only the lost span replays; arrivals
keep landing).  This class is the scalar reference semantics — the
vector engines carry the same state machine as ``[G, F]`` arrays.

A small PFC-deadlock watchdog (`has_pause_cycle`) rounds out the
graceful-degradation metrics: it detects cyclic pause dependencies in
the per-TC pause state each tick.  The vector engines run the same
predicate as boolean-matrix squaring over the precomputed pause-pair
graph (``repro_torch.fabric.fused.cycle_flags``), so ``deadlock_ticks`` is
engine-equivalent and rides sweep grids.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Iterable, Optional, Tuple

HASH_MOD = 65536          # hash range; power of two -> exact in f32/f64
_LOSS_MULT = 40503        # tick multiplier, loss stream (routing.py idiom)
_CORRUPT_MULT = 24593     # tick multiplier, corruption stream
_SALT_MULT = 9973


def link_salt(src: str, dst: str, seed: int) -> int:
    """Per-link, per-seed salt in [0, 65536) from the link *name* —
    computable identically at scalar setup and vector pack time."""
    base = zlib.crc32(f"{src}->{dst}".encode()) % HASH_MOD
    return int((base + int(seed) * 7919) % HASH_MOD)


def loss_threshold(rate: float) -> int:
    """``floor(rate * 65536)``: 0.0 never fires, 1.0 always fires."""
    return int(math.floor(float(rate) * HASH_MOD))


def fault_hash(t: int, salt: int) -> int:
    """Counter-based loss hash (vector.py evaluates the same value via
    a high/low split of ``t`` so int32 never overflows)."""
    return ((t + 1) * _LOSS_MULT + (salt + 1) * _SALT_MULT) % HASH_MOD


def corrupt_hash(t: int, salt: int) -> int:
    """Independent stream for receiver-side corruption (CRC fail)."""
    return ((t + 1) * _CORRUPT_MULT + (salt + 1) * _SALT_MULT) % HASH_MOD


def flap_down_now(t: int, start: int, period: int, down: int) -> bool:
    """Is a flapping link down at tick ``t``?  The link repeats a
    ``period``-tick cycle from ``start``: down for the first ``down``
    ticks of each cycle, up for the rest."""
    return t >= start and (t - start) % period < down


def flap_edge(t: int, start: int, period: int) -> bool:
    """First down-tick of a flap cycle (in-flight bytes drop here)."""
    return t >= start and (t - start) % period == 0


@dataclasses.dataclass
class FaultConfig:
    """Stochastic fault injection knobs for one fabric run.

    Attaching any ``FaultConfig`` to ``FabricConfig.faults`` — even an
    all-zero one — also *engages* the recovery ledger for every flow
    that carries a message config (``MessageConfig.recovery`` picks
    go-back-N vs selective); flows without one keep the fluid core's
    instant drop-re-credit.  ``faults=None`` is bit-equal to the
    pre-fault engines.

    - ``loss_rate``: per-tick probability that a link drops everything
      it drained that tick (fluid burst loss; the expected *byte* loss
      fraction equals the rate).  Applied to every link.
    - ``corrupt_rate``: an independent second stream applied only to
      the receiver access links (stage 3) — modeling CRC failures at
      the NIC; same drop effect, different realization.
    - ``link_loss``: per-link ``(src, dst) -> rate`` overrides.
    - ``crashes``: ``host -> (at_us, restart_us)``: at ``at_us`` the
      receiver's in-flight admission state is zeroed and everything
      queued on its access link is dropped; arrivals are discarded
      until ``restart_us``.
    - ``seed`` perturbs every link's hash salt; ``mtu_bytes`` converts
      dropped bytes into the ``dropped_pkts`` metric.
    """

    loss_rate: float = 0.0
    corrupt_rate: float = 0.0
    link_loss: Dict[Tuple[str, str], float] = \
        dataclasses.field(default_factory=dict)
    crashes: Dict[str, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)
    seed: int = 0
    mtu_bytes: float = 4096.0

    def __post_init__(self) -> None:
        for name, r in (("loss_rate", self.loss_rate),
                        ("corrupt_rate", self.corrupt_rate)):
            if not 0.0 <= float(r) <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {r!r}")
        for k, r in self.link_loss.items():
            if not 0.0 <= float(r) <= 1.0:
                raise ValueError(
                    f"link_loss[{k!r}] must be in [0, 1], got {r!r}")
        for host, (at, until) in self.crashes.items():
            if not (0.0 <= at < until):
                raise ValueError(
                    f"crash window for {host!r} needs 0 <= at < "
                    f"restart, got ({at!r}, {until!r})")
        if self.mtu_bytes <= 0:
            raise ValueError(f"mtu_bytes must be > 0, got {self.mtu_bytes!r}")

    def crash(self, host: str, at_us: float,
              restart_us: float) -> "FaultConfig":
        """Schedule a crash--restart window (chainable)."""
        self.crashes[host] = (float(at_us), float(restart_us))
        return self

    def rate_for(self, src: str, dst: str) -> float:
        return float(self.link_loss.get((src, dst), self.loss_rate))

    @property
    def any_loss(self) -> bool:
        return (self.loss_rate > 0.0 or self.corrupt_rate > 0.0
                or any(r > 0.0 for r in self.link_loss.values()))


class FlowRecovery:
    """Per-flow sender-side loss-recovery ledger (scalar reference).

    The fluid analogue of a retransmission queue: ``lost`` bytes wait
    in the ledger; when the timer fires they are re-credited to the
    sender (``injected -= lost``) so the rate machine replays them,
    and counted as ``retransmit_bytes``.  go-back-N gaps the receiver
    window — every byte arriving while gapped is a duplicate of the
    pre-loss prefix, discarded and added to the ledger — and backs the
    RTO off exponentially (``rto_us * backoff**k``, ``k`` capped and
    reset on delivery progress).  Selective (IRN) keeps arrivals and
    replays only the lost span after a fixed NACK delay.

    Timers run in whole ticks; with the default power-of-two backoff
    the deadline arithmetic is exact in float32, so the card's float32
    run fires on the same tick as this class.
    """

    __slots__ = ("sel", "rto_ticks", "nack_ticks", "mult", "cap",
                 "lost", "timer", "k", "gapped", "retx_bytes",
                 "dup_bytes")

    def __init__(self, *, selective: bool, rto_us: float, backoff: float,
                 cap: int, nack_us: float, dt_us: float):
        self.sel = bool(selective)
        self.rto_ticks = max(1, int(round(rto_us / dt_us)))
        self.nack_ticks = max(1, int(round(nack_us / dt_us)))
        self.mult = float(backoff)
        self.cap = int(cap)
        self.lost = 0.0
        self.timer = 0
        self.k = 0
        self.gapped = False
        self.retx_bytes = 0.0
        self.dup_bytes = 0.0

    @classmethod
    def from_msg(cls, mcfg, dt_us: float) -> "FlowRecovery":
        return cls(selective=(mcfg.recovery == "selective"),
                   rto_us=mcfg.rto_us, backoff=mcfg.rto_backoff,
                   cap=mcfg.rto_cap, nack_us=mcfg.nack_us, dt_us=dt_us)

    def on_loss(self, b: float) -> None:
        """Bytes dropped somewhere on the wire for this flow."""
        if b <= 0.0:
            return
        self.lost += b
        if not self.sel:
            self.gapped = True

    def on_arrival(self, b: float) -> float:
        """Bytes reaching the receiver; returns the bytes admitted.
        While a go-back-N window is gapped, everything is a duplicate:
        discarded and appended to the retransmit ledger."""
        if self.gapped and b > 0.0:
            self.dup_bytes += b
            self.lost += b
            return 0.0
        return b

    def deadline_ticks(self) -> int:
        if self.sel:
            return self.nack_ticks
        return int(self.rto_ticks * (self.mult ** min(self.k, self.cap)))

    def tick(self, progressed: bool) -> float:
        """Advance one tick; returns the bytes to re-credit to the
        sender (nonzero exactly when the retransmit timer fires)."""
        if progressed:
            self.k = 0
        if self.lost <= 0.0:
            self.timer = 0
            return 0.0
        self.timer += 1
        if self.timer < self.deadline_ticks():
            return 0.0
        fire = self.lost
        self.lost = 0.0
        self.timer = 0
        self.gapped = False
        if not self.sel:
            self.k = min(self.k + 1, self.cap)
        self.retx_bytes += fire
        return fire


def has_pause_cycle(pairs: Iterable) -> bool:
    """PFC-deadlock watchdog: do the currently-paused ``(link, tc)``
    pairs contain a cyclic pause dependency within any single traffic
    class?  A paused link ``u -> v`` means ``u`` cannot drain until
    ``v`` unpauses it (edge ``u -> v`` in the dependency digraph); a
    cycle is the classic PFC deadlock precondition."""
    by_tc: Dict[int, Dict[str, set]] = {}
    for link, tc in pairs:
        u, v = link[0], link[1]
        by_tc.setdefault(tc, {}).setdefault(u, set()).add(v)
    for adj in by_tc.values():
        color: Dict[str, int] = {}
        for root in list(adj):
            if color.get(root):
                continue
            color[root] = 1
            stack = [(root, iter(adj.get(root, ())))]
            while stack:
                node, it = stack[-1]
                advanced = False
                for nxt in it:
                    c = color.get(nxt, 0)
                    if c == 1:
                        return True
                    if c == 0:
                        color[nxt] = 1
                        stack.append((nxt, iter(adj.get(nxt, ()))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = 2
                    stack.pop()
    return False
