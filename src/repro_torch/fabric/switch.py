"""Output-queued switch model with per-traffic-class queues, ECN and PFC.

Fluid model.  Each output port owns one FIFO *per traffic class* (TC —
the fabric reuses the receiver's :class:`repro_torch.core.datapath.QoS`
classes, so ``N_TC == N_QOS``), with

* a per-TC ECN knee: departures of a class are marked once *that class's*
  queue is past the knee (DCTCP-style, knee evaluated on enqueue);
* per-TC PFC xoff/xon watermarks: a congested class asserts pause toward
  exactly the ``(ingress link, tc)`` pairs feeding it, so a paused HIGH
  class no longer stalls LOW traffic sharing the same ingress link — the
  per-priority pause granularity real Clos fabrics run (802.1Qbb), which
  the paper's PFC fan-out / HoL measurements assume (§2, §6);
* inter-class scheduling on the shared link budget: strict priority
  (HIGH drains first — the default) or deficit-weighted round robin
  (``SwitchConfig.scheduler="wrr"``): the budget is water-filled across
  backlogged classes proportionally to per-TC quanta, so a saturated
  port can no longer starve LOW — at the cost of HIGH's absolute
  priority.  Both are pro rata across flows within a class (fluid
  approximation of per-class FIFO);
* per-class buffer space: every class owns a full ``port_buffer_bytes``
  worth of queue memory (the static per-priority-group partition real
  802.1Qbb switches reserve so a paused class cannot squeeze the
  others' headroom); tail drop and the xoff/xon watermark fractions are
  evaluated against the class's own partition.

The legacy per-link behaviour (one FIFO per port, pause stalls the whole
ingress link) is exactly the special case "all traffic in one class":
the driver maps every flow to TC 0 when ``SwitchConfig.per_tc`` is
False, which keeps the congestion-spreading pathology (§2.1) available
as a comparison baseline.

The ports here are the scalar driver's (:func:`repro_torch.fabric
.fabric.run_fabric`), host objects in Python floats; the grid engine
(:mod:`repro_torch.fabric.vector`) holds the same queues stacked and
drains them through the strict-priority water-fill kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.datapath import N_QOS
from .topology import Link, LinkKey

N_TC = N_QOS                      # switch queues mirror the QoS classes

# (ingress link, traffic class) — the granularity of a PFC pause frame
PauseKey = Tuple[LinkKey, int]


@dataclasses.dataclass
class SwitchConfig:
    port_buffer_bytes: int = 4 << 20
    ecn_enabled: bool = True
    ecn_kmin_frac: float = 0.10       # mark departures once queue > kmin
    pfc_enabled: bool = False
    pfc_xoff_frac: float = 0.60       # assert pause above this occupancy
    pfc_xon_frac: float = 0.30        # release below this occupancy
    # classed queues (per-TC ECN knees + per-priority PFC).  False =
    # legacy per-link behaviour: every flow rides TC 0, one knee, one
    # watermark pair, and a pause stalls the whole ingress link.
    per_tc: bool = True
    # inter-class drain discipline: "strict" (priority ladder, HIGH
    # first — the default) or "wrr" (deficit-
    # weighted round robin by ``wrr_quanta``, so LOW keeps a weighted
    # share of a saturated port instead of starving)
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


@dataclasses.dataclass
class _FlowQ:
    bytes: float = 0.0
    marked: float = 0.0               # ECN-marked subset of ``bytes``


_NO_TCS: frozenset = frozenset()


class OutputPort:
    """One output port: per-TC FIFOs with per-flow byte accounting, ECN
    and per-priority PFC watermarks, drop + pause accounting."""

    def __init__(self, link: Link, cfg: SwitchConfig):
        self.link = link
        self.cfg = cfg
        # per-TC FIFO: tc -> {fid -> _FlowQ}; within a class, dict
        # insertion order is the (fluid) FIFO order
        self.tcq: List[Dict[int, _FlowQ]] = [{} for _ in range(N_TC)]
        # which ingress link each queued flow arrived on (pause targeting)
        self.flow_ingress: Dict[int, Optional[LinkKey]] = {}
        # candidate-ingress override (dynamic routing): flow -> every
        # ingress link that may feed it here.  When set, pause targets
        # cover the whole candidate set — a sprayed/rerouted flow's
        # queued bytes have mixed provenance, so per-arrival tracking
        # would under-pause; the grid engine's static prev-port
        # incidence implements the same semantics.
        self.static_ingress: Optional[Dict[int, Tuple[LinkKey, ...]]] = None
        self.paused = False           # whole-link pause (receiver gate)
        self.paused_tcs: frozenset = _NO_TCS   # downstream per-TC pause
        self.tc_asserted = [False] * N_TC      # this port's per-TC xoff
        self.dropped_bytes = 0.0
        self.marked_bytes = 0.0
        self.pause_us = 0.0
        self.peak_bytes = 0.0
        # running totals: queued_bytes is read per (flow, tick) by the
        # fabric hot loop, so summing the dicts there would be O(flows^2)
        self._tc_bytes = [0.0] * N_TC
        self._total_bytes = 0.0

    @property
    def queued_bytes(self) -> float:
        return self._total_bytes

    def tc_bytes(self, tc: int) -> float:
        return self._tc_bytes[tc]

    @property
    def pause_asserted(self) -> bool:
        """Any class asserting xoff (legacy single-flag view)."""
        return any(self.tc_asserted)

    @property
    def flows(self) -> Dict[int, _FlowQ]:
        """Merged per-flow view across classes (stats / introspection)."""
        merged: Dict[int, _FlowQ] = {}
        for q in self.tcq:
            merged.update(q)
        return merged

    def enqueue(self, fid: int, nbytes: float, marked: float,
                in_link: Optional[LinkKey], tc: int = 0) -> float:
        """Queue up to the buffer limit; returns the bytes dropped (tail
        drop — the fabric re-credits them to the sender, i.e. fluid
        go-back-N retransmission).  Exactly a single-item
        :meth:`enqueue_batch`."""
        if nbytes <= 0.0:
            return 0.0
        return self.enqueue_batch([(fid, nbytes, marked, in_link, tc)]) \
            .get(fid, 0.0)

    def enqueue_batch(
            self,
            items: List[Tuple[int, float, float, Optional[LinkKey], int]],
    ) -> Dict[int, float]:
        """Queue one tick's simultaneous arrivals ``[(fid, bytes, marked,
        in_link, tc)]`` as a single fluid batch: each class's buffer
        partition is allocated proportionally to that class's offered
        bytes, and each class's ECN knee is evaluated once against that
        class's pre-batch occupancy, so the outcome is independent of
        the order arrivals are listed in.  Returns ``{fid: dropped
        bytes}``."""
        tot_tc = [0.0] * N_TC
        for _, b, _, _, tc in items:
            if b > 0.0:
                tot_tc[tc] += b
        if not any(t > 0.0 for t in tot_tc):
            return {}
        buf = self.cfg.port_buffer_bytes
        scale_tc = [1.0] * N_TC
        for tc in range(N_TC):
            if tot_tc[tc] <= 0.0:
                continue
            space = max(0.0, buf - self._tc_bytes[tc])
            if tot_tc[tc] > space:
                scale_tc[tc] = space / tot_tc[tc]
        # one knee decision per class against the pre-batch occupancy
        mark_tc = [self.cfg.ecn_enabled and
                   self._tc_bytes[tc] > self.cfg.kmin_frac(tc) * buf
                   for tc in range(N_TC)]
        dropped: Dict[int, float] = {}
        for fid, b, m, in_link, tc in items:
            if b <= 0.0:
                continue
            take = b if scale_tc[tc] >= 1.0 else b * scale_tc[tc]
            lost = b - take
            if lost > 0.0:
                self.dropped_bytes += lost
                dropped[fid] = dropped.get(fid, 0.0) + lost
            if take <= 0.0:
                continue
            mk = m * (take / b)
            if mark_tc[tc]:
                self.marked_bytes += take - mk
                mk = take
            fq = self.tcq[tc].setdefault(fid, _FlowQ())
            fq.bytes += take
            fq.marked += mk
            self._tc_bytes[tc] += take
            self._total_bytes += take
            self.flow_ingress[fid] = in_link
        self.peak_bytes = max(self.peak_bytes, self._total_bytes)
        return dropped

    def _wrr_fracs(self, budget: float) -> List[float]:
        """Per-class drained fraction under deficit-weighted round robin:
        the link budget is water-filled over backlogged unpaused classes
        proportionally to ``wrr_quanta`` (a class that drains fully
        releases its leftover to the others).  Unrolled to ``N_TC``
        rounds with the exact op order of the grid engine, so its
        float64 run and this driver make identical grants."""
        quanta = self.cfg.quanta()
        rem = list(self._tc_bytes)
        for tc in self.paused_tcs:
            rem[tc] = 0.0
        alloc = [0.0] * N_TC
        budget_left = budget
        for _ in range(N_TC):
            act = [tc for tc in range(N_TC) if rem[tc] > 0.0]
            if budget_left <= 0.0 or not act:
                break
            wsum = 0.0
            for tc in act:
                wsum += quanta[tc]
            b0 = budget_left
            spent = 0.0
            for tc in act:
                take = min(b0 * quanta[tc] / wsum, rem[tc])
                alloc[tc] += take
                rem[tc] -= take
                spent += take
            budget_left = b0 - spent
            if budget_left < 1e-6 * budget:   # relative crumb clamp, as
                budget_left = 0.0             # in the strict ladder
        return [alloc[tc] / self._tc_bytes[tc]
                if self._tc_bytes[tc] > 0.0 else 0.0
                for tc in range(N_TC)]

    def drain(self, dt_us: float) -> List[Tuple[int, float, float]]:
        """Forward up to rate*dt bytes; returns [(fid, bytes, marked)].

        Inter-class discipline per ``SwitchConfig.scheduler`` — strict
        priority (TC 0 first) or weighted round robin — pro rata across
        flows within a class; paused classes keep their bytes and do not
        consume link budget."""
        if self.paused or self.paused_tcs:
            self.pause_us += dt_us
            if self.paused:
                return []
        if self._total_bytes <= 0.0:
            return []
        budget = self.link.gbps * 1e9 / 8.0 * dt_us * 1e-6
        budget_left = budget
        wrr = self._wrr_fracs(budget) \
            if self.cfg.scheduler == "wrr" else None
        out: List[Tuple[int, float, float]] = []
        for tc in range(N_TC):
            total = self._tc_bytes[tc]
            if total <= 0.0 or tc in self.paused_tcs:
                continue
            frac = min(1.0, budget_left / total) if wrr is None \
                else wrr[tc]
            q = self.tcq[tc]
            for fid, fq in list(q.items()):
                b = fq.bytes * frac
                m = fq.marked * frac
                fq.bytes -= b
                fq.marked -= m
                self._tc_bytes[tc] -= b
                self._total_bytes -= b
                if fq.bytes < 1e-9:
                    self._tc_bytes[tc] -= fq.bytes
                    self._total_bytes -= fq.bytes
                    del q[fid]
                if b > 0.0:
                    out.append((fid, b, m))
            budget_left -= total * frac
            # leftover budget below 1e-6 of the link budget is rounding
            # crumb (budget - frac * total when a class eats the whole
            # budget); granting it to the next class would forward
            # micro-byte trickles that downstream convert into full-size
            # discrete events (ECN marks -> CNPs).  The clamp is
            # *relative* so float32 and float64 engines make the same
            # grant/no-grant decision, keeping the priority ladder
            # deterministic across backends.
            if budget_left < 1e-6 * budget:
                budget_left = 0.0
            self._tc_bytes[tc] = max(0.0, self._tc_bytes[tc])
        self._total_bytes = max(0.0, self._total_bytes)
        return out

    def drop_all(self) -> Dict[int, float]:
        """Drop everything queued (the link just died): clears every
        class, counts the bytes as drops and returns ``{fid: bytes}`` so
        the caller can re-credit senders (fluid go-back-N retransmission
        over whatever path routing picks next)."""
        lost: Dict[int, float] = {}
        for q in self.tcq:
            for fid, fq in q.items():
                if fq.bytes > 0.0:
                    lost[fid] = lost.get(fid, 0.0) + fq.bytes
                    self.dropped_bytes += fq.bytes
            q.clear()
        self._tc_bytes = [0.0] * N_TC
        self._total_bytes = 0.0
        return lost

    def update_pfc(self) -> None:
        if not self.cfg.pfc_enabled:
            return
        buf = self.cfg.port_buffer_bytes
        for tc in range(N_TC):
            q_frac = self._tc_bytes[tc] / buf
            if self.tc_asserted[tc]:
                if q_frac < self.cfg.xon_frac(tc):
                    self.tc_asserted[tc] = False
            elif q_frac > self.cfg.xoff_frac(tc):
                self.tc_asserted[tc] = True

    def pause_targets(self) -> Set[PauseKey]:
        """``(ingress link, tc)`` pairs this port wants paused: only the
        ingress links of flows actually queued in an over-watermark
        class — PFC's per-priority granularity (802.1Qbb).  With a
        ``static_ingress`` candidate map (dynamic routing), every
        ingress link that may feed a queued flow is targeted."""
        out: Set[PauseKey] = set()
        for tc in range(N_TC):
            if not self.tc_asserted[tc]:
                continue
            for fid in self.tcq[tc]:
                if self.static_ingress is not None:
                    for lk in self.static_ingress.get(fid, ()):
                        out.add((lk, tc))
                else:
                    lk = self.flow_ingress.get(fid)
                    if lk is not None:
                        out.add((lk, tc))
        return out


class Switch:
    """A named switch owning one OutputPort per outgoing link."""

    def __init__(self, name: str, out_links: List[Link], cfg: SwitchConfig):
        self.name = name
        self.cfg = cfg
        self.ports: Dict[str, OutputPort] = {
            l.dst: OutputPort(l, cfg) for l in out_links}

    def enqueue(self, out_dst: str, fid: int, nbytes: float, marked: float,
                in_link: Optional[LinkKey], tc: int = 0) -> float:
        """Returns bytes tail-dropped at the output port."""
        return self.ports[out_dst].enqueue(fid, nbytes, marked, in_link, tc)

    def update_pfc(self) -> Set[PauseKey]:
        """Refresh per-port per-TC xoff/xon state; returns the
        ``(ingress link, tc)`` pairs to pause."""
        targets: Set[PauseKey] = set()
        for p in self.ports.values():
            p.update_pfc()
            targets |= p.pause_targets()
        return targets

    # -- stats ----------------------------------------------------------------
    def dropped_bytes(self) -> float:
        return sum(p.dropped_bytes for p in self.ports.values())

    def marked_bytes(self) -> float:
        return sum(p.marked_bytes for p in self.ports.values())

    def queued_bytes(self) -> float:
        return sum(p.queued_bytes for p in self.ports.values())
