"""Multi-host discrete-event driver: senders -> Clos switches -> receivers.

Per 1 us fluid tick (same timebase as the single-host simulator):

0. scheduled link failures fire (in-flight bytes on a dead link are
   dropped and re-credited — fluid go-back-N) and the routing layer
   resolves each cross-leaf flow's spine choice / spray split from
   per-uplink queue depth and link up/down state
   (:mod:`repro_torch.fabric.routing`; ``static_ecmp`` keeps the
   frozen next hops of the static route);
1. every flow's DCQCN machine offers bytes into its host NIC queue;
2. queues forward in tier order (host->leaf, leaf->spine, and on
   3-level fabrics spine->super-spine, super-spine->spine, then
   spine->leaf, leaf->host), so an uncongested byte traverses the
   fabric in one tick — the cut-through limit, which keeps a
   1-sender/1-receiver fabric numerically equivalent to
   ``repro_torch.core.run_sim``;
3. each receiver's :class:`ReceiverHost` advances one tick on the arrived
   bytes; its CNPs (RNIC watermark / Jet escape ECN) and the ECN marks the
   switches stamped on departing bytes are converted into per-flow CNPs
   that throttle exactly the offending senders;
4. switch ports refresh per-TC PFC xoff/xon state; a paused
   ``(ingress link, tc)`` pair stalls that class's flows on that link
   next tick.  With ``SwitchConfig.per_tc`` (the default) pause is
   per-priority, so a congested class no longer head-of-line-blocks the
   other classes sharing the link; with ``per_tc=False`` every flow
   rides TC 0 and the legacy whole-link pause (congestion spreading,
   §2.1) is reproduced exactly.

Outputs one :class:`~repro_torch.core.simulator.SimResult` per receiver plus
fabric-level metrics: per-flow goodput, victim-flow goodput, pause-frame
fan-out and incast completion time.

Forwarding uses *batch-fluid* semantics: all bytes arriving at an output
port within one tick stage are enqueued as a single batch (proportional
buffer-space allocation, one ECN-knee decision against the pre-batch
occupancy) rather than flow-by-flow in container iteration order.  A
fluid-model tick has no intra-tick arrival order, so this is the faithful
semantics — and it is what makes the tick body expressible as fixed
tensor operations, which :mod:`repro_torch.fabric.vector` exploits to
advance whole scenario grids at once on the card.  This driver is host
code in Python floats: it takes no device and makes no tensor, and it is
the grid engine's scalar oracle.  With a single flow per batch (e.g. the
1-sender/1-receiver equivalence anchor) it reduces exactly to the
sequential semantics.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..core.datapath import N_QOS, QoS
from ..core.simulator import SimConfig, SimResult, testbed_100g
from .cc import CcConfig
from .faults import (FaultConfig, FlowRecovery, corrupt_hash, fault_hash,
                     flap_down_now, flap_edge, has_pause_cycle, link_salt,
                     loss_threshold)
from .hosts import ReceiverHost, SenderHost
from .messages import MessageConfig, MessageTracker, exact_percentile
from .routing import (RoutingConfig, adaptive_pick, flowlet_hash,
                      spray_weights, weighted_pick)
from .switch import OutputPort, PauseKey, Switch, SwitchConfig
from .topology import LinkKey, Topology


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
    #                                          + switch traffic class (per-TC
    #                                          queues, SwitchConfig.per_tc)
    # burst-train source: (on_us, off_us) duty cycle — the flow offers
    # bytes only during the on-phase (OLTP client trains); None = always on
    on_off_us: Optional[Tuple[float, float]] = None
    # per-flow NP->RP CNP propagation delay override; None falls back to
    # FabricConfig.cnp_delay_us
    cnp_delay_us: Optional[float] = None
    # op-granular message layer (verbs WRITE/SEND, outstanding window,
    # per-message latency percentiles); None falls back to
    # FabricConfig.msg, and None there means plain fluid bytes
    msg: Optional[MessageConfig] = None
    # congestion-control selection (dcqcn / timely / hpcc); None falls
    # back to FabricConfig.cc, and None there means per-line-rate DCQCN
    cc: Optional[CcConfig] = None


def burst_done_bytes(burst_bytes: float) -> float:
    """Delivered-bytes threshold at which a closed flow counts as complete.

    Fluid go-back-N never delivers the *last* byte sharply: once drops or
    RNIC backpressure kick in, the remaining bytes decay geometrically, so
    "time of the final 1e-6 bytes" is log-sensitive to the threshold and
    numerically meaningless.  A closed flow therefore completes at 99.99%
    delivery — discrete wire traffic would have finished in one more MTU —
    which both the scalar driver and the grid engine can place to
    within a tick of each other.
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
    # CNP propagation delay NP -> RP (us): a congestion notification
    # generated at the receiver (escape-ladder ECN, RNIC watermark, paced
    # switch marks) cuts its sender's DCQCN rate this many microseconds
    # later.  0.0 = same-tick delivery.
    cnp_delay_us: float = 0.0
    # per-tick path selection over the spine candidates (static ECMP,
    # flowlet-weighted ECMP, adaptive least-congested, packet spray) —
    # see repro_torch.fabric.routing.  static_ecmp freezes each flow's
    # hashed spine for the whole run.
    routing: RoutingConfig = dataclasses.field(default_factory=RoutingConfig)
    # fabric-wide message-layer / congestion-control defaults (per-flow
    # Flow.msg / Flow.cc override); None keeps plain fluid bytes and
    # per-line-rate DCQCN
    msg: Optional[MessageConfig] = None
    cc: Optional[CcConfig] = None
    # fault injection + loss recovery (repro_torch.fabric.faults).  None
    # injects nothing and engages no ledger; any FaultConfig — even an
    # all-zero one — also engages the RTO/retransmit ledger for every
    # flow carrying a MessageConfig (MessageConfig.recovery picks
    # go-back-N vs IRN-style selective)
    faults: Optional[FaultConfig] = None


@dataclasses.dataclass
class FabricResult:
    per_host: Dict[str, SimResult]
    flow_goodput_gbps: Dict[int, float]
    flow_delivered_bytes: Dict[int, float]
    flow_completion_us: Dict[int, float]     # closed flows; inf if unfinished
    flow_tags: Dict[int, str]
    incast_completion_us: float              # max over tag=="incast" flows
    victim_goodput_gbps: float               # mean over tag=="victim" flows;
    #                                          0.0 when has_victim is False
    pause_link_us: Dict[LinkKey, float]      # link paused in >=1 TC
    pause_fanout: int                        # distinct links ever paused
    ecn_marked_bytes: float
    switch_dropped_bytes: float
    has_victim: bool = False                 # any tag=="victim" flow present
    # per-priority pause breakdown: (link, tc) -> paused microseconds.
    # With per-TC queues a pause stalls one class on one ingress link;
    # summing over links per tc gives the class-level pause budget.
    pause_tc_us: Dict[PauseKey, float] = \
        dataclasses.field(default_factory=dict)
    # routing-layer observability: fraction of each leaf->spine uplink's
    # capacity-time actually carried, and how often flows changed spine
    # (0 everywhere under static_ecmp)
    uplink_util: Dict[LinkKey, float] = \
        dataclasses.field(default_factory=dict)
    flow_reroutes: Dict[int, int] = dataclasses.field(default_factory=dict)
    reroute_count: int = 0
    # message layer (flows with a MessageConfig): exact per-message
    # completion latencies in completion order, per flow
    msg_latency_us: Dict[int, List[float]] = \
        dataclasses.field(default_factory=dict)
    msg_last_done_us: Dict[int, float] = \
        dataclasses.field(default_factory=dict)
    has_messages: bool = False               # any flow ran the op layer
    sim_us: float = 0.0                      # simulated horizon
    # fault layer (FabricConfig.faults) — graceful-degradation metrics.
    # dropped_pkts counts fault-injected drops only (stochastic loss,
    # corruption, flap/fail in-flight kills, crash discards, go-back-N
    # duplicate discards) in MTU units; buffer tail drops stay in
    # switch_dropped_bytes as before
    dropped_pkts: float = 0.0
    retransmit_bytes: float = 0.0            # recovery-ledger re-credits
    # crashed host -> us from crash to first post-restart accepted byte
    # (inf if it never recovered within the horizon)
    crash_recovery_us: Dict[str, float] = \
        dataclasses.field(default_factory=dict)
    deadlock_ticks: int = 0                  # ticks with a cyclic per-TC
    #                                          pause dependency (same
    #                                          watchdog in every engine)
    # routing-aware PFC-storm observability: per-TC count of distinct
    # ingress links ever paused, against the candidate ingress sets the
    # routing layer could steer through (OutputPort.static_ingress /
    # the grid engine's prev-mat)
    pause_tc_fanout: Dict[int, int] = dataclasses.field(default_factory=dict)
    n_pausable_links: int = 0
    # links whose failure window covered the whole horizon: they carried
    # nothing and could pause nothing, so they are excluded from the
    # pause_storm denominator (at aggregation) and from the
    # uplink_imbalance mean — a dead uplink is a wiring fact, not a
    # load-balance signal.  Flapping links keep some up-time and stay in.
    dead_links: Set[LinkKey] = dataclasses.field(default_factory=set)

    def pause_storm(self) -> float:
        """PFC-storm severity: the worst traffic class's pause fan-out
        as a fraction of the candidate ingress links it *could* pause
        under the active routing mode (links down for the entire window
        are excluded from the denominator — they can never pause).
        1.0 = some class paused every candidate ingress at least once;
        0.0 (never NaN) when nothing paused or the fabric has no
        pausable links — same contract as :meth:`uplink_imbalance`."""
        if not self.pause_tc_fanout or self.n_pausable_links <= 0:
            return 0.0
        return max(self.pause_tc_fanout.values()) / self.n_pausable_links

    def _msg_pool(self, tag: Optional[str]) -> List[float]:
        return [v for fid, vals in self.msg_latency_us.items()
                if tag is None or self.flow_tags[fid] == tag
                for v in vals]

    def msg_percentile(self, q: float, tag: Optional[str] = None) -> float:
        """Exact nearest-rank percentile of message latency pooled over
        all message flows (optionally one tag).  0.0 (never NaN) when no
        messages completed — check :attr:`has_messages` to tell "no op
        layer" apart from "nothing finished", same contract as
        :meth:`tagged_goodput`."""
        return exact_percentile(self._msg_pool(tag), q)

    def msg_count(self, tag: Optional[str] = None) -> int:
        """Completed messages pooled over message flows."""
        return len(self._msg_pool(tag))

    def msg_rate_mops(self, tag: Optional[str] = None) -> float:
        """Completed message ops per microsecond == Mops; 0.0 (never
        NaN) when nothing completed or the horizon is empty."""
        n = self.msg_count(tag)
        return n / self.sim_us if self.sim_us > 0.0 and n else 0.0

    def uplink_imbalance(self) -> float:
        """Load-balance quality: max/mean utilization over the fabric
        uplinks that had any up-time (an idle-but-alive uplink is
        imbalance — perfect spraying scores 1.0, everything piled on
        one of N uplinks scores N — but a link that was down for the
        whole window is wiring, not imbalance, and is excluded).  0.0
        (never NaN) when the fabric has no live uplinks or carried
        nothing, so sweep summaries can aggregate it unconditionally —
        same contract as :meth:`tagged_goodput`."""
        vals = [u for lk, u in self.uplink_util.items()
                if lk not in self.dead_links]
        if not vals:
            return 0.0
        mean = sum(vals) / len(vals)
        return max(vals) / mean if mean > 0.0 else 0.0

    def has_tag(self, tag: str) -> bool:
        return any(t == tag for t in self.flow_tags.values())

    def tagged_goodput(self, tag: str) -> float:
        """Mean goodput over flows with ``tag``; 0.0 (not NaN) when no flow
        carries the tag, so fleet summaries that average over scenarios
        never silently absorb a NaN — check :meth:`has_tag` to tell "no
        such flows" apart from "flows starved to zero"."""
        vals = [g for fid, g in self.flow_goodput_gbps.items()
                if self.flow_tags[fid] == tag]
        return sum(vals) / len(vals) if vals else 0.0


def run_fabric(topo: Topology, flows: List[Flow],
               fcfg: Optional[FabricConfig] = None) -> FabricResult:
    fcfg = fcfg or FabricConfig()
    topo.validate()
    dt = fcfg.dt_us
    ticks = int(fcfg.sim_time_s * 1e6 / dt)

    # -- build components ---------------------------------------------------
    rcfg = fcfg.routing
    F = len(flows)
    fail_ticks = topo.failure_ticks(dt)
    if any(fcfg.receiver_cfg(h).host_pfc_per_tc
           for h in sorted({f.dst for f in flows})) \
            and not fcfg.switch.per_tc:
        # the receiver's per-class gate pauses (access link, tc) pairs;
        # with a single-queue legacy switch those classes don't exist on
        # the wire, and silently falling back to the whole-link gate
        # would diverge from the per-class watermark arithmetic
        raise ValueError("host_pfc_per_tc requires SwitchConfig.per_tc")
    # dynamic-routing land: per-tick spine selection and/or link-failure
    # events (scheduled windows or flap cycles).  Static ECMP without
    # failures takes the frozen next_hop fast path below.
    flaps = topo.flap_ticks(dt)
    dyn = rcfg.is_dynamic or bool(fail_ticks) or bool(flaps)

    # per-flow message-layer / CC resolution (Flow overrides FabricConfig)
    msg_of: List[Optional[MessageConfig]] = [f.msg or fcfg.msg
                                             for f in flows]
    cc_of: List[Optional[CcConfig]] = [f.cc or fcfg.cc for f in flows]
    trackers: Dict[int, MessageTracker] = {
        fid: MessageTracker(m) for fid, m in enumerate(msg_of)
        if m is not None}
    # delay/INT telemetry is only computed when a non-DCQCN controller
    # is present (DCQCN ignores it; skipping keeps the legacy path
    # byte-identical and cheap)
    need_cc = any(c is not None and c.algo != "dcqcn" for c in cc_of)
    cc_flow_ids = [fid for fid in range(F)
                   if cc_of[fid] is not None
                   and cc_of[fid].algo != "dcqcn"]
    bpt = 1e9 / 8.0 * dt * 1e-6                    # bytes per Gbps*tick

    senders: Dict[int, SenderHost] = {}
    next_hop: Dict[Tuple[str, int], str] = {}      # (node, fid) -> next node
    cross_flows: List[int] = []                    # rerouteable flow ids
    flow_leaves: Dict[int, Tuple[str, str]] = {}   # fid -> (src, dst leaf)
    cur_spine: Dict[int, int] = {}                 # current candidate index
    route_frac: Dict[int, Dict[str, float]] = {}   # fid -> {spine: frac}
    # rerouteable flows only: the wired candidate structure.  cand_of is
    # the first-hop spine per candidate (what the routing layer picks
    # between); cand_paths_of the full interior node path per candidate
    # — on a 3-level fabric choosing the pod spine chooses the plane, so
    # everything below the source leaf is frozen per candidate.
    cand_of: Dict[int, List[str]] = {}
    cand_paths_of: Dict[int, List[List[str]]] = {}
    flow_reroutes: Dict[int, int] = {fid: 0 for fid in range(F)}
    for fid, f in enumerate(flows):
        nodes = topo.route(f.src, f.dst, fid)      # validates + static path
        sl, dl = topo.host_leaf[f.src], topo.host_leaf[f.dst]
        flow_leaves[fid] = (sl, dl)
        next_hop[(f.src, fid)] = sl
        if sl == dl:
            next_hop[(sl, fid)] = f.dst
        else:
            next_hop[(dl, fid)] = f.dst
            paths = topo.candidate_paths(f.src, f.dst)
            cands = [p[1] for p in paths]
            deep = any(len(p) > 3 for p in paths)  # transits super-spines
            if rcfg.is_dynamic or (dyn and not deep):
                # the leaf->spine hop is resolved per tick (or could be,
                # under a failure schedule): freeze every hop *below*
                # the source leaf on every candidate path and let the
                # drain fall through to route_frac at the leaf
                if len(set(cands)) != len(cands):
                    raise ValueError(
                        "dynamic routing needs a unique candidate path "
                        "per first-hop spine; this fabric has several "
                        "super-spines per plane — use static_ecmp or "
                        "sspines_per_plane=1")
                for p in paths:
                    for a, b in zip(p[1:], p[2:]):
                        next_hop[(a, fid)] = b
                cross_flows.append(fid)
                cand_of[fid] = cands
                cand_paths_of[fid] = paths
                k0 = fid % len(cands)
                cur_spine[fid] = k0
                route_frac[fid] = {cands[k0]: 1.0}
            else:
                # static route (including failure schedules on 3-level
                # fabrics): freeze the chosen path end to end
                for a, b in zip(nodes[1:], nodes[2:]):
                    next_hop[(a, fid)] = b
        senders[fid] = SenderHost(
            line_rate_gbps=topo.access_gbps(f.src),
            offered_gbps=f.offered_gbps, burst_bytes=f.burst_bytes,
            start_us=f.start_us, on_off_us=f.on_off_us,
            cc=cc_of[fid],
            op_cap_gbps=(msg_of[fid].op_rate_gbps
                         if msg_of[fid] is not None else None))

    recv_hosts = sorted({f.dst for f in flows})
    receivers: Dict[str, ReceiverHost] = {
        h: ReceiverHost(fcfg.receiver_cfg(h), sim_ticks=ticks)
        for h in recv_hosts}

    # host NIC egress queues (source-side backlog onto the access link);
    # NICs never ECN-mark their own egress — only switches do
    nic_cfg = dataclasses.replace(fcfg.switch, ecn_enabled=False)
    nic_ports: Dict[str, OutputPort] = {}
    for f in flows:
        if f.src not in nic_ports:
            nic_ports[f.src] = OutputPort(
                topo.link(f.src, topo.host_leaf[f.src]), nic_cfg)
    switches: Dict[str, Switch] = {}
    for name in topo.leaves + topo.spines + topo.super_spines:
        out = [l for l in topo.links.values() if l.src == name]
        switches[name] = Switch(name, out, fcfg.switch)
    port_by_link: Dict[LinkKey, OutputPort] = {
        p.link.key: p for p in nic_ports.values()}
    for sw in switches.values():
        for p in sw.ports.values():
            port_by_link[p.link.key] = p

    if dyn:
        # pause targeting in dynamic-routing land covers the whole
        # candidate ingress set of every queued flow (mixed provenance
        # under spraying/rerouting; see OutputPort.static_ingress)
        ingress: Dict[LinkKey, Dict[int, Tuple[LinkKey, ...]]] = {}
        for fid, f in enumerate(flows):
            sl, dl = flow_leaves[fid]
            acc = (f.src, sl)
            if sl == dl:
                ingress.setdefault((sl, f.dst), {})[fid] = (acc,)
            elif fid in cand_paths_of:
                last_hops = []
                for p in cand_paths_of[fid]:
                    prev = acc
                    for a, b in zip(p, p[1:]):
                        ingress.setdefault((a, b), {})[fid] = (prev,)
                        prev = (a, b)
                    last_hops.append(prev)
                ingress.setdefault((dl, f.dst), {})[fid] = \
                    tuple(last_hops)
            else:
                # frozen end-to-end route (static mode under a failure
                # schedule on a 3-level fabric): exact chain provenance
                prev = acc
                node = sl
                while node != dl:
                    nh = next_hop[(node, fid)]
                    ingress.setdefault((node, nh), {})[fid] = (prev,)
                    prev = (node, nh)
                    node = nh
                ingress.setdefault((dl, f.dst), {})[fid] = (prev,)
        for lk, m in ingress.items():
            port_by_link[lk].static_ingress = m

    # spray reorder settling: sprayed arrivals wait settle_ticks before
    # entering receiver admission (per-flow ring, 0 = pass-through)
    settle_ticks = int(round(rcfg.spray_settle_us / dt)) \
        if rcfg.mode == "spray" else 0
    Hs = settle_ticks + 1
    if settle_ticks:
        cross_set = set(cross_flows)
        settle_f = [settle_ticks if fid in cross_set else 0
                    for fid in range(F)]
        ring_b = [[0.0] * Hs for _ in range(F)]
        ring_m = [[0.0] * Hs for _ in range(F)]

    # per-uplink carried bytes (load-balance observability): leaf->spine
    # everywhere, plus spine->super-spine on 3-level fabrics
    uplink_tx: Dict[LinkKey, float] = {
        l.key: 0.0 for l in topo.fabric_uplinks()}

    # routing-step invariants: decision constants and the cross-leaf
    # flows grouped by (source leaf, dest leaf) — uplink occupancy is a
    # per-pair candidate read and the up-mask a per-pair read, not
    # per-flow.  pair_info carries the shared candidate structure: the
    # first-hop spines and each candidate's interior link chain (the
    # whole chain must be up for the candidate to count as up).
    route_buf = float(fcfg.switch.port_buffer_bytes)
    route_hyst = rcfg.hysteresis_frac * route_buf
    leaf_pairs: Dict[Tuple[str, str], List[int]] = {}
    pair_info: Dict[Tuple[str, str],
                    Tuple[List[str], List[List[LinkKey]]]] = {}
    for fid in cross_flows:
        pr = flow_leaves[fid]
        leaf_pairs.setdefault(pr, []).append(fid)
        if pr not in pair_info:
            paths = cand_paths_of[fid]
            pair_info[pr] = (cand_of[fid],
                             [list(zip(p, p[1:])) for p in paths])

    # flowlet bookkeeping (weighted_ecmp): a flow opens a new flowlet —
    # and re-hashes — on its first NIC injection after an idle gap
    # longer than flowlet_gap_us; a continuously-backlogged flow is one
    # flowlet and keeps its spine until the path dies
    flet_track = rcfg.mode == "weighted_ecmp" and bool(cross_flows)
    flet_gap = max(1, int(round(rcfg.flowlet_gap_us / dt)))
    flet_last = {fid: -(1 << 30) for fid in cross_flows}  # last active tick
    flet_k = {fid: 0 for fid in cross_flows}              # flowlet index
    flet_boundary: Set[int] = set()

    # switch traffic class of each flow: the QoS class selects the
    # per-TC queue along the route; legacy per-link mode collapses
    # everything onto TC 0 (one queue, one watermark — the whole-link
    # pause behaviour)
    tc_of = [int(f.qos) if fcfg.switch.per_tc else 0 for f in flows]

    # -- fault layer (repro_torch.fabric.faults) -----------------------------
    flt = fcfg.faults
    # recovery ledgers: engaged per flow iff a FaultConfig is attached
    # AND the flow runs the message layer; every other flow keeps the
    # fluid core's instant drop-re-credit via lose()
    recovery: Dict[int, FlowRecovery] = {}
    if flt is not None:
        for fid, m in enumerate(msg_of):
            if m is not None:
                recovery[fid] = FlowRecovery.from_msg(m, dt)

    def lose(fid: int, b: float) -> None:
        """Route dropped bytes: into the flow's retransmit ledger when
        recovery is engaged, else instantly re-credited (go-back-N of
        the fluid core) when ``recovery`` is empty."""
        rec = recovery.get(fid)
        if rec is None:
            senders[fid].credit(b)
        else:
            rec.on_loss(b)

    # stochastic loss: one counter-based hash per (link, tick); the
    # whole drained batch drops when it fires (fluid burst loss), so
    # the expected byte-loss fraction equals the configured rate.  The
    # corruption stream models CRC failures at the receiving NIC and
    # only applies to receiver access links.
    flt_loss = flt is not None and flt.any_loss
    if flt_loss:
        salt_of = {lk: link_salt(lk[0], lk[1], flt.seed)
                   for lk in port_by_link}
        loss_thr = {lk: loss_threshold(flt.rate_for(*lk))
                    for lk in port_by_link}
        corr_thr = {lk: (loss_threshold(flt.corrupt_rate)
                         if lk[1] in receivers else 0)
                    for lk in port_by_link}
    # NIC/host crash--restart windows in tick space
    crash_win: Dict[str, Tuple[int, int]] = {}
    if flt is not None:
        for h, (a_us, r_us) in flt.crashes.items():
            if h not in receivers:
                raise ValueError(f"crash scheduled on {h!r}, which is "
                                 "not a receiver in this run")
            at = max(0, int(round(a_us / dt)))
            crash_win[h] = (at, max(at + 1, int(round(r_us / dt))))
    crash_rec_us: Dict[str, float] = {}     # first post-restart byte
    flt_dropped = 0.0                       # fault-injected drops, bytes
    deadlock_ticks = 0
    prog_set: Set[int] = set()              # flows delivered-to this tick

    # candidate ingress links that PFC could ever pause (the routing-
    # aware denominator of FabricResult.pause_storm): every flow's
    # access link plus, cross-leaf, every interior link of each
    # candidate path (all candidates in dynamic-routing land, the
    # frozen path under static ECMP) — the scalar twin of the grid
    # engine's prev-mat
    pausable: Set[LinkKey] = set()
    for fid, f in enumerate(flows):
        sl, dl = flow_leaves[fid]
        pausable.add((f.src, sl))
        if sl == dl:
            continue
        if fid in cand_paths_of:
            for p in cand_paths_of[fid]:
                pausable.update(zip(p, p[1:]))
        else:
            node = sl
            while node != dl:
                nh = next_hop[(node, fid)]
                pausable.add((node, nh))
                node = nh

    # -- per-flow CNP pacing at the receiver NP (DCQCN) ----------------------
    cnp_accum_us = {fid: math.inf for fid in senders}   # immediate first CNP
    marked_backlog = {fid: 0.0 for fid in senders}
    # CNP propagation: a notification generated at tick t cuts its sender
    # at t + delay ticks; the delay is per flow (Flow.cnp_delay_us
    # overriding FabricConfig.cnp_delay_us), so pending notifications
    # live in a min-heap on due tick (insertion order breaks ties)
    cnp_delay_ticks = {
        fid: max(0, int(round(
            (f.cnp_delay_us if f.cnp_delay_us is not None
             else fcfg.cnp_delay_us) / dt)))
        for fid, f in enumerate(flows)}
    pending_cnps: List[Tuple[int, int, int]] = []       # (due, seq, fid)
    cnp_seq = 0
    flows_by_dst: Dict[str, List[int]] = {}
    for fid, f in enumerate(flows):
        flows_by_dst.setdefault(f.dst, []).append(fid)
    # heaviest recently-arriving flow per receiver: the CNP target while
    # the access link is paused and nothing arrives (run_sim always
    # delivers receiver CNPs to its sender; the fabric must too)
    last_heavy: Dict[str, Optional[int]] = {}

    delivered = {fid: 0.0 for fid in senders}
    completion = {fid: math.inf for fid in senders}
    # per-tick drained bytes per link — the txRate leg of the HPCC-style
    # INT signal (only maintained when a delay/INT controller is active)
    tick_tx: Dict[LinkKey, float] = {}
    pause_link_us: Dict[LinkKey, float] = {}
    pause_tc_us: Dict[PauseKey, float] = {}
    # (ingress link -> paused TC set) as of the previous tick's PFC pass
    paused_by_link: Dict[LinkKey, frozenset] = {}
    _no_tcs: frozenset = frozenset()

    hosts_set = set(topo.hosts)
    Batches = Dict[Tuple[str, str], List[Tuple[int, float, float,
                                               Optional[LinkKey], int]]]

    def flush(batches: Batches) -> None:
        """Enqueue one stage's accumulated arrivals, one batch per
        destination port; tail-dropped bytes are re-credited to their
        senders (fluid go-back-N retransmission) or, with recovery
        engaged, wait in the retransmit ledger."""
        for (sw, dst), items in batches.items():
            for fid, lost in switches[sw].ports[dst] \
                    .enqueue_batch(items).items():
                lose(fid, lost)

    def drain_stage(ports, arrivals, batches: Batches,
                    down_now: frozenset, t: int) -> float:
        """Drain ``ports`` [(owner switch or None, port)]; forwarded bytes
        land in next-hop ``batches``, host-bound bytes in ``arrivals``.
        Dead links forward nothing; a cross-leaf flow without a frozen
        next hop is split over ``route_frac`` (this tick's routing).
        Returns the bytes killed by stochastic loss/corruption."""
        killed = 0.0
        for owner, port in ports:
            lk = port.link.key
            if lk in down_now:
                continue
            dst = port.link.dst
            to_host = dst in hosts_set
            # stochastic faults: when the per-(link, tick) hash fires,
            # everything this port drains this tick is lost on the wire
            # (ECN marks ride the bytes and die with them)
            drop_link = False
            if flt_loss:
                drop_link = fault_hash(t, salt_of[lk]) < loss_thr[lk]
                if not drop_link and corr_thr[lk]:
                    drop_link = corrupt_hash(t, salt_of[lk]) < corr_thr[lk]
            # switch-side PFC is per (link, tc); the receiver-side RNIC
            # gate pauses its whole access link, or — with
            # host_pfc_per_tc — only the congested admission classes
            port.paused_tcs = paused_by_link.get(lk, _no_tcs)
            port.paused = False
            if to_host and dst in receivers:
                rx = receivers[dst]
                if rx.cfg.pfc_enabled:
                    if rx.cfg.host_pfc_per_tc:   # implies switch.per_tc
                        port.paused_tcs = \
                            port.paused_tcs | rx.paused_classes
                    else:
                        port.paused = rx.pfc_paused
            track = lk in uplink_tx
            for fid, b, m in port.drain(dt):
                if drop_link:
                    lose(fid, b)
                    killed += b
                    continue
                if track:
                    uplink_tx[lk] += b
                if need_cc:
                    tick_tx[lk] = tick_tx.get(lk, 0.0) + b
                if to_host:
                    cur = arrivals.setdefault(dst, {}) \
                        .setdefault(fid, [0.0, 0.0])
                    cur[0] += b
                    cur[1] += m
                else:
                    nh = next_hop.get((dst, fid))
                    if nh is not None:
                        batches.setdefault((dst, nh), []) \
                            .append((fid, b, m, lk, tc_of[fid]))
                    else:
                        for sp_name, fr in route_frac[fid].items():
                            batches.setdefault((dst, sp_name), []) \
                                .append((fid, b * fr, m * fr, lk,
                                         tc_of[fid]))
        return killed

    # the forwarding stages of one tick, in traversal order; a port
    # drains once per tick, after every same-tick upstream stage has
    # deposited into it (cut-through: an uncongested byte crosses the
    # whole fabric in one tick).  On a 2-tier fabric the super-spine
    # stages are empty and the spine-down stage is exactly the old
    # all-spine-port stage; on a 3-level fabric a spine's super-spine-
    # facing ports drain before the super-spines and its leaf-facing
    # ports after, so cross-pod bytes still cross in one tick.
    sspine_set = set(topo.super_spines)
    stage_nic = [(None, p) for p in nic_ports.values()]
    stage_up = [(leaf, p) for leaf in topo.leaves
                for p in switches[leaf].ports.values()
                if p.link.dst not in hosts_set]
    stage_s_up = [(sp, p) for sp in topo.spines
                  for p in switches[sp].ports.values()
                  if p.link.dst in sspine_set]
    stage_ss = [(ss, p) for ss in topo.super_spines
                for p in switches[ss].ports.values()]
    stage_s_down = [(sp, p) for sp in topo.spines
                    for p in switches[sp].ports.values()
                    if p.link.dst not in sspine_set]
    stage_down = [(leaf, p) for leaf in topo.leaves
                  for p in switches[leaf].ports.values()
                  if p.link.dst in hosts_set]
    stages = [st for st in (stage_nic, stage_up, stage_s_up, stage_ss,
                            stage_s_down, stage_down) if st]

    _no_links: frozenset = frozenset()
    for t in range(ticks):
        now_us = (t + 1) * dt
        # ---- 0. link failure / flap / crash events ------------------------ #
        down_now = _no_links
        if fail_ticks or flaps:
            down = {lk for lk, (a, u) in fail_ticks.items() if a <= t < u}
            edges = [lk for lk, (a, _) in fail_ticks.items() if a == t]
            for lk, (s0, per, dn) in flaps.items():
                if flap_down_now(t, s0, per, dn):
                    down.add(lk)
                if flap_edge(t, s0, per):
                    edges.append(lk)
            down_now = frozenset(down)
            for lk in edges:
                port = port_by_link.get(lk)
                if port is not None:
                    # in-flight bytes die with the link; fluid
                    # go-back-N (or the recovery ledger) re-credits
                    # them for retransmission
                    for fid, lost in port.drop_all().items():
                        lose(fid, lost)
                        if flt is not None:
                            flt_dropped += lost
        if crash_win:
            for h, (a, _) in crash_win.items():
                if a == t:
                    # the NIC dies: everything queued on the access
                    # link is lost and the receiver's admission state
                    # zeroes; arrivals are discarded until restart
                    port = port_by_link.get((topo.host_leaf[h], h))
                    if port is not None:
                        for fid, lost in port.drop_all().items():
                            lose(fid, lost)
                            flt_dropped += lost
                    receivers[h].crash_reset()
                    last_heavy[h] = None

        # ---- 1. senders inject into their NIC queue ----------------------- #
        # one batch per NIC port: each class's buffer partition is split
        # proportionally over that class's flows (source-side
        # backpressure never overflows the NIC queue, so un-injectable
        # bytes are refunded, not dropped)
        offers: Dict[str, List[Tuple[int, float]]] = {}
        for fid, f in enumerate(flows):
            tr = trackers.get(fid)
            b = senders[fid].offer(
                dt, window_room=(None if tr is None else
                                 tr.window_room_bytes(
                                     senders[fid].injected,
                                     delivered[fid])))
            if b > 0.0:
                offers.setdefault(f.src, []).append((fid, b))
        nic_take: Dict[int, float] = {}
        for host, items in offers.items():
            port = nic_ports[host]
            by_tc: Dict[int, List[Tuple[int, float]]] = {}
            for fid, b in items:
                by_tc.setdefault(tc_of[fid], []).append((fid, b))
            batch = []
            for tc, tc_items in by_tc.items():
                space = max(0.0, fcfg.switch.port_buffer_bytes
                            - port.tc_bytes(tc))
                total = sum(b for _, b in tc_items)
                scale = 1.0 if total <= space else space / total
                for fid, b in tc_items:
                    take = b if scale >= 1.0 else b * scale
                    senders[fid].injected -= b - take
                    nic_take[fid] = take
                    batch.append((fid, take, 0.0, None, tc))
            port.enqueue_batch(batch)
        if flet_track:
            # flowlet boundaries open on the first injection after an
            # idle gap; the flowlet index advances with the boundary so
            # the re-hash below draws a fresh deterministic hash
            flet_boundary.clear()
            for fid in cross_flows:
                if nic_take.get(fid, 0.0) > 0.0:
                    if t - flet_last[fid] > flet_gap:
                        flet_boundary.add(fid)
                        flet_k[fid] += 1
                    flet_last[fid] = t

        # ---- 1.5 routing layer: per-tick candidate selection -------------- #
        if rcfg.is_dynamic and cross_flows:
            occ_of_pair: Dict[Tuple[str, str], List[float]] = {}
            for (sl, dl), pair_fids in leaf_pairs.items():
                cands, plinks = pair_info[(sl, dl)]
                nc = len(cands)
                occ = occ_of_pair.get((sl, dl))
                if occ is None:
                    up_ports = switches[sl].ports
                    occ = occ_of_pair[(sl, dl)] = \
                        [up_ports[s].queued_bytes for s in cands]
                up = [all(lk not in down_now for lk in plinks[i])
                      for i in range(nc)]
                for fid in pair_fids:
                    cur = cur_spine[fid]
                    if rcfg.mode == "adaptive":
                        new = adaptive_pick(occ, up, cur, route_hyst)
                    elif rcfg.mode == "weighted_ecmp":
                        # a flowlet boundary (idle gap exceeded — see
                        # step 1) or a dead current path re-hashes onto
                        # the free-space-weighted candidate distribution
                        new = cur
                        if fid in flet_boundary or not up[cur]:
                            w = [max(route_buf - occ[i], 0.0)
                                 if up[i] else 0.0 for i in range(nc)]
                            if sum(w) > 0.0:
                                new = weighted_pick(
                                    w, flowlet_hash(fid, flet_k[fid]))
                    else:                                   # spray
                        new = cur
                        fr = spray_weights(occ, up, route_buf, cur)
                        route_frac[fid] = {cands[i]: fr[i]
                                           for i in range(nc)
                                           if fr[i] > 0.0}
                    if new != cur:
                        flow_reroutes[fid] += 1
                        cur_spine[fid] = new
                    if rcfg.mode != "spray":
                        route_frac[fid] = {cands[new]: 1.0}

        # ---- 2. tier-ordered forwarding ----------------------------------- #
        arrivals: Dict[str, Dict[int, List[float]]] = {}
        if need_cc:
            tick_tx.clear()
        for stage in stages:
            batches: Batches = {}
            flt_dropped += drain_stage(stage, arrivals, batches,
                                       down_now, t)
            flush(batches)

        # ---- 2.2 congestion signals: path delay + INT utilization --------- #
        # end-of-forwarding queue state along each flow's current path,
        # converted into the two telemetry channels the CC zoo consumes:
        # rtt = base + sum(queue/drain-budget) and util = max per-hop
        # HPCC-style (txRate/B + qlen/(B*T)).  Same arithmetic, same
        # read point as the grid engine's masked lanes.
        if need_cc:
            for fid in cc_flow_ids:
                c = cc_of[fid]
                f = flows[fid]
                sl, dl = flow_leaves[fid]
                if sl == dl:
                    path = (nic_ports[f.src], switches[sl].ports[f.dst])
                else:
                    # walk the flow's current frozen chain below its
                    # first hop (2-tier: leaf->spine->leaf->host;
                    # 3-level adds the super-spine transit)
                    hop = cand_of[fid][cur_spine[fid]] \
                        if fid in cur_spine else next_hop[(sl, fid)]
                    ports = [nic_ports[f.src], switches[sl].ports[hop]]
                    node = hop
                    while node != f.dst:
                        nh = next_hop[(node, fid)]
                        ports.append(switches[node].ports[nh])
                        node = nh
                    path = tuple(ports)
                qd = 0.0
                util = 0.0
                for port in path:
                    budget = port.link.gbps * bpt
                    q = port.queued_bytes
                    qd += q / budget
                    u = (tick_tx.get(port.link.key, 0.0)
                         + q * (dt / c.base_rtt_us)) / budget
                    if u > util:
                        util = u
                senders[fid].on_signal(c.base_rtt_us + qd * dt, util, dt)

        # ---- 2.5 spray reorder settling ----------------------------------- #
        if settle_ticks:
            slot = t % Hs
            for fid in range(F):
                ring_b[fid][slot] = 0.0
                ring_m[fid][slot] = 0.0
            for host, arr in arrivals.items():
                for fid, (b, m) in arr.items():
                    ring_b[fid][slot] = b
                    ring_m[fid][slot] = m
            arrivals = {}
            for fid, f in enumerate(flows):
                rs = (t - settle_f[fid]) % Hs
                b = ring_b[fid][rs]
                if b > 0.0:
                    arrivals.setdefault(f.dst, {})[fid] = \
                        [b, ring_m[fid][rs]]

        # ---- 3. receivers advance; CNPs route back ------------------------ #
        for host, rx in receivers.items():
            arr = arrivals.get(host, {})
            # fault layer: a crashed host discards everything on its
            # access link until restart; a gapped go-back-N window
            # discards out-of-order arrivals as duplicates (both feed
            # the retransmit ledger / instant re-credit via lose())
            cw = crash_win.get(host)
            if cw is not None and cw[0] <= t < cw[1] and arr:
                for fid, (b, _) in arr.items():
                    lose(fid, b)
                    flt_dropped += b
                arr = {}
            if recovery and arr:
                for fid in list(arr):
                    rec = recovery.get(fid)
                    if rec is not None and rec.gapped:
                        b = arr[fid][0]
                        rec.on_arrival(b)    # dup: discarded + ledgered
                        flt_dropped += b
                        del arr[fid]
            # arrivals enter the datapath's QoS admission classes: RNIC
            # buffer space is granted in priority order, so a LOW-class
            # bulk flow can no longer crowd out a HIGH-class one
            per_class = [0.0] * N_QOS
            for fid, (b, _) in arr.items():
                per_class[flows[fid].qos] += b
            total = sum(per_class)
            fb = rx.step(per_class)
            if cw is not None and t >= cw[1] and fb.accepted > 0.0 \
                    and host not in crash_rec_us:
                # first byte accepted after restart: recovery latency
                crash_rec_us[host] = now_us - cw[0] * dt
            if total > 0.0:
                acc = fb.accepted_qos or [0.0] * N_QOS
                share = [acc[q] / per_class[q] if per_class[q] > 0.0
                         else 0.0 for q in range(N_QOS)]
                for fid, (b, _) in arr.items():
                    d = b * share[flows[fid].qos]
                    delivered[fid] += d
                    # RNIC tail-drops are retransmitted too (fluid RC)
                    lose(fid, b - d)
                    if recovery and d > 0.0:
                        prog_set.add(fid)
                    f = flows[fid]
                    if (f.burst_bytes is not None
                            and math.isinf(completion[fid])
                            and delivered[fid]
                            >= burst_done_bytes(f.burst_bytes)):
                        completion[fid] = now_us
            # receiver-generated CNPs (escape-ladder ECN + RNIC watermark)
            # hit the heaviest arriving flow; with the access link paused
            # (arr empty) they fall back to the most recent heavy flow so
            # senders stay throttled during pauses, as in run_sim
            if arr:
                # deterministic tie-break (lowest flow id), independent of
                # arrival-dict insertion order — the grid engine's argmax
                # resolves ties the same way
                last_heavy[host] = max(sorted(arr), key=lambda i: arr[i][0])
            heavy = last_heavy.get(host)
            if fb.cnps and heavy is not None:
                for _ in range(fb.cnps):
                    heapq.heappush(pending_cnps,
                                   (t + cnp_delay_ticks[heavy], cnp_seq,
                                    heavy))
                    cnp_seq += 1
            # switch ECN marks -> per-flow CNPs, paced per DCQCN NP; the
            # pacing clock runs for every flow of this receiver, so marks
            # owed to a stalled/paused flow still convert on schedule
            for fid, (_, m) in arr.items():
                marked_backlog[fid] += m
            interval = rx.cfg.cnp_interval_us
            for fid in flows_by_dst.get(host, ()):
                cnp_accum_us[fid] += dt
                if marked_backlog[fid] > 0.0 and \
                        cnp_accum_us[fid] >= interval:
                    cnp_accum_us[fid] = 0.0
                    marked_backlog[fid] = 0.0
                    heapq.heappush(pending_cnps,
                                   (t + cnp_delay_ticks[fid], cnp_seq, fid))
                    cnp_seq += 1
        # deliver CNPs whose propagation delay has elapsed (same tick
        # when the flow's delay is 0 — the sender's rate machine is only
        # read at the next tick's offer, so end-of-tick delivery is exact)
        while pending_cnps and pending_cnps[0][0] <= t:
            _, _, fid = heapq.heappop(pending_cnps)
            senders[fid].on_cnp()

        # ---- 3.5 message layer: starts / completions this tick ------------ #
        # end-of-tick cumulative counters (post re-credit): a message
        # starts when injected bytes cross its threshold, completes when
        # delivered bytes do — go-back-N losses stretch exactly the
        # open messages' latency
        for fid, tr in trackers.items():
            tr.observe(now_us, senders[fid].injected, delivered[fid],
                       start_us=t * dt)

        # ---- 3.7 retransmit timers (fault layer) -------------------------- #
        # after the message observe: both engines record this tick's
        # latencies against the pre-fire injected count, and the
        # re-credit reopens the sender's tap from the next offer on
        if recovery:
            for fid, rec in recovery.items():
                credit = rec.tick(fid in prog_set)
                if credit > 0.0:
                    senders[fid].credit(credit)
            prog_set.clear()

        # ---- 4. PFC pause propagation ------------------------------------- #
        paused_pairs: Set[PauseKey] = set()
        for sw in switches.values():
            paused_pairs |= sw.update_pfc()
        if flt is not None and paused_pairs \
                and has_pause_cycle(paused_pairs):
            deadlock_ticks += 1
        by_link: Dict[LinkKey, Set[int]] = {}
        for lk, tc in paused_pairs:
            by_link.setdefault(lk, set()).add(tc)
            pause_tc_us[(lk, tc)] = pause_tc_us.get((lk, tc), 0.0) + dt
        paused_by_link = {lk: frozenset(tcs) for lk, tcs in by_link.items()}
        for lk in paused_by_link:
            pause_link_us[lk] = pause_link_us.get(lk, 0.0) + dt

    # -- aggregate ----------------------------------------------------------
    sim_us = ticks * dt
    per_host = {h: rx.finalize() for h, rx in receivers.items()}
    goodput = {fid: delivered[fid] * 8.0 / (sim_us * 1e-6) / 1e9
               for fid in delivered}
    tags = {fid: f.tag for fid, f in enumerate(flows)}
    incast = [completion[fid] for fid, f in enumerate(flows)
              if f.tag == "incast" and f.burst_bytes is not None]
    victims = [goodput[fid] for fid, f in enumerate(flows)
               if f.tag == "victim"]
    uplink_util = {}
    for lk, tx in uplink_tx.items():
        cap = topo.links[lk].gbps * 1e9 / 8.0 * (sim_us * 1e-6)
        uplink_util[lk] = tx / cap if cap > 0.0 else 0.0
    pause_tc_fanout: Dict[int, int] = {}
    for (lk, tc) in pause_tc_us:
        pause_tc_fanout[tc] = pause_tc_fanout.get(tc, 0) + 1
    # links down for the entire window carried nothing and could pause
    # nothing: drop them from the storm denominator and let
    # uplink_imbalance() skip them (flaps always leave some up-time)
    dead_links = {lk for lk, (a, u) in fail_ticks.items()
                  if a <= 0 and u >= ticks}
    return FabricResult(
        per_host=per_host,
        flow_goodput_gbps=goodput,
        flow_delivered_bytes=dict(delivered),
        flow_completion_us=dict(completion),
        flow_tags=tags,
        incast_completion_us=max(incast) if incast else float("nan"),
        victim_goodput_gbps=(sum(victims) / len(victims)
                             if victims else 0.0),
        has_victim=bool(victims),
        pause_link_us=pause_link_us,
        pause_tc_us=pause_tc_us,
        pause_fanout=len(pause_link_us),
        ecn_marked_bytes=sum(s.marked_bytes() for s in switches.values()),
        switch_dropped_bytes=sum(s.dropped_bytes()
                                 for s in switches.values())
        + sum(p.dropped_bytes for p in nic_ports.values()),
        uplink_util=uplink_util,
        flow_reroutes=dict(flow_reroutes),
        reroute_count=sum(flow_reroutes.values()),
        msg_latency_us={fid: tr.latencies for fid, tr in trackers.items()},
        msg_last_done_us={fid: tr.last_done_us
                          for fid, tr in trackers.items()},
        has_messages=bool(trackers),
        sim_us=sim_us,
        dropped_pkts=(flt_dropped / flt.mtu_bytes
                      if flt is not None else 0.0),
        retransmit_bytes=sum(r.retx_bytes for r in recovery.values()),
        crash_recovery_us={h: crash_rec_us.get(h, math.inf)
                           for h in crash_win},
        deadlock_ticks=deadlock_ticks,
        pause_tc_fanout=pause_tc_fanout,
        n_pausable_links=len(pausable - dead_links),
        dead_links=dead_links,
    )
