"""Leaf–spine and pod-scale Clos topologies for the multi-host RDCA fabric.

A topology is a set of hosts, leaf switches, spine switches and, at pod
scale, super-spine switches, joined by unidirectional
capacity-annotated links.  :meth:`Topology.route` gives the *static
ECMP* path: a flow hashes onto one of its wired candidate paths
(cross-leaf pairs transit a common spine, cross-pod pairs climb to a
super-spine), an intra-leaf flow turns at its leaf.  The candidate
structure (:meth:`Topology.candidate_spines` /
:meth:`Topology.candidate_paths`) feeds the dynamic routing modes, and
links carry scheduled failure windows (:meth:`Topology.fail_link`) and
periodic flap schedules (:meth:`Topology.flap_link`) on any tier, which
the engine turns into per-tick link state.

Two preset families:

* :func:`clos`: the 2-tier leaf–spine fabric (every leaf wired to every
  spine);
* :func:`make_pod_clos`: a 3-level fabric of ``pods`` pods, each of
  ``leaves_per_pod`` leaves and ``spines_per_pod`` pod-local spines,
  under a super-spine *plane* per pod-spine index (pod spine ``i`` of
  every pod wires to the plane-``i`` super-spines), with per-tier link
  speeds and hence per-tier oversubscription.

Candidate sets are wiring-restricted: a spine is a candidate for a host
pair only if it has links to both endpoints' leaves, and an unroutable
pair raises a clear ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

LinkKey = Tuple[str, str]                  # (src node, dst node)

# failure-schedule sentinel for "never" in integer tick space
NEVER_TICK = 1 << 30


@dataclasses.dataclass(frozen=True)
class Link:
    src: str
    dst: str
    gbps: float

    @property
    def key(self) -> LinkKey:
        return (self.src, self.dst)


@dataclasses.dataclass
class Topology:
    hosts: List[str]
    leaves: List[str]
    spines: List[str]
    links: Dict[LinkKey, Link]             # both directions present
    host_leaf: Dict[str, str]              # host -> its leaf
    # 3-level fabrics only: super-spine tier above the pod spines.  A
    # 2-tier fabric leaves this empty and nothing else changes.
    super_spines: List[str] = dataclasses.field(default_factory=list)
    # pod index per leaf/spine (presets fill this; purely informational
    # for single-pod fabrics)
    pod_of: Dict[str, int] = dataclasses.field(default_factory=dict)
    # scheduled failure windows: link key -> (down_at_us, restore_us);
    # a link is down while down_at_us <= t < restore_us
    link_down: Dict[LinkKey, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)
    # periodic flap schedules (generalized fail_link): link key ->
    # (start_us, period_us, down_us); from start_us the link repeats a
    # period_us cycle — down for the first down_us of each cycle
    link_flaps: Dict[LinkKey, Tuple[float, float, float]] = \
        dataclasses.field(default_factory=dict)

    # -- queries ------------------------------------------------------------
    def link(self, src: str, dst: str) -> Link:
        return self.links[(src, dst)]

    def access_gbps(self, host: str) -> float:
        return self.links[(host, self.host_leaf[host])].gbps

    def uplinks(self, leaf: str) -> List[Link]:
        return [l for l in self.links.values()
                if l.src == leaf and l.dst in self.spines]

    def super_uplinks(self, spine: str) -> List[Link]:
        """Spine -> super-spine links (empty on 2-tier fabrics)."""
        ss = set(self.super_spines)
        return [l for l in self.links.values()
                if l.src == spine and l.dst in ss]

    def fabric_uplinks(self) -> List[Link]:
        """All upward-facing fabric links: leaf->spine on every fabric
        plus spine->super-spine on 3-level fabrics — the link set the
        engines track for uplink utilization/imbalance."""
        out = [l for leaf in self.leaves for l in self.uplinks(leaf)]
        if self.super_spines:
            out += [l for s in self.spines for l in self.super_uplinks(s)]
        return out

    def hosts_on(self, leaf: str) -> List[str]:
        return [h for h in self.hosts if self.host_leaf[h] == leaf]

    def oversubscription(self, leaf: str) -> float:
        """Host-facing bandwidth / spine-facing bandwidth (1.0 = rearrange-
        ably non-blocking, >1 = oversubscribed)."""
        down = sum(self.links[(h, leaf)].gbps for h in self.hosts_on(leaf))
        up = sum(l.gbps for l in self.uplinks(leaf))
        return down / up if up else float("inf")

    def spine_oversubscription(self, spine: str) -> float:
        """Leaf-facing bandwidth / super-spine-facing bandwidth of a pod
        spine — the tier-2 analogue of :meth:`oversubscription`."""
        ss = set(self.super_spines)
        down = sum(l.gbps for l in self.links.values()
                   if l.src == spine and l.dst in self.leaves)
        up = sum(l.gbps for l in self.links.values()
                 if l.src == spine and l.dst in ss)
        return down / up if up else float("inf")

    def bisection_gbps(self) -> float:
        """Aggregate leaf->spine capacity (the fabric's bisection)."""
        return sum(l.gbps for leaf in self.leaves for l in self.uplinks(leaf))

    def candidate_paths(self, src_host: str, dst_host: str) \
            -> List[List[str]]:
        """Interior (leaf..leaf) candidate node paths for a host pair,
        restricted to wired links.  ``[]`` for intra-leaf pairs;
        ``[sl, spine, dl]`` triples when a common spine exists;
        ``[sl, spineA, ss, spineB, dl]`` five-tuples through the
        super-spine tier otherwise.  Raises a clear ``ValueError`` when
        the pair is unroutable (no common spine and no super-spine
        path)."""
        sl, dl = self.host_leaf[src_host], self.host_leaf[dst_host]
        if sl == dl:
            return []
        common = [s for s in self.spines
                  if (sl, s) in self.links and (s, dl) in self.links]
        if common:
            return [[sl, s, dl] for s in common]
        out: List[List[str]] = []
        for ss in self.super_spines:
            ups = [s for s in self.spines
                   if (sl, s) in self.links and (s, ss) in self.links]
            dns = [s for s in self.spines
                   if (ss, s) in self.links and (s, dl) in self.links]
            out += [[sl, sa, ss, sb, dl] for sa in ups for sb in dns]
        if not out:
            raise ValueError(
                f"no spine or super-spine path connects {sl} and {dl} "
                f"(pair {src_host}->{dst_host} is unroutable)")
        return out

    def route(self, src_host: str, dst_host: str, flow_id: int) -> List[str]:
        """Node path for a flow; ECMP picks among the wired candidate
        paths by flow-id hash (on a fully-wired 2-tier Clos this is the
        classic spine = spines[flow_id % n_spines] pick)."""
        if src_host == dst_host:
            raise ValueError("flow endpoints must differ")
        sl = self.host_leaf[src_host]
        if sl == self.host_leaf[dst_host]:
            return [src_host, sl, dst_host]
        paths = self.candidate_paths(src_host, dst_host)
        return [src_host] + paths[flow_id % len(paths)] + [dst_host]

    def route_links(self, src_host: str, dst_host: str,
                    flow_id: int) -> List[Link]:
        nodes = self.route(src_host, dst_host, flow_id)
        return [self.links[(a, b)] for a, b in zip(nodes, nodes[1:])]

    def candidate_spines(self, src_host: str, dst_host: str) -> List[str]:
        """Spines that can carry this pair's traffic (the ECMP candidate
        set a dynamic routing mode chooses from), restricted to spines
        with wired links to *both* endpoints' leaves; empty for
        intra-leaf pairs (which never transit a spine) and for
        cross-pod pairs (whose candidates are super-spine paths — see
        :meth:`candidate_paths`)."""
        sl = self.host_leaf[src_host]
        dl = self.host_leaf[dst_host]
        if sl == dl:
            return []
        return [s for s in self.spines
                if (sl, s) in self.links and (s, dl) in self.links]

    # -- link failure schedule ----------------------------------------------
    def fail_link(self, src: str, dst: str, at_us: float,
                  restore_us: float = math.inf,
                  bidi: bool = True) -> "Topology":
        """Schedule a link failure: ``(src, dst)`` goes down at ``at_us``
        and comes back at ``restore_us`` (default: never).  ``bidi``
        fails the reverse direction too — the physical-link semantics.
        Returns ``self`` for chaining."""
        if (src, dst) not in self.links:
            raise ValueError(f"no link {src}->{dst} to fail")
        if at_us < 0.0 or restore_us <= at_us:
            raise ValueError("need 0 <= at_us < restore_us")
        self.link_down[(src, dst)] = (at_us, restore_us)
        if bidi:
            self.link_down[(dst, src)] = (at_us, restore_us)
        return self

    def flap_link(self, src: str, dst: str, start_us: float,
                  period_us: float, down_us: float,
                  bidi: bool = True) -> "Topology":
        """Schedule a periodic link flap: from ``start_us`` the link
        repeats a ``period_us`` cycle, down for the first ``down_us``
        of each cycle (in-flight bytes drop on every falling edge).
        Returns ``self`` for chaining."""
        if (src, dst) not in self.links:
            raise ValueError(f"no link {src}->{dst} to flap")
        if start_us < 0.0 or not 0.0 < down_us < period_us:
            raise ValueError("need start_us >= 0 and 0 < down_us "
                             "< period_us")
        self.link_flaps[(src, dst)] = (start_us, period_us, down_us)
        if bidi:
            self.link_flaps[(dst, src)] = (start_us, period_us, down_us)
        return self

    def link_up_at(self, key: LinkKey, now_us: float) -> bool:
        w = self.link_down.get(key)
        if w is not None and w[0] <= now_us < w[1]:
            return False
        f = self.link_flaps.get(key)
        if f is not None and now_us >= f[0] \
                and (now_us - f[0]) % f[1] < f[2]:
            return False
        return True

    def failure_ticks(self, dt_us: float) -> Dict[LinkKey,
                                                  Tuple[int, int]]:
        """Failure windows as integer tick indices (down while
        ``at <= t < until``); ``NEVER_TICK`` encodes +inf so every
        engine compares the same int32-safe values."""
        out = {}
        for key, (a, u) in self.link_down.items():
            at = max(0, int(round(a / dt_us)))
            until = NEVER_TICK if math.isinf(u) \
                else max(at + 1, int(round(u / dt_us)))
            out[key] = (at, until)
        return out

    def flap_ticks(self, dt_us: float) -> Dict[LinkKey,
                                               Tuple[int, int, int]]:
        """Flap schedules as integer tick triples ``(start, period,
        down)``; down while ``t >= start and (t - start) % period <
        down`` — the contract every engine shares (see
        :func:`repro_torch.fabric.faults.flap_down_now`)."""
        out = {}
        for key, (s, p, d) in self.link_flaps.items():
            start = max(0, int(round(s / dt_us)))
            period = max(2, int(round(p / dt_us)))
            down = min(period - 1, max(1, int(round(d / dt_us))))
            out[key] = (start, period, down)
        return out

    # -- invariants ----------------------------------------------------------
    def validate(self) -> None:
        names = self.hosts + self.leaves + self.spines + self.super_spines
        if len(set(names)) != len(names):
            raise ValueError("node names must be unique")
        for h in self.hosts:
            leaf = self.host_leaf.get(h)
            if leaf not in self.leaves:
                raise ValueError(f"host {h} not attached to a leaf")
            if (h, leaf) not in self.links or (leaf, h) not in self.links:
                raise ValueError(f"host {h} missing bidirectional access "
                                 "link")
        for (src, dst), l in self.links.items():
            if (l.src, l.dst) != (src, dst):
                raise ValueError(f"link key {src}->{dst} mismatches payload")
            if l.gbps <= 0:
                raise ValueError(f"link {src}->{dst} has non-positive rate")
            if (dst, src) not in self.links:
                raise ValueError(f"link {src}->{dst} has no reverse link")
        # Partial leaf<->spine wiring is legal (the normal case in
        # multi-pod fabrics) — candidate sets are wiring-restricted and
        # route() raises on unroutable pairs.  Structurally we only
        # require each fabric switch to be wired at all.
        spine_set, ss_set = set(self.spines), set(self.super_spines)
        for s in self.spines:
            if not any(l.dst == s and l.src in self.leaves
                       for l in self.links.values()):
                raise ValueError(f"spine {s} not connected to any leaf")
        for ss in self.super_spines:
            if not any(l.dst == ss and l.src in spine_set
                       for l in self.links.values()):
                raise ValueError(f"super-spine {ss} not connected to any "
                                 "spine")
        if ss_set and not spine_set:
            raise ValueError("super-spines require a spine tier")
        if len(self.leaves) > 1 and not self.spines:
            raise ValueError("multi-leaf topology requires spines")
        for key in self.link_down:
            if key not in self.links:
                raise ValueError(f"failure scheduled on unknown link "
                                 f"{key[0]}->{key[1]}")
        for key in self.link_flaps:
            if key not in self.links:
                raise ValueError(f"flap scheduled on unknown link "
                                 f"{key[0]}->{key[1]}")


def _bidi(links: Dict[LinkKey, Link], a: str, b: str, gbps: float) -> None:
    links[(a, b)] = Link(a, b, gbps)
    links[(b, a)] = Link(b, a, gbps)


# --------------------------------------------------------------------------- #
# Presets
# --------------------------------------------------------------------------- #
def clos(n_leaves: int = 2, hosts_per_leaf: int = 4, n_spines: int = 2,
         host_gbps: float = 200.0, uplink_gbps: float = 400.0) -> Topology:
    """Generic two-tier Clos: ``n_leaves`` leaves x ``hosts_per_leaf`` hosts,
    each leaf wired to every spine at ``uplink_gbps``."""
    if n_leaves < 1 or hosts_per_leaf < 1 or n_spines < 0:
        raise ValueError("invalid Clos dimensions")
    hosts, leaves, spines = [], [], []
    links: Dict[LinkKey, Link] = {}
    host_leaf: Dict[str, str] = {}
    for li in range(n_leaves):
        leaf = f"leaf{li}"
        leaves.append(leaf)
        for hi in range(hosts_per_leaf):
            h = f"h{li}_{hi}"
            hosts.append(h)
            host_leaf[h] = leaf
            _bidi(links, h, leaf, host_gbps)
    for si in range(n_spines):
        spine = f"spine{si}"
        spines.append(spine)
        for leaf in leaves:
            _bidi(links, leaf, spine, uplink_gbps)
    topo = Topology(hosts, leaves, spines, links, host_leaf)
    topo.validate()
    return topo


def jet_testbed(n_hosts: int = 2, host_gbps: float = 200.0) -> Topology:
    """The paper's measurement testbed: hosts under a single switch
    (2x100 Gbps dual-port NICs -> 200 Gbps access links, §2.1)."""
    return clos(n_leaves=1, hosts_per_leaf=n_hosts, n_spines=0,
                host_gbps=host_gbps)


def incast_fabric(n_senders: int, host_gbps: float = 200.0,
                  uplink_gbps: float = 800.0,
                  extra_receivers: int = 1) -> Topology:
    """Senders on one leaf, receiver(s) on another — the paper's storage
    incast shape.  ``extra_receivers`` >= 1 leaves room for a victim flow's
    receiver next to the incast target."""
    return clos(n_leaves=2, hosts_per_leaf=max(n_senders,
                                               1 + extra_receivers),
                n_spines=2, host_gbps=host_gbps, uplink_gbps=uplink_gbps)


def make_pod_clos(pods: int, leaves_per_pod: int, hosts_per_leaf: int,
                  spines_per_pod: int = 2, sspines_per_plane: int = 1,
                  host_gbps: float = 100.0, leaf_spine_gbps: float = 200.0,
                  spine_sspine_gbps: float = 400.0) -> Topology:
    """Pod-scale 3-level Clos.

    Each pod is a fully-wired 2-tier Clos of ``leaves_per_pod`` leaves
    (``hosts_per_leaf`` hosts each) and ``spines_per_pod`` pod-local
    spines.  Above the pods sit super-spine *planes*: pod spine ``i``
    of every pod wires to the ``sspines_per_plane`` super-spines of
    plane ``i`` — the standard plane-aligned wiring, which means
    choosing the source pod's spine chooses the plane, and the rest of
    a cross-pod path is determined.  Per-tier link speeds give per-tier
    oversubscription (:meth:`Topology.oversubscription` at the leaf,
    :meth:`Topology.spine_oversubscription` at the pod spine).

    Node naming: host ``p{pod}h{leaf}_{i}``, leaf ``p{pod}l{leaf}``,
    spine ``p{pod}s{i}``, super-spine ``ss{plane}`` (or
    ``ss{plane}_{k}`` when ``sspines_per_plane > 1``).

    ``pods == 1`` builds a plain 2-tier pod (no super-spine tier).
    """
    if pods < 1 or leaves_per_pod < 1 or hosts_per_leaf < 1 \
            or spines_per_pod < 1 or sspines_per_plane < 1:
        raise ValueError("invalid pod-Clos dimensions")
    hosts, leaves, spines, sspines = [], [], [], []
    links: Dict[LinkKey, Link] = {}
    host_leaf: Dict[str, str] = {}
    pod_of: Dict[str, int] = {}
    for pi in range(pods):
        pod_leaves = []
        for li in range(leaves_per_pod):
            leaf = f"p{pi}l{li}"
            leaves.append(leaf)
            pod_leaves.append(leaf)
            pod_of[leaf] = pi
            for hi in range(hosts_per_leaf):
                h = f"p{pi}h{li}_{hi}"
                hosts.append(h)
                host_leaf[h] = leaf
                _bidi(links, h, leaf, host_gbps)
        for si in range(spines_per_pod):
            spine = f"p{pi}s{si}"
            spines.append(spine)
            pod_of[spine] = pi
            for leaf in pod_leaves:
                _bidi(links, leaf, spine, leaf_spine_gbps)
    if pods > 1:
        for plane in range(spines_per_pod):
            for k in range(sspines_per_plane):
                ss = f"ss{plane}" if sspines_per_plane == 1 \
                    else f"ss{plane}_{k}"
                sspines.append(ss)
                for pi in range(pods):
                    _bidi(links, f"p{pi}s{plane}", ss, spine_sspine_gbps)
    topo = Topology(hosts, leaves, spines, links, host_leaf,
                    super_spines=sspines, pod_of=pod_of)
    topo.validate()
    return topo
