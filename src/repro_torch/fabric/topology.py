"""Two-tier leaf–spine Clos topologies for the multi-host RDCA fabric.

A topology is a set of hosts, leaf switches and spine switches joined by
unidirectional capacity-annotated links.  :meth:`Topology.route` gives
the *static ECMP* path: a cross-leaf flow hashes onto one of the spines
wired to both of its leaves (``spines[flow_id % n]`` on a fully wired
Clos), an intra-leaf flow turns at its leaf.

Candidate sets are wiring-restricted: a spine is a candidate for a host
pair only if it has links to both endpoints' leaves, and an unroutable
pair raises a clear ``ValueError``.  Links carry scheduled failure
windows (:meth:`Topology.fail_link`) and periodic flap schedules
(:meth:`Topology.flap_link`), which the engine turns into per-tick
reroutes under load.  The 3-level pod fabrics of the reference are not
part of this port.
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
    # scheduled failure windows: link key -> (down_at_us, restore_us);
    # a link is down while down_at_us <= t < restore_us
    link_down: Dict[LinkKey, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)
    # periodic flap schedules: link key -> (start_us, period_us, down_us);
    # from start_us the link repeats a period_us cycle, down for the
    # first down_us of each cycle
    link_flaps: Dict[LinkKey, Tuple[float, float, float]] = \
        dataclasses.field(default_factory=dict)

    def link(self, src: str, dst: str) -> Link:
        return self.links[(src, dst)]

    def access_gbps(self, host: str) -> float:
        return self.links[(host, self.host_leaf[host])].gbps

    def uplinks(self, leaf: str) -> List[Link]:
        return [l for l in self.links.values()
                if l.src == leaf and l.dst in self.spines]

    def candidate_paths(self, src_host: str, dst_host: str) \
            -> List[List[str]]:
        """Interior (leaf..leaf) candidate node paths of a host pair over
        wired links: ``[]`` for an intra-leaf pair, ``[sl, spine, dl]``
        triples otherwise; raises ``ValueError`` when no spine connects
        the two leaves."""
        sl, dl = self.host_leaf[src_host], self.host_leaf[dst_host]
        if sl == dl:
            return []
        common = self.candidate_spines(src_host, dst_host)
        if not common:
            raise ValueError(f"no spine connects {sl} and {dl} (pair "
                             f"{src_host}->{dst_host} is unroutable)")
        return [[sl, s, dl] for s in common]

    def candidate_spines(self, src_host: str, dst_host: str) -> List[str]:
        """Spines that can carry this pair's traffic, restricted to
        spines with wired links to *both* endpoints' leaves; empty for
        intra-leaf pairs (which never transit a spine)."""
        sl = self.host_leaf[src_host]
        dl = self.host_leaf[dst_host]
        if sl == dl:
            return []
        return [s for s in self.spines
                if (sl, s) in self.links and (s, dl) in self.links]

    def route(self, src_host: str, dst_host: str, flow_id: int) -> List[str]:
        """Node path for a flow; ECMP picks among the wired candidate
        spines by flow-id hash."""
        if src_host == dst_host:
            raise ValueError("flow endpoints must differ")
        sl, dl = self.host_leaf[src_host], self.host_leaf[dst_host]
        if sl == dl:
            return [src_host, sl, dst_host]
        spines = self.candidate_spines(src_host, dst_host)
        if not spines:
            raise ValueError(f"no spine connects {sl} and {dl} (pair "
                             f"{src_host}->{dst_host} is unroutable)")
        return [src_host, sl, spines[flow_id % len(spines)], dl, dst_host]

    # -- link failure schedule ----------------------------------------------
    def fail_link(self, src: str, dst: str, at_us: float,
                  restore_us: float = math.inf,
                  bidi: bool = True) -> "Topology":
        """Schedule a link failure: ``(src, dst)`` goes down at ``at_us``
        and comes back at ``restore_us`` (default: never).  ``bidi``
        fails the reverse direction too.  Returns ``self``."""
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
        repeats a ``period_us`` cycle, down for the first ``down_us`` of
        each cycle (in-flight bytes drop on every falling edge).
        Returns ``self``."""
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
        """Failure windows as integer ticks (down while ``at <= t <
        until``); ``NEVER_TICK`` stands for +inf."""
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
        down)``: down while ``t >= start and (t - start) % period <
        down``."""
        out = {}
        for key, (s, p, d) in self.link_flaps.items():
            start = max(0, int(round(s / dt_us)))
            period = max(2, int(round(p / dt_us)))
            down = min(period - 1, max(1, int(round(d / dt_us))))
            out[key] = (start, period, down)
        return out

    def validate(self) -> None:
        names = self.hosts + self.leaves + self.spines
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
        for s in self.spines:
            if not any(l.dst == s and l.src in self.leaves
                       for l in self.links.values()):
                raise ValueError(f"spine {s} not connected to any leaf")
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
