"""Two-tier leaf–spine Clos topologies for the multi-host RDCA fabric.

A topology is a set of hosts, leaf switches and spine switches joined by
unidirectional capacity-annotated links.  :meth:`Topology.route` gives
the *static ECMP* path: a cross-leaf flow hashes onto one of the spines
wired to both of its leaves (``spines[flow_id % n]`` on a fully wired
Clos), an intra-leaf flow turns at its leaf.

Candidate sets are wiring-restricted: a spine is a candidate for a host
pair only if it has links to both endpoints' leaves, and an unroutable
pair raises a clear ``ValueError``.  Failure/flap schedules and the
3-level pod fabrics of the reference are not part of this port.
"""
from __future__ import annotations

import dataclasses
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

    def link(self, src: str, dst: str) -> Link:
        return self.links[(src, dst)]

    def access_gbps(self, host: str) -> float:
        return self.links[(host, self.host_leaf[host])].gbps

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
