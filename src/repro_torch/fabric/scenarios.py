"""Scenario library: the storage-incast workload over the Clos fabric
(paper §5–6: N senders on one leaf burst into one receiver on another,
plus an optional open-loop victim flow), HPC all-to-all, the fig 9
storage mixes, the mixed Jet + DDIO fleet, the single-pair testbed, the
QoS-mixed storage fleet, the OLAP shuffle, incast under a link failure,
the strict/WRR and whole-link/per-class host-gate pairs, the message
incast under the CC zoo and its lossy twin, the pod-scale (3-level Clos)
incast, shuffle and PFC-storm scenarios, the grid functions that feed
:func:`repro_torch.fabric.vector.run_fabric_sweep`, and the sweep farm's
named-grid registry (:data:`GRIDS`, :func:`build_grid`) and chunk plan
(:func:`chunk_plan`)."""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.datapath import QoS
from ..core.simulator import SimConfig, testbed_100g
from .cc import CcConfig
from .fabric import FabricConfig, FabricResult, Flow, run_fabric
from .faults import FaultConfig
from .messages import MessageConfig
from .routing import RoutingConfig
from .switch import SwitchConfig
from .topology import (Topology, clos, incast_fabric, jet_testbed,
                       make_pod_clos)


@dataclasses.dataclass
class Scenario:
    name: str
    topology: Topology
    flows: List[Flow]
    fabric: FabricConfig

    def run(self) -> FabricResult:
        """Advance this one scenario with the scalar driver
        (:func:`repro_torch.fabric.fabric.run_fabric`, host code)."""
        return run_fabric(self.topology, self.flows, self.fabric)


def fabric_grid(mk: Callable[..., Scenario],
                **axes: Sequence) -> Tuple[List[Scenario], List[dict]]:
    """Cartesian grid of scenarios: ``mk(**point)`` per combination of the
    ``axes`` lists, axes in sorted name order.  Returns ``(scenarios,
    point-dicts)``.  Axes must not change the topology *structure*
    (flow set / routes / tick count)."""
    names = sorted(axes)
    scens, points = [], []
    for combo in itertools.product(*(axes[n] for n in names)):
        pt = dict(zip(names, combo))
        scens.append(mk(**pt))
        points.append(pt)
    return scens, points


def _recv_factory(mode: str, pfc: bool,
                  msg_bytes: Optional[int] = None,
                  **kw) -> Callable[[str], SimConfig]:
    def make(host: str) -> SimConfig:
        extra = dict(kw)
        if msg_bytes is not None:
            extra["msg_bytes"] = msg_bytes
        return testbed_100g(mode, pfc_enabled=pfc, **extra)
    return make


def incast(n_senders: int = 8, mode: str = "jet", burst_mb: float = 2.0,
           pfc: bool = False, with_victim: bool = True,
           sim_time_s: float = 0.02) -> Scenario:
    """N senders on one leaf burst into one receiver on another leaf; an
    optional open-loop victim flow shares a sender host + the fabric path
    but targets a different receiver (measures HoL collateral)."""
    topo = incast_fabric(n_senders)
    flows = [Flow(src=f"h0_{i}", dst="h1_0",
                  burst_bytes=burst_mb * 1e6, tag="incast")
             for i in range(n_senders)]
    if with_victim:
        flows.append(Flow(src=f"h0_{n_senders - 1}", dst="h1_1",
                          tag="victim"))
    sw = SwitchConfig(pfc_enabled=pfc)
    return Scenario(
        name=f"incast{n_senders}_{mode}{'_pfc' if pfc else ''}",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=_recv_factory(mode, pfc)))


def all_to_all(n_hosts: int = 8, mode: str = "jet",
               msg_kb: int = 256, pfc: bool = False,
               sim_time_s: float = 0.01) -> Scenario:
    """HPC all-to-all: every host streams to every other host (the MPI
    personalized-exchange shape of the paper's fig 13 substrate)."""
    per_leaf = max(2, (n_hosts + 1) // 2)   # ceil: never truncate odd N
    topo = clos(n_leaves=2, hosts_per_leaf=per_leaf, n_spines=2)
    hosts = topo.hosts[:n_hosts]
    assert len(hosts) == n_hosts
    flows = [Flow(src=a, dst=b, tag="a2a")
             for a in hosts for b in hosts if a != b]
    sw = SwitchConfig(pfc_enabled=pfc)
    return Scenario(
        name=f"a2a{n_hosts}_{mode}", topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=_recv_factory(
                                mode, pfc, msg_bytes=msg_kb << 10)))


# fig 9 storage classes: message size + per-flow open-loop load; num_qps
# shrinks with message size so latency "generations" (num_qps * msg bytes)
# stay observable within a few ms of simulated time
_STORAGE: Dict[str, dict] = {
    "oltp":   dict(msg_kb=8,    flow_gbps=8.0,  n_clients=8, num_qps=32),
    "olap":   dict(msg_kb=1024, flow_gbps=40.0, n_clients=4, num_qps=8),
    "backup": dict(msg_kb=4096, flow_gbps=90.0, n_clients=2, num_qps=2),
}


def storage_mix(kind: str = "oltp", mode: str = "jet",
                pfc: bool = False, sim_time_s: float = 0.02) -> Scenario:
    """Storage traffic fanning into one receiver host (paper fig 9):
    OLTP = many small-message clients, OLAP = 1 MB scans, backup = few
    near-line-rate streams."""
    if kind not in _STORAGE:
        raise ValueError(f"unknown storage mix {kind!r}; "
                         f"pick one of {sorted(_STORAGE)}")
    p = _STORAGE[kind]
    topo = incast_fabric(p["n_clients"])
    flows = [Flow(src=f"h0_{i}", dst="h1_0", offered_gbps=p["flow_gbps"],
                  tag=kind)
             for i in range(p["n_clients"])]
    sw = SwitchConfig(pfc_enabled=pfc)
    return Scenario(
        name=f"storage_{kind}_{mode}", topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=_recv_factory(
                                mode, pfc, msg_bytes=p["msg_kb"] << 10,
                                num_qps=p["num_qps"])))


def mixed_fleet(n_senders: int = 8, pool_mb: float = 12.0,
                burst_mb: float = 1.0, pfc: bool = False,
                rnic_ecn_cnp: bool = False,
                sim_time_s: float = 0.02) -> Scenario:
    """Mixed Jet + DDIO fleet on one fabric: N senders burst into a *Jet*
    receiver (``h1_0``, pool size ``pool_mb``) while a victim flow streams
    open-loop into a *DDIO* receiver (``h1_1``) sharing the source leaf
    and fabric path.

    With ``rnic_ecn_cnp=False`` (the default here) the only
    receiver-side brake on the incast is the escape ladder's ECN -> CNP
    path, so sweeping ``pool_mb`` down makes the host-side
    admission/escape -> network-side DCQCN feedback loop observable in
    fleet metrics (incast FCT, victim goodput)."""
    topo = incast_fabric(n_senders)
    flows = [Flow(src=f"h0_{i}", dst="h1_0",
                  burst_bytes=burst_mb * 1e6, tag="incast")
             for i in range(n_senders)]
    flows.append(Flow(src=f"h0_{n_senders - 1}", dst="h1_1",
                      tag="victim"))
    pool_b = int(pool_mb * (1 << 20))

    def recv(host: str) -> SimConfig:
        if host == "h1_0":
            return testbed_100g("jet", pfc_enabled=pfc,
                                jet_pool_bytes=pool_b,
                                rnic_ecn_cnp=rnic_ecn_cnp)
        return testbed_100g("ddio", pfc_enabled=pfc)

    sw = SwitchConfig(pfc_enabled=pfc)
    return Scenario(
        name=f"mixed{n_senders}_pool{pool_mb:g}{'_pfc' if pfc else ''}",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=recv))


def mixed_fleet_grid(pool_mb: Sequence[float] = (12.0, 4.0, 1.0),
                     burst_mb: Sequence[float] = (1.0, 2.0),
                     **kw) -> Tuple[List[Scenario], List[dict]]:
    """Jet pool size x burst size grid over :func:`mixed_fleet`, the
    closed-loop sweep: shrinking the receiver pool raises escape-ladder
    ECN pressure, which throttles that receiver's DCQCN senders and
    shifts fleet incast FCT and victim goodput."""
    return fabric_grid(
        lambda pool_mb, burst_mb: mixed_fleet(
            pool_mb=pool_mb, burst_mb=burst_mb, **kw),
        pool_mb=list(pool_mb), burst_mb=list(burst_mb))


def qos_mixed_storage(n_bulk: int = 4, n_oltp: int = 3, n_olap: int = 2,
                      bulk_gbps: float = 60.0, oltp_gbps: float = 25.0,
                      olap_gbps: float = 25.0,
                      oltp_on_off_us: Tuple[float, float] = (60.0, 60.0),
                      per_tc: bool = True, pfc: bool = True,
                      ecn: bool = False, pool_mb: float = 0.5,
                      sim_time_s: float = 0.01) -> Scenario:
    """QoS-mixed storage fleet (paper fig 9 classes on one fabric): LOW
    bulk writers incast into a small-pool Jet receiver (``h1_0``, whose
    pool pressure drives the §5 LOW->DRAM spill), HIGH OLTP clients run
    on-off burst trains into ``h1_1`` and NORMAL OLAP scans stream into
    ``h1_2``.  The bulk class oversubscribes its receiver's access link,
    so with ``pfc`` the congested downlink asserts pause up the tree:
    per-priority pause (``per_tc=True``) stalls only LOW, the legacy
    whole-link pause stalls all three classes.  OLTP/OLAP clients share
    source hosts with bulk writers, so the classes meet at the source
    NIC and on every fabric link."""
    n = max(n_bulk, n_oltp, n_olap)
    topo = incast_fabric(n, host_gbps=100.0, uplink_gbps=800.0,
                         extra_receivers=2)
    flows = [Flow(src=f"h0_{i}", dst="h1_0", offered_gbps=bulk_gbps,
                  qos=QoS.LOW, tag="incast")
             for i in range(n_bulk)]
    flows += [Flow(src=f"h0_{i}", dst="h1_1", offered_gbps=oltp_gbps,
                   qos=QoS.HIGH, tag="oltp", on_off_us=oltp_on_off_us)
              for i in range(n_oltp)]
    flows += [Flow(src=f"h0_{i}", dst="h1_2", offered_gbps=olap_gbps,
                   qos=QoS.NORMAL, tag="olap")
              for i in range(n_olap)]

    def recv(host: str) -> SimConfig:
        if host == "h1_0":      # the squeezed Jet pool: LOW spills (§5)
            return testbed_100g("jet", pfc_enabled=False,
                                jet_pool_bytes=int(pool_mb * (1 << 20)),
                                rnic_ecn_cnp=False)
        return testbed_100g("ddio", pfc_enabled=False)

    sw = SwitchConfig(pfc_enabled=pfc, ecn_enabled=ecn, per_tc=per_tc,
                      port_buffer_bytes=1 << 20)
    return Scenario(
        name=f"qosmix{n_bulk}b{n_oltp}o{n_olap}a"
             f"_{'tc' if per_tc else 'link'}{'_pfc' if pfc else ''}",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=recv))


def qos_mixed_grid(per_tc: Sequence[bool] = (False, True),
                   pool_mb: Sequence[float] = (0.5,),
                   **kw) -> Tuple[List[Scenario], List[dict]]:
    """Pause granularity x Jet pool size grid over
    :func:`qos_mixed_storage` (both are per-point parameters, so one
    sweep covers 802.1Qbb and legacy whole-link pause)."""
    return fabric_grid(
        lambda per_tc, pool_mb: qos_mixed_storage(
            per_tc=per_tc, pool_mb=pool_mb, **kw),
        per_tc=list(per_tc), pool_mb=list(pool_mb))


def olap_shuffle(n_mappers: int = 4, n_reducers: int = 4,
                 shuffle_mb: float = 2.0, routing: str = "static_ecmp",
                 pfc: bool = False, n_spines: int = 2,
                 sim_time_s: float = 0.02) -> Scenario:
    """Multi-receiver OLAP shuffle: every mapper on leaf 0 streams one
    partition to every reducer on leaf 1, an all-to-all across the spine
    tier, so the uplink choice decides completion time.  Static ECMP
    piles the partitions onto ``flow_id % n_spines`` uplinks; the dynamic
    modes spread them by load."""
    per_leaf = max(n_mappers, n_reducers)
    topo = clos(n_leaves=2, hosts_per_leaf=per_leaf, n_spines=n_spines,
                host_gbps=100.0, uplink_gbps=200.0)
    flows = [Flow(src=f"h0_{i}", dst=f"h1_{j}",
                  burst_bytes=shuffle_mb * 1e6 / n_reducers,
                  qos=QoS.NORMAL, tag="shuffle")
             for i in range(n_mappers) for j in range(n_reducers)]
    sw = SwitchConfig(pfc_enabled=pfc)
    return Scenario(
        name=f"shuffle{n_mappers}x{n_reducers}_{routing}",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=_recv_factory("ddio", pfc),
                            routing=RoutingConfig(mode=routing)))


def link_failure_incast(n_senders: int = 8, mode: str = "ddio",
                        routing: str = "adaptive", burst_mb: float = 2.0,
                        fail_at_us: float = 150.0,
                        restore_us: float = math.inf,
                        fail_spine: int = 0, pfc: bool = False,
                        with_victim: bool = True,
                        uplink_gbps: float = 400.0,
                        sim_time_s: float = 0.02) -> Scenario:
    """Incast under a link failure: the incast-N burst is in flight when
    the ``leaf0 -> spine{fail_spine}`` uplink dies at ``fail_at_us``
    (both directions; back at ``restore_us``, never by default).  Static
    ECMP keeps hashing half the flows onto the dead spine, whose bursts
    stall; adaptive and spray reroute onto the surviving uplinks.
    ``fail_at_us=inf`` schedules no failure."""
    topo = incast_fabric(n_senders, uplink_gbps=uplink_gbps)
    if math.isfinite(fail_at_us):
        topo.fail_link("leaf0", f"spine{fail_spine}", at_us=fail_at_us,
                       restore_us=restore_us)
    flows = [Flow(src=f"h0_{i}", dst="h1_0",
                  burst_bytes=burst_mb * 1e6, tag="incast")
             for i in range(n_senders)]
    if with_victim:
        flows.append(Flow(src=f"h0_{n_senders - 1}", dst="h1_1",
                          tag="victim"))
    sw = SwitchConfig(pfc_enabled=pfc)
    fa = "nofail" if not math.isfinite(fail_at_us) else f"f{fail_at_us:g}"
    return Scenario(
        name=f"linkfail{n_senders}_{routing}_{fa}",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=_recv_factory(mode, pfc),
                            routing=RoutingConfig(mode=routing)))


def routing_grid(modes: Sequence[str] = ("static_ecmp", "adaptive",
                                         "spray"),
                 fail_at_us: Sequence[float] = (math.inf, 150.0),
                 **kw) -> Tuple[List[Scenario], List[dict]]:
    """Routing mode x link-failure schedule grid over
    :func:`link_failure_incast`: both are per-point parameters, so one
    engine run covers every (mode, failure) combination."""
    return fabric_grid(
        lambda routing, fail_at_us: link_failure_incast(
            routing=routing, fail_at_us=fail_at_us, **kw),
        routing=list(modes), fail_at_us=list(fail_at_us))


def wrr_pair(sim_time_s: float = 0.004) -> List[Scenario]:
    """Strict priority vs WRR (quanta 4:2:1) on one saturated 100G
    downlink: three 60 Gbps HIGH senders and one 40 Gbps LOW sender into
    one receiver, PFC and ECN off.  Strict priority starves LOW; WRR
    keeps it at its quanta share (the reference's
    ``tests/test_routing.py::test_wrr_prevents_low_starvation_on_
    saturated_port``)."""
    topo = incast_fabric(4, host_gbps=100.0, uplink_gbps=800.0)
    flows = [Flow(src=f"h0_{i}", dst="h1_0", offered_gbps=60.0,
                  qos=QoS.HIGH, tag="hi") for i in range(3)]
    flows.append(Flow(src="h0_3", dst="h1_0", offered_gbps=40.0,
                      qos=QoS.LOW, tag="low"))
    out = []
    for sched in ("strict", "wrr"):
        sw = SwitchConfig(pfc_enabled=False, ecn_enabled=False,
                          scheduler=sched, port_buffer_bytes=1 << 20)
        out.append(Scenario(
            name=sched, topology=topo, flows=flows,
            fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                                receiver_cfg=lambda h: testbed_100g(
                                    "ddio"))))
    return out


def host_gate_pair(sim_time_s: float = 0.004) -> List[Scenario]:
    """Whole-link vs per-class receiver PFC: a LOW bulk incast fills the
    receiver's RNIC buffer beside a 1 Gbps HIGH flow.  The whole-link
    gate stalls HIGH with the bulk; the per-class gate pauses only the
    LOW class (the reference's ``tests/test_routing.py::
    test_host_per_tc_pfc_isolates_classes_on_access_link``)."""
    topo = incast_fabric(4, host_gbps=100.0, uplink_gbps=800.0)
    flows = [Flow(src=f"h0_{i}", dst="h1_0", qos=QoS.LOW, tag="bulk")
             for i in range(3)]
    flows.append(Flow(src="h0_3", dst="h1_0", offered_gbps=1.0,
                      qos=QoS.HIGH, tag="hi"))
    out = []
    for per_tc in (False, True):
        def recv(host, per_tc=per_tc):
            return testbed_100g("ddio", pfc_enabled=True,
                                host_pfc_per_tc=per_tc, rnic_ecn_cnp=False,
                                cpu_membw_gbps=1995.0)
        out.append(Scenario(
            name=f"host_gate_{'tc' if per_tc else 'link'}", topology=topo,
            flows=flows,
            fabric=FabricConfig(sim_time_s=sim_time_s,
                                switch=SwitchConfig(pfc_enabled=True),
                                receiver_cfg=recv)))
    return out


def single_pair(mode: str = "jet", sim_time_s: float = 0.01,
                **recv_kw) -> Scenario:
    """One sender, one receiver under one switch: the fabric rendition of
    the paper's two-host testbed."""
    topo = jet_testbed(2)
    return Scenario(
        name=f"pair_{mode}", topology=topo,
        flows=[Flow(src="h0_0", dst="h0_1")],
        fabric=FabricConfig(sim_time_s=sim_time_s,
                            receiver_cfg=_recv_factory(mode, False,
                                                       **recv_kw)))


def message_incast(n_senders: int = 8, algo: str = "dcqcn",
                   verb: str = "write", msg_kb: float = 64.0,
                   window: int = 16, mode: str = "ddio",
                   sim_time_s: float = 0.002,
                   cc: Optional[CcConfig] = None) -> Scenario:
    """N open-loop senders incast one receiver, every flow carrying the
    op layer: fixed-size verbs messages under an outstanding window,
    rate-controlled by ``algo`` from the CC zoo.  The canonical tail-
    latency benchmark — DCQCN's CNP-driven throttling versus the
    delay/INT controllers shows up directly in message p99/p999."""
    topo = incast_fabric(n_senders)
    flows = [Flow(src=f"h0_{i}", dst="h1_0", tag="incast")
             for i in range(n_senders)]
    msg = MessageConfig(verb=verb, msg_bytes=msg_kb * 1024.0,
                        window=window)
    return Scenario(
        name=f"msg_incast{n_senders}_{algo}_{verb}"
             f"_{int(msg_kb)}k_w{window}",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, msg=msg,
                            cc=cc if cc is not None else CcConfig(algo=algo),
                            receiver_cfg=_recv_factory(mode, False)))


def message_sweep_grid(msg_kb: Sequence[float] = (4.0, 64.0, 1024.0),
                       window: Sequence[int] = (1, 16, 64),
                       verb: Sequence[str] = ("write", "send"),
                       algo: Sequence[str] = ("dcqcn", "timely", "hpcc"),
                       **kw) -> Tuple[List[Scenario], List[dict]]:
    """Message size x outstanding window x verb x CC algorithm grid over
    :func:`message_incast` for :func:`repro_torch.fabric.vector
    .run_fabric_sweep` — the classic verbs sweep (ib_write_bw-style
    size/queue-depth curves) as one grid run.  Per point the
    results carry Mops (``msg_rate_mops``), GiB/s (``msg_goodput_gbps``)
    and tail latency (``msg_p99_us``) — msg/cc are per-point parameters,
    not structure, so all points share one packing."""
    return fabric_grid(
        lambda msg_kb, window, verb, algo: message_incast(
            msg_kb=msg_kb, window=window, verb=verb, algo=algo, **kw),
        msg_kb=list(msg_kb), window=list(window), verb=list(verb),
        algo=list(algo))


def lossy_incast(n_senders: int = 8, loss_rate: float = 0.01,
                 recovery: str = "go_back_n", algo: str = "dcqcn",
                 verb: str = "write", msg_kb: float = 64.0,
                 window: int = 16, mode: str = "ddio", seed: int = 7,
                 sim_time_s: float = 0.002,
                 cc: Optional[CcConfig] = None) -> Scenario:
    """:func:`message_incast` on a lossy fabric: every link drops a
    stochastic ``loss_rate`` fraction of its ticks (counter-based hash,
    identical realization in every engine — see
    :mod:`repro_torch.fabric.faults`), and every flow recovers via
    ``MessageConfig.recovery`` — ``"go_back_n"`` gaps the receive window
    and replays from the RTO with exponential backoff, ``"selective"``
    replays only the lost span after the NACK delay (IRN).  The p999 gap
    between the two recovery modes under the same loss realization is
    the fault layer's headline plot."""
    topo = incast_fabric(n_senders)
    flows = [Flow(src=f"h0_{i}", dst="h1_0", tag="incast")
             for i in range(n_senders)]
    msg = MessageConfig(verb=verb, msg_bytes=msg_kb * 1024.0,
                        window=window, recovery=recovery)
    return Scenario(
        name=f"lossy_incast{n_senders}_{recovery}"
             f"_l{loss_rate:g}_{algo}_{int(msg_kb)}k",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, msg=msg,
                            cc=cc if cc is not None else CcConfig(algo=algo),
                            faults=FaultConfig(loss_rate=loss_rate,
                                               seed=seed),
                            receiver_cfg=_recv_factory(mode, False)))


def lossy_incast_grid(loss_rate: Sequence[float] = (0.002, 0.01, 0.05),
                      recovery: Sequence[str] = ("go_back_n", "selective"),
                      **kw) -> Tuple[List[Scenario], List[dict]]:
    """Loss rate x recovery mode grid over :func:`lossy_incast` for
    :func:`repro_torch.fabric.vector.run_fabric_sweep` — fault parameters are
    per-point sweep values, not structure, so the whole grid shares one
    packing.  Per point the results carry ``dropped_pkts``,
    ``retransmit_bytes`` and the message latency percentiles the
    go-back-N vs selective comparison reads (``msg_p999_us``)."""
    return fabric_grid(
        lambda loss_rate, recovery: lossy_incast(
            loss_rate=loss_rate, recovery=recovery, **kw),
        loss_rate=list(loss_rate), recovery=list(recovery))


# --------------------------------------------------------------------------- #
# Pod-scale (3-level Clos) scenarios
# --------------------------------------------------------------------------- #
def pod_incast(pods: int = 2, leaves_per_pod: int = 2,
               hosts_per_leaf: int = 4, mode: str = "jet",
               burst_mb: float = 1.0, pfc: bool = False,
               with_victim: bool = True,
               sim_time_s: float = 0.005) -> Scenario:
    """Cross-pod incast: every host of pods 1..P-1 bursts into one
    receiver in pod 0, so the fan-in crosses two oversubscription
    points (pod spine, then super-spine) before hitting the last-mile
    receiver bottleneck the paper studies — the hundreds-of-senders
    regime where the cache/PFC cascade differs in kind from the
    single-leaf testbed.  An optional victim inside the destination
    pod measures cross-tier HoL collateral.  Super-spine topologies run
    on the sparse-incidence engine (``run_fabric_sweep`` picks it
    automatically)."""
    topo = make_pod_clos(pods, leaves_per_pod, hosts_per_leaf)
    flows = [Flow(src=f"p{pi}h{li}_{hi}", dst="p0h0_0",
                  burst_bytes=burst_mb * 1e6, tag="incast")
             for pi in range(1, pods)
             for li in range(leaves_per_pod)
             for hi in range(hosts_per_leaf)]
    if with_victim and hosts_per_leaf > 1:
        flows.append(Flow(src=f"p0h{leaves_per_pod - 1}_0",
                          dst="p0h0_1", tag="victim"))
    sw = SwitchConfig(pfc_enabled=pfc)
    return Scenario(
        name=f"pod_incast{pods}x{leaves_per_pod}x{hosts_per_leaf}"
             f"_{mode}{'_pfc' if pfc else ''}",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=_recv_factory(mode, pfc)))


def pod_incast_grid(mode: Sequence[str] = ("jet", "ddio"),
                    pfc: Sequence[bool] = (False, True),
                    **kw) -> Tuple[List[Scenario], List[dict]]:
    """Receiver mode x PFC grid over :func:`pod_incast` — one sparse
    vector program covers the whole pod-scale comparison."""
    return fabric_grid(
        lambda mode, pfc: pod_incast(mode=mode, pfc=pfc, **kw),
        mode=list(mode), pfc=list(pfc))


def pod_shuffle(pods: int = 2, leaves_per_pod: int = 2,
                hosts_per_leaf: int = 2, shuffle_mb: float = 1.0,
                mode: str = "ddio", pfc: bool = False,
                sim_time_s: float = 0.005) -> Scenario:
    """Pod-wide OLAP shuffle (:func:`olap_shuffle` at pod scale): every
    host of pod ``i`` streams one partition to every host of pod
    ``i+1 mod P`` — an all-to-all *across the super-spine tier*, so
    completion time is decided by the plane-aligned uplink choice and
    the per-tier oversubscription, not one congested receiver.
    ``pods=1`` degenerates to the 2-tier intra-pod shuffle."""
    topo = make_pod_clos(pods, leaves_per_pod, hosts_per_leaf)

    def hosts_of(pi: int) -> List[str]:
        return [f"p{pi}h{li}_{hi}" for li in range(leaves_per_pod)
                for hi in range(hosts_per_leaf)]

    n_red = leaves_per_pod * hosts_per_leaf
    flows = [Flow(src=src, dst=dst,
                  burst_bytes=shuffle_mb * 1e6 / n_red,
                  qos=QoS.NORMAL, tag="shuffle")
             for pi in range(pods)
             for src in hosts_of(pi)
             for dst in hosts_of((pi + 1) % pods)
             if src != dst]
    sw = SwitchConfig(pfc_enabled=pfc)
    return Scenario(
        name=f"pod_shuffle{pods}x{leaves_per_pod}x{hosts_per_leaf}",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=_recv_factory(mode, pfc)))


def pod_pfc_storm(pods: int = 2, leaves_per_pod: int = 2,
                  hosts_per_leaf: int = 4, buffer_kb: float = 64.0,
                  per_tc: bool = True,
                  sim_time_s: float = 0.005) -> Scenario:
    """Cross-tier PFC-storm study: a lossless (PFC everywhere) cross-pod
    incast with deliberately small switch buffers, so xoff cascades from
    the destination leaf back through its pod spine to the super-spine
    tier and out into every source pod.  ``pause_tc_fanout`` /
    ``pause_storm`` measure the blast radius — the pause-propagation
    failure mode that only appears beyond one tier.
    Open-loop senders (no burst cap) keep the cascade fed for the whole
    window."""
    topo = make_pod_clos(pods, leaves_per_pod, hosts_per_leaf)
    flows = [Flow(src=f"p{pi}h{li}_{hi}", dst="p0h0_0",
                  qos=QoS.NORMAL, tag="incast")
             for pi in range(1, pods)
             for li in range(leaves_per_pod)
             for hi in range(hosts_per_leaf)]
    if hosts_per_leaf > 1:
        # cross-pod victim sharing only the paused tiers (collateral)
        flows.append(Flow(src="p1h0_1", dst=f"p0h{leaves_per_pod - 1}_1",
                          qos=QoS.HIGH, tag="victim"))
    sw = SwitchConfig(pfc_enabled=True, per_tc=per_tc,
                      port_buffer_bytes=int(buffer_kb * 1024))
    return Scenario(
        name=f"pod_storm{pods}x{leaves_per_pod}x{hosts_per_leaf}"
             f"_b{buffer_kb:g}k",
        topology=topo, flows=flows,
        fabric=FabricConfig(sim_time_s=sim_time_s, switch=sw,
                            receiver_cfg=_recv_factory("ddio", True)))


def pod_storm_grid(buffer_kb: Sequence[float] = (32.0, 64.0, 128.0),
                   **kw) -> Tuple[List[Scenario], List[dict]]:
    """Buffer-size sweep over :func:`pod_pfc_storm`: smaller per-port
    buffers assert xoff earlier and push the pause frontier deeper into
    the fabric — ``pause_storm`` vs buffer size is the cross-tier
    cascade curve."""
    return fabric_grid(
        lambda buffer_kb: pod_pfc_storm(buffer_kb=buffer_kb, **kw),
        buffer_kb=list(buffer_kb))


# --------------------------------------------------------------------------- #
# Farm layer: named grids + chunk plans
# --------------------------------------------------------------------------- #
def incast_grid(mode: Sequence[str] = ("jet", "ddio"),
                pfc: Sequence[bool] = (False, True),
                burst_mb: Sequence[float] = tuple(
                    0.25 * (i + 1) for i in range(16)),
                n_senders: int = 4,
                sim_time_s: float = 0.002,
                ) -> Tuple[List[Scenario], List[dict]]:
    """Receiver mode x PFC x burst-size grid over :func:`incast`: the
    farm's canonical 64-point 2-tier workload (burst size is a pure
    numeric axis, so chunks of this grid share structure)."""
    return fabric_grid(
        lambda mode, pfc, burst_mb: incast(
            n_senders=n_senders, mode=mode, pfc=pfc, burst_mb=burst_mb,
            sim_time_s=sim_time_s),
        mode=list(mode), pfc=list(pfc), burst_mb=list(burst_mb))


#: Named grids the farm can rebuild by name inside worker processes
#: (Scenario objects embed receiver-config closures and do not pickle;
#: workers re-materialize the grid from this registry instead).  Each
#: entry maps name -> (builder, quick-kwargs): the builder returns
#: ``(scenarios, point-dicts)``; the quick kwargs shrink the grid for
#: smoke runs (``build_grid(name, quick=True)``).
GRIDS: Dict[str, Tuple[Callable[..., Tuple[List[Scenario], List[dict]]],
                       dict]] = {
    "incast": (incast_grid,
               dict(burst_mb=(0.25, 0.5, 1.0, 2.0), n_senders=4,
                    sim_time_s=0.001)),
    "mixed_fleet": (mixed_fleet_grid,
                    dict(pool_mb=(12.0, 4.0), burst_mb=(1.0,),
                         sim_time_s=0.002)),
    "qos_mixed": (qos_mixed_grid, dict(sim_time_s=0.001)),
    "routing": (routing_grid,
                dict(modes=("static_ecmp", "adaptive"),
                     sim_time_s=0.001)),
    "message_sweep": (message_sweep_grid,
                      dict(msg_kb=(64.0,), window=(1, 16),
                           verb=("write",), algo=("dcqcn", "timely"),
                           sim_time_s=0.001)),
    "lossy_incast": (lossy_incast_grid,
                     dict(loss_rate=(0.01,), sim_time_s=0.001)),
    "pod_incast": (pod_incast_grid, dict(sim_time_s=0.002)),
    "pod_storm": (pod_storm_grid,
                  dict(buffer_kb=(32.0, 64.0), sim_time_s=0.002)),
}


def build_grid(name: str, quick: bool = False,
               **overrides) -> Tuple[List[Scenario], List[dict]]:
    """Materialize a named grid from :data:`GRIDS`.

    ``quick=True`` applies the registry's shrunken axes (smoke-test
    size); explicit ``overrides`` win over both defaults and quick
    kwargs.  This is the farm's worker-side entry point: a ``(name,
    quick, overrides)`` triple is picklable where a scenario list is
    not, and rebuilding is deterministic, so every worker sees the
    identical grid."""
    if name not in GRIDS:
        raise ValueError(f"unknown grid {name!r}; "
                         f"pick one of {sorted(GRIDS)}")
    builder, quick_kw = GRIDS[name]
    kw = dict(quick_kw) if quick else {}
    kw.update(overrides)
    return builder(**kw)


def chunk_plan(n_points: int, chunk_size: int) -> List[dict]:
    """Split ``n_points`` grid points into fixed-shape chunks.

    Full chunks use exactly ``chunk_size`` points; the remainder is
    padded *up* to the next power of two (capped at ``chunk_size``), so
    a farm run builds at most two run shapes whatever the grid size: the
    padding points replicate a real scenario and are sliced off after
    the run (grid points are independent lanes, so padded lanes cannot
    perturb real results).

    Returns a list of ``{"chunk": k, "start": i, "stop": j, "padded":
    m}`` dicts where ``stop - start`` is the real point count and
    ``padded >= stop - start`` is the dispatch shape.
    """
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    if n_points <= 0:
        raise ValueError("empty grid")
    plan = []
    start = 0
    while start < n_points:
        stop = min(start + chunk_size, n_points)
        real = stop - start
        if real == chunk_size:
            padded = chunk_size
        else:
            padded = 1
            while padded < real:
                padded *= 2
            padded = min(padded, chunk_size)
        plan.append({"chunk": len(plan), "start": start, "stop": stop,
                     "padded": padded})
        start = stop
    return plan
