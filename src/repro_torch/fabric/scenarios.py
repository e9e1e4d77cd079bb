"""Scenario library: the storage-incast workload over the Clos fabric
(paper §5–6: N senders on one leaf burst into one receiver on another,
plus an optional open-loop victim flow) and the grid builders that feed
:func:`repro_torch.fabric.vector.run_fabric_sweep`."""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence, Tuple

from ..core.simulator import SimConfig, testbed_100g
from .fabric import FabricConfig, Flow
from .switch import SwitchConfig
from .topology import Topology, incast_fabric


@dataclasses.dataclass
class Scenario:
    name: str
    topology: Topology
    flows: List[Flow]
    fabric: FabricConfig


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


def incast_grid(mode: Sequence[str] = ("jet", "ddio"),
                pfc: Sequence[bool] = (False, True),
                burst_mb: Sequence[float] = tuple(
                    0.25 * (i + 1) for i in range(16)),
                n_senders: int = 4,
                sim_time_s: float = 0.002,
                ) -> Tuple[List[Scenario], List[dict]]:
    """Receiver mode x PFC x burst-size grid over :func:`incast`."""
    return fabric_grid(
        lambda mode, pfc, burst_mb: incast(
            n_senders=n_senders, mode=mode, pfc=pfc, burst_mb=burst_mb,
            sim_time_s=sim_time_s),
        mode=list(mode), pfc=list(pfc), burst_mb=list(burst_mb))
