"""Multi-host RDCA fabric in PyTorch: configuration, the storage-incast,
QoS-mixed, shuffle, link-failure, WRR and host-gate scenarios, the
vectorized grid engine with its CUDA water-fills, and the
receiver-datapath sweep engine."""
from .fabric import FabricConfig, Flow, burst_done_bytes
from .routing import RoutingConfig
from .scenarios import (Scenario, fabric_grid, incast, incast_grid,
                        host_gate_pair, link_failure_incast, olap_shuffle,
                        qos_mixed_grid, qos_mixed_storage, routing_grid,
                        wrr_pair)
from .sweep import SweepParams, grid_configs, run_sweep
from .switch import SwitchConfig
from .topology import (Link, NEVER_TICK, Topology, clos, incast_fabric,
                       jet_testbed)
from .vector import FabricSweepParams, run_fabric_sweep, run_packed

__all__ = ["FabricConfig", "Flow", "burst_done_bytes", "RoutingConfig",
           "Scenario", "fabric_grid", "incast", "incast_grid",
           "host_gate_pair", "link_failure_incast", "olap_shuffle",
           "qos_mixed_grid", "qos_mixed_storage", "routing_grid",
           "wrr_pair", "SweepParams",
           "grid_configs", "run_sweep", "SwitchConfig", "Link",
           "NEVER_TICK", "Topology", "clos", "incast_fabric",
           "jet_testbed", "FabricSweepParams", "run_fabric_sweep",
           "run_packed"]
