"""Multi-host RDCA fabric in PyTorch: configuration, the storage-incast
scenarios and the vectorized grid engine with its CUDA water-fills."""
from .fabric import FabricConfig, Flow, burst_done_bytes
from .routing import RoutingConfig
from .scenarios import Scenario, fabric_grid, incast, incast_grid
from .switch import SwitchConfig
from .topology import (Link, NEVER_TICK, Topology, clos, incast_fabric,
                       jet_testbed)
from .vector import FabricSweepParams, run_fabric_sweep, run_packed

__all__ = ["FabricConfig", "Flow", "burst_done_bytes", "RoutingConfig",
           "Scenario", "fabric_grid", "incast", "incast_grid",
           "SwitchConfig", "Link", "NEVER_TICK", "Topology", "clos",
           "incast_fabric", "jet_testbed", "FabricSweepParams",
           "run_fabric_sweep", "run_packed"]
