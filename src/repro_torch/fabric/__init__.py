"""Multi-host RDCA fabric in PyTorch: configuration, the CC zoo, the
message and fault layers, the storage-incast, QoS-mixed, shuffle,
link-failure, WRR, host-gate, all-to-all, message-incast and lossy
scenarios, the vectorized grid engine with its CUDA water-fills, and the
receiver-datapath sweep engine."""
from .cc import CC_ALGOS, CcConfig, HpccRate, TimelyRate, make_controller
from .fabric import FabricConfig, Flow, burst_done_bytes
from .faults import FaultConfig, FlowRecovery, has_pause_cycle
from .messages import (HIST_BUCKETS, HIST_MAX_US, HIST_MIN_US, LogHistogram,
                       MessageConfig, MessageTracker, percentile_from_counts)
from .routing import RoutingConfig
from .scenarios import (Scenario, all_to_all, fabric_grid, incast,
                        incast_grid, host_gate_pair, link_failure_incast,
                        lossy_incast, lossy_incast_grid, message_incast,
                        message_sweep_grid, olap_shuffle, qos_mixed_grid,
                        qos_mixed_storage, routing_grid, wrr_pair)
from .sweep import SweepParams, grid_configs, run_sweep
from .switch import SwitchConfig
from .topology import (Link, NEVER_TICK, Topology, clos, incast_fabric,
                       jet_testbed)
from .vector import FabricSweepParams, run_fabric_sweep, run_packed

__all__ = ["CC_ALGOS", "CcConfig", "HpccRate", "TimelyRate",
           "make_controller", "FabricConfig", "Flow", "burst_done_bytes",
           "FaultConfig", "FlowRecovery", "has_pause_cycle",
           "HIST_BUCKETS", "HIST_MAX_US", "HIST_MIN_US", "LogHistogram",
           "MessageConfig", "MessageTracker", "percentile_from_counts",
           "RoutingConfig", "Scenario", "all_to_all", "fabric_grid",
           "incast", "incast_grid", "host_gate_pair",
           "link_failure_incast", "lossy_incast", "lossy_incast_grid",
           "message_incast", "message_sweep_grid", "olap_shuffle",
           "qos_mixed_grid", "qos_mixed_storage", "routing_grid",
           "wrr_pair", "SweepParams", "grid_configs", "run_sweep",
           "SwitchConfig", "Link", "NEVER_TICK", "Topology", "clos",
           "incast_fabric", "jet_testbed", "FabricSweepParams",
           "run_fabric_sweep", "run_packed"]
