"""Multi-host RDCA fabric in PyTorch: configuration, the scalar driver
(``run_fabric`` over ``Switch`` / ``OutputPort``, ``SenderHost`` and
``ReceiverHost``: host code, the grid engine's oracle), the CC zoo, the
message and fault layers, the 2-tier and pod-scale (3-level) Clos
topologies, the storage-incast, storage-mix, mixed-fleet, single-pair,
QoS-mixed, shuffle, link-failure, WRR, host-gate, all-to-all,
message-incast, lossy and pod scenarios, the vectorized grid engine
(dense and sparse incidence) with its CUDA water-fills and segment sum,
the sweep farm (chunked grids under the full grid's envelope, one built
run re-armed per chunk shape, versioned artifacts and resume), and the
receiver-datapath sweep engine."""
from .cc import CC_ALGOS, CcConfig, HpccRate, TimelyRate, make_controller
from .fabric import (FabricConfig, FabricResult, Flow, burst_done_bytes,
                     run_fabric)
from .faults import FaultConfig, FlowRecovery, has_pause_cycle
from .hosts import HostFeedback, ReceiverHost, SenderHost
from .messages import (HIST_BUCKETS, HIST_MAX_US, HIST_MIN_US, LogHistogram,
                       MessageConfig, MessageTracker, exact_percentile,
                       percentile_from_counts)
from .routing import RoutingConfig
from .scenarios import (GRIDS, Scenario, all_to_all, build_grid,
                        chunk_plan, fabric_grid, incast, incast_grid,
                        host_gate_pair, link_failure_incast, lossy_incast,
                        lossy_incast_grid, message_incast,
                        message_sweep_grid, mixed_fleet, mixed_fleet_grid,
                        olap_shuffle, pod_incast, pod_incast_grid,
                        pod_pfc_storm, pod_shuffle, pod_storm_grid,
                        qos_mixed_grid, qos_mixed_storage, routing_grid,
                        single_pair, storage_mix, wrr_pair)
from .sweep import SweepParams, grid_configs, run_sweep
from .switch import OutputPort, Switch, SwitchConfig
from .topology import (Link, NEVER_TICK, Topology, clos, incast_fabric,
                       jet_testbed, make_pod_clos)
from .vector import (FabricRun, FabricSweepParams, cached_run,
                     run_fabric_sweep, run_packed)
from .farm import GridSpec, run_farm

__all__ = ["CC_ALGOS", "CcConfig", "HpccRate", "TimelyRate",
           "make_controller", "FabricConfig", "FabricResult", "Flow",
           "burst_done_bytes", "run_fabric",
           "FaultConfig", "FlowRecovery", "has_pause_cycle",
           "HostFeedback", "ReceiverHost", "SenderHost",
           "HIST_BUCKETS", "HIST_MAX_US", "HIST_MIN_US", "LogHistogram",
           "MessageConfig", "MessageTracker", "exact_percentile",
           "percentile_from_counts",
           "RoutingConfig", "GRIDS", "Scenario", "all_to_all",
           "build_grid", "chunk_plan", "fabric_grid", "incast",
           "incast_grid", "host_gate_pair", "link_failure_incast",
           "lossy_incast", "lossy_incast_grid", "message_incast",
           "message_sweep_grid", "mixed_fleet", "mixed_fleet_grid",
           "olap_shuffle", "pod_incast", "pod_incast_grid",
           "pod_pfc_storm", "pod_shuffle", "pod_storm_grid",
           "qos_mixed_grid", "qos_mixed_storage", "routing_grid",
           "single_pair", "storage_mix", "wrr_pair", "SweepParams",
           "grid_configs", "run_sweep", "OutputPort", "Switch", "SwitchConfig",
           "Link",
           "NEVER_TICK", "Topology", "clos", "incast_fabric",
           "jet_testbed", "make_pod_clos", "FabricRun",
           "FabricSweepParams", "cached_run", "run_fabric_sweep",
           "run_packed", "GridSpec", "run_farm"]
