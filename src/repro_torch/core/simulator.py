"""Receiver-host configuration (paper §2, §6): the knobs of one RDMA
receiver — RNIC buffer, PCIe, DRAM contention, DDIO, Jet pool, escape
ladder — and the paper's two testbed presets.

Calibration constants mirror the paper's two testbeds:
  * 2x25 Gbps PFC-enabled, PCIe3 x8,  ~64 GB/s DRAM, DDIO 4 MB
  * 2x100 Gbps PFC-free,   PCIe4 x16, ~250 GB/s DRAM, DDIO 6 MB
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .dcqcn import DcqcnConfig
from .recycle import RecycleModel, paper_default


@dataclasses.dataclass
class SimConfig:
    mode: str = "ddio"                 # "ddio" (baseline) | "jet"
    pfc_enabled: bool = False
    sim_time_s: float = 0.03
    dt_us: float = 1.0

    # network / workload
    line_rate_gbps: float = 200.0      # dual-port 100 Gbps
    num_qps: int = 32
    msg_bytes: int = 256 << 10
    incast_senders: int = 1            # >1 models in-cast (HPC all-to-all)
    offered_gbps: Optional[float] = None  # open-loop load cap (None=saturate)

    # host
    pcie_gbps: float = 2048.0          # PCIe 4.0 x16 ~ 32 GB/s
    membw_total_gbps: float = 2000.0   # 250 GB/s
    cpu_membw_gbps: float = 1760.0     # 220 GB/s of CPU-side contention
    cpu_membw_schedule: Optional[Callable[[float], float]] = None
    app_gbps: float = 3200.0           # app-side consumption bandwidth
    consumer_latency_us: float = 60.0  # SSD/GPU/compute hand-off latency

    # DDIO (baseline)
    ddio_bytes: int = 6 << 20
    miss_knee: float = 0.5             # miss ramps over knee*ddio_bytes

    # RNIC buffer & congestion signalling
    rnic_buffer_bytes: int = 2 << 20
    pfc_xoff: float = 0.80
    pfc_xon: float = 0.50
    # per-class receiver PFC (watermarks on each admission class's
    # 1/N_QOS partition); False = legacy whole-link gate
    host_pfc_per_tc: bool = False
    ecn_threshold: float = 0.15
    cnp_interval_us: float = 50.0
    # ConnectX-6 DX marks CNPs on an RNIC-buffer watermark (§2.1); older
    # CX-4 (25G testbed) lacks the feature and relies on PFC backpressure.
    rnic_ecn_cnp: bool = True

    # Jet
    jet_pool_bytes: int = 12 << 20
    recycle: RecycleModel = dataclasses.field(default_factory=paper_default)
    straggler_frac: float = 0.005
    straggler_mult: float = 20.0
    cache_safe: float = 0.20
    cache_danger: float = 0.05
    mem_esc_bytes: int = 2 << 20

    dcqcn: DcqcnConfig = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.dcqcn is None:
            self.dcqcn = DcqcnConfig(line_rate_gbps=self.line_rate_gbps *
                                     self.incast_senders)


def testbed_25g(mode: str = "ddio", **kw) -> SimConfig:
    """2x25 Gbps PFC-enabled testbed (§2.1): PCIe3 x8, 64 GB/s DRAM."""
    base = dict(pfc_enabled=True, line_rate_gbps=50.0, pcie_gbps=500.0,
                membw_total_gbps=512.0, cpu_membw_gbps=456.0,
                ddio_bytes=4 << 20, rnic_ecn_cnp=False)
    base.update(kw)
    return SimConfig(mode=mode, **base)


def testbed_100g(mode: str = "ddio", **kw) -> SimConfig:
    """2x100 Gbps PFC-free testbed (§2.1): PCIe4 x16, 250 GB/s DRAM."""
    base = dict(pfc_enabled=False, line_rate_gbps=200.0, pcie_gbps=2048.0,
                membw_total_gbps=2000.0, cpu_membw_gbps=1760.0,
                ddio_bytes=6 << 20)
    base.update(kw)
    return SimConfig(mode=mode, **base)
