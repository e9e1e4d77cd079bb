"""Receiver-host configuration the fabric engine packs (the subset of
:mod:`repro.core` that the ported fabric grid needs)."""
from .datapath import N_QOS, QoS, hold_us_baseline, hold_us_jet
from .dcqcn import DcqcnConfig
from .recycle import RecycleModel, paper_default
from .simulator import SimConfig, testbed_25g, testbed_100g

__all__ = ["N_QOS", "QoS", "hold_us_baseline", "hold_us_jet",
           "DcqcnConfig", "RecycleModel", "paper_default", "SimConfig",
           "testbed_25g", "testbed_100g"]
