"""Receiver-host configuration and the Jet service: the subset of
:mod:`repro.core` that the ported fabric grid packs and that the serving
engine drives (``JetService`` over ``SlabPool``, ``ReadWindow`` and the
escape ladder), and ``DevicePool``, the paged KV cache's page bitmap."""
from .datapath import (N_QOS, Admit, AdmissionQueues, QoS,
                       expected_footprint, hold_us_baseline, hold_us_jet)
from .dcqcn import DcqcnConfig
from .escape import Action, EscapeConfig, EscapeController, EscapeStats
from .jet import SMALL_MSG_BYTES, JetConfig, JetService
from .pool import DevicePool, SlabPool
from .recycle import RecycleModel, paper_default
from .simulator import SimConfig, testbed_25g, testbed_100g
from .window import ReadWindow, fragment

__all__ = ["N_QOS", "Action", "Admit", "AdmissionQueues", "DcqcnConfig",
           "DevicePool", "EscapeConfig", "EscapeController", "EscapeStats", "JetConfig",
           "JetService", "QoS", "ReadWindow", "RecycleModel",
           "SMALL_MSG_BYTES", "SimConfig", "SlabPool", "expected_footprint",
           "fragment", "hold_us_baseline", "hold_us_jet", "paper_default",
           "testbed_25g", "testbed_100g"]
