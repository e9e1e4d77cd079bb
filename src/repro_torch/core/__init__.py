"""Receiver-host core of the port: the configuration the fabric grid
packs, the scalar engines (``run_sim`` over ``ReceiverHost`` and
``HostDatapath``: host code in Python floats, the oracle of the receiver
sweep and of the fabric's receivers), the recycle and pool-sizing model,
the Jet service the serving engine drives (``JetService`` over
``SlabPool``, ``ReadWindow`` and the escape ladder), and ``DevicePool``,
the paged KV cache's page bitmap."""
from .datapath import (N_QOS, Admit, AdmissionQueues, DatapathFeedback,
                       HostDatapath, QoS, expected_footprint,
                       hold_us_baseline, hold_us_jet)
from .dcqcn import DcqcnConfig, DcqcnRate
from .escape import Action, EscapeConfig, EscapeController, EscapeStats
from .jet import SMALL_MSG_BYTES, JetConfig, JetService
from .pool import DevicePool, SlabPool
from .recycle import (RecycleModel, little_law_bytes, paper_default,
                      paper_unoptimized, slice_message)
from .simulator import (HostFeedback, ReceiverHost, ReceiverSim, SimConfig,
                        SimResult, run_sim, testbed_25g, testbed_100g)
from .window import ReadWindow, fragment

__all__ = ["N_QOS", "Action", "Admit", "AdmissionQueues",
           "DatapathFeedback", "DcqcnConfig", "DcqcnRate", "DevicePool",
           "EscapeConfig", "EscapeController", "EscapeStats",
           "HostDatapath", "HostFeedback", "JetConfig", "JetService", "QoS",
           "ReadWindow", "ReceiverHost", "ReceiverSim", "RecycleModel",
           "SMALL_MSG_BYTES", "SimConfig", "SimResult", "SlabPool",
           "expected_footprint", "fragment", "hold_us_baseline",
           "hold_us_jet", "little_law_bytes", "paper_default",
           "paper_unoptimized", "run_sim", "slice_message", "testbed_25g",
           "testbed_100g"]
