"""The paper's own configuration: Jet on the two measurement testbeds
(§2.1, §6.1).  This is not an LM architecture, so it stays out of the arch
registry: it parameterizes the receive-datapath substrate (the simulator and
serving admission)."""
from ..core.jet import JetConfig
from ..core.simulator import testbed_25g, testbed_100g

JET_CONFIG = JetConfig(
    pool_bytes=12 << 20,          # 12 MB LLC (20% of cache)  §6.1
    srq_bytes=4 << 20,            # 4 MB small-message share   §4.1.3
    srq_wqes=1024,                # 1K pre-posted 4 KB WQEs    §4.1.3
    max_concurrency=32,           # READ concurrency window    §4.1.2
    max_inflight_bytes=8 << 20,   # in-flight byte window      §4.1.2
)

TESTBEDS = {
    "25g_pfc": testbed_25g,       # 2x25 Gbps, PFC-enabled, DDIO 4 MB
    "100g_pfcfree": testbed_100g, # 2x100 Gbps, PFC-free, DDIO 6 MB
}
