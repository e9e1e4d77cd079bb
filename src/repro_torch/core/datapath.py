"""Receive-datapath service classes and post-NIC hold times (paper
§3–§4): the QoS priority order the fabric's admission water-fill follows
and the release delays its recycle rings use."""
from __future__ import annotations

import enum


class QoS(enum.IntEnum):
    """Transfer service classes (paper §3.2); lower value = higher
    priority.  Priority order is the iteration order everywhere: RNIC
    buffer space allocation and drain budget."""
    HIGH = 0
    NORMAL = 1
    LOW = 2


N_QOS = len(QoS)


def hold_us_baseline(c) -> float:
    """Message-granular post-NIC hold time (baseline, non-pipelined)."""
    return (c.consumer_latency_us +
            c.msg_bytes * 8.0 / (c.app_gbps * 1e9) * 1e6)


def hold_us_jet(c) -> float:
    """Slice-granular hold (Jet recycle pipeline): consumer latency
    dominates, the pipeline transit adds ~3 slice-times (paper §4.2.2)."""
    r = c.recycle
    per_byte_ns = r.get_ns_per_byte + r.process_ns_per_byte()
    transit = 3.0 * r.slice_bytes * per_byte_ns * 1e-3
    if not r.pipelined:
        # unpipelined Jet holds whole messages (ablation mode)
        return hold_us_baseline(c) + transit
    return c.consumer_latency_us + transit
