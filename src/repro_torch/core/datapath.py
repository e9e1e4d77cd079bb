"""Receive-datapath service classes, post-NIC hold times and the
event-driven admission queues (paper §3–§4): the QoS priority order the
fabric's admission water-fill follows, the release delays its recycle
rings use, and the QoS-priority FIFO pump behind ``JetService``."""
from __future__ import annotations

import collections
import enum
from typing import Callable, Deque, List, Optional


class QoS(enum.IntEnum):
    """Transfer service classes (paper §3.2); lower value = higher
    priority.  Priority order is the iteration order everywhere: RNIC
    buffer space allocation and drain budget."""
    HIGH = 0
    NORMAL = 1
    LOW = 2


N_QOS = len(QoS)


def expected_footprint(nbytes: int, expected_timespan_us: float) -> int:
    """Admission rule (§3.2 step 2): expected throughput x timespan,
    capped by the transfer size itself (Little's law working set)."""
    rate_gbps = 8.0 * nbytes / max(expected_timespan_us, 1e-9) / 1e3
    little = rate_gbps * 1e9 / 8.0 * expected_timespan_us * 1e-6
    return min(nbytes, int(little))


# --------------------------------------------------------------------------- #
# Event-driven admission (wrapped by JetService)
# --------------------------------------------------------------------------- #
class Admit(enum.Enum):
    """Outcome of a ``try_admit`` probe during a queue pump."""
    OK = "ok"          # admitted; pop and continue with this class
    DEFER = "defer"    # resource pressure; LOW falls back, others wait
    STOP = "stop"      # global limit (e.g. max concurrent); stop pumping


class AdmissionQueues:
    """QoS-priority FIFO admission queues (paper §3.2 step 3).

    Generic over the admitted item type: the caller supplies a
    ``try_admit(item) -> Admit`` probe (pool allocation, lane
    availability, ...) and optionally a ``fallback(item)`` sink invoked
    when a LOW-class head cannot be admitted (§5: low-QoS transfers fall
    back to DRAM buffers instead of waiting for cache).
    """

    def __init__(self) -> None:
        self._queues: "collections.OrderedDict[QoS, Deque]" = \
            collections.OrderedDict((q, collections.deque()) for q in QoS)

    def push(self, item, qos: QoS) -> None:
        self._queues[QoS(qos)].append(item)

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth(self, qos: QoS) -> int:
        return len(self._queues[QoS(qos)])

    def pump(self, try_admit: Callable[[object], "Admit"],
             fallback: Optional[Callable[[object], None]] = None) -> List:
        """Admit in QoS-priority, FIFO-within-class order.

        A ``DEFER`` head blocks only its own class (lower classes still
        get probed — small LOW transfers may fit where a big NORMAL one
        did not), except LOW itself, which falls back to ``fallback``
        and keeps draining.  ``STOP`` ends the pump entirely.
        """
        admitted: List = []
        for qos in QoS:
            q = self._queues[qos]
            while q:
                verdict = try_admit(q[0])
                if verdict is Admit.STOP:
                    return admitted
                if verdict is Admit.DEFER:
                    if qos is QoS.LOW and fallback is not None:
                        fallback(q.popleft())
                        continue
                    break
                admitted.append(q.popleft())
        return admitted



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
