"""Swift cache recycle controller (paper §4.2).

The recycle controller's goal: shrink the *post-NIC timespan* so that (by
Little's law) a smaller reserved cache sustains line rate.  The paper's three
accelerations are modeled explicitly so benchmarks can ablate them:

1. **multi-threading** — data-processing stages run ``threads``-wide;
2. **pipelining** — messages are cut into <=4 KB slices that flow through
   get -> process -> release; a slice's slot frees as soon as *that slice*
   is consumed rather than when the whole message is;
3. **simplification** — CRC offloaded to the NIC (cost 0) and struct-based
   in-place (de)serialization (huibuffer) instead of copy-based (protobuf).

This module is the quantitative model used by admission control, by the
simulator (``process_ns_per_byte`` sets the Jet receiver's slot holding time,
:func:`..datapath.hold_us_jet`) and by pool sizing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

SLICE_BYTES_DEFAULT = 4 << 10  # paper §4.2.2


def slice_message(nbytes: int, slice_bytes: int = SLICE_BYTES_DEFAULT
                  ) -> List[int]:
    if nbytes <= 0:
        raise ValueError("message must be positive-sized")
    full, rem = divmod(nbytes, slice_bytes)
    return [slice_bytes] * full + ([rem] if rem else [])


def little_law_bytes(rate_gbps: float, timespan_us: float) -> float:
    """Average resident bytes = arrival rate x residence time (paper §2.2).

    e.g. 200 Gbps x 200 us = 5 MB — the feasibility argument for RDCA."""
    return rate_gbps * 1e9 / 8.0 * timespan_us * 1e-6


@dataclasses.dataclass
class RecycleModel:
    """Post-NIC timespan model for one received message.

    Default per-byte costs are calibrated so that the *unoptimized* pipeline
    yields a few hundred us for 256 KB messages (paper §1: "hundreds of us on
    average") and the optimized one tens of us.
    """
    # stage costs
    get_ns_per_byte: float = 0.012       # RNIC -> cache landing (PCIe-paced)
    crc_ns_per_byte: float = 0.25        # software CRC32C
    serialize_ns_per_byte: float = 0.30  # protobuf-style copy (de)serialize
    app_ns_per_byte: float = 0.10        # application touch/consume
    fixed_overhead_us: float = 3.0       # syscalls, completion handling
    # optimizations (paper §4.2.2)
    threads: int = 1
    pipelined: bool = False
    crc_offload: bool = False            # CRC -> RNIC (CX-5+)
    struct_serialization: bool = False   # huibuffer: in-place, ~zero copy
    slice_bytes: int = SLICE_BYTES_DEFAULT

    # -- derived ------------------------------------------------------------
    def process_ns_per_byte(self) -> float:
        crc = 0.0 if self.crc_offload else self.crc_ns_per_byte
        ser = (0.02 if self.struct_serialization
               else self.serialize_ns_per_byte)
        return (crc + ser + self.app_ns_per_byte) / max(1, self.threads)

    def slot_holding_time_us(self, msg_bytes: int) -> float:
        """How long one buffer slot stays allocated (drives pool sizing).

        Non-pipelined: the whole message's slots are held until the full
        message is processed.  Pipelined: a slot is held for roughly one
        slice's transit through the 3 deep stages.
        """
        per_byte = self.get_ns_per_byte + self.process_ns_per_byte()
        if not self.pipelined:
            return self.fixed_overhead_us + msg_bytes * per_byte * 1e-3
        n_slices = len(slice_message(msg_bytes, self.slice_bytes))
        slice_us = self.slice_bytes * per_byte * 1e-3
        # 3-stage pipeline: a slot is occupied for ~3 slice-times, plus the
        # fixed overhead amortized over all slices of the message.
        return 3.0 * slice_us + self.fixed_overhead_us / n_slices

    def message_latency_us(self, msg_bytes: int) -> float:
        """End-to-end post-NIC latency of the *message* (not slot time)."""
        per_byte = self.get_ns_per_byte + self.process_ns_per_byte()
        base = self.fixed_overhead_us + msg_bytes * per_byte * 1e-3
        if not self.pipelined:
            return base
        # pipeline overlaps get/process/release: ~ dominated by slowest stage
        bottleneck = max(self.get_ns_per_byte, self.process_ns_per_byte())
        return (self.fixed_overhead_us + 3 * self.slice_bytes * per_byte * 1e-3
                + msg_bytes * bottleneck * 1e-3)

    def resident_bytes(self, rate_gbps: float, msg_bytes: int) -> float:
        """Little's-law average pool occupancy at ``rate_gbps``."""
        return little_law_bytes(rate_gbps,
                                self.slot_holding_time_us(msg_bytes))

    def required_pool_bytes(self, rate_gbps: float, msg_bytes: int,
                            headroom: float = 2.0) -> int:
        """Pool size with jitter headroom, rounded up to whole MB."""
        need = self.resident_bytes(rate_gbps, msg_bytes) * headroom
        return int(math.ceil(need / (1 << 20))) << 20


def paper_default() -> RecycleModel:
    """The fully-optimized Jet configuration (paper §4.2)."""
    return RecycleModel(threads=4, pipelined=True, crc_offload=True,
                        struct_serialization=True)


def paper_unoptimized() -> RecycleModel:
    """Strawman: single-threaded, message-granular, software CRC, protobuf."""
    return RecycleModel()
