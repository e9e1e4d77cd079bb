"""Swift cache recycle controller (paper §4.2): the post-NIC timespan
model whose per-byte costs set the Jet receiver's slot holding time.

Only the configuration and the arithmetic the fabric engine reads are
kept (``process_ns_per_byte`` feeds :func:`..datapath.hold_us_jet`).
"""
from __future__ import annotations

import dataclasses

SLICE_BYTES_DEFAULT = 4 << 10  # paper §4.2.2


@dataclasses.dataclass
class RecycleModel:
    """Post-NIC timespan model for one received message."""
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

    def process_ns_per_byte(self) -> float:
        crc = 0.0 if self.crc_offload else self.crc_ns_per_byte
        ser = (0.02 if self.struct_serialization
               else self.serialize_ns_per_byte)
        return (crc + ser + self.app_ns_per_byte) / max(1, self.threads)


def paper_default() -> RecycleModel:
    """The fully-optimized Jet configuration (paper §4.2)."""
    return RecycleModel(threads=4, pipelined=True, crc_offload=True,
                        struct_serialization=True)
