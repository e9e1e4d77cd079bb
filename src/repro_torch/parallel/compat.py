"""What the reference's ``repro.parallel.compat`` answers for the port.

The reference's module is a version shim for JAX: ``shard_map`` over
two API generations, and ``PARTIAL_MANUAL_SAFE``, whether partial-manual
``shard_map`` survives a scan.  Both belong to JAX's versions and have no
counterpart here by design: the port runs SPMD with one process a rank,
so there is no ``shard_map`` to wrap.  What carries over is the probe
the sweep farm asks before it spreads chunks over devices.
"""
from __future__ import annotations

from typing import Tuple

import torch


def farm_dispatch_probe(min_devices: int = 2) -> Tuple[bool, str]:
    """Can the sweep farm spread chunks over the local cards?

    Returns ``(ok, reason)``: ``ok`` when this process sees at least
    ``min_devices`` CUDA devices.  ``reason`` is human-readable, for the
    run manifest."""
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_dev < min_devices:
        return False, (f"only {n_dev} local CUDA device(s) (need >= "
                       f"{min_devices}); chunks run on one device")
    return True, f"{n_dev} local CUDA devices"
