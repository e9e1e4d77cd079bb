"""Cache-pressure-aware escape controller (paper §4.3, Algorithm 1).

Three escalating actions when the cache-resident buffer pool runs low:

1. ``REPLACE``  — swap straggler buffers for DRAM-backed ones (pool size
   constant, bounded by ``MEM_ESC`` borrowed DRAM);
2. ``COPY``     — for every app whose straggler ratio exceeds ``CREDIT``,
   copy its resident data to DRAM and free its cache slots;
3. ``MARK_ECN`` — last resort: signal congestion back to senders (on TPU:
   shrink the chunk-scheduler window, see window.ReadWindow.on_ecn).

Thresholds: CACHE_DANGER < CACHE_SAFE (fractions of pool available).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple

from .pool import SlabPool


class Action(enum.Enum):
    NONE = "none"
    REPLACE = "replace"
    COPY = "copy"
    MARK_ECN = "mark_ecn"


@dataclasses.dataclass
class EscapeConfig:
    cache_safe: float = 0.20      # act when < 20% of pool is available
    cache_danger: float = 0.05    # last resort when < 5% available
    mem_esc_bytes: int = 2 << 20  # max DRAM borrowed via REPLACE
    credit: float = 0.5           # straggler ratio marking a slow app
    straggler_age: float = 1e-3   # seconds a slot may live before straggling
    max_replace_per_tick: int = 64


@dataclasses.dataclass
class EscapeStats:
    replaces: int = 0
    copies: int = 0
    ecn_marks: int = 0
    bytes_copied: int = 0
    bytes_replaced: int = 0


class EscapeController:
    """Faithful implementation of the paper's Algorithm 1."""

    def __init__(self, cfg: EscapeConfig = EscapeConfig()):
        self.cfg = cfg
        self.stats = EscapeStats()

    def step(self, pool: SlabPool, now: float
             ) -> List[Tuple[Action, object]]:
        """One escape() invocation. Returns the actions taken (with args)."""
        cfg = self.cfg
        actions: List[Tuple[Action, object]] = []
        avl = pool.available_bytes / max(1, pool.capacity_bytes)

        if avl >= cfg.cache_safe:                 # pool is fine
            return [(Action.NONE, None)]

        if pool.replace_mem_bytes < cfg.mem_esc_bytes:
            # Action 1: replace straggler buffers.
            replaced = 0
            for app in pool.apps():
                for sid in pool.straggler_slots(app, now, cfg.straggler_age):
                    if (replaced >= cfg.max_replace_per_tick or
                            pool.replace_mem_bytes >= cfg.mem_esc_bytes):
                        break
                    self.stats.bytes_replaced += pool.replace([sid])
                    replaced += 1
            if replaced:
                self.stats.replaces += replaced
                actions.append((Action.REPLACE, replaced))
        else:
            # Action 2: copy slow-releasing apps' data to DRAM.
            for app in pool.apps():
                if pool.straggler_ratio(app, now,
                                        cfg.straggler_age) > cfg.credit:
                    freed = pool.evict_app(app)
                    self.stats.copies += 1
                    self.stats.bytes_copied += freed
                    actions.append((Action.COPY, app))

        # Action 3: if still in danger, mark ECN.
        avl = pool.available_bytes / max(1, pool.capacity_bytes)
        if avl < cfg.cache_danger:
            self.stats.ecn_marks += 1
            actions.append((Action.MARK_ECN, None))

        return actions or [(Action.NONE, None)]
