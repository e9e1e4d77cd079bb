"""Cache-resident buffer pool (paper §4.1, §4.2.1): :class:`SlabPool`, the
host-side slab allocator that backs the Jet service.  It manages the
reserved "LLC" area at 4 KB slot granularity, tracks per-app allocations
in arrival order (monotonic timestamps -> O(1) straggler head check, paper
§4.3), and supports the escape controller's *replace* action (swap a
straggler slot for a DRAM-backed one so the recyclable size is constant).

:class:`DevicePool` is the device-side pool behind the paged KV cache
(``serving.kv_cache``): a free bitmap over the cache's pages.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Set, Tuple

import torch

from .._device import DeviceLike, resolve_device

SLOT_BYTES_DEFAULT = 4 * 1024  # paper: slab granularity 4 KB


# --------------------------------------------------------------------------- #
# Host-side slab pool
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _Slot:
    slot_id: int
    app_id: Optional[int] = None
    alloc_ts: float = 0.0
    replaced: bool = False  # True => DRAM-backed escape slot


class SlabPool:
    """Slab allocator over the reserved cache area (paper §4.2).

    ``capacity_bytes`` is the reserved LLC area (12 MB in the paper).
    Allocations are rounded up to whole 4 KB slots.  Slots belonging to one
    app are kept in allocation order, so the oldest slot is O(1) to find
    (paper: "checking the timestamp of the head node ... O(1)").
    """

    def __init__(self, capacity_bytes: int = 12 << 20,
                 slot_bytes: int = SLOT_BYTES_DEFAULT):
        if capacity_bytes % slot_bytes:
            raise ValueError("capacity must be a multiple of slot size")
        self.slot_bytes = slot_bytes
        self.num_slots = capacity_bytes // slot_bytes
        self._free: Deque[int] = collections.deque(range(self.num_slots))
        self._slots: Dict[int, _Slot] = {}
        # per-app FIFO of live slot ids (allocation order == timestamp order)
        self._by_app: Dict[int, Deque[int]] = collections.defaultdict(
            collections.deque)
        # escape bookkeeping
        self._replaced_live: Set[int] = set()
        self.replace_mem_bytes = 0          # DRAM currently borrowed (escape)
        self._next_extra_id = self.num_slots

    # -- basic queries ------------------------------------------------------
    @property
    def capacity_bytes(self) -> int:
        return self.num_slots * self.slot_bytes

    @property
    def used_slots(self) -> int:
        return len(self._slots)

    @property
    def available_bytes(self) -> int:
        return len(self._free) * self.slot_bytes

    @property
    def available_fraction(self) -> float:
        return len(self._free) / max(
            1, len(self._free) + len(self._slots) - len(self._replaced_live))

    def held_slots(self, app_id: int) -> int:
        return len(self._by_app.get(app_id, ()))

    def apps(self) -> List[int]:
        return [a for a, q in self._by_app.items() if q]

    # -- alloc / free -------------------------------------------------------
    def slots_needed(self, nbytes: int) -> int:
        return max(1, -(-nbytes // self.slot_bytes))

    def alloc(self, app_id: int, nbytes: int, now: float) -> Optional[List[int]]:
        """Allocate slots for ``nbytes``; None if the pool can't satisfy it."""
        n = self.slots_needed(nbytes)
        if n > len(self._free):
            return None
        ids = [self._free.popleft() for _ in range(n)]
        for sid in ids:
            self._slots[sid] = _Slot(sid, app_id, now)
            self._by_app[app_id].append(sid)
        return ids

    def free(self, app_id: int, slot_ids: List[int]) -> None:
        for sid in slot_ids:
            slot = self._slots.pop(sid, None)
            if slot is None:
                raise KeyError(f"double free of slot {sid}")
            if slot.app_id != app_id:
                raise ValueError(f"slot {sid} owned by {slot.app_id}, "
                                 f"freed by {app_id}")
            try:
                self._by_app[app_id].remove(sid)
            except ValueError:
                pass
            if slot.replaced:
                # a DRAM-backed escape slot retires instead of rejoining
                self._replaced_live.discard(sid)
                self.replace_mem_bytes -= self.slot_bytes
            else:
                self._free.append(sid)

    # -- straggler accounting (paper §4.3) ----------------------------------
    def oldest_age(self, app_id: int, now: float) -> float:
        q = self._by_app.get(app_id)
        if not q:
            return 0.0
        return now - self._slots[q[0]].alloc_ts

    def straggler_slots(self, app_id: int, now: float,
                        age_threshold: float) -> List[int]:
        """Slots held longer than ``age_threshold`` (oldest-first prefix)."""
        out: List[int] = []
        for sid in self._by_app.get(app_id, ()):
            if now - self._slots[sid].alloc_ts > age_threshold:
                out.append(sid)
            else:
                break  # timestamps are monotone within an app's deque
        return out

    def straggler_ratio(self, app_id: int, now: float,
                        age_threshold: float) -> float:
        held = self.held_slots(app_id)
        if held == 0:
            return 0.0
        return len(self.straggler_slots(app_id, now, age_threshold)) / held

    # -- escape actions (paper §4.3) -----------------------------------------
    def replace(self, slot_ids: List[int]) -> int:
        """Escape action 1: *replace straggler buffers*.

        Each straggler slot is re-backed by DRAM (it no longer occupies the
        reserved cache) and a fresh cache slot joins the free list, keeping the
        recyclable pool size constant.  Returns bytes of DRAM borrowed.
        """
        borrowed = 0
        for sid in slot_ids:
            slot = self._slots.get(sid)
            if slot is None or slot.replaced:
                continue
            slot.replaced = True
            self._replaced_live.add(sid)
            self.replace_mem_bytes += self.slot_bytes
            borrowed += self.slot_bytes
            # fresh DRAM-backed identity joins the free list in its stead
            self._free.append(self._next_extra_id)
            self._next_extra_id += 1
        return borrowed

    def evict_app(self, app_id: int) -> int:
        """Escape action 2: *copy to memory* — forcibly release all of an
        app's cache slots (data now lives in DRAM).  Returns bytes freed."""
        ids = list(self._by_app.get(app_id, ()))
        n = len(ids)
        if n:
            self.free(app_id, ids)
        return n * self.slot_bytes


# --------------------------------------------------------------------------- #
# Device-side pool (paged KV cache backing)
# --------------------------------------------------------------------------- #
class DevicePool:
    """Slab pool on the device: a free bitmap over ``num_slots`` pages.

    The reference's pool is functional (each call returns a new pool);
    this one updates ``free`` in place, as PyTorch code does, with the
    same semantics: :meth:`alloc` hands out the lowest free slots in
    ascending order, ``-1`` where too few are free, and :meth:`release`
    ignores entries ``< 0``.  Neither call reads anything back to the
    host: the slots are ranked by a cumulative sum on the device, so a
    caller that does not look at ``ok`` never waits for the card.
    """

    def __init__(self, free: torch.Tensor):
        self.free = free  # bool[num_slots]

    @classmethod
    def create(cls, num_slots: int,
               device: DeviceLike = None) -> "DevicePool":
        """All ``num_slots`` slots free, on ``device`` (CUDA unless the
        caller asks for the CPU)."""
        return cls(torch.ones((num_slots,), dtype=torch.bool,
                              device=resolve_device(device)))

    @property
    def num_slots(self) -> int:
        return self.free.shape[0]

    def available(self) -> torch.Tensor:
        return self.free.sum()

    def find(self, n: int) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
        """The slots :meth:`alloc` would take, without taking them:
        (idx int64[n], ok, taken bool[num_slots])."""
        rank = torch.cumsum(self.free, 0) - 1            # among free slots
        sel = self.free & (rank < n)
        idx = torch.full((n + 1,), -1, dtype=torch.int64,
                         device=self.free.device)
        slots = torch.arange(self.num_slots, device=self.free.device)
        # unselected slots land in the spare entry n, which is dropped
        idx.scatter_(0, torch.where(sel, rank, n), slots)
        idx = idx[:n]
        ok = (idx >= 0).all()
        # The reference scatters its "taken" mask with the -1 entries
        # redirected to slot 0, and XLA applies duplicate updates in order,
        # so after a short allocation slot 0 stays free even if it was
        # handed out.  Kept for parity (ROADMAP Queue 3).
        taken = sel.clone()
        taken[0] &= ok
        return idx, ok, taken

    def alloc(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Allocate ``n`` slots: (idx int64[n], ok).  When fewer than ``n``
        are free, ``ok`` is False, the missing entries of ``idx`` are -1
        (callers route those to the escape path) and the slots that were
        found are taken all the same."""
        idx, ok, taken = self.find(n)
        self.free &= ~taken
        return idx, ok

    def release(self, idx: torch.Tensor) -> None:
        """Free the slots listed in ``idx`` (entries < 0 are ignored)."""
        idx = idx.reshape(-1).long()
        valid = idx >= 0
        hits = torch.zeros(self.num_slots, dtype=torch.int32,
                           device=self.free.device)
        hits.index_add_(0, torch.where(valid, idx, 0), valid.int())
        self.free |= hits > 0
