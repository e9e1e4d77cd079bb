"""The Jet service facade (paper §3), the port's copy of
``repro.core.jet``: registration, QoS admission queues and the receive
workflow glue between the RNIC ("network"), the cache-resident buffer
pool, the recycle controller and the escape controller.

This is the host-side service object the serving engine drives
(:mod:`repro_torch.serving.engine`).  The admission machinery — QoS
classes, priority pump order, the expected-footprint rule and the §5
low-QoS DRAM fallback — is :class:`~repro_torch.core.datapath.AdmissionQueues`;
this facade binds it to the concrete pool/window/recycle/escape objects.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .datapath import Admit, AdmissionQueues, QoS, expected_footprint
from .escape import Action, EscapeConfig, EscapeController
from .pool import SlabPool
from .recycle import RecycleModel, paper_default
from .window import ReadWindow

SMALL_MSG_BYTES = 4 << 10  # paper §4.1.1: <4 KB -> SEND/RECV via SRQ


@dataclasses.dataclass
class JetConfig:
    pool_bytes: int = 12 << 20
    srq_bytes: int = 4 << 20            # small-message share (initial)
    srq_min_bytes: int = 1 << 20        # floor when rebalancing (paper §4.1.3)
    srq_wqes: int = 1024                # pre-posted 4 KB WQEs
    max_concurrency: int = 32
    max_inflight_bytes: int = 8 << 20
    expected_timespan_us: float = 200.0
    max_concurrent_transfers: int = 128
    escape: EscapeConfig = dataclasses.field(default_factory=EscapeConfig)


@dataclasses.dataclass
class Transfer:
    xfer_id: int
    app_id: int
    nbytes: int
    qos: QoS
    slots: List[int] = dataclasses.field(default_factory=list)
    small: bool = False


class JetService:
    """Admission + pool orchestration for the receive path (paper §3.2)."""

    def __init__(self, cfg: JetConfig = JetConfig(),
                 recycle: Optional[RecycleModel] = None):
        self.cfg = cfg
        self.pool = SlabPool(cfg.pool_bytes)
        self.window = ReadWindow(cfg.max_concurrency, cfg.max_inflight_bytes)
        self.recycle = recycle or paper_default()
        self.escape = EscapeController(cfg.escape)
        self._apps: Dict[int, QoS] = {}
        self._queues = AdmissionQueues()
        self._live: Dict[int, Transfer] = {}
        self._next_id = 0
        self.rejected_small = 0
        self.memory_fallbacks = 0   # low-QoS apps pushed to DRAM buffers (§5)
        # Network backpressure gate (PFC pause / fabric congestion): while
        # asserted, no new transfers are admitted to the pool — arrivals
        # are stalled on the wire, so reserving cache slots for them would
        # only deepen the pressure that caused the pause.
        self.network_paused = False

    # -- step 1: registration -------------------------------------------------
    def register(self, app_id: int, qos: QoS = QoS.NORMAL) -> None:
        self._apps[app_id] = qos

    # -- step 2: transfer request ---------------------------------------------
    def request(self, app_id: int, nbytes: int, now: float) -> int:
        """Host B announces a transfer; returns transfer id (queued)."""
        if app_id not in self._apps:
            raise KeyError(f"app {app_id} not registered with Jet")
        t = Transfer(self._next_id, app_id, nbytes, self._apps[app_id],
                     small=nbytes < SMALL_MSG_BYTES)
        self._next_id += 1
        self._queues.push(t, t.qos)
        return t.xfer_id

    def _expected_footprint(self, nbytes: int) -> int:
        """Admission rule (§3.2 step 2), shared with the fluid datapath."""
        return expected_footprint(nbytes, self.cfg.expected_timespan_us)

    # -- network feedback ------------------------------------------------------
    def set_backpressure(self, paused: bool) -> None:
        """Assert/clear the network backpressure gate (e.g. the receiver's
        PFC pause state, or fabric-level pool-danger signalling)."""
        self.network_paused = bool(paused)

    # -- step 3: admission + allocation ----------------------------------------
    def queue_depth(self, qos: Optional[QoS] = None) -> int:
        return (len(self._queues) if qos is None
                else self._queues.depth(qos))

    def pump(self, now: float) -> List[Transfer]:
        """Admit queued transfers in QoS-priority, FIFO-within-class order
        (the shared :class:`~repro.core.datapath.AdmissionQueues` pump)."""
        if self.network_paused:
            return []

        def try_admit(t: Transfer) -> Admit:
            if len(self._live) >= self.cfg.max_concurrent_transfers:
                return Admit.STOP
            need = self.pool.slots_needed(t.nbytes) * self.pool.slot_bytes
            if self._expected_footprint(t.nbytes) > \
                    self.pool.available_bytes or \
                    need > self.pool.available_bytes:
                return Admit.DEFER
            slots = self.pool.alloc(t.app_id, t.nbytes, now)
            if slots is None:
                return Admit.DEFER
            t.slots = slots
            self._live[t.xfer_id] = t
            return Admit.OK

        def fallback(t: Transfer) -> None:
            # §5: low-QoS transfers fall back to DRAM buffers
            self.memory_fallbacks += 1

        return self._queues.pump(try_admit, fallback)

    # -- steps 4-6: arrival notification + release ------------------------------
    def complete(self, xfer_id: int, now: float) -> None:
        """Application finished consuming; release slots back to the pool.

        Idempotent w.r.t. escape: an escape COPY may already have evicted
        the transfer's slots (and ``tick_escape`` may have dropped its
        bookkeeping) — completing such a transfer is a no-op, not an error.
        """
        t = self._live.pop(xfer_id, None)
        if t is None:
            return
        # slots may have been evicted by an escape COPY already
        live = [s for s in t.slots if s in self.pool._slots]
        if live:
            self.pool.free(t.app_id, live)

    def tick_escape(self, now: float) -> List[Tuple[Action, object]]:
        acts = self.escape.step(self.pool, now)
        for a, _ in acts:
            if a is Action.MARK_ECN:
                self.window.on_ecn()
        if all(a is Action.NONE for a, _ in acts):
            self.window.on_quiet()
        # drop bookkeeping for transfers fully evicted by COPY
        for xid in [x for x, t in self._live.items()
                    if not any(s in self.pool._slots for s in t.slots)]:
            self._live.pop(xid)
        return acts

    # -- introspection -----------------------------------------------------------
    def stats(self) -> dict:
        return dict(pool_available=self.pool.available_bytes,
                    live_transfers=len(self._live),
                    queued=len(self._queues),
                    queued_by_qos={q.name: self._queues.depth(q)
                                   for q in QoS},
                    window_cap=self.window.cap_bytes,
                    escape=dataclasses.asdict(self.escape.stats),
                    network_paused=self.network_paused,
                    memory_fallbacks=self.memory_fallbacks)
