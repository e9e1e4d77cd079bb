"""Receiver-side READ control (paper §4.1.2).

Two coupled sliding windows govern large-message ("READ") admission:

* a **concurrency window** — at most ``max_concurrency`` READs in flight
  (paper: 32; Fig. 5 shows 4 already saturates 2x100 Gbps);
* an **in-flight-bytes window** — at most ``max_inflight_bytes`` of requested
  data in transit (paper: 8 MB).

Messages are fragmented to ``fragment_bytes`` (paper: 256 KB) before entering
the window.  Requests that do not fit wait in a FIFO queue (paper: "queued and
deferred until sufficient window capacity is allocated").

The window also implements the DCQCN-inspired AIMD backpressure that replaces
ECN-in-CNP on TPU (DESIGN.md §2, assumption 2): ``on_ecn`` multiplicatively
shrinks the byte window; ``on_quiet`` additively recovers it.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

FRAGMENT_BYTES_DEFAULT = 256 << 10   # paper §4.1.2
MAX_CONCURRENCY_DEFAULT = 32         # paper Fig. 5 / §4.1.2
MAX_INFLIGHT_BYTES_DEFAULT = 8 << 20 # paper §4.1.2


def fragment(nbytes: int, fragment_bytes: int = FRAGMENT_BYTES_DEFAULT
             ) -> List[int]:
    """Slice a message into fragments of at most ``fragment_bytes``."""
    if nbytes <= 0:
        raise ValueError("message must be positive-sized")
    full, rem = divmod(nbytes, fragment_bytes)
    return [fragment_bytes] * full + ([rem] if rem else [])


@dataclasses.dataclass
class ReadRequest:
    req_id: int
    nbytes: int
    submit_ts: float
    admit_ts: Optional[float] = None


class ReadWindow:
    """Concurrency + in-flight-bytes sliding windows with FIFO deferral."""

    def __init__(self,
                 max_concurrency: int = MAX_CONCURRENCY_DEFAULT,
                 max_inflight_bytes: int = MAX_INFLIGHT_BYTES_DEFAULT,
                 fragment_bytes: int = FRAGMENT_BYTES_DEFAULT,
                 min_inflight_bytes: Optional[int] = None,
                 aimd_beta: float = 0.5,
                 aimd_step: int = 256 << 10):
        self.max_concurrency = max_concurrency
        self.max_inflight_bytes = max_inflight_bytes
        self.fragment_bytes = fragment_bytes
        # AIMD state (escape backpressure)
        self._cap_bytes = max_inflight_bytes
        self._min_bytes = min_inflight_bytes or fragment_bytes
        self._beta = aimd_beta
        self._step = aimd_step
        # windows
        self.inflight: Dict[int, ReadRequest] = {}
        self.inflight_bytes = 0
        self.pending: Deque[ReadRequest] = collections.deque()
        self._next_id = 0
        # stats
        self.admitted = 0
        self.deferred = 0
        self.ecn_events = 0

    # -- public API ----------------------------------------------------------
    @property
    def cap_bytes(self) -> int:
        return self._cap_bytes

    def submit(self, nbytes: int, now: float) -> int:
        """Submit a READ; returns its id. Fragmentation happens on admit."""
        if nbytes > self.fragment_bytes:
            # window admission operates on fragments; large messages are
            # split and each fragment becomes its own READ (paper §4.1.2).
            raise ValueError(
                "submit() takes a single fragment; use submit_message()")
        req = ReadRequest(self._next_id, nbytes, now)
        self._next_id += 1
        self.pending.append(req)
        return req.req_id

    def submit_message(self, nbytes: int, now: float) -> List[int]:
        return [self.submit(f, now) for f in fragment(nbytes,
                                                      self.fragment_bytes)]

    def pump(self, now: float) -> List[ReadRequest]:
        """Admit FIFO-pending requests while both windows have room."""
        admitted = []
        while self.pending:
            head = self.pending[0]
            if (len(self.inflight) + 1 > self.max_concurrency or
                    self.inflight_bytes + head.nbytes > self._cap_bytes):
                self.deferred += 1
                break
            self.pending.popleft()
            head.admit_ts = now
            self.inflight[head.req_id] = head
            self.inflight_bytes += head.nbytes
            self.admitted += 1
            admitted.append(head)
        return admitted

    def complete(self, req_id: int) -> ReadRequest:
        req = self.inflight.pop(req_id)
        self.inflight_bytes -= req.nbytes
        return req

    # -- AIMD backpressure (DESIGN.md: ECN -> window) -------------------------
    def on_ecn(self) -> None:
        self.ecn_events += 1
        self._cap_bytes = max(self._min_bytes,
                              int(self._cap_bytes * self._beta))

    def on_quiet(self) -> None:
        self._cap_bytes = min(self.max_inflight_bytes,
                              self._cap_bytes + self._step)

    # -- invariants (used by property tests) ---------------------------------
    def check_invariants(self) -> None:
        assert len(self.inflight) <= self.max_concurrency
        assert self.inflight_bytes <= self._cap_bytes <= self.max_inflight_bytes
        assert self.inflight_bytes == sum(r.nbytes
                                          for r in self.inflight.values())
        assert self._cap_bytes >= self._min_bytes
