"""Op-granular message layer decorated over the fluid fabric core.

The fluid engines move *bytes*; the paper's headline claims are about
*tail message latency* (memory-bandwidth contention causes "a large
increase of tail latency"; Lamda cuts HPC communication latency by
35.1%).  This module adds the op layer without abandoning the fluid
core: a flow with a :class:`MessageConfig` is interpreted as a stream of
fixed-size verbs operations riding the flow's byte stream.  Message
``k`` *starts* when the flow's cumulative injected bytes first exceed
``k * msg_bytes`` (its first byte enters the stream — op latency
includes serialization, like a verbs post-to-CQE time) and *completes*
when cumulative delivered bytes reach ``(k+1) * msg_bytes`` — so drops
and RNIC tail-drops, which the fluid core
re-credits to ``injected`` (go-back-N retransmission), automatically
stretch exactly the in-flight messages' latency, and an outstanding
window ``W`` caps ``injected - delivered`` at ``W * msg_bytes`` (the
classic verbs queue-depth sweep knob).

Verbs semantics follow the RDMA verbs split the paper's testbed
measures:

``write``
    One-sided RDMA WRITE: no receiver CPU involvement.  Per-op issue
    overhead ``write_gap_us`` caps the op rate (the Mops plateau for
    small messages); the wire latency is the message latency.
``send``
    Two-sided SEND/RECV: the receiver must post + complete a WQE, so
    each op pays ``send_extra_us`` of receiver-side completion latency
    on top of the wire time, and the per-op gap ``send_gap_us`` is
    larger (both sides touch descriptors).

Per-message completion times feed two percentile paths with a tested
agreement bound:

* the scalar driver keeps the exact per-message latency list
  (:class:`MessageTracker`) — sort + nearest-rank gives the reference
  p50/p99/p999;
* the vector engine folds completions into a fixed
  ``HIST_BUCKETS``-bucket log-spaced histogram (:class:`LogHistogram`
  arithmetic, streamed as a per-flow count tensor) whose geometric-
  midpoint percentile estimate is within a *documented* relative bound
  of the exact value: buckets grow by ``r = (hi/lo)**(1/B)`` per step,
  the midpoint is off from any value in the bucket by at most a factor
  ``sqrt(r)``, hence ``rel_error <= sqrt(r) - 1``
  (:func:`hist_rel_error_bound`; ~4.7% for the default 128 buckets over
  [1 us, 1e5 us]).  ``tests/test_torch_messages.py`` holds it.

Message counting uses ``floor(bytes / msg_bytes + MSG_COUNT_EPS)`` in
every engine: the epsilon (1e-6 of a message) makes the count robust to
the ~1e-13-relative accumulation differences between the scalar float64
sums and the split hi/lo accumulators of the vector engines, so a burst
that ends exactly on a message boundary counts identically everywhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

VERBS = ("write", "send")
RECOVERY_MODES = ("go_back_n", "selective")

# log-histogram domain shared by every engine: 1 us (one tick — nothing
# completes faster) to 100 ms (the default sim horizon)
HIST_MIN_US = 1.0
HIST_MAX_US = 1e5
HIST_BUCKETS = 128

# counting slack, in units of one message (see module docstring)
MSG_COUNT_EPS = 1e-6


@dataclasses.dataclass
class MessageConfig:
    """Op-layer interpretation of one flow's byte stream.

    ``window=None`` means an unbounded outstanding window: the op layer
    only *observes* the fluid stream (message latencies are still
    recorded) without ever gating injection — with DCQCN this reproduces
    the plain fluid goodput.  The vector engines require a finite
    window (state is carried in a fixed ring); use the scalar driver
    for the unbounded case.
    """
    verb: str = "write"
    msg_bytes: float = 64 * 1024
    window: Optional[int] = 16           # max outstanding messages
    # per-op issue overhead (us) — caps the op rate: the Mops plateau
    # observed for small messages when the wire is not the bottleneck
    write_gap_us: float = 0.25
    send_gap_us: float = 0.70
    # two-sided receive completion cost added to every SEND's latency
    send_extra_us: float = 1.5
    # loss recovery (active only when FabricConfig.faults is set — see
    # repro_torch.fabric.faults): go_back_n replays the whole outstanding
    # span after an RTO with exponential backoff and discards
    # out-of-gap arrivals as duplicates; selective (IRN-style) keeps
    # what arrived and replays only the lost span after a NACK delay
    recovery: str = "go_back_n"
    rto_us: float = 50.0                 # base retransmission timeout
    rto_backoff: float = 2.0             # RTO multiplier per retry
    rto_cap: int = 6                     # max backoff doublings
    nack_us: float = 8.0                 # selective-retransmit delay

    def __post_init__(self) -> None:
        if self.verb not in VERBS:
            raise ValueError(f"unknown verb {self.verb!r}; "
                             f"pick one of {VERBS}")
        if self.msg_bytes <= 0.0:
            raise ValueError("msg_bytes must be positive")
        if self.window is not None and self.window < 1:
            raise ValueError("window must be >= 1 (or None for unbounded)")
        if self.write_gap_us <= 0.0 or self.send_gap_us <= 0.0:
            raise ValueError("per-op gaps must be positive")
        if self.send_extra_us < 0.0:
            raise ValueError("send_extra_us must be >= 0")
        if self.recovery not in RECOVERY_MODES:
            raise ValueError(f"unknown recovery {self.recovery!r}; "
                             f"pick one of {RECOVERY_MODES}")
        if self.rto_us <= 0.0 or self.nack_us <= 0.0:
            raise ValueError("rto_us and nack_us must be positive")
        if self.rto_backoff < 1.0:
            raise ValueError("rto_backoff must be >= 1")
        if self.rto_cap < 0:
            raise ValueError("rto_cap must be >= 0")

    @property
    def op_gap_us(self) -> float:
        return self.write_gap_us if self.verb == "write" \
            else self.send_gap_us

    @property
    def extra_us(self) -> float:
        """Latency added to every message (two-sided completion cost)."""
        return self.send_extra_us if self.verb == "send" else 0.0

    @property
    def op_rate_gbps(self) -> float:
        """Issue-rate cap as a byte rate: one op per ``op_gap_us``.

        ``msg_bytes * 8 bits / (gap us)`` — for large messages this is
        far above any line rate (the wire dominates); for small ones it
        is the binding cap that produces the Mops plateau.
        """
        return self.msg_bytes * 0.008 / self.op_gap_us

    def verb_code(self) -> int:
        """Integer code for stacked per-point parameters (vector)."""
        return VERBS.index(self.verb)

    def recovery_code(self) -> int:
        """Integer code for stacked per-point parameters (vector)."""
        return RECOVERY_MODES.index(self.recovery)


def msg_count(total_bytes: float, msg_bytes: float) -> int:
    """Whole messages contained in ``total_bytes`` (epsilon-robust).

    Counts *completion* crossings: message ``i`` is covered once
    ``total_bytes >= (i+1) * msg_bytes``."""
    return int(math.floor(total_bytes / msg_bytes + MSG_COUNT_EPS))


def msg_started(total_bytes: float, msg_bytes: float) -> int:
    """Messages whose *first* byte is inside ``total_bytes``.

    A verbs op is posted when its first byte enters the stream, so op
    latency includes serialization: ``ceil`` rather than ``floor``, with
    the same epsilon convention (an exact multiple starts nothing new).
    """
    return int(math.ceil(total_bytes / msg_bytes - MSG_COUNT_EPS))


def exact_percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of exact samples; 0.0 on an empty set.

    ``rank = ceil(q/100 * n)`` (clamped to [1, n]) — the same convention
    the histogram estimator applies to bucket counts, so the two paths
    agree up to bucket quantization only.
    """
    n = len(values)
    if n == 0:
        return 0.0
    s = sorted(values)
    rank = max(1, min(n, int(math.ceil(q / 100.0 * n))))
    return s[rank - 1]


def hist_ratio(lo: float = HIST_MIN_US, hi: float = HIST_MAX_US,
               buckets: int = HIST_BUCKETS) -> float:
    """Per-bucket growth factor ``r`` of the log-spaced histogram."""
    return (hi / lo) ** (1.0 / buckets)


def hist_rel_error_bound(lo: float = HIST_MIN_US, hi: float = HIST_MAX_US,
                         buckets: int = HIST_BUCKETS) -> float:
    """Documented worst-case relative error of the midpoint estimate.

    A value in bucket ``b`` lies in ``[lo*r^b, lo*r^(b+1))``; the
    estimate is the geometric midpoint ``lo*r^(b+0.5)``, at most a
    factor ``sqrt(r)`` away, i.e. relative error ``sqrt(r) - 1``.
    The bound only covers in-domain samples: latencies above ``hi``
    land in the explicit overflow counter (:class:`LogHistogram`
    ``overflow_count``), where no midpoint exists — a percentile that
    lands in overflow is reported as ``hi`` (a *lower* bound) and
    :meth:`LogHistogram.rel_error_bound` widens to ``inf`` so the
    violation is signalled rather than silent.
    """
    return math.sqrt(hist_ratio(lo, hi, buckets)) - 1.0


def hist_bucket(v_us: float, lo: float = HIST_MIN_US,
                hi: float = HIST_MAX_US,
                buckets: int = HIST_BUCKETS) -> int:
    """Bucket index of a latency sample (clamped into [0, buckets-1])."""
    if v_us <= lo:
        return 0
    b = int(math.floor(math.log(v_us / lo) / math.log(hist_ratio(
        lo, hi, buckets))))
    return min(max(b, 0), buckets - 1)


def hist_estimate(bucket: int, lo: float = HIST_MIN_US,
                  hi: float = HIST_MAX_US,
                  buckets: int = HIST_BUCKETS) -> float:
    """Geometric-midpoint latency estimate of a bucket."""
    return lo * hist_ratio(lo, hi, buckets) ** (bucket + 0.5)


class LogHistogram:
    """Streaming fixed-bucket log histogram with nearest-rank percentiles.

    The deterministic reference implementation of the arithmetic the
    vector engines carry as a ``[buckets]`` count tensor per flow —
    same bucket edges, same midpoint estimate, same nearest-rank
    convention as :func:`exact_percentile`.
    """

    def __init__(self, lo: float = HIST_MIN_US, hi: float = HIST_MAX_US,
                 buckets: int = HIST_BUCKETS):
        if not (hi > lo > 0.0) or buckets < 1:
            raise ValueError("need hi > lo > 0 and buckets >= 1")
        self.lo, self.hi, self.buckets = lo, hi, buckets
        self.counts = [0] * buckets
        self.n = 0
        # samples above hi: counted (they are real completions — n and
        # percentile ranks include them) but kept out of the in-range
        # buckets, whose midpoint estimate would otherwise silently
        # report a value *below* the true latency
        self.overflow_count = 0

    def add(self, v_us: float) -> None:
        if v_us > self.hi:
            self.overflow_count += 1
        else:
            self.counts[hist_bucket(v_us, self.lo, self.hi,
                                    self.buckets)] += 1
        self.n += 1

    def rel_error_bound(self) -> float:
        """The documented midpoint bound — widened to ``inf`` when any
        sample overflowed the domain (the overflow region has no
        midpoint, so no finite bound holds)."""
        if self.overflow_count:
            return math.inf
        return hist_rel_error_bound(self.lo, self.hi, self.buckets)

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile; 0.0 on an empty histogram.  A
        rank that lands in the overflow region reports ``hi`` — an
        explicit lower bound on the true value (check
        :attr:`overflow_count` / :meth:`rel_error_bound`)."""
        if self.n == 0:
            return 0.0
        rank = max(1, min(self.n, int(math.ceil(q / 100.0 * self.n))))
        acc = 0
        for b, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return hist_estimate(b, self.lo, self.hi, self.buckets)
        return self.hi


def percentile_from_counts(counts, q: float, lo: float = HIST_MIN_US,
                           hi: float = HIST_MAX_US, overflow=None):
    """Vectorized nearest-rank percentile over histogram count arrays.

    ``counts`` is any numpy-like array ``[..., B]`` (the vector engines'
    per-flow or per-point histograms); returns ``[...]`` midpoint
    estimates, 0.0 where the histogram is empty.  ``overflow`` is an
    optional ``[...]`` count of samples above ``hi`` (the vector twin
    of :attr:`LogHistogram.overflow_count`): overflowed samples join
    the rank denominator, and a rank landing in the overflow region
    reports ``hi`` — an explicit lower bound — instead of an in-range
    midpoint below the true value.  Imports numpy lazily so the scalar
    path stays dependency-free.
    """
    import numpy as np
    c = np.asarray(counts, dtype=np.float64)
    buckets = c.shape[-1]
    in_range = c.sum(axis=-1)
    over = np.zeros_like(in_range) if overflow is None \
        else np.asarray(overflow, dtype=np.float64)
    n = in_range + over
    rank = np.maximum(1.0, np.minimum(n, np.ceil(q / 100.0 * n)))
    cum = np.cumsum(c, axis=-1)
    idx = np.argmax(cum >= rank[..., None], axis=-1)
    est = lo * hist_ratio(lo, hi, buckets) ** (idx + 0.5)
    est = np.where(rank > in_range, hi, est)
    return np.where(n > 0, est, 0.0)


class MessageTracker:
    """Exact per-flow message bookkeeping for the scalar driver.

    ``observe(now, injected, delivered)`` is called once per tick with
    the flow's cumulative byte counters (post re-credit, so go-back-N
    losses keep the affected messages open).  Message ``i`` starts when
    its first byte injects (``injected`` crosses ``i * msg_bytes``) and
    completes when its last byte lands (``delivered`` crosses
    ``(i+1) * msg_bytes``), so the recorded latency covers
    serialization + transit + queueing + retransmission, like a verbs
    post-to-CQE time.  The started high-water mark only ever grows — a
    re-credit that drops ``injected`` below an already-started
    message's threshold does *not* restart it; the message keeps its
    original start time and simply completes later (go-back-N: the op
    is done when its bytes finally all arrive).
    """

    def __init__(self, cfg: MessageConfig):
        self.cfg = cfg
        self.starts: List[float] = []        # start time per message index
        self.latencies: List[float] = []     # completion order == index order
        self.hw = 0                          # messages started
        self.done = 0                        # messages completed
        self.last_done_us = 0.0
        # latencies above the shared histogram domain (HIST_MAX_US):
        # exact percentiles are unaffected, but any histogram built
        # from this flow would overflow — nonzero means the documented
        # 4.6% bound does not hold for this flow's tail
        self.overflow_count = 0

    @property
    def outstanding(self) -> int:
        return self.hw - self.done

    def window_room_bytes(self, injected: float, delivered: float) -> float:
        """Bytes the outstanding window still admits (inf if unbounded)."""
        if self.cfg.window is None:
            return math.inf
        return max(self.cfg.window * self.cfg.msg_bytes
                   - (injected - delivered), 0.0)

    def observe(self, now_us: float, injected: float, delivered: float,
                start_us: Optional[float] = None) -> None:
        """Record this tick's crossings.  ``now_us`` is the tick's *end*
        (completion timestamp); ``start_us`` is the tick's *beginning*
        (start timestamp of messages first injected this tick), so a
        message injected and delivered within one cut-through tick
        reports one tick of latency — the fluid model's floor — rather
        than zero, keeping every sample inside the histogram domain.
        """
        if start_us is None:
            start_us = now_us
        m = self.cfg.msg_bytes
        ns = msg_started(injected, m)
        while self.hw < ns:
            self.starts.append(start_us)
            self.hw += 1
        nd = min(msg_count(delivered, m), self.hw)
        extra = self.cfg.extra_us
        while self.done < nd:
            lat = now_us - self.starts[self.done] + extra
            self.latencies.append(lat)
            if lat > HIST_MAX_US:
                self.overflow_count += 1
            self.done += 1
            self.last_done_us = now_us

    def percentile(self, q: float) -> float:
        return exact_percentile(self.latencies, q)
