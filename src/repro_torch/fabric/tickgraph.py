"""Static-buffer tick chains, captured as CUDA graphs on the card.

An engine's tick loop issues hundreds of small kernels a tick from the
host.  :class:`TickChain` runs the same tick body over *static* state
buffers so that a chain of ticks can be captured once as a CUDA graph
and replayed: the port's counterpart of the reference's compiled
``lax.scan`` / ``lax.while_loop`` programs.

The body is ``body(s) -> s``: one iteration from the state dict ``s``.
It may return new tensors, write ring tensors of ``s`` in place, and
advance the 0-d counter tensors it closes over in place (the tick is a
device tensor, so a replay needs nothing from the host).  A chain of
``n`` iterations feeds each body the previous one's dict and, at its
end, copies every key of the last dict back into its static buffer once;
a key whose output *is* its buffer (a ring written in place) is skipped.

With ``capture`` (CUDA) the constructor warms the body up on a side
stream, captures a graph of one iteration and one of ``chain``
iterations (with Python's cyclic garbage collector off, see
:func:`_no_gc`), and then restores the real initial state and counters:
the warm-up advances the buffers and the in-place rings.  Without it the
same chains run eagerly, so a CPU run executes everything but the
capture.
A capture or replay error raises; nothing falls back to the eager loop.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_WARMUP = 2          # iterations run on a side stream before capture


class TickChain:
    """Runs ``body`` over the static buffers ``state`` (see the module
    docstring).  ``counters`` are the 0-d tensors the body advances.
    ``counts`` (a :class:`repro_torch._device.LaunchCounts`), where given,
    gives ``per_iteration``: the launches captured for one iteration.
    The counts themselves are the wrappers' own: the warm-up's launches
    on the host, the replays' on the card."""

    def __init__(self, body: Callable, state: Dict[str, torch.Tensor],
                 counters: Sequence[torch.Tensor], chain: int,
                 capture: bool, counts: Optional[dict] = None):
        if chain < 1:
            raise ValueError(f"chain must be >= 1, got {chain}")
        self.body = body
        self.state = state
        self.counters = tuple(counters)
        self.chain = chain
        self.counts = counts
        self.per_iteration: Dict[str, int] = {}
        self.graphs: Optional[Tuple] = None
        if capture:
            self._capture()

    def enqueue(self, n: int) -> None:
        """Issue ``n`` chained iterations and the copy-back."""
        s = self.state
        for _ in range(n):
            s = self.body(s)
        if s.keys() != self.state.keys():
            raise RuntimeError("the tick body changed the state's keys: "
                               f"{sorted(set(s) ^ set(self.state))}")
        for k, v in s.items():
            buf = self.state[k]
            if v is buf:
                continue
            if (v.dtype, v.shape, v.stride()) != \
                    (buf.dtype, buf.shape, buf.stride()):
                # a silent cast or relayout would part the chain from the
                # eager loop, which carries the body's own tensors
                raise RuntimeError(
                    f"state {k!r}: the body returns {v.dtype} "
                    f"{tuple(v.shape)} strides {v.stride()}, the buffer is "
                    f"{buf.dtype} {tuple(buf.shape)} strides {buf.stride()}")
            buf.copy_(v)

    def _capture(self) -> None:
        dev = next(iter(self.state.values())).device
        keep = {k: v.clone() for k, v in self.state.items()}
        keep_ctr = [c.clone() for c in self.counters]
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.enqueue(_WARMUP)
        main.wait_stream(side)
        one = torch.cuda.CUDAGraph()
        mark = dict(self.counts.captured) if self.counts is not None \
            else {}
        # capture on this device's own stream: ``torch.cuda.graph``'s
        # default capture stream is made once, on the device current at
        # the process's first capture, and a capture of another card's
        # work on it fails
        with _no_gc(), torch.cuda.graph(one, stream=side):
            self.enqueue(1)
        if self.counts is not None:
            self.per_iteration = {k: self.counts.captured[k] - mark[k]
                                  for k in mark}
        many = one
        if self.chain > 1:
            many = torch.cuda.CUDAGraph()
            with _no_gc(), torch.cuda.graph(many, stream=side):
                self.enqueue(self.chain)
        self.graphs = (one, many)
        for k, v in keep.items():
            self.state[k].copy_(v)
        for c, c0 in zip(self.counters, keep_ctr):
            c.copy_(c0)
        torch.cuda.synchronize(dev)

    def run(self, n: int) -> None:
        """Advance ``n`` iterations: ``n // chain`` chains of ``chain`` and
        ``n % chain`` single iterations, replayed or enqueued."""
        q, r = divmod(n, self.chain)
        if self.graphs is None:
            for _ in range(q):
                self.enqueue(self.chain)
            for _ in range(r):
                self.enqueue(1)
            return
        one, many = self.graphs
        for _ in range(q):
            many.replay()
        for _ in range(r):
            one.replay()


@contextlib.contextmanager
def _no_gc():
    """No cyclic garbage collection inside a capture: a collection there
    may destroy a dead run's CUDA graph, and destroying a graph while
    another is captured invalidates that capture (CUDA refuses the
    graph's reset on a capturing stream)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def adaptive_batches(ticks: int, max_stride: int,
                     run: Callable[[int], int]) -> Tuple[int, int]:
    """Drive an adaptive loop to exactly ``ticks`` with one host read of
    the tick a batch.  ``run(n)`` runs ``n`` iterations and returns the
    tick reached.  Each iteration advances between 1 and ``max_stride``
    ticks and never past ``ticks`` (the stride is capped at
    ``min(max_stride, ticks - t)``), so a batch of
    ``max(1, (ticks - t) // max_stride)`` iterations starts none at or
    past the end.  Returns (iterations, batches)."""
    t = iterations = batches = 0
    while t < ticks:
        n = max(1, (ticks - t) // max_stride)
        t = run(n)
        iterations += n
        batches += 1
    if t != ticks:
        raise RuntimeError(f"adaptive loop ended at tick {t}, not {ticks}")
    return iterations, batches
