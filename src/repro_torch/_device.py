"""Device, precision and kernel-dispatch resolution for the port.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means CUDA, and a missing CUDA runtime is an error, never
a silent fall back to the CPU.  Every path that resolves a device also
keeps float32 products in full float32 (:func:`full_fp32_matmul`).  On
CUDA the engines compute in float32 (as the JAX reference does); on the
CPU float32 and float64 are both allowed, float64 being the oracle mode.

Every kernel wrapper dispatches through :func:`resolve_impl` and counts
its launches in a :class:`LaunchCounts`.  A kernel without a backward
calls :func:`require_no_grad` before it launches.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]
IMPLS = ("auto", "cuda", "ref")


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card by default; pass device='cpu' to run on "
                           "the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):   # meta: shapes, no data
        raise ValueError(f"unsupported device {dev}")
    full_fp32_matmul()
    return dev


def resolve_dtype(dev: torch.device,
                  dtype: Optional[torch.dtype] = None) -> torch.dtype:
    if dtype is None:
        return torch.float32
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    if dev.type == "cuda" and dtype != torch.float32:
        raise ValueError("the CUDA engine computes in float32")
    return dtype


def full_fp32_matmul() -> None:
    """Keep float32 products in full float32 on the card.  The fabric tick
    scatters class and PFC state through one-hot ``matmul``s and the
    model's projections are ``matmul``s; TF32 would round their operands
    to 10 mantissa bits and break the float32 parity with the
    reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("could not disable TF32 matmuls")


def resolve_impl(impl: str, device: torch.device) -> str:
    """The dispatch of every kernel wrapper: ``auto`` -> ``cuda`` for a
    CUDA tensor, ``ref`` (the plain version) for a CPU one; ``cuda``
    demands a CUDA tensor; ``ref`` forces the plain version on any device.
    Nothing falls back: a build or launch failure propagates."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} ({' | '.join(IMPLS)})")
    if impl == "ref":
        return "ref"
    if device.type == "cuda":
        return "cuda"
    if impl == "cuda":
        raise ValueError("impl='cuda' needs CUDA tensors; CPU tensors run "
                         "the plain version (impl='auto')")
    return "ref"


def require_no_grad(name: str, *tensors) -> None:
    """Raise where a kernel with no backward would be asked for a
    gradient.  A kernel's output comes through ``ctypes`` and carries no
    ``grad_fn``, so autograd would treat it as a constant and silently
    leave its inputs without a gradient.  The CUDA branch of every
    kernel wrapper but flash attention's (which has its backward kernel)
    calls this; the plain versions on the CPU keep autograd."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad; run it under torch.no_grad(), or train on "
            f"the CPU's plain version, until its backward kernel is "
            f"ported")


class LaunchCounts(dict):
    """Launches per kernel name: a wrapper adds one where it launches its
    kernel, and nowhere else.

    A wrapper whose kernel may be captured into a CUDA graph adds through
    :meth:`add`.  A launch on a capturing stream only records the kernel
    into the graph, which runs it at every replay; so there :meth:`add`
    records, right after the kernel, one increment of a device counter
    into the same graph, and every replay adds one on the card.
    :meth:`read` returns the host counts with those device counts folded
    in; ``captured`` tallies the launches recorded into graphs."""

    def __init__(self, **counts):
        super().__init__(**counts)
        self.captured = dict.fromkeys(counts, 0)
        self._device = {}       # (name, device) -> 0-d int64 counter

    def add(self, name: str, device: torch.device) -> None:
        key = (name, device)
        if device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            if key not in self._device:
                # made in the graph's pool, the counter would be zeroed
                # by every replay
                raise RuntimeError(
                    f"{name}: launch the kernel once on {device} before "
                    "capturing it, so that its device counter exists")
            self._device[key].add_(1)
            self.captured[name] += 1
            return
        self[name] += 1
        if device.type == "cuda" and key not in self._device:
            self._device[key] = torch.zeros((), dtype=torch.int64,
                                            device=device)

    def read(self) -> dict:
        """The counts, with the replays' device counts folded in (waits
        for the card)."""
        out = dict(self)
        for (name, _), c in self._device.items():
            out[name] += int(c)
        return out

    def reset(self) -> None:
        for k in self:
            self[k] = 0
        for k in self.captured:
            self.captured[k] = 0
        for c in self._device.values():
            c.zero_()
