"""Chunked Mamba2 SSD scan on the card: the wrapper of
``csrc/ssd_scan.cu``.

The kernel replaces the reference's Pallas TPU kernel
(``repro.kernels.mamba2_ssd.ssd_scan``): within a chunk a masked
decay-attention, across chunks an (N, P) float32 state carry, one block
per (batch, head) walking its chunks in order.  Its plain version is
:func:`repro_torch.kernels.ref.ssd_chunked_ref`; callers go through
:func:`repro_torch.kernels.ops.ssd`, which counts launches, applies
``chunk = min(chunk, T)`` and sends CPU tensors to the plain version.

This wrapper checks what the kernel takes (CUDA; x, dt, b, c of one type,
float32 or bfloat16; a float32; contiguous; T a multiple of the chunk, H
of G; the chunk's working set within the card's shared memory per block)
and raises on the rest, allocates y and h, and launches on the current
stream.  A launch error raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._build import library

_SOURCE = "ssd_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Hopper's opt-in shared memory per block, where the runtime does not say
SMEM_PER_BLOCK = 232448


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p] + [i32] * 8 + [p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [i32, i32, i32]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _check(x, dt, a, b, c, chunk: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the SSD kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the SSD kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("dt", dt), ("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError("want x [B,T,H,P], b and c [B,T,G,N]")
    B, T, H, P = x.shape
    G = b.shape[2]
    if tuple(dt.shape) != (B, T, H) or tuple(a.shape) != (H,) \
            or tuple(b.shape[:2]) != (B, T):
        raise ValueError(f"shapes do not match x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b/c "
                         f"{tuple(b.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if chunk < 1 or T % chunk:
        raise ValueError(f"sequence length {T} must divide by the chunk "
                         f"{chunk}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.index is not None and \
            x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x:[B,T,H,P] dt:[B,T,H] a:[H] b,c:[B,T,G,N] -> (y:[B,T,H,P] in x's
    type, h:[B,H,N,P] float32), by one launch of the CUDA kernel."""
    _check(x, dt, a, b, c, chunk)
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    lib = _lib()
    need = lib.ssd_scan_smem_bytes(chunk, N, P)
    limit = getattr(torch.cuda.get_device_properties(x.device),
                    "shared_memory_per_block_optin", SMEM_PER_BLOCK)
    if need > limit:
        raise ValueError(f"chunk {chunk} at N={N}, P={P} needs {need} bytes "
                         f"of shared memory per block, over the card's "
                         f"{limit}; use a smaller chunk")
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h.zero_()
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), h.data_ptr(), B, T, H, P, G, N, chunk,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    return y, h
