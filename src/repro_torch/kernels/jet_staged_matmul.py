"""Staged matrix product on the card: the wrapper of
``csrc/staged_matmul.cu``.

The kernel replaces the reference's Pallas TPU kernel
(``repro.kernels.jet_staged_matmul.staged_matmul``): ``A[M,K] @ B[K,N]``
with A and B consumed in K fragments from a small recycled staging
buffer and a float32 accumulator that never leaves the core.  Its plain
version is :func:`repro_torch.kernels.ref.matmul_naive`; callers go
through :func:`repro_torch.kernels.ops.staged_matmul`, which counts
launches and sends CPU tensors to the plain version.

**Tiles.**  The reference's ``block_m/n/k`` size its VMEM staging pool;
its default (256, 256, 512) needs :func:`staging_pool_bytes` = 1.25 MB,
which no block of the card can hold (227 KB of shared memory).  The CUDA
kernel's tile is a constant of each path instead (:data:`TILES`: 128 x
128 with K fragments of 8 in float32, of 32 in bfloat16; its shared
memory is :func:`smem_bytes`), and the wrappers take no ``block_*``
argument: :func:`repro_torch.kernels.ops.staged_matmul` raises
``TypeError`` on one rather than ignore it.

This wrapper checks what the kernel takes (CUDA; 2-D float32 or bfloat16
operands of one type; output float32 or bfloat16; contiguous, 16-byte
aligned) and raises on the rest, allocates the output, and launches on
the current stream.  A launch error raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import library

_SOURCE = "staged_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (block_m, block_n, block_k) of each path of the CUDA kernel
TILES = {torch.float32: (128, 128, 8), torch.bfloat16: (128, 128, 32)}
_PAD = {torch.float32: 4, torch.bfloat16: 8}   # shared-memory row padding


def staging_pool_bytes(block_m: int, block_n: int, block_k: int,
                       dtype_bytes: int = 2, num_buffers: int = 2) -> int:
    """VMEM footprint of the reference's staging pool for a tiling (A and
    B slots, ``num_buffers`` deep, plus the float32 accumulator): the
    in-kernel analogue of the paper's pool-sizing arithmetic (§4.1.3),
    the same numbers as the reference's."""
    a_slot = block_m * block_k * dtype_bytes
    b_slot = block_k * block_n * dtype_bytes
    acc = block_m * block_n * 4
    return num_buffers * (a_slot + b_slot) + acc


def smem_bytes(dtype: torch.dtype) -> int:
    """Shared memory of one block of the CUDA kernel for inputs of
    ``dtype``: the A and B fragments, double-buffered, with their rows
    padded; the accumulator lives in registers.  16,896 bytes in float32,
    40,960 in bfloat16."""
    bm, bn, bk = TILES[dtype]
    pad = _PAD[dtype]
    esize = torch.empty((), dtype=dtype).element_size()
    if dtype == torch.float32:        # [2][bk][bm + pad] + [2][bk][bn + pad]
        return 2 * bk * (bm + bn + 2 * pad) * esize
    return 2 * (bm + bn) * (bk + pad) * esize   # [2][bm|bn][bk + pad]


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.staged_matmul_fwd.argtypes = [p, p, p, i32, i32, i32, i32, i32,
                                          p]
        lib.staged_matmul_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"the staged matmul kernel needs CUDA tensors, got "
                         f"{a.device}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be float32 or both bfloat16, "
                        f"got {a.dtype} and {b.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or \
            min(a.shape + b.shape) < 1:
        raise ValueError(f"want nonempty a [M,K] and b [K,N]; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if a.device.index is not None and \
            a.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {a.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def staged_matmul(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a:[M,K] @ b:[K,N] -> [M,N] in ``out_dtype`` (default: a's type), by
    one launch of the CUDA kernel."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _lib().staged_matmul_fwd(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        _DTYPES[a.dtype], _DTYPES[out_dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"staged_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return out
