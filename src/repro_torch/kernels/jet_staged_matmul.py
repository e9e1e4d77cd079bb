"""Staged matrix product on the card: the wrapper of
``csrc/staged_matmul.cu``.

The kernel replaces the reference's Pallas TPU kernel
(``repro.kernels.jet_staged_matmul.staged_matmul``): ``A[M,K] @ B[K,N]``
with A and B consumed in K fragments from a small recycled staging
buffer and a float32 accumulator that never leaves the core.  Its plain
version is :func:`repro_torch.kernels.ref.matmul_naive`; callers go
through :func:`repro_torch.kernels.ops.staged_matmul`, which counts
launches and sends CPU tensors to the plain version.

**Variants.**  The source holds three kernels, the wgmma one in two tile
widths, and :func:`variant` picks one from the operands' type and shape
alone, before the launch:

* ``simt_f32``: float32 on the CUDA cores (no TF32);
* ``wgmma_bf16_n256`` and ``wgmma_bf16``: bfloat16 with K and N multiples
  of 8, a ring of :data:`STAGES` K fragments filled by TMA under mbarriers
  and consumed by ``wgmma`` from shared memory.  TMA needs 16-byte global
  strides, hence the rule.  Tiles of 128 x 256 (``wgmma_bf16_n256``) load
  each A box half as often as 128 x 128 ones, and are taken when they make a
  full wave of blocks on the H100's 132 SMs; smaller products take
  128 x 128 tiles (``wgmma_bf16``), which fill more SMs;
* ``mma_sync_bf16``: every other bfloat16 shape, through ``mma.sync``.

Each launch adds one to :data:`VARIANT_LAUNCHES` under its variant.  No
variant stands in for another: a build, encode or launch error raises.

**Tiles.**  The reference's ``block_m/n/k`` size its VMEM staging pool;
its default (256, 256, 512) needs :func:`staging_pool_bytes` = 1.25 MB,
which no block of the card can hold (227 KB of shared memory).  Each CUDA
kernel's tile is a constant instead (:data:`TILES`; its shared memory is
:func:`smem_bytes`), and the wrappers take no ``block_*`` argument:
:func:`repro_torch.kernels.ops.staged_matmul` raises ``TypeError`` on one
rather than ignore it.

This wrapper checks what the kernel takes (CUDA; 2-D float32 or bfloat16
operands of one type; output float32 or bfloat16; contiguous, 16-byte
aligned) and raises on the rest, allocates the output, and launches on
the current stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import library
from .._device import LaunchCounts

_SOURCE = "staged_matmul"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (block_m, block_n, block_k) and K fragments in flight of each kernel
TILES = {"simt_f32": (128, 128, 8), "mma_sync_bf16": (128, 128, 32),
         "wgmma_bf16": (128, 128, 64), "wgmma_bf16_n256": (128, 256, 64)}
STAGES = {"simt_f32": 2, "mma_sync_bf16": 2, "wgmma_bf16": 5,
          "wgmma_bf16_n256": 4}
_PAD = {"simt_f32": 4, "mma_sync_bf16": 8}     # shared-memory row padding
SMS = 132                                       # H100 SXM multiprocessors
VARIANT_LAUNCHES = LaunchCounts(simt_f32=0, mma_sync_bf16=0, wgmma_bf16=0,
                                wgmma_bf16_n256=0)


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


def variant(dtype: torch.dtype, m: int, n: int, k: int) -> str:
    """The kernel that computes ``[m,k] @ [k,n]`` on ``dtype`` operands.
    TMA reads rows whose byte stride is a multiple of 16, so bfloat16 goes
    to wgmma when K and N are multiples of 8 (A's and B's rows), in
    128 x 256 tiles when there are at least :data:`SMS` of them and in
    128 x 128 tiles otherwise; other bfloat16 shapes go to
    ``mma_sync_bf16``, float32 to ``simt_f32``."""
    if dtype == torch.float32:
        return "simt_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"no staged matmul kernel takes {dtype}")
    if k % 8 or n % 8:
        return "mma_sync_bf16"
    wide = -(-m // 128) * -(-n // 256)
    return "wgmma_bf16_n256" if wide >= SMS else "wgmma_bf16"


def smem_bytes(name: str) -> int:
    """Shared memory of one block of kernel ``name``; the accumulator lives
    in registers.  ``simt_f32``: A and B fragments, double-buffered, rows
    padded, 16,896 bytes.  ``mma_sync_bf16``: the same, 40,960 bytes.  The
    wgmma kernels: a ring of stages, each a 128 x 64 A box and BN / 64 B
    boxes of 64 x 64 (32 KB a stage at BN = 128, 48 KB at 256), 1 KB of
    slack to align the ring to the swizzle's 1 KB period, and a full and an
    empty 8-byte mbarrier a stage: 164,944 bytes of dynamic shared memory
    for ``wgmma_bf16`` (5 stages), 197,696 for ``wgmma_bf16_n256`` (4)."""
    bm, bn, bk = TILES[name]
    stages = STAGES[name]
    if name.startswith("wgmma"):
        return stages * (bm + bn) * bk * 2 + 1024 + 2 * stages * 8
    pad = _PAD[name]
    if name == "simt_f32":      # [2][bk][bm + pad] + [2][bk][bn + pad]
        return stages * bk * (bm + bn + 2 * pad) * 4
    return stages * (bm + bn) * (bk + pad) * 2   # [2][bm|bn][bk + pad]


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.staged_matmul_fwd.argtypes = [p, p, p, i32, i32, i32, i32, i32,
                                          p]
        lib.staged_matmul_fwd.restype = ctypes.c_int
        lib.staged_matmul_wgmma_fwd.argtypes = [p, p, p, i32, i32, i32, i32,
                                                i32, p]
        lib.staged_matmul_wgmma_fwd.restype = ctypes.c_int
        lib.staged_matmul_wgmma_smem_bytes.argtypes = [i32]
        lib.staged_matmul_wgmma_smem_bytes.restype = ctypes.c_int
        lib.staged_matmul_encode_stats.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong)]
        lib.staged_matmul_encode_stats.restype = None
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


def encode_stats() -> tuple:
    """(host microseconds, launches) spent encoding the wgmma kernel's
    tensor maps since the library was loaded."""
    us, calls = ctypes.c_double(), ctypes.c_longlong()
    _lib().staged_matmul_encode_stats(ctypes.byref(us), ctypes.byref(calls))
    return us.value, calls.value


def staged_matmul(a: torch.Tensor, b: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a:[M,K] @ b:[K,N] -> [M,N] in ``out_dtype`` (default: a's type), by
    one launch of the kernel that :func:`variant` picks."""
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    name = variant(a.dtype, m, n, k)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if name.startswith("wgmma"):
        err = _lib().staged_matmul_wgmma_fwd(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            TILES[name][1], _DTYPES[out_dtype], stream)
    else:
        err = _lib().staged_matmul_fwd(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            _DTYPES[a.dtype], _DTYPES[out_dtype], stream)
    if err < 0:
        raise RuntimeError(f"staged_matmul ({name}): tensor-map encode "
                           f"failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"staged_matmul kernel launch failed ({name}): "
                           f"CUDA error {err}")
    VARIANT_LAUNCHES[name] += 1
    return out
