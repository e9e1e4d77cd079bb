"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

The kernel replaces the reference's Pallas TPU kernel
(``repro.kernels.jet_flash_attention.flash_attention``): causal,
sliding-window or non-causal GQA attention with a float32 online softmax
and right-aligned causality.  Its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`; callers go through
:func:`repro_torch.kernels.ops.flash_attention`, which counts launches and
sends CPU tensors to the plain version.

**What bounds it.**  Operations: 4·D flops per visible (query, key) pair
against each of q, k, v and the output moved once; at the serving path's
[1, 32, 1024, 64] in float32 that is ~64 flop a byte, above the card's
ridge.  So the products go to the tensor cores.

**Variants.**  The source holds two kernels, and :func:`variant` picks one
from the type and the head dim alone, before the launch:

* ``mma_bf16`` (bfloat16) and ``mma_3xtf32`` (float32), where rows are
  16-byte multiples (D % 8 == 0; every registry head dim: 32, 64, 80, 128,
  256), up to :data:`MAX_HEAD_DIM`: ``mma.sync`` on the tensor cores, 4
  warps of 16 query rows walking 64-key K/V tiles (32 keys for float32 at
  D > 80) that arrive by ``cp.async`` in a 2-stage ring.  bfloat16 runs
  ``m16n8k16`` with float32 accumulators; float32 runs ``m16n8k8`` TF32 on a
  split of each operand into ``big`` (its TF32 rounding, to nearest) and
  the rest, ``small``, of which the tensor core reads TF32's bits, summing
  small·big + big·small + big·big: float32 accuracy (each operand held to
  2**-21, the dropped small·small term below 2**-22 of a product), not
  TF32 rounding;
* ``simt``: the first kernel, on the CUDA cores in float32, for any other
  D <= 128.

D > 128 with D % 8 != 0 raises.  Each launch adds one to
:data:`VARIANT_LAUNCHES` under its variant.  No variant stands in for
another: a build or launch error raises.

This wrapper checks what the kernel takes (CUDA, float32 or bfloat16,
contiguous, the head dim its variant takes, Hq a multiple of Hkv, 16-byte
aligned for the mma variants) and raises on the rest, allocates the
output, and launches on the current stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import library
from .._device import LaunchCounts

_SOURCE = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_IDS = {"simt": 0, "mma_bf16": 1, "mma_3xtf32": 1}
MAX_HEAD_DIM = 256
SIMT_MAX_HEAD_DIM = 128
BLOCK_Q = 64                        # query rows a block (16 a warp, 4 warps)
D_TILES = (32, 64, 80, 128, 256)    # head-dim tiles of the mma kernel
STAGES = 2                          # K/V ring depth of the mma kernel
VARIANT_LAUNCHES = LaunchCounts(mma_bf16=0, mma_3xtf32=0, simt=0)


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes head dim ``d`` in ``dtype``: ``mma_bf16`` /
    ``mma_3xtf32`` when ``d`` is a multiple of 8 (16-byte rows for
    ``cp.async``) up to :data:`MAX_HEAD_DIM`, else ``simt`` up to
    :data:`SIMT_MAX_HEAD_DIM`."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if d % 8 == 0:
        return "mma_bf16" if dtype == torch.bfloat16 else "mma_3xtf32"
    if d > SIMT_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {SIMT_MAX_HEAD_DIM} must be a "
                         f"multiple of 8 (the tensor-core kernel reads "
                         f"16-byte rows)")
    return "simt"


def d_tile(d: int) -> int:
    """The mma kernel's head-dim tile for head dim ``d``: the smallest of
    :data:`D_TILES` that holds it (``d`` is zero-padded to it in shared
    memory; each registry head dim has its own)."""
    return next(t for t in D_TILES if d <= t)


def block_kv(name: str, d: int) -> int:
    """Keys a K/V tile of the mma variant ``name`` at head dim ``d``: 64,
    and 32 for float32 past D = 80, so that two blocks fit on an SM at
    D = 128 (and one at 256, where a 64-key K plus V tile alone would take
    128 KB)."""
    return 32 if name == "mma_3xtf32" and d_tile(d) > 80 else 64


def smem_bytes(name: str, d: int) -> int:
    """Dynamic shared memory of one block of variant ``name`` at head dim
    ``d``.  ``simt``: the scaled q tile, the k tile (rows padded by one),
    the v tile and the probability tile, all float32.  The mma kernels: a
    q tile of 64 rows and :data:`STAGES` K and V tiles of
    :func:`block_kv` rows, each row the bytes of :func:`d_tile` plus 16
    of padding (ldmatrix reads 8 rows from 8 distinct bank groups).  The
    plan the kernel's launcher sizes its request by (``simt_smem_bytes``,
    ``Tile`` and ``mma_smem_bytes`` in ``csrc/flash_attention.cu``)."""
    if name == "simt":
        return 4 * (BLOCK_Q * d + 64 * (d + 1) + 64 * d + BLOCK_Q * 64)
    esize = 2 if name == "mma_bf16" else 4
    row = d_tile(d) * esize + 16
    return row * (BLOCK_Q + 2 * STAGES * block_kv(name, d))


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i32, i32, i32, i32,
                                            i32, i32, i32, i32,
                                            ctypes.c_float, i32, i32, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> str:
    if q.device.type != "cuda":
        raise ValueError(f"the flash attention kernel needs CUDA tensors, "
                         f"got {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Hq,T,D] and k, v [B,Hkv,S,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    name = variant(q.dtype, d)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if name != "simt" and t.data_ptr() % 16:
            raise ValueError(f"{n} must be 16-byte aligned")
    if q.device.index is not None and \
            q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    return name


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q:[B,Hq,T,D] k/v:[B,Hkv,S,D] -> [B,Hq,T,D] in q's type, by one
    launch of the kernel that :func:`variant` picks."""
    name = _check(q, k, v, window)
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hkv, t, s, d, int(causal), int(window or 0), d ** -0.5,
        _DTYPES[q.dtype], _VARIANT_IDS[name],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({name}): "
                           f"CUDA error {err}")
    VARIANT_LAUNCHES[name] += 1
    return out
