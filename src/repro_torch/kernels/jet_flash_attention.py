"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

The kernel replaces the reference's Pallas TPU kernel
(``repro.kernels.jet_flash_attention.flash_attention``): causal,
sliding-window or non-causal GQA attention with a float32 online softmax
and right-aligned causality.  Its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`; callers go through
:func:`repro_torch.kernels.ops.flash_attention`, which counts launches and
sends CPU tensors to the plain version.

This wrapper checks what the kernel takes (CUDA, float32 or bfloat16,
contiguous, D <= 128, Hq a multiple of Hkv) and raises on the rest,
allocates the output, and launches on the current stream.  A launch error
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .._build import library

_SOURCE = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i32, i32, i32, i32,
                                            i32, i32, i32, i32,
                                            ctypes.c_float, i32, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the flash attention kernel needs CUDA tensors, "
                         f"got {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
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
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.index is not None and \
            q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q:[B,Hq,T,D] k/v:[B,Hkv,S,D] -> [B,Hq,T,D] in q's type, by one
    launch of the CUDA kernel."""
    _check(q, k, v, window)
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hkv, t, s, d, int(causal), int(window or 0), d ** -0.5,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
