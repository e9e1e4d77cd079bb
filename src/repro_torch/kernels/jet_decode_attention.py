"""Paged decode attention on the card: the wrapper of
``csrc/decode_attention.cu``.

The kernel replaces the reference's Pallas TPU kernel
(``repro.kernels.jet_decode_attention.decode_attention_paged``): one
query token per sequence attends, head group by head group (GQA), over
the pages its table lists, with a float32 online softmax, and returns
``(o, lse)`` so that partial results over shards of the pages merge
(``ref.combine_partial_attention``).  Its plain version is
:func:`repro_torch.kernels.ref.decode_attention_paged_ref`; callers go
through :func:`repro_torch.kernels.ops.decode_attention`, which counts
launches and sends CPU tensors to the plain version.

This wrapper checks what the kernel takes (CUDA; q float32 or bfloat16;
pages float32 or bfloat16, with rows of a whole number of 16-byte
vectors; D <= 128; Hq / Hkv <= 32; int32 table and lengths; contiguous,
16-byte aligned) and raises on the rest, allocates the outputs, and
launches on the current stream.  A launch error raises; nothing falls
back.  Table entries past the pool read its last page (the reference's
gather clamps them), holes (-1) read page 0.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._build import library

_SOURCE = "decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUP = 32


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_paged_fwd.argtypes = [
            p, p, p, p, p, p, p, i32, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, i32, i32, p]
        lib.decode_attention_paged_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(q, k_pages, v_pages, page_table, lengths) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the paged decode kernel needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES:
        raise TypeError(f"q and the pages must be float32 or bfloat16, got "
                        f"{q.dtype} and {k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"v_pages is {v_pages.dtype}, k_pages "
                        f"{k_pages.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"page_table and lengths must be int32, got "
                        f"{page_table.dtype} and {lengths.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"want q [B,Hq,D] and k/v pages [P,page,Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, hq, d = q.shape
    n_pool, page, hkv, dk = k_pages.shape
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            tuple(lengths.shape) != (b,):
        raise ValueError(f"want page_table [B,maxp] and lengths [B] with "
                         f"B={b}; got {tuple(page_table.shape)}, "
                         f"{tuple(lengths.shape)}")
    if dk != d:
        raise ValueError(f"pages have head dim {dk}, q {d}")
    if min(b, n_pool, page, page_table.shape[1]) < 1:
        raise ValueError("empty batch, pool, page or page table")
    if hkv < 1 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}, at most "
                         f"{MAX_GROUP} times it")
    vec = 16 // k_pages.element_size()
    if not 1 <= d <= MAX_HEAD_DIM or d % vec:
        raise ValueError(f"head dim {d} must be in 1..{MAX_HEAD_DIM} and a "
                         f"multiple of {vec} (16-byte rows of "
                         f"{k_pages.dtype})")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.device.index is not None and \
            q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q:[B,Hq,D]; k/v_pages:[P,page,Hkv,D]; page_table:[B,maxp] int32
    (-1 holes); lengths:[B] int32 -> (o:[B,Hq,D] in q's type,
    lse:[B,Hq] float32), by one launch of the CUDA kernel."""
    _check(q, k_pages, v_pages, page_table, lengths)
    b, hq, d = q.shape
    n_pool, page, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    err = _lib().decode_attention_paged_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, hq, hkv, d, n_pool, page, page_table.shape[1],
        d ** -0.5, _DTYPES[q.dtype], _DTYPES[k_pages.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_paged kernel launch failed: "
                           f"CUDA error {err}")
    return out, lse
