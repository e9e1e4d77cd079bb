"""Dispatch of the model kernels, the counterpart of ``repro.kernels.ops``.

``impl``:

* ``"auto"`` — a CUDA tensor launches the hand-written kernel, a CPU
  tensor runs the plain version (the only reason the plain version runs);
* ``"cuda"`` — the kernel; a CPU tensor raises;
* ``"ref"`` — the plain version on any device.  Only the tests and the
  chip smoke test's comparisons ask for it.

Nothing falls back: a build or launch failure propagates (the policy is
``_device.resolve_impl``, shared with the fabric's water-fills).  Each
kernel launch adds one to :data:`LAUNCHES` under the kernel's name.

Gradients: on the card flash attention runs through
``jet_flash_attention.FlashAttention`` and the SSD scan through
``mamba2_ssd.SSDScan`` whenever an input requires grad; their backwards
are the kernels ``flash_attention_bwd`` and ``ssd_scan_bwd``.  The other
kernels (paged decode, the staged matmul) have no backward: on the card
they raise under grad (``_device.require_no_grad``) instead of returning
an output that autograd would treat as a constant.  The plain versions
on the CPU keep autograd.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._device import LaunchCounts, require_no_grad, resolve_impl
from . import ref
from .jet_decode_attention import decode_attention_paged as _decode_cuda
from .jet_flash_attention import FlashAttention
from .jet_flash_attention import flash_attention as _flash_cuda
from .jet_staged_matmul import staged_matmul as _matmul_cuda
from .mamba2_ssd import SSDScan
from .mamba2_ssd import ssd_scan as _ssd_cuda

LAUNCHES = LaunchCounts(flash_attention=0, flash_attention_bwd=0,
                        ssd_scan=0, ssd_scan_bwd=0,
                        decode_attention_paged=0, staged_matmul=0)
reset_launches = LAUNCHES.reset


def staged_matmul(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto",
                  out_dtype: Optional[torch.dtype] = None,
                  **kw) -> torch.Tensor:
    """a:[M,K] @ b:[K,N] -> [M,N] in ``out_dtype`` (default: a's type),
    float32 accumulation.  On the card the type and shape pick one of the
    kernel's variants (``jet_staged_matmul.variant``: float32 on the CUDA
    cores; bfloat16 through wgmma fed by TMA when K and N are multiples of
    8, through mma.sync otherwise), counted in
    ``jet_staged_matmul.VARIANT_LAUNCHES``; :data:`LAUNCHES` counts them
    all under ``staged_matmul``.  The reference's ``block_m/n/k`` (its VMEM
    staging tiles) have no meaning for the CUDA kernels, whose tiles are
    fixed (``jet_staged_matmul.TILES``): they raise ``TypeError``."""
    if kw:
        raise TypeError(f"staged_matmul takes no {sorted(kw)}: the CUDA "
                        f"kernel's tiles are fixed (jet_staged_matmul.TILES)")
    if resolve_impl(impl, a.device) == "ref":
        return ref.matmul_naive(a, b, out_dtype)
    require_no_grad("staged_matmul", a, b)
    out = _matmul_cuda(a, b, out_dtype)
    LAUNCHES["staged_matmul"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """q:[B,Hq,T,D] k/v:[B,Hkv,S,D] -> [B,Hq,T,D].  On the card the type
    and head dim pick one of the kernel's variants
    (``jet_flash_attention.variant``: ``mma.sync`` on the tensor cores,
    bfloat16 or float32 through a 3xTF32 split, for D % 8 == 0 up to 256;
    the CUDA cores otherwise, D <= 128), counted in
    ``jet_flash_attention.VARIANT_LAUNCHES``.  When grad is enabled and
    an input requires it, the launch goes through
    ``jet_flash_attention.FlashAttention``, whose backward launches
    ``flash_attention_bwd`` (counted under that name)."""
    if resolve_impl(impl, q.device) == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, LAUNCHES)
    out = _flash_cuda(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, page_table: torch.Tensor,
                     lengths: torch.Tensor, *, impl: str = "auto"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token decode over a paged KV cache: q:[B,Hq,D];
    k/v_pages:[P,page,Hkv,D]; page_table:[B,maxp] int32 (-1 holes);
    lengths:[B] int32 -> (o:[B,Hq,D], lse:[B,Hq] float32).  On the card
    one call enqueues the kernel's split over positions and, where it
    splits, the merge through lse; the types pick its variant
    (``jet_decode_attention.variant``: bfloat16 pages on ``mma.sync``,
    ``mma_bf16`` or, for a float32 q, ``mma_bf16x2``; float32 pages on the
    CUDA cores, ``simt_f32``), counted in
    ``jet_decode_attention.VARIANT_LAUNCHES``."""
    if resolve_impl(impl, q.device) == "ref":
        return ref.decode_attention_paged_ref(q, k_pages, v_pages,
                                              page_table, lengths)
    require_no_grad("decode_attention_paged", q, k_pages, v_pages)
    out = _decode_cuda(q, k_pages, v_pages, page_table, lengths)
    LAUNCHES["decode_attention_paged"] += 1
    return out


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, *, chunk: int = 256,
        impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y [B,T,H,P], h [B,H,N,P] float32).  The chunk
    is ``min(chunk, T)``, and T must divide by it (ValueError).  On the card
    the widths pick one of the kernel's variants (``mamba2_ssd.variant``:
    three chunk-parallel passes on the tensor cores through a 3xTF32 split
    for N, P multiples of 8 up to 128; the CUDA cores otherwise), counted
    in ``mamba2_ssd.VARIANT_LAUNCHES``.  When grad is enabled and an input
    requires it, the launch goes through ``mamba2_ssd.SSDScan``, whose
    backward launches ``ssd_scan_bwd`` (counted under that name)."""
    chunk = min(chunk, x.shape[1])
    if chunk < 1 or x.shape[1] % chunk:
        raise ValueError(f"sequence length {x.shape[1]} must divide by the "
                         f"chunk {chunk} (pad the sequence)")
    if resolve_impl(impl, x.device) == "ref":
        return ref.ssd_chunked_ref(x, dt, a, b, c, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, a, b, c)):
        return SSDScan.apply(x, dt, a, b, c, chunk, LAUNCHES)
    out = _ssd_cuda(x, dt, a, b, c, chunk)
    LAUNCHES["ssd_scan"] += 1
    return out
