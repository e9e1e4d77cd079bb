"""Paged KV cache backed by the device pool (``repro.serving.kv_cache``).

The slab design of paper §4.2 applied to serving KV: pages of
``page_size`` tokens come from a free bitmap (:class:`DevicePool`),
sequences map to pages through a page table, and the paged decode kernel
(``kernels.ops.decode_attention``) reads the pages where they lie.
Releasing a finished sequence recycles its pages at once (swift
recycle); an exhausted pool surfaces the escape path (``ok`` is False).

The reference's store is functional (each call returns a new store);
this one is updated in place, with the same results, including the
reference's behaviour at the edges: on an exhausted pool ``append``
still writes the token into page 0 at the token's offset (the hole's
clamped page) and counts it in ``lengths``; past ``max_pages_per_seq``
the pool still hands out a page (never recorded, so it is lost until the
pool is recreated) and the token overwrites a slot of the sequence's
last page.  Nothing in ``append`` or ``release`` reads back to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from .._device import DeviceLike, resolve_device
from ..core.pool import DevicePool


@dataclasses.dataclass
class PagedKVConfig:
    num_pages: int
    page_size: int
    num_kv_heads: int
    head_dim: int
    max_pages_per_seq: int
    dtype: torch.dtype = torch.bfloat16


class PagedKV:
    """Single-layer paged KV store and its allocator state."""

    def __init__(self, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 pool: DevicePool, page_table: torch.Tensor,
                 lengths: torch.Tensor):
        self.k_pages = k_pages          # [P, page, Hkv, D]
        self.v_pages = v_pages
        self.pool = pool
        self.page_table = page_table    # [B, maxp] int32, -1 = hole
        self.lengths = lengths          # [B] int32

    @classmethod
    def create(cls, cfg: PagedKVConfig, batch: int,
               device: DeviceLike = None) -> "PagedKV":
        """An empty store for ``batch`` sequences on ``device`` (CUDA
        unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        shape = (cfg.num_pages, cfg.page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   DevicePool.create(cfg.num_pages, dev),
                   torch.full((batch, cfg.max_pages_per_seq), -1,
                              dtype=torch.int32, device=dev),
                   torch.zeros((batch,), dtype=torch.int32, device=dev))

    def append(self, b: int, k_new: torch.Tensor,
               v_new: torch.Tensor) -> torch.Tensor:
        """Append one token's (k, v) [Hkv, D] to sequence ``b``, taking a
        fresh page from the pool on a page boundary.  Returns ``ok`` (a
        bool tensor on the device): False means the pool was exhausted
        (escape)."""
        page = self.k_pages.shape[1]
        maxp = self.page_table.shape[1]
        pos = self.lengths[b].long()
        page_idx, off = pos // page, pos % page
        need_page = off == 0
        fresh, got, taken = self.pool.find(1)
        self.pool.free &= ~(taken & need_page)
        # the reference's table write drops an index past maxp, and its
        # read clamps it to the last entry
        row = self.page_table[b]
        col = torch.clamp(page_idx, max=maxp - 1)
        entry = torch.where(need_page & (page_idx < maxp),
                            fresh[0].to(row.dtype), row[col])
        row.index_put_((col,), entry)
        phys = torch.clamp(row[col], min=0).long()
        self.k_pages.index_put_((phys, off), k_new.to(self.k_pages.dtype))
        self.v_pages.index_put_((phys, off), v_new.to(self.v_pages.dtype))
        self.lengths[b] += 1
        return ~need_page | got

    def release(self, b: int) -> None:
        """Free every page of sequence ``b`` back to the pool (recycle)."""
        self.pool.release(self.page_table[b])
        self.page_table[b] = -1
        self.lengths[b] = 0
