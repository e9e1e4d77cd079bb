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

**What bounds it.**  Bytes: K and V are read once for at most 64 flops a
byte (bfloat16, G = Hq / Hkv <= 32).  So the position axis is split
across blocks (split-KV): S splits of every (sequence, KV head), each over
a contiguous range of positions, merged through their float32
``(m, l, acc)`` by a second kernel that one C call enqueues behind the
first (S = 1: the first kernel emits o and lse itself).  S comes from the
batch, the KV heads, the table's width and the card's SM count, never
from ``lengths``, which stay on the card.

**Variants**, picked by :func:`variant` from the types alone:

* ``mma_bf16``: bfloat16 q and pages, products on ``mma.sync`` m16n8k16
  with float32 accumulators, P rounded to bfloat16 once for P·V;
* ``mma_bf16x2``: float32 q over bfloat16 pages: q and P (o is float32)
  each split into two bfloat16 halves, two products each;
* ``simt_f32``: float32 pages (either q) on the CUDA cores.

Each launch adds one to :data:`VARIANT_LAUNCHES` under its variant.  What
a launch runs (splits, blocks, shared memory) is the C source's to say:
:func:`plan` asks it; :func:`split_plan` is the same plan in Python, for
machines without the card (``chip_smoke.py`` holds the two equal).

This wrapper checks what the kernel takes (CUDA; q float32 or bfloat16;
pages float32 or bfloat16, with rows of a whole number of 16-byte
vectors; D <= 256; Hq / Hkv <= 32; int32 table and lengths; contiguous,
16-byte aligned) and raises on the rest, allocates the outputs and the
float32 partials, and launches on the current stream.  A launch error
raises; nothing falls back.  Table entries past the pool read its last
page (the reference's gather clamps them), holes (-1) read page 0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .._build import library
from .._device import LaunchCounts

_SOURCE = "decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("simt_f32", "mma_bf16", "mma_bf16x2")    # the C source's ids
MAX_HEAD_DIM = 256
MAX_GROUP = 32
# the C source's constants, mirrored by split_plan
WARPS = 4
STAGES = 3                      # cp.async ring depth of a warp
TILE = 64                       # a split's range is whole tiles
MMA_ROWS = 16                   # mma: positions a warp step, heads a tile
SIMT_ROWS = 8                   # simt: positions a warp step
MAX_SPLITS = 256
BLOCKS_PER_SM = 4               # what the split count aims at
SMEM_PER_BLOCK = 232448         # Hopper's opt-in shared memory per block
VARIANT_LAUNCHES = LaunchCounts(**dict.fromkeys(VARIANTS, 0))


def variant(q_dtype: torch.dtype, kv_dtype: torch.dtype, d: int,
            g: int) -> str:
    """The kernel variant that takes a q of ``q_dtype`` over pages of
    ``kv_dtype`` at head dim ``d`` and group ``g``; raises on what no
    variant takes."""
    if q_dtype not in _DTYPES or kv_dtype not in _DTYPES:
        raise TypeError(f"q and the pages must be float32 or bfloat16, got "
                        f"{q_dtype} and {kv_dtype}")
    vec = 4 if kv_dtype == torch.float32 else 8
    if not 1 <= d <= MAX_HEAD_DIM or d % vec:
        raise ValueError(f"head dim {d} must be in 1..{MAX_HEAD_DIM} and a "
                         f"multiple of {vec} (16-byte rows of {kv_dtype})")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"group Hq / Hkv = {g} must be in 1..{MAX_GROUP}")
    if kv_dtype == torch.float32:
        return "simt_f32"
    return "mma_bf16" if q_dtype == torch.bfloat16 else "mma_bf16x2"


def _split_kernel(name: str) -> str:
    return ("decode_split_simt_kernel" if name == "simt_f32"
            else "decode_split_mma_kernel")


def _smem_before_table(name: str, d: int, rows: int) -> int:
    """Bytes of a split block's shared memory below its table entries, as
    ``Layout`` in the C source: each warp's ring, q, (m, l), simt's P."""
    if name == "simt_f32":
        rs = 4 * (d if (d // 4) % 2 else d + 4)
        ring, qb, pb = WARPS * STAGES * 2 * SIMT_ROWS * rs, rows * rs, \
            WARPS * SIMT_ROWS * rows * 4
    else:
        dt = 64 if d <= 64 else 128 if d <= 128 else 256
        rb = 2 * dt + 16
        ring = WARPS * STAGES * 2 * MMA_ROWS * rb
        qb = (2 if name == "mma_bf16x2" else 1) * MMA_ROWS * rb
        pb = 0
    return ring + qb + -(-WARPS * rows * 8 // 16) * 16 + pb


def split_plan(q_dtype: torch.dtype, kv_dtype: torch.dtype, b: int, hq: int,
               hkv: int, d: int, page: int, maxp: int, sm_count: int,
               splits: Optional[int] = None) -> Dict:
    """The launch plan of ``csrc/decode_attention.cu`` (``make_plan``) in
    Python: ``variant``, ``splits`` S, ``chunk`` (positions a split; split
    s owns [s * chunk, (s + 1) * chunk)), ``head_tiles`` and, per kernel a
    launch runs, (dynamic shared memory bytes, blocks).  ``splits`` forces
    S; else S aims at :data:`BLOCKS_PER_SM` blocks an SM with at least one
    :data:`TILE` of positions a split.  Raises where the C plan refuses."""
    name = variant(q_dtype, kv_dtype, d, hq // hkv if hkv else 0)
    if min(b, hkv, page, maxp, sm_count) < 1 or hq % hkv:
        raise ValueError(f"want B, Hkv, page, maxp, SMs >= 1 and Hq a "
                         f"multiple of Hkv; got B={b}, Hq={hq}, Hkv={hkv}, "
                         f"page={page}, maxp={maxp}, SMs={sm_count}")
    if maxp * page > 2 ** 30:
        raise ValueError(f"a table of {maxp} pages of {page} positions is "
                         f"over 2**30 positions")
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits={splits} must be in 1..{MAX_SPLITS}")
    g = hq // hkv
    rows = MMA_ROWS if name != "simt_f32" else \
        1 if g == 1 else 4 if g <= 4 else 8 if g <= 8 else 16
    htiles = -(-g // rows)
    tiles = -(-maxp * page // TILE)
    base = _smem_before_table(name, d, rows)

    def smem(ct):
        return base + -(-4 * (ct * TILE // page + 2) // 16) * 16
    if splits:
        s, ct = splits, -(-tiles // splits)
        if smem(ct) > SMEM_PER_BLOCK:
            raise ValueError(f"splits={splits}: a split's {ct * TILE} "
                             f"positions need {smem(ct)} bytes of shared "
                             f"memory, over {SMEM_PER_BLOCK}")
    else:
        per = b * hkv * htiles
        s = min(max(-(-BLOCKS_PER_SM * sm_count // per), 1), tiles)
        room = (SMEM_PER_BLOCK - base - 16) // 4 - 2
        ct = max(1, min(-(-tiles // s), room * page // TILE))
        s = -(-tiles // ct)
        if s > MAX_SPLITS:
            raise ValueError(f"a table of {maxp} pages of {page} needs "
                             f"{s} splits, over {MAX_SPLITS}")
    kernels = {_split_kernel(name): (smem(ct), b * hkv * htiles * s)}
    if s > 1:
        kernels["decode_merge_kernel"] = (4 * s, b * hq)
    return {"variant": name, "splits": s, "chunk": ct * TILE,
            "head_tiles": htiles, "kernels": kernels}


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_paged_fwd.argtypes = [
            p] * 8 + [i32] * 7 + [ctypes.c_float] + [i32] * 4 + [p]
        lib.decode_attention_paged_fwd.restype = ctypes.c_int
        lib.decode_attention_plan.argtypes = [i32] * 10 + [p]
        lib.decode_attention_plan.restype = ctypes.c_int
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=256)
def _plan(q_dtype: int, kv_dtype: int, b: int, hq: int, hkv: int, d: int,
          page: int, maxp: int, sm_count: int, splits: int) -> Dict:
    out = (ctypes.c_longlong * 8)()
    k = _lib().decode_attention_plan(q_dtype, kv_dtype, b, hq, hkv, d, page,
                                     maxp, splits, sm_count,
                                     ctypes.addressof(out))
    if k < 0:
        raise ValueError(
            f"the paged decode kernel does not take B={b}, Hq={hq}, "
            f"Hkv={hkv}, D={d}, page={page}, maxp={maxp}, splits={splits} "
            f"(types {q_dtype}/{kv_dtype}, {sm_count} SMs)")
    name = VARIANTS[out[0]]
    kernels = {_split_kernel(name): (out[4], out[5])}
    if k == 2:
        kernels["decode_merge_kernel"] = (out[6], out[7])
    return {"variant": name, "splits": out[1], "chunk": out[2],
            "head_tiles": out[3], "kernels": kernels}


def plan(q_dtype: torch.dtype, kv_dtype: torch.dtype, b: int, hq: int,
         hkv: int, d: int, page: int, maxp: int, sm_count: int,
         splits: Optional[int] = None) -> Dict:
    """:func:`split_plan` as the C source computes it
    (``decode_attention_plan``): what a launch at these sizes runs.
    Builds the library; raises ``ValueError`` on sizes it does not take."""
    if q_dtype not in _DTYPES or kv_dtype not in _DTYPES:
        raise TypeError(f"q and the pages must be float32 or bfloat16, got "
                        f"{q_dtype} and {kv_dtype}")
    p = _plan(_DTYPES[q_dtype], _DTYPES[kv_dtype], b, hq, hkv, d, page, maxp,
              sm_count, splits or 0)
    return {**p, "kernels": dict(p["kernels"])}   # not the cached dict


@functools.lru_cache(maxsize=16)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    variant(q.dtype, k_pages.dtype, d, hq // hkv)
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
                           lengths: torch.Tensor, *,
                           splits: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q:[B,Hq,D]; k/v_pages:[P,page,Hkv,D]; page_table:[B,maxp] int32
    (-1 holes); lengths:[B] int32 -> (o:[B,Hq,D] in q's type,
    lse:[B,Hq] float32), by one C call that enqueues the split kernel and,
    for S > 1, the merge.  ``splits`` forces S (tests and the chip smoke
    test only; ``ops`` never passes it)."""
    _check(q, k_pages, v_pages, page_table, lengths)
    b, hq, d = q.shape
    n_pool, page, hkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    sms = sm_count(torch.cuda.current_device())
    p = _plan(_DTYPES[q.dtype], _DTYPES[k_pages.dtype], b, hq, hkv, d, page,
              maxp, sms, splits or 0)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    # the splits' float32 (m, l, acc), read back by the merge; freed into
    # the stream's cache on return, so later work on the stream reuses it
    # only after the merge has run
    part = None if p["splits"] == 1 else torch.empty(
        p["splits"] * b * hq * (d + 2), dtype=torch.float32, device=q.device)
    err = _lib().decode_attention_paged_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        lse.data_ptr(), None if part is None else part.data_ptr(), b, hq,
        hkv, d, n_pool, page, maxp, d ** -0.5, _DTYPES[q.dtype],
        _DTYPES[k_pages.dtype], splits or 0, sms,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_paged kernel launch failed "
                           f"({p['variant']}, {p['splits']} splits): CUDA "
                           f"error {err}")
    VARIANT_LAUNCHES[p["variant"]] += 1
    return out, lse
