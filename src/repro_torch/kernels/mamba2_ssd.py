"""Chunked Mamba2 SSD scan on the card: the wrapper of
``csrc/ssd_scan.cu``.

The kernel replaces the reference's Pallas TPU kernel
(``repro.kernels.mamba2_ssd.ssd_scan``): within a chunk a masked
decay-attention, across chunks an (N, P) float32 state carry.  Its plain
version is :func:`repro_torch.kernels.ref.ssd_chunked_ref`; callers go
through :func:`repro_torch.kernels.ops.ssd`, which counts launches, applies
``chunk = min(chunk, T)`` and sends CPU tensors to the plain version.

**What bounds it.**  Operations: ~L²(N + P) + 4·L·N·P flops per (batch,
head, chunk) against the inputs moved once; at the serving path's
x [1, 1024, 64, 64], N 64, chunk 256 that is ~48 flop a byte, above the
card's float32 ridge.  So the products go to the tensor cores.

**Variants.**  The source holds two kernels, and :func:`variant` picks one
from the type and the widths alone, before the launch:

* ``mma_3xtf32``, where N and P are multiples of 8 up to
  :data:`MAX_WIDTH` (zamba2: 64 and 64): three passes enqueued by one C
  call, each parallel over chunks: the chunks' own states
  and the prefix sums of dt·a (``ssd_state_kernel``), the carry of the
  state from chunk to chunk (``ssd_carry_kernel``), and y per 64-row tile
  of a chunk (``ssd_output_kernel``, four warps of 16 rows, flash
  attention's ``mma.sync`` layout).  Every product runs on ``mma.sync``
  m16n8k8 TF32 through a split of each operand into ``big`` (its TF32
  rounding) and ``small`` (the rest), small·big + big·small + big·big:
  float32 accuracy, not TF32 rounding.  bfloat16 inputs are widened to
  float32 as they are staged.  The wrapper allocates the passes' float32
  scratch in one tensor (states [B, H, T / chunk, N, P], then cum
  [B, H, T]);
* ``simt``: the first kernel, on the CUDA cores in float32, one block per
  (batch, head) walking its chunks in order, for any other N, P, within
  the card's shared memory per block at the chunk.

Each launch adds one to :data:`VARIANT_LAUNCHES` under its variant.  No
variant stands in for another: a build or launch error raises.

What a launch runs (each kernel's shared memory and blocks) is the C
source's to say: :func:`plan` asks it, and the wrapper's refusal of a
``simt`` chunk too large for shared memory reads it there.
:func:`smem_bytes` is the same plan in Python, for machines without the
card; ``chip_smoke.py`` holds the two equal.

**The backward** (``csrc/ssd_scan_bwd.cu``, :func:`ssd_scan_bwd`): the
gradient of (y, h) at upstream dy and dh, deterministic (no atomics, every
sum in a fixed order), for N and P up to :data:`BWD_MAX_WIDTH` in either
type.  It reads the states entering each chunk and the prefix sums of
dt·a that ``mma_3xtf32`` leaves in its scratch (:func:`ssd_scan_states`)
and recomputes them where it gets none.  :func:`bwd_variant` picks one of
two designs of the same passes from the type and the widths:

* ``bwd_mma_3xtf32`` where the forward runs ``mma_3xtf32`` (N and P
  multiples of 8 up to 128; zamba2's 64 and 64): the products on
  ``mma.sync`` with the 3xTF32 split, flash attention's backward layout —
  a 64-key-tile pass (dx, db, the direct ddt) and a 64-row-tile pass (dc),
  each warp 16 rows, the score tiles kept in registers and fed from the
  accumulators into the next product; D_k and the recomputed states as
  the forward's state pass runs its product;
* ``bwd_simt_recompute`` at every other width (after a ``simt`` forward,
  which keeps no states): the first design, in float32 on the CUDA cores.
  ``ssd_scan_bwd(..., _variant="bwd_simt")`` forces it at any width, as a
  comparison; nothing on the path does.

Its plain version is :func:`repro_torch.kernels.ref.ssd_chunked_bwd_ref`.
:class:`SSDScan` binds the two for autograd; :func:`bwd_plan` and
:func:`bwd_smem_bytes` are each design's plan from the C source and in
Python.

This wrapper checks what the kernel takes (CUDA; x, dt, b, c of one type,
float32 or bfloat16; a float32; contiguous; T a multiple of the chunk, H
of G; 16-byte aligned for ``mma_3xtf32``; ``simt``'s working set within
the card's shared memory per block) and raises on the rest, allocates y
and h, and launches on the current stream.  On ``meta`` tensors it does
all of that but the launch (the shared memory from :func:`smem_bytes`
against :data:`SMEM_PER_BLOCK`, the backward's scratch from
:func:`bwd_scratch_floats`), in whose place it calls
``_device.meta_launch`` with the operation count (:func:`flops`,
:func:`bwd_work`), and counts the launch all the same.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .._build import library
from .._device import LaunchCounts, meta_launch

_SOURCE = "ssd_scan"
_BWD_SOURCE = "ssd_scan_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_IDS = {"simt": 0, "mma_3xtf32": 1}
# Hopper's opt-in shared memory per block, where the runtime does not say
SMEM_PER_BLOCK = 232448
MAX_WIDTH = 128                     # N and P of mma_3xtf32
WIDTH_TILES = (64, 128)             # N and P zero-padded to one of these
TILE = 64                           # rows of a row tile, keys of a key tile
STAGES = 2                          # cp.async ring depth
SIMT_ROWS = 32                      # simt's row tile
KERNELS = {"simt": ("ssd_simt_kernel",),
           "mma_3xtf32": ("ssd_state_kernel", "ssd_carry_kernel",
                          "ssd_output_kernel")}
# each backward design's kernels in launch order; the first two run only
# where the states are recomputed (after simt)
_BWD_TAIL = ("ssd_bwd_dt_kernel", "ssd_bwd_da_kernel", "ssd_bwd_group_kernel")
BWD_KERNELS = {
    "bwd_simt": ("ssd_bwd_state_kernel", "ssd_bwd_state_carry_kernel",
                 "ssd_bwd_dstate_kernel", "ssd_bwd_grad_carry_kernel",
                 "ssd_bwd_key_kernel", "ssd_bwd_query_kernel") + _BWD_TAIL,
    "bwd_mma_3xtf32": ("ssd_bwd_state_mma_kernel",
                       "ssd_bwd_state_carry_kernel",
                       "ssd_bwd_dstate_mma_kernel",
                       "ssd_bwd_grad_carry_kernel", "ssd_bwd_key_mma_kernel",
                       "ssd_bwd_query_mma_kernel") + _BWD_TAIL}
BWD_KERNELS["bwd_simt_recompute"] = BWD_KERNELS["bwd_simt"]
_BWD_IDS = {"bwd_simt": 0, "bwd_simt_recompute": 0, "bwd_mma_3xtf32": 1}
BWD_MAX_WIDTH = 128                 # N and P of the backward
VARIANT_LAUNCHES = LaunchCounts(mma_3xtf32=0, simt=0, bwd_mma_3xtf32=0,
                                bwd_simt=0, bwd_simt_recompute=0)


def variant(dtype: torch.dtype, n: int, p: int) -> str:
    """The kernel that takes state width ``n`` and head dim ``p`` in
    ``dtype``: ``mma_3xtf32`` when both are multiples of 8 (16-byte rows
    for ``cp.async``) up to :data:`MAX_WIDTH`, else ``simt``."""
    if dtype not in _DTYPES:
        raise TypeError(f"the SSD kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if n < 1 or p < 1:
        raise ValueError(f"widths N={n}, P={p} must be positive")
    if n % 8 == 0 and p % 8 == 0 and n <= MAX_WIDTH and p <= MAX_WIDTH:
        return "mma_3xtf32"
    return "simt"


def flops(B: int, T: int, H: int, N: int, P: int, chunk: int) -> float:
    """The forward's operations, whichever variant does them: per (batch,
    head) the causal half of the scores (c·b) and of scores @ x in every
    chunk, every chunk's own state (b w)ᵀ x, and c @ h_in in the chunks
    after the first (h_in is 0 in the first)."""
    nc = T // chunk
    return float(B * H) * (nc * chunk * (chunk + 1) * (N + P)
                           + 2.0 * chunk * N * P * (2 * nc - 1))


def bwd_work(B: int, T: int, H: int, G: int, N: int, P: int, L: int,
             esize: int, recompute: bool) -> Tuple[float, float]:
    """(flops, bytes) that the backward must do and move at dh None (as
    the train path runs it).  Per (b, h) and chunk: the causal half of
    the L x L pairs (L (L + 1) / 2), each taking c.b, dy.x and the three
    products into dx, db and dc (3 N + 2 P multiply-adds); and the state
    terms, 2 L N P each: D_k = sum exp(cum) c dy^T for every chunk but
    the first (D_0 feeds only the zero initial state's gradient), c H dy
    for every chunk but the first (H_0 = 0), and the G terms of dx and db
    for every chunk but the last (G_last = dh = 0); with the states
    recomputed, also the states entering chunks 1 .. nc - 1.  Bytes: x,
    dt, b, c read and their gradients written in their type (``esize``
    bytes an element), dy read once, a read and da written in float32,
    and the forward's float32 states and cum read where they are kept."""
    nc = T // L
    terms = 4 * (nc - 1) + (nc - 1 if recompute else 0)
    nops = float(B * H) * (nc * L * (L + 1) * (3 * N + 2 * P)
                           + 2.0 * L * N * P * terms)
    x_n, dt_n, bc_n = B * T * H * P, B * T * H, B * T * G * N
    nbytes = esize * (3 * x_n + 2 * dt_n + 4 * bc_n) + 4 * 2 * H
    if not recompute:
        nbytes += 4 * (B * H * nc * N * P + B * H * T)
    return nops, nbytes


def bwd_scratch_floats(B: int, T: int, H: int, P: int, G: int, N: int,
                       L: int) -> int:
    """The float32 scratch a backward launch needs at these sizes, either
    design (``Scratch`` in ``csrc/ssd_scan_bwd.cu``; the C launcher's
    ``ssd_scan_bwd_scratch`` returns the same): the G_k states, the
    per-head db and dc parts, four row vectors and two chunk vectors;
    -1 where the backward does not take the sizes."""
    if not (B >= 1 and L >= 1 and T >= L and T % L == 0 and G >= 1
            and H % G == 0 and 1 <= N <= BWD_MAX_WIDTH
            and 1 <= P <= BWD_MAX_WIDTH):
        return -1
    nc = T // L
    return (B * H * nc * N * P + 2 * B * T * H * N + 4 * B * H * T
            + 2 * B * H * nc)


def width_tile(w: int) -> int:
    """The tile ``mma_3xtf32`` zero-pads a width (N or P) to: the smallest
    of :data:`WIDTH_TILES` that holds it."""
    return next(t for t in WIDTH_TILES if w <= t)


def smem_bytes(name: str, n: int, p: int,
               chunk: Optional[int] = None) -> int:
    """Dynamic shared memory of the largest block of variant ``name`` at
    widths ``n``, ``p``, as ``csrc/ssd_scan.cu`` lays it out (``Plan`` and
    ``simt_smem_bytes``; :func:`plan` asks the source itself).

    ``mma_3xtf32`` (widths padded by :func:`width_tile` to NT, PT; float32
    words): the state pass holds :data:`STAGES` b and x tiles of
    :data:`TILE` rows (NT + 8 and PT + 8 words a row) and their weights;
    the output pass a c tile (NT + 4 words a row, for ldmatrix) and a ring
    of :data:`STAGES` b and x key tiles (NT + 4, PT + 4) with their cum and
    dt, in which h_in (NT rows of PT + 8) is staged first.  Neither depends
    on the chunk.  ``simt`` holds the whole chunk, so it needs ``chunk``."""
    if name == "simt":
        if chunk is None:
            raise ValueError("simt's shared memory depends on the chunk")
        ns = n + 1
        return 4 * (chunk * p + chunk * ns + n * p + 3 * chunk
                    + SIMT_ROWS * ns + SIMT_ROWS * chunk)
    if name != "mma_3xtf32":
        raise ValueError(f"unknown SSD variant {name!r}")
    nt, pt = width_tile(n), width_tile(p)
    state = STAGES * (TILE * ((nt + 8) + (pt + 8)) + TILE)
    out_stage = TILE * ((nt + 4) + (pt + 4)) + 2 * TILE
    output = TILE * (nt + 4) + max(STAGES * out_stage, nt * (pt + 8))
    return 4 * max(state, output)


def check_bwd(dtype: torch.dtype, n: int, p: int) -> None:
    """Raise unless the backward takes state width ``n`` and head dim
    ``p`` in ``dtype``: N and P up to :data:`BWD_MAX_WIDTH`, float32 or
    bfloat16 (:class:`SSDScan` asks before its forward launches)."""
    if dtype not in _DTYPES:
        raise TypeError(f"the SSD backward takes float32 or bfloat16, got "
                        f"{dtype}")
    if not (1 <= n <= BWD_MAX_WIDTH and 1 <= p <= BWD_MAX_WIDTH):
        raise ValueError(f"the SSD backward does not take N={n}, P={p} "
                         f"(each 1..{BWD_MAX_WIDTH})")


def bwd_variant(dtype: torch.dtype, n: int, p: int) -> str:
    """The backward design that takes state width ``n`` and head dim
    ``p`` in ``dtype``: ``bwd_mma_3xtf32`` where :func:`variant` picks
    ``mma_3xtf32`` for the forward (N and P multiples of 8 up to
    :data:`MAX_WIDTH`), else ``bwd_simt_recompute`` (the forward ran
    ``simt`` and kept no states).  ``bwd_simt`` is never picked:
    :func:`ssd_scan_bwd` runs it only when asked."""
    check_bwd(dtype, n, p)
    return "bwd_mma_3xtf32" if variant(dtype, n, p) == "mma_3xtf32" \
        else "bwd_simt_recompute"


def _bwd_id(name: str, n: int, p: int) -> int:
    if name not in _BWD_IDS:
        raise ValueError(f"unknown SSD backward variant {name!r}")
    if name == "bwd_mma_3xtf32" and (n % 8 or p % 8):
        raise ValueError(f"bwd_mma_3xtf32 does not take N={n}, P={p}")
    return _BWD_IDS[name]


def bwd_smem_bytes(name: str, n: int, p: int) -> int:
    """Dynamic shared memory of the largest block of backward design
    ``name`` at widths ``n``, ``p``, as ``csrc/ssd_scan_bwd.cu`` lays it
    out (``Plan``, ``MmaPlan``; :func:`bwd_plan` asks the source).  None
    depends on the chunk; widths pad by :func:`width_tile` to NT, PT,
    for ``bwd_mma_3xtf32`` both to the tile of the wider (its kernels are
    built at 64 x 64 and 128 x 128 only).

    ``bwd_mma_3xtf32`` (rows of NT + 4 and PT + 4 words, for ldmatrix):
    the key pass holds its keys' b and x tiles and four weights a key,
    and a ring of :data:`STAGES` row tiles (c, dy, cum), G_k staged in its
    second stage first; the row pass its rows' c and dy and two weights a
    row, and a ring of key tiles (b, x, cum, dt), H_k first; the state
    passes a ring of 64-row u and v tiles (NT + 8, PT + 8) and weights.

    ``bwd_simt`` / ``bwd_simt_recompute`` (every tile row one word
    wider): the state passes hold a 64-row b or c tile, an x or dy tile
    and the row weights; the key pass its b and x tiles and four weights
    a key, then G (NT rows) or, per row tile, c, dy, cum and two 64 x 64
    score tiles; the row pass its c and dy tiles and two weights a row,
    then H or, per key tile, b, x, cum, dt and one score tile."""
    check_bwd(torch.float32, n, p)
    nt, pt = width_tile(n), width_tile(p)
    if _bwd_id(name, n, p):
        nt = pt = max(nt, pt)
        own = TILE * ((nt + 4) + (pt + 4))
        key = own + 4 * TILE + STAGES * (own + TILE)
        row = own + 2 * TILE + STAGES * (own + 2 * TILE)
        state = STAGES * (TILE * ((nt + 8) + (pt + 8)) + TILE)
        return 4 * max(key, row, state)
    ntile, ptile, mat = TILE * (nt + 1), TILE * (pt + 1), nt * (pt + 1)
    score = TILE * (TILE + 1)
    state = ntile + ptile + TILE
    key = ntile + ptile + 4 * TILE + max(mat, ntile + ptile + TILE
                                         + 2 * score)
    row = ntile + ptile + 2 * TILE + max(mat, ntile + ptile + 2 * TILE
                                         + score)
    return 4 * max(state, key, row)


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [p] * 9 + [i32] * 9 + [p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_plan.argtypes = [i32] * 7 + [p, p]
        lib.ssd_scan_plan.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_lib():
    lib = library(_BWD_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_bwd.argtypes = [p] * 9 + [i32] + [p] * 6 + [i32] * 9 \
            + [p]
        lib.ssd_scan_bwd.restype = ctypes.c_int
        lib.ssd_scan_bwd_plan.argtypes = [i32] * 9 + [p, p]
        lib.ssd_scan_bwd_plan.restype = ctypes.c_int
        lib.ssd_scan_bwd_scratch.argtypes = [i32] * 7
        lib.ssd_scan_bwd_scratch.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def bwd_plan(name: str, batch: int, t: int, heads: int, groups: int,
             n: int, p: int, chunk: int, recompute: bool = False
             ) -> Dict[str, Tuple[int, int]]:
    """(dynamic shared memory bytes, blocks) of each kernel a launch of
    backward design ``name`` runs at these sizes, keyed by kernel name in
    launch order (``recompute``: the states are recomputed first), as the
    launcher of ``csrc/ssd_scan_bwd.cu`` sizes them
    (``ssd_scan_bwd_plan``).  Builds the library; raises on sizes the
    design does not take."""
    vid = _bwd_id(name, n, p)
    kernels = BWD_KERNELS[name]
    smem = (ctypes.c_longlong * len(kernels))()
    blk = (ctypes.c_longlong * len(kernels))()
    k = _bwd_lib().ssd_scan_bwd_plan(vid, int(recompute), batch, t, heads,
                                     p, groups, n, chunk,
                                     ctypes.addressof(smem),
                                     ctypes.addressof(blk))
    names = kernels if recompute else kernels[2:]
    if k != len(names):
        raise ValueError(f"the SSD backward does not take N={n}, P={p}, "
                         f"T={t}, chunk={chunk}")
    return {kn: (smem[i], blk[i]) for i, kn in enumerate(names)}


def plan(name: str, batch: int, t: int, heads: int, n: int, p: int,
         chunk: int) -> Dict[str, Tuple[int, int]]:
    """(dynamic shared memory bytes, blocks) of each kernel a launch of
    variant ``name`` runs at these sizes, keyed by kernel name in launch
    order, as the launchers of ``csrc/ssd_scan.cu`` size them
    (``ssd_scan_plan``).  Builds the library; raises on sizes the variant
    does not take."""
    smem, blk = (ctypes.c_longlong * 3)(), (ctypes.c_longlong * 3)()
    k = _lib().ssd_scan_plan(_VARIANT_IDS[name], batch, t, heads, p, n,
                             chunk, ctypes.addressof(smem),
                             ctypes.addressof(blk))
    if k != len(KERNELS[name]):
        raise ValueError(f"{name} does not take N={n}, P={p}, T={t}, "
                         f"chunk={chunk}")
    return {kn: (smem[i], blk[i]) for i, kn in enumerate(KERNELS[name])}


def _check(x, dt, a, b, c, chunk: int, force: Optional[str]) -> str:
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"the SSD kernel needs CUDA tensors (or meta "
                         f"ones, to trace), got {x.device}")
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
    G, N = b.shape[2], b.shape[3]
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
    name = variant(x.dtype, N, P)
    if force is not None:
        if force not in _VARIANT_IDS:
            raise ValueError(f"unknown SSD variant {force!r}")
        if force == "mma_3xtf32" and name != force:
            raise ValueError(f"mma_3xtf32 does not take N={N}, P={P}")
        name = force
    for n, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if name != "simt" and n in ("x", "b", "c") and t.data_ptr() % 16:
            raise ValueError(f"{n} must be 16-byte aligned")
    if x.device.index is not None and \
            x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if name == "simt":
        if x.device.type == "meta":
            need, limit = smem_bytes(name, N, P, chunk), SMEM_PER_BLOCK
        else:
            need = plan(name, B, T, H, N, P, chunk)["ssd_simt_kernel"][0]
            limit = getattr(torch.cuda.get_device_properties(x.device),
                            "shared_memory_per_block_optin", SMEM_PER_BLOCK)
        if need > limit:
            raise ValueError(f"chunk {chunk} at N={N}, P={P} needs {need} "
                             f"bytes of shared memory per block, over the "
                             f"card's {limit}; use a smaller chunk")
    return name


def ssd_scan_states(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int,
                    _variant: Optional[str] = None):
    """:func:`ssd_scan`'s launch, with a third item: the ``mma_3xtf32``
    scratch as (states entering each chunk [B, H, T / chunk, N, P],
    in-chunk prefix sums of dt·a [B, H, T]), which :func:`ssd_scan_bwd`
    reads, or None after ``simt``, which keeps none."""
    name = _check(x, dt, a, b, c, chunk, _variant)
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h.zero_(), None
    cum = st = states = None
    if name == "mma_3xtf32":
        # one allocation: the states (16-byte aligned for cp.async), cum
        n_st = B * H * (T // chunk) * N * P
        scratch = torch.empty(n_st + B * H * T, dtype=torch.float32,
                              device=x.device)
        st = scratch.data_ptr()
        cum = st + 4 * n_st
        states = (scratch[:n_st].view(B, H, T // chunk, N, P),
                  scratch[n_st:].view(B, H, T))
    if x.device.type == "meta":
        meta_launch("ssd_scan", flops(B, T, H, N, P, chunk),
                    [x, dt, a, b, c, y, h])
        VARIANT_LAUNCHES[name] += 1
        return y, h, states
    err = _lib().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), h.data_ptr(), cum, st, B, T, H, P, G, N,
        chunk, _DTYPES[x.dtype], _VARIANT_IDS[name],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed ({name}): CUDA "
                           f"error {err}")
    VARIANT_LAUNCHES[name] += 1
    return y, h, states


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int,
             _variant: Optional[str] = None):
    """x:[B,T,H,P] dt:[B,T,H] a:[H] b,c:[B,T,G,N] -> (y:[B,T,H,P] in x's
    type, h:[B,H,N,P] float32), by the kernel that :func:`variant` picks,
    its passes enqueued by one C call.  ``_variant`` forces a variant (the
    chip smoke test times ``simt`` beside the chosen one with it)."""
    return ssd_scan_states(x, dt, a, b, c, chunk, _variant)[:2]


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                 dh: Optional[torch.Tensor], chunk: int,
                 states: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 _variant: Optional[str] = None):
    """(dx, ddt, da, db, dc): the gradient of :func:`ssd_scan`'s (y, h) at
    upstream ``dy`` (x's type and shape) and ``dh`` ([B, H, N, P] float32,
    or None: h unused), by one call that enqueues the passes of the design
    :func:`bwd_variant` picks, counted once in :data:`VARIANT_LAUNCHES`
    under its name (the first design as ``bwd_simt``, or
    ``bwd_simt_recompute`` where ``states`` is None and it recomputes
    them; ``bwd_mma_3xtf32`` recomputes them on the tensor cores).
    ``states``: what :func:`ssd_scan_states` returned third.
    ``_variant="bwd_simt"`` forces the first design (the chip smoke test
    times it beside the picked one).  Gradients in the inputs' type, da
    float32.  A build or launch error raises."""
    _check(x, dt, a, b, c, chunk, None)
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    name = bwd_variant(x.dtype, N, P)
    if _variant is not None:
        if _variant not in ("bwd_simt", "bwd_mma_3xtf32"):
            raise ValueError(f"unknown SSD backward variant {_variant!r}")
        if _variant == "bwd_mma_3xtf32" and name != _variant:
            raise ValueError(f"bwd_mma_3xtf32 does not take N={N}, P={P}")
        name = _variant
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} tensor of x's "
                         f"shape {tuple(x.shape)} on {x.device}")
    if name == "bwd_mma_3xtf32" and dy.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned")
    if dh is not None and (tuple(dh.shape) != (B, H, N, P)
                           or dh.dtype != torch.float32
                           or dh.device != x.device
                           or not dh.is_contiguous()):
        raise ValueError(f"dh must be None or a contiguous float32 "
                         f"[{B}, {H}, {N}, {P}] tensor on {x.device}")
    nc = T // chunk
    if states is not None:
        st, cum = states
        if tuple(st.shape) != (B, H, nc, N, P) or tuple(cum.shape) != \
                (B, H, T) or st.dtype != torch.float32 or \
                cum.dtype != torch.float32 or not st.is_contiguous() or \
                not cum.is_contiguous():
            raise ValueError("states must be the forward's float32 "
                             "(states [B, H, T / chunk, N, P], cum "
                             "[B, H, T])")
    grads = (torch.empty_like(x), torch.empty_like(dt),
             torch.empty(H, dtype=torch.float32, device=x.device),
             torch.empty_like(b), torch.empty_like(c))
    if x.numel() == 0:
        return tuple(g.zero_() for g in grads)
    if name != "bwd_mma_3xtf32":
        name = "bwd_simt" if states is not None else "bwd_simt_recompute"
    if states is None:
        st = torch.empty((B, H, nc, N, P), dtype=torch.float32,
                         device=x.device)
        cum = torch.empty((B, H, T), dtype=torch.float32, device=x.device)
    meta = x.device.type == "meta"
    lib = None if meta else _bwd_lib()
    n_scratch = bwd_scratch_floats(B, T, H, P, G, N, chunk) if meta else \
        lib.ssd_scan_bwd_scratch(B, T, H, P, G, N, chunk)
    if n_scratch < 0:
        raise ValueError(f"the SSD backward does not take N={N}, P={P}, "
                         f"T={T}, chunk={chunk}")
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    dx, ddt, da, db, dc = grads
    if meta:
        meta_launch("ssd_scan_bwd", bwd_work(B, T, H, G, N, P, chunk,
                                             x.element_size(),
                                             states is None)[0],
                    [x, dt, a, b, c, dy] + ([] if dh is None else [dh])
                    + ([] if states is None else [st, cum]) + list(grads))
        VARIANT_LAUNCHES[name] += 1
        return grads
    err = lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), dy.data_ptr(), None if dh is None else dh.data_ptr(),
        st.data_ptr(), cum.data_ptr(), int(states is not None),
        scratch.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
        db.data_ptr(), dc.data_ptr(), B, T, H, P, G, N, chunk,
        _DTYPES[x.dtype], _BWD_IDS[name],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed ({name}): "
                           f"CUDA error {err}")
    VARIANT_LAUNCHES[name] += 1
    return grads


class SSDScan(torch.autograd.Function):
    """The kernel with its gradient: the forward launches :func:`ssd_scan`
    and saves its inputs and the states it leaves; the backward launches
    :func:`ssd_scan_bwd`.  ``launches`` (``ops.LAUNCHES``) counts each
    forward under ``ssd_scan`` (a replay under activation checkpointing
    runs the forward, and its launch, again) and each backward under
    ``ssd_scan_bwd``.  Widths the backward does not take raise before the
    forward launches.  Either output may go unused: its gradient is then
    None (zero)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk, launches):
        check_bwd(x.dtype, b.shape[3], x.shape[3])
        y, h, states = ssd_scan_states(x, dt, a, b, c, chunk)
        launches["ssd_scan"] += 1
        st, cum = (None, None) if states is None else states
        ctx.save_for_backward(x, dt, a, b, c, st, cum)
        ctx.chunk, ctx.launches = chunk, launches
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, b, c, st, cum = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dh is not None:
            dh = dh.contiguous()
        grads = ssd_scan_bwd(x, dt, a, b, c, dy, dh, ctx.chunk,
                             None if st is None else (st, cum))
        ctx.launches["ssd_scan_bwd"] += 1
        return (*grads, None, None)
