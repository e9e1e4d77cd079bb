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
output, and launches on the current stream.  On ``meta`` tensors it does
all of that but the launch, in whose place it calls
``_device.meta_launch`` with the operation count (:func:`flops`,
:func:`bwd_flops`), and counts the launch all the same.  Asked for it,
each variant also writes the row log-sum-exp ``lse`` (float32
``[B, Hq, T]``); the serve paths do not ask.

**The gradient.**  The reference's kernel is forward-only (JAX
differentiates its plain attention); here the output comes through
``ctypes``, which autograd cannot see into.  :class:`FlashAttention`, the
``torch.autograd.Function`` that ``ops.flash_attention`` runs whenever an
input requires grad, saves q, k, v, the output and ``lse`` and runs the
backward kernel, ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`): three passes, FA2's split — (lse, delta =
rowsum(do o)) a row, dk and dv per 64-key tile, dq per 64-row query tile —
for D a multiple of 8 up to 256 (other head dims raise).
:func:`bwd_variant` picks its design from the type: ``bwd_mma_3xtf32``
(float32) and ``bwd_mma_bf16`` (bfloat16) run all five products on the
tensor cores through ``mma.sync``, the dk/dv pass with the operands
turned so that Pᵀ and dSᵀ feed the next products from registers;
``bwd_simt``, the first design on the CUDA cores, is reached only by
asking for it (``variant="bwd_simt"``), as a comparison.  The float32
variant adds its accumulators into the output every
:data:`BWD_FLUSH_ROWS` rows: the tensor core truncates each step's sum,
and one accumulator chained over a key's 16,384 rows at the train path
drifted 1.2e-4 off.  The plan (tiles, shared memory, flush interval) is
:func:`bwd_plan`, equal to the C launcher's (:func:`bwd_plan_c`).
Bound: operations, 10·D flops per visible (query, key) pair for the
gradient (the kernel does 14·D: both passes recompute the scores; 18·D
at D = 256, whose dk/dv accumulators split in two).  Its plain version is
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`, autograd's
gradient of the plain forward.  A row with no visible key (causal with
T > S) gets zero gradients.  No pass uses atomics: the gradients are the
same bits run to run.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .._build import library
from .._device import LaunchCounts, meta_launch

_SOURCE = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_IDS = {"simt": 0, "mma_bf16": 1, "mma_3xtf32": 1}
MAX_HEAD_DIM = 256
SIMT_MAX_HEAD_DIM = 128
BLOCK_Q = 64                        # query rows a block (16 a warp, 4 warps)
D_TILES = (32, 64, 80, 128, 256)    # head-dim tiles of the mma kernel
STAGES = 2                          # K/V ring depth of the mma kernel
_BWD_SOURCE = "flash_attention_bwd"
_BWD_VARIANT_IDS = {"bwd_simt": 0, "bwd_mma_bf16": 1,
                    "bwd_mma_3xtf32": 1}
BWD_BLOCK = 64      # keys of a dk/dv block, query rows of a dq block
BWD_PAD_T = 64      # the (lse, delta) scratch pads each head's rows to this
BWD_FLUSH_ROWS = 256  # float32: rows between adds of the accumulators into
                      # the output (kFlushRows)
VARIANT_LAUNCHES = LaunchCounts(mma_bf16=0, mma_3xtf32=0, simt=0,
                                bwd_mma_bf16=0, bwd_mma_3xtf32=0,
                                bwd_simt=0)


def visible_pairs(t: int, s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through for T queries over S
    keys, causality right-aligned (the last query sees the last key)."""
    tq = np.arange(t, dtype=np.int64) + (s - t)
    hi = np.minimum(tq, s - 1) if causal else np.full(t, s - 1)
    lo = np.maximum(tq - window + 1, 0) if window else np.zeros(t, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flops(b: int, hq: int, t: int, s: int, d: int, causal: bool,
          window) -> float:
    """The forward's operations: 4·D a visible pair (q·k and p·v) for
    each of the B·Hq heads."""
    return 4.0 * b * hq * d * visible_pairs(t, s, causal, window)


def bwd_flops(b: int, hq: int, t: int, s: int, d: int, causal: bool,
              window) -> float:
    """The gradient's operations: 10·D a visible pair (the scores, dv,
    dp, dq and dk products; the kernel recomputes the scores, 14·D)."""
    return 10.0 * b * hq * d * visible_pairs(t, s, causal, window)


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


def bwd_variant(dtype: torch.dtype, d: int) -> str:
    """The backward kernel that takes head dim ``d`` in ``dtype``:
    ``bwd_mma_bf16`` / ``bwd_mma_3xtf32`` (``mma.sync`` on the tensor
    cores) for ``d`` a multiple of 8 up to :data:`MAX_HEAD_DIM`, every
    registry head dim; other head dims raise.  ``bwd_simt`` is never
    picked: :func:`flash_attention_bwd` runs it only when asked."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if not 8 <= d <= MAX_HEAD_DIM or d % 8:
        raise ValueError(f"the flash attention backward takes head dims "
                         f"that are multiples of 8 up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    return "bwd_mma_bf16" if dtype == torch.bfloat16 else "bwd_mma_3xtf32"


def bwd_tiles(name: str, d: int) -> tuple:
    """(query rows a ring stage of the dk/dv pass, keys a ring stage of
    the dq pass, blocks that split a dk/dv tile's head dim) of backward
    variant ``name`` at head dim ``d``.  The mma variants hold 16 rows a
    warp, 4 warps: 64 keys a dk/dv block and 64 query rows a dq block;
    their stages are 64 rows up to D = 64; float32 32 at D = 80 and 16
    past it; bfloat16 64 up to D = 80 (dk/dv) or 128 (dq), then 32, and
    16 for the dk/dv pass at 256 — so that the score accumulators fit
    beside dk, dv or dq in registers and two blocks share an SM up to
    D = 128; at D = 256 two blocks each accumulate 128 of dk's and dv's
    columns.
    ``bwd_simt``: its 64 x 64 tiles, 32 x 32 past D = 128 (``Plan`` and
    ``simt_tile`` in ``csrc/flash_attention_bwd.cu``)."""
    if name == "bwd_simt":
        t = 64 if d <= 128 else 32
        return t, t, 1
    dt = d_tile(d)
    if name == "bwd_mma_3xtf32":
        bq = bk = 64 if dt <= 64 else 32 if dt <= 80 else 16
    elif name == "bwd_mma_bf16":
        bq = 64 if dt <= 80 else 32 if dt <= 128 else 16
        bk = 64 if dt <= 128 else 32
    else:
        raise ValueError(f"unknown backward variant {name!r}")
    return bq, bk, 2 if dt > 128 else 1


def bwd_smem_bytes(name: str, d: int) -> tuple:
    """Dynamic shared memory of one block of the dk/dv pass and of the dq
    pass of backward variant ``name`` at head dim ``d``, in bytes.  The
    mma variants: the block's own 64-row tiles (K and V; Q and dO) and 2
    ring stages (Q, dO and their (lse, delta) float2s; K and V), each row
    the bytes of :func:`d_tile` plus 16.  ``bwd_simt``: k and v tiles
    (rows padded to D + 1 words), q and do tiles (D + 4), one P / dS tile
    and the q tile's lse and delta, all float32, one plan for both
    passes.  What the kernel's launcher sizes its requests by
    (``flash_attention_bwd_plan`` in the C source returns it)."""
    bq, bk, _ = bwd_tiles(name, d)
    if name == "bwd_simt":
        n = 4 * (2 * bk * (d + 1) + 2 * bq * (d + 4) + bq * (bk + 1)
                 + 2 * bq)
        return n, n
    row = d_tile(d) * (4 if name == "bwd_mma_3xtf32" else 2) + 16
    own = 2 * BWD_BLOCK * row
    return (own + STAGES * (2 * bq * row + 8 * bq),
            own + STAGES * 2 * bk * row)


def bwd_plan(name: str, d: int) -> tuple:
    """Backward variant ``name``'s whole plan at head dim ``d``:
    :func:`bwd_tiles`, :func:`bwd_smem_bytes` and the rows between the
    float32 variant's flushes of its accumulators into the output
    (:data:`BWD_FLUSH_ROWS`; 0 where none: bf16 keeps one accumulator
    chain, ``bwd_simt`` adds on the CUDA cores) — what
    ``flash_attention_bwd_plan`` in the C source returns."""
    flush = BWD_FLUSH_ROWS if name == "bwd_mma_3xtf32" else 0
    return bwd_tiles(name, d) + bwd_smem_bytes(name, d) + (flush,)


def bwd_plan_c(name: str, d: int) -> tuple:
    """The C launcher's own plan (``flash_attention_bwd_plan``), to be
    equal to :func:`bwd_plan` (needs the built library, so the card)."""
    dtype = 1 if name == "bwd_mma_bf16" else 0
    out = (ctypes.c_int * 6)()
    err = _bwd_lib().flash_attention_bwd_plan(
        dtype, _BWD_VARIANT_IDS[name], d, out)
    if err != 0:
        raise ValueError(f"flash_attention_bwd_plan refused {name} at "
                         f"D={d}: CUDA error {err}")
    return tuple(out)


def _lib():
    lib = library(_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i32, i32, i32,
                                            i32, i32, i32, i32, i32,
                                            ctypes.c_float, i32, i32, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_lib():
    lib = library(_BWD_SOURCE)
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i32] * 8 + [
            ctypes.c_float, i32, i32, p]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_plan.argtypes = [i32, i32, i32, p]
        lib.flash_attention_bwd_plan.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> str:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"the flash attention kernel needs CUDA tensors "
                         f"(or meta ones, to trace), got {q.device}")
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
                    causal: bool = True, window: Optional[int] = None,
                    with_lse: bool = False):
    """q:[B,Hq,T,D] k/v:[B,Hkv,S,D] -> [B,Hq,T,D] in q's type, by one
    launch of the kernel that :func:`variant` picks; ``with_lse`` also
    returns each row's log-sum-exp, float32 ``[B, Hq, T]``."""
    name = _check(q, k, v, window)
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() and q.device.type == "meta":
        meta_launch("flash_attention",
                    flops(b, hq, t, s, d, causal, window),
                    [q, k, v, out] + ([lse] if with_lse else []))
        VARIANT_LAUNCHES[name] += 1
    elif out.numel():
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, hq, hkv, t, s, d,
            int(causal), int(window or 0), d ** -0.5, _DTYPES[q.dtype],
            _VARIANT_IDS[name],
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_attention kernel launch failed "
                               f"({name}): CUDA error {err}")
        VARIANT_LAUNCHES[name] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        variant: Optional[str] = None):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at upstream
    ``dout``, from its inputs, its output ``out`` and its ``lse``, by one
    call that enqueues the backward kernel's three passes (counted once
    in :data:`VARIANT_LAUNCHES` under the variant that ran).  ``variant``
    None runs the one :func:`bwd_variant` picks; ``"bwd_simt"`` forces
    the first design (a comparison; no path asks for it).  Gradients come
    in the inputs' type; a row with no visible key gets zeros."""
    _check(q, k, v, window)
    picked = bwd_variant(q.dtype, q.shape[-1])
    name = picked if variant is None else variant
    if name not in (picked, "bwd_simt"):
        raise ValueError(f"backward variant {name!r} does not take "
                         f"{q.dtype} (want {picked!r} or 'bwd_simt')")
    for n, t_ in (("out", out), ("dout", dout)):
        if t_.shape != q.shape or t_.dtype != q.dtype or \
                t_.device != q.device or not t_.is_contiguous():
            raise ValueError(f"{n} must be a contiguous {q.dtype} tensor of "
                             f"q's shape {tuple(q.shape)} on {q.device}")
    if name != "bwd_simt" and dout.data_ptr() % 16:
        raise ValueError("dout must be 16-byte aligned")
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if lse.shape != (b, hq, t) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 [{b}, {hq}, "
                         f"{t}] tensor on {q.device}")
    if t == 0 or s == 0 or b == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    t_pad = -(-t // BWD_PAD_T) * BWD_PAD_T
    stats = torch.empty((b, hq, t_pad, 2), dtype=torch.float32,
                        device=q.device)
    if q.device.type == "meta":
        meta_launch("flash_attention_bwd",
                    bwd_flops(b, hq, t, s, d, causal, window),
                    [q, k, v, out, dout, lse, dq, dk, dv])
        VARIANT_LAUNCHES[name] += 1
        return dq, dk, dv
    err = _bwd_lib().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, t, s, d, int(causal),
        int(window or 0), d ** -0.5, _DTYPES[q.dtype],
        _BWD_VARIANT_IDS[name],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed "
                           f"({name}): CUDA error {err}")
    VARIANT_LAUNCHES[name] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The kernel with its gradient: the forward launches
    :func:`flash_attention` with ``lse`` and saves q, k, v, the output and
    ``lse``; the backward launches :func:`flash_attention_bwd`.
    ``launches`` (``ops.LAUNCHES``) counts each forward under
    ``flash_attention`` (a replay under activation checkpointing runs the
    forward, and its launch, again) and each backward under
    ``flash_attention_bwd``.  A head dim the backward does not take
    raises before the forward launches."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, launches):
        bwd_variant(q.dtype, q.shape[-1])
        out, lse = flash_attention(q, k, v, causal, window, with_lse=True)
        launches["flash_attention"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.launches = causal, window, launches
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, ctx.causal, ctx.window)
        ctx.launches["flash_attention_bwd"] += 1
        return dq, dk, dv, None, None, None
