"""The arithmetic of the flash attention backward kernel, emulated on the
CPU (``csrc/flash_attention_bwd.cu``: ``bwd_mma_3xtf32`` for float32,
``bwd_mma_bf16`` for bfloat16).

The kernel's two passes compute five products on the tensor cores:
S = q kᵀ and dP = do vᵀ (in both passes), dv += Pᵀ do, dk += dSᵀ q and
dq += dS k.  The emulation runs each as the kernel's ``mma.sync`` steps
into one float32 accumulator — 8 deep for float32 (m16n8k8 tf32, every
operand split for 3xTF32), 16 deep for bfloat16 (m16n8k16, P and dS
rounded to bfloat16 as they become A operands) — with each head's query
and key rows zero-padded to whole steps, as the kernel's tiles are; dk
and dv sum the group's query heads in head order, one step after the
other, as the dk/dv pass's accumulators do.  P = exp2((scale S - lse)
log2 e) from the forward's lse, zero where the mask hides a pair;
dS = P (dP - delta) with delta = rowsum(do o).

Each emulation is held against ``jax.grad`` of the reference's plain
attention on the cases of ``tests/test_torch_flash_grad.py``: float32
within 2e-5 of each gradient's largest magnitude and at least 10x closer
than the same design with one TF32 product; bfloat16 within 2e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch.kernels import jet_flash_attention as jfa

from test_torch_flash import _split, _tf32
from test_torch_flash_grad import CASES, _inputs, _rel

torch.set_num_threads(1)

F32_TOL = 2e-5      # chip_smoke.py's FLASH_BWD_TOL: of each max |gradient|
BF16_TOL = 2e-2
LOG2E = np.float32(1.4426950408889634)


def _bf16(x):
    """Round float32 to bfloat16, to nearest even, kept as float32 (what
    cvt.rn.bf16x2.f32 gives the tensor core)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _rz(x):
    """float64 to float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _mma(a, b, kind: str, acc=None, rz: bool = False):
    """a [..., m, K] @ b [..., K, n] as the kernel's mma.sync steps along K
    into one float32 accumulator (``acc``, zeros if None): ``3xtf32``
    small·big + big·small + big·big on each operand's split, 8 deep;
    ``tf32`` one product of the TF32 roundings, 8 deep; ``bf16`` the exact
    products of bfloat16 operands, 16 deep.  ``rz``: each step's sum
    (accumulator plus products, in float64) rounds toward zero, a model of
    the tensor core's truncating accumulation; else to nearest."""
    step = 16 if kind == "bf16" else 8
    assert a.shape[-1] % step == 0
    if acc is None:
        acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)

    def add(acc, x, y):
        if not rz:
            return acc + x @ y
        return _rz(acc.astype(np.float64) + x.astype(np.float64)
                   @ y.astype(np.float64))
    for c in range(0, a.shape[-1], step):
        ac, bc = a[..., c:c + step], b[..., c:c + step, :]
        if kind == "3xtf32":
            (ab, as_), (bb, bs) = _split(ac), _split(bc)
            acc = add(acc, as_, bb)
            acc = add(acc, ab, bs)
            acc = add(acc, ab, bb)
        elif kind == "tf32":
            acc = add(acc, _tf32(ac), _tf32(bc))
        else:
            acc = add(acc, ac, bc)
    return acc


def _flush(total, acc, mul):
    """total + acc * mul in one float32 rounding (the kernel's fma)."""
    return (acc.astype(np.float64) * np.float64(mul)
            + total.astype(np.float64)).astype(np.float32)


def _pad(x, axis: int, mult: int):
    """Zeros past the end of ``axis`` up to a multiple of ``mult``."""
    extra = -x.shape[axis] % mult
    width = [(0, 0)] * x.ndim
    width[axis] = (0, extra)
    return np.pad(x, width)


def _visible(t, s, causal, window):
    tq = np.arange(t)[:, None] + (s - t)
    sk = np.arange(s)[None, :]
    ok = np.ones((t, s), bool)
    if causal:
        ok &= tq >= sk
    if window:
        ok &= tq - sk < window
    return ok


def _forward(q, k, v, causal, window):
    """The forward's output and lse, in float64 then float32 (what the
    forward kernel hands the backward, to its own rounding); a row with
    no visible key gets o = 0 and lse = -inf, as the kernel gives it."""
    group = q.shape[1] // k.shape[1]
    kr, vr = (np.repeat(x.astype(np.float64), group, axis=1) for x in (k, v))
    vis = _visible(q.shape[2], k.shape[2], causal, window)
    sc = np.einsum("bhtd,bhsd->bhts", q.astype(np.float64), kr) \
        * q.shape[-1] ** -0.5
    sc = np.where(vis, sc, -np.inf)
    seen = vis.any(-1)
    m = np.where(seen[:, None], sc.max(-1, keepdims=True), 0.0)
    p = np.exp(sc - m)
    with np.errstate(divide="ignore"):      # rows with no key: log(0)
        lse = np.where(seen, m[..., 0] + np.log(p.sum(-1)), -np.inf)
    o = np.einsum("bhts,bhsd->bhtd",
                  p / np.maximum(p.sum(-1, keepdims=True), 1e-300), vr)
    return o.astype(np.float32), lse.astype(np.float32)


def _dkdv_tiles(t, s, k0, bq, causal, window, group):
    """The (head, first query) of every query tile the dk/dv block of keys
    [k0, k0 + 64) walks, in its order: the group's heads, each over the
    tiles that see a key of the block."""
    offset, k1 = s - t, min(k0 + jfa.BWD_BLOCK, s) - 1
    t_lo = max(0, k0 - offset) if causal else 0
    t_hi = min(t, window + k1 - offset) if window else t
    i_lo = t_lo // bq
    n_qt = -(-t_hi // bq) - i_lo if t_hi > t_lo else 0
    return [(g, (i_lo + j) * bq) for g in range(group) for j in range(n_qt)]


def _dq_tiles(t, s, t0, bk, causal, window):
    """The first key of every key tile the dq block of rows [t0, t0 + 64)
    walks, in order."""
    offset, last = s - t, min(t0 + jfa.BWD_BLOCK, t) - 1
    hi = min(s, last + offset + 1) if causal else s
    lo = max(0, t0 + offset - window + 1) if window else 0
    return [j * bk for j in range(lo // bk, -(-max(hi, 0) // bk))]


def _bwd_emulated(q, k, v, o, do, lse, causal, window, kind):
    """(dq, dk, dv) of the two passes with the kernel's products
    (:func:`_mma`) in its tiles and order.  ``kind``: ``3xtf32`` (the
    float32 kernel), ``tf32`` (the same design with one TF32 product) or
    ``bf16`` (the bfloat16 kernel: inputs, o and do already bfloat16
    values; gradients rounded to bfloat16).  The dk/dv pass walks each
    64-key block's (head, query tile) pairs and the dq pass each 64-row
    block's key tiles (:func:`_dkdv_tiles`, :func:`_dq_tiles`, the
    stage sizes of ``jet_flash_attention.bwd_tiles``), chaining every
    tile's mma steps into one accumulator; float32 adds it into the
    gradient every ``BWD_FLUSH_ROWS`` rows (:func:`_flush`), bf16 once."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    step = 16 if kind == "bf16" else 8
    scale = np.float32(d ** -0.5)
    a_op = _bf16 if kind == "bf16" else (lambda x: x)
    name = "bwd_mma_bf16" if kind == "bf16" else "bwd_mma_3xtf32"
    bq, bk, _ = jfa.bwd_tiles(name, d)
    flush = jfa.BWD_FLUSH_ROWS if kind != "bf16" else 1 << 30
    delta = (do * o).sum(-1, dtype=np.float32)
    kr, vr = np.repeat(k, group, axis=1), np.repeat(v, group, axis=1)
    # S and dP over the head dim (zero-padded to the kernel's head-dim tile)
    qp, dop, krp, vrp = (_pad(x, -1, step) for x in (q, do, kr, vr))
    sc = _mma(qp, np.swapaxes(krp, -1, -2), kind)
    dpr = _mma(dop, np.swapaxes(vrp, -1, -2), kind)
    with np.errstate(over="ignore"):        # lse = -inf: masked below
        p = np.exp2((sc * scale - lse[..., None]) * LOG2E)
    p = np.where(_visible(t, s, causal, window), p, np.float32(0))
    ds = p * (dpr - delta[..., None])
    # rows and keys zero-padded to whole blocks, as the tiles are
    blk = jfa.BWD_BLOCK
    pa, dsa = (_pad(_pad(a_op(x), -1, blk), -2, blk) for x in (p, ds))
    qz, doz = (_pad(x, -2, blk) for x in (q, do))
    kz = _pad(kr, -2, blk)
    dq = np.zeros((b, hq, pa.shape[2], d), np.float32)
    dk = np.zeros((b, hkv, pa.shape[3], d), np.float32)
    dv = np.zeros_like(dk)
    for k0 in range(0, s, blk):
        tiles = _dkdv_tiles(t, s, k0, bq, causal, window, group)
        per = max(flush // bq, 1)
        for c in range(0, len(tiles), per):
            accv = acck = None
            for g, t0 in tiles[c:c + per]:
                heads = [h * group + g for h in range(hkv)]
                rows = slice(t0, t0 + bq)
                pt = np.swapaxes(pa[:, heads, rows, k0:k0 + blk], -1, -2)
                dst = np.swapaxes(dsa[:, heads, rows, k0:k0 + blk], -1, -2)
                accv = _mma(pt, doz[:, heads, rows], kind, accv)
                acck = _mma(dst, qz[:, heads, rows], kind, acck)
            dv[:, :, k0:k0 + blk] = _flush(dv[:, :, k0:k0 + blk], accv, 1.0)
            dk[:, :, k0:k0 + blk] = _flush(dk[:, :, k0:k0 + blk], acck,
                                           scale)
    for t0 in range(0, t, blk):
        tiles = _dq_tiles(t, s, t0, bk, causal, window)
        per = max(flush // bk, 1)
        for c in range(0, len(tiles), per):
            acc = None
            for s0 in tiles[c:c + per]:
                acc = _mma(dsa[:, :, t0:t0 + blk, s0:s0 + bk],
                           kz[:, :, s0:s0 + bk], kind, acc)
            dq[:, :, t0:t0 + blk] = _flush(dq[:, :, t0:t0 + blk], acc,
                                           scale)
    out = dq[:, :, :t], dk[:, :, :s], dv[:, :, :s]
    return tuple(_bf16(x) for x in out) if kind == "bf16" else out


def _jax_grad(q, k, v, do, causal, window):
    def f(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, causal=causal, window=window,
                                   impl="ref")
        return jnp.sum(out * do)
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_backward_keeps_float32_accuracy(case):
    *_, causal, window = CASES[case]
    q, k, v, do = _inputs(case, 1)
    o, lse = _forward(q, k, v, causal, window)
    want = _jax_grad(q, k, v, do, causal, window)
    three = _bwd_emulated(q, k, v, o, do, lse, causal, window, "3xtf32")
    one = _bwd_emulated(q, k, v, o, do, lse, causal, window, "tf32")
    for name, g3, g1, w in zip(("dq", "dk", "dv"), three, one, want):
        assert g3.shape == w.shape
        err3, err1 = _rel(g3, w), _rel(g1, w)
        assert err3 <= F32_TOL, (name, err3)
        assert 10 * err3 <= err1, (name, err3, err1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_backward_within_its_tolerance(case):
    *_, causal, window = CASES[case]
    q, k, v, do = (_bf16(x) for x in _inputs(case, 2))
    o, lse = _forward(q, k, v, causal, window)
    want = _jax_grad(q, k, v, do, causal, window)
    got = _bwd_emulated(q, k, v, _bf16(o), do, lse, causal, window, "bf16")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= BF16_TOL, (name, _rel(g, w))


def test_rows_without_a_key_get_zeros():
    """Causal with T > S: the first T - S rows see no key (the forward
    gives them lse = -inf); the emulated kernel masks their P to 0, so
    their dq is zero and no NaN reaches dk or dv."""
    rng = np.random.default_rng(3)
    q, do = (rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, 2, 8, 16)).astype(np.float32)
            for _ in range(2))
    o, lse = _forward(q, k, v, True, None)
    assert np.isneginf(lse[..., :16]).all() and np.all(o[..., :16, :] == 0)
    dq, dk, dv = _bwd_emulated(q, k, v, o, do, lse, True, None, "3xtf32")
    assert np.all(dq[..., :16, :] == 0)
    assert np.isfinite(dk).all() and np.isfinite(dv).all()
    want = _jax_grad(q[..., 16:, :], k, v, do[..., 16:, :], True, None)
    for g, w in zip((dq[..., 16:, :], dk, dv), want):
        assert _rel(g, w) <= F32_TOL


@pytest.mark.parametrize("kind", ["3xtf32", "bf16"])
def test_flushes_bound_the_accumulator_drift(kind):
    """dv of one key block at the train path's depth (4 heads x 4,096
    query rows) with the tensor core's accumulation modelled as rounding
    toward zero at every mma step (:func:`_mma` ``rz``).  One float32
    accumulator chained over all 16,384 rows (6,144 3xTF32 steps) drifts
    past chip_smoke.py's 2e-5 (the card measured 1.2e-4 at that shape
    without flushes); adding it into the gradient every BWD_FLUSH_ROWS
    rows keeps it within.  bf16's one chain (1,024 steps) stays far
    below its own 2e-2."""
    rng = np.random.default_rng(5)
    rows = 4 * 4096
    p = rng.uniform(0, 1, (64, rows)).astype(np.float32)
    dout = rng.standard_normal((rows, 8)).astype(np.float32)
    if kind == "bf16":
        p, dout = _bf16(p), _bf16(dout)
    exact = p.astype(np.float64) @ dout.astype(np.float64)
    chained = _mma(p, dout, kind, rz=True)
    err = _rel(chained, exact)
    if kind == "bf16":
        assert err <= 1e-3 * BF16_TOL, err
        return
    total = np.zeros_like(chained)
    for r0 in range(0, rows, jfa.BWD_FLUSH_ROWS):
        r1 = r0 + jfa.BWD_FLUSH_ROWS
        total = _flush(total, _mma(p[:, r0:r1], dout[r0:r1], kind, rz=True),
                       1.0)
    flushed = _rel(total, exact)
    assert flushed <= F32_TOL < err, (flushed, err)
    assert 10 * flushed <= err, (flushed, err)


def test_bf16_rounding_matches_the_cvt():
    """:func:`_bf16` rounds to nearest even at bfloat16's 8 significant
    bits, as torch's own conversion does."""
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32)
    x[:3] = (1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8))
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(_bf16(x), want)
