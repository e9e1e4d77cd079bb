"""The SSD scan's kernel choice, shared-memory plan and float32 numerics on
the CPU.

On the card ``repro_torch.kernels.ops.ssd`` runs one of two kernels,
picked from the type and the widths alone before the launch
(``mamba2_ssd.variant``): three chunk-parallel passes on the tensor cores
through a 3xTF32 split (``mma_3xtf32``) when N and P are multiples of 8 up
to 128, the first kernel on the CUDA cores (``simt``) otherwise.  The
kernels run only on the card (``tests/test_torch_cuda.py``); here the three
passes are emulated in numpy, with each product rounded as the tensor
cores round it, to pin the float32 design's accuracy against the
reference's Pallas kernel.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ref

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_torch_kernels.py


# --------------------------------------------------------------------------- #
# the kernel choice, its shared memory and its grid
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,p,mma", [(64, 64, True), (16, 32, True),
                                     (8, 8, True), (128, 128, True),
                                     (64, 20, False), (12, 64, False),
                                     (136, 64, False), (64, 256, False)])
def test_variant_follows_type_and_widths(dtype, n, p, mma):
    assert ssd.variant(dtype, n, p) == ("mma_3xtf32" if mma else "simt")
    # the rule: 16-byte rows within the tile plan go to the tensor cores
    assert mma == (n % 8 == 0 and p % 8 == 0 and max(n, p) <= 128)


@pytest.mark.parametrize("dtype,n,p,err,match", [
    (torch.float16, 64, 64, TypeError, "float32 or bfloat16"),
    (torch.float32, 0, 64, ValueError, "positive"),
    (torch.bfloat16, 64, 0, ValueError, "positive"),
])
def test_variant_refuses_what_no_kernel_takes(dtype, n, p, err, match):
    with pytest.raises(err, match=match):
        ssd.variant(dtype, n, p)


@pytest.mark.parametrize("n,p", [(8, 8), (64, 64), (8, 128), (128, 8),
                                 (72, 64), (128, 128)])
def test_mma_smem_fits_a_block(n, p):
    assert ssd.smem_bytes("mma_3xtf32", n, p) <= 232448      # 227 KB


def test_smem_plan_at_the_path_and_the_widest_widths():
    # serve path, N = P = 64: the output pass is the larger (a c tile of
    # 64 rows of 68 words, two stages of b and x key tiles with cum and
    # dt); two blocks to an SM (228 KB, 1 KB reserved per block)
    assert ssd.smem_bytes("mma_3xtf32", 64, 64) == 4 * (64 * 68 + 2 * (
        64 * (68 + 68) + 128))
    assert 2 * (ssd.smem_bytes("mma_3xtf32", 64, 64) + 1024) <= 228 * 1024
    assert ssd.smem_bytes("mma_3xtf32", 128, 128) == 169984
    # no chunk enters the mma plan; widths pad to 64 or 128
    assert ssd.smem_bytes("mma_3xtf32", 16, 32) == \
        ssd.smem_bytes("mma_3xtf32", 64, 64)
    assert [ssd.width_tile(w) for w in (8, 64, 72, 128)] == [64, 64, 128,
                                                             128]
    # simt holds the chunk: the serve path's fits, N = P = 128 at chunk
    # 512 does not (the wrapper refuses it)
    assert ssd.smem_bytes("simt", 64, 64, 256) == 192640
    assert ssd.smem_bytes("simt", 128, 128, 512) > 232448
    with pytest.raises(ValueError, match="chunk"):
        ssd.smem_bytes("simt", 64, 64)
    with pytest.raises(ValueError, match="unknown"):
        ssd.smem_bytes("wgmma", 64, 64)


@pytest.mark.parametrize("force", [None, "simt", "mma_3xtf32"])
def test_wrapper_refuses_cpu_tensors_and_unknown_variants(force):
    x = torch.zeros((1, 8, 2, 8))
    dt, a = torch.zeros((1, 8, 2)), torch.zeros(2)
    bc = torch.zeros((1, 8, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_scan(x, dt, a, bc, bc, 8, _variant=force)
    assert dict(ssd.VARIANT_LAUNCHES) == {"mma_3xtf32": 0, "simt": 0,
                                          "bwd_mma_3xtf32": 0,
                                          "bwd_simt": 0,
                                          "bwd_simt_recompute": 0}


# --------------------------------------------------------------------------- #
# the float32 kernel's numerics: the three passes under 3xTF32
# --------------------------------------------------------------------------- #
def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: add half of the 13 dropped bits'
    weight to the magnitude, then clear them."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_read(x):
    """What the tensor core reads of a float32 register as TF32: its upper
    19 bits (the low 13 cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """The kernel's split in float32: big = the TF32 rounding of x;
    small = x - big, exact, as the tensor core reads it."""
    x = np.asarray(x, np.float32)
    big = _tf32(x)
    return big, _tf32_read(x - big)


def _product(a, b, split: bool, acc=None):
    """acc + a [..., m, k] @ b [..., k, n] as the kernel's mma.sync steps
    of 8 along k into one float32 accumulator: with ``split``, small.big +
    big.small + big.big on the split of each operand; without it, one
    product of the TF32 roundings."""
    if acc is None:
        acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k in range(0, a.shape[-1], 8):
        ak, bk = a[..., k:k + 8], b[..., k:k + 8, :]
        if split:
            (ab, as_), (bb, bs) = _split(ak), _split(bk)
            acc = acc + as_ @ bb
            acc = acc + ab @ bs
            acc = acc + ab @ bb
        else:
            acc = acc + _tf32(ak) @ _tf32(bk)
    return acc.astype(np.float32)


def _scan_f64(dth, a):
    """The state pass's prefix sum of dt * a along the last axis: float64
    sums (the order does not show at float32), each rounded to float32."""
    return np.cumsum(dth.astype(np.float64) * a[None, :, None, None],
                     axis=-1).astype(np.float32)


def _scan_f32_warp(dth, a):
    """The same prefix sum as the first design took it, all in float32:
    each of 32 lanes sums ceil(L / 32) elements in order (dt * a fused into
    the add), the lanes' totals are scanned by shuffles (Hillis-Steele),
    and a lane's exclusive start is its inclusive total less its own."""
    f32 = np.float32
    L = dth.shape[-1]
    per = -(-L // 32)
    av = a.astype(np.float64)[None, :, None]
    spans = [(min(j * per, L), min(j * per + per, L)) for j in range(32)]

    def fma_run(start, beg, end, out=None):
        r = start
        for l in range(beg, end):
            r = (dth[..., l].astype(np.float64) * av + r).astype(f32)
            if out is not None:
                out[..., l] = r
        return r
    run = np.stack([fma_run(np.zeros(dth.shape[:-1], f32), b, e)
                    for b, e in spans], -1)
    tot = run.copy()
    for o in (1, 2, 4, 8, 16):
        up = np.concatenate([np.zeros_like(tot[..., :o]), tot[..., :-o]],
                            -1)
        tot = (tot + up).astype(f32)
    start = (tot - run).astype(f32)
    out = np.zeros(dth.shape, f32)
    for j, (b, e) in enumerate(spans):
        fma_run(start[..., j], b, e, out)
    return out


def _ssd_emulated(x, dt, a, b, c, chunk: int, split: bool,
                  scan=_scan_f64):
    """The three passes of ``mma_3xtf32`` in float32, every product as
    :func:`_product`: the chunks' states and prefix sums (by ``scan``), the
    carry, and y per 64-row tile over key tiles up to the diagonal."""
    tile = ssd.TILE
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    L, nc = chunk, T // chunk
    f32 = np.float32
    # [B, H, nc, L, ...] per chunk, b and c repeated over each group's heads
    xh = x.transpose(0, 2, 1, 3).reshape(B, H, nc, L, P)
    dth = dt.transpose(0, 2, 1).reshape(B, H, nc, L)
    bh = np.repeat(b, H // G, axis=2).transpose(0, 2, 1, 3).reshape(
        B, H, nc, L, N)
    ch = np.repeat(c, H // G, axis=2).transpose(0, 2, 1, 3).reshape(
        B, H, nc, L, N)
    cum = scan(dth, a)
    last = cum[..., -1]                                      # [B, H, nc]
    # pass 1: S[k] = (b w)^T x over the chunk, w = dt exp(cum_last - cum)
    w = dth * np.exp(last[..., None] - cum)
    states = _product(np.swapaxes(bh * w[..., None], -1, -2), xh, split)
    # pass 2: h_in[k] = exp(cum_last[k-1]) h_in[k-1] + S[k-1]
    h = np.zeros((B, H, N, P), f32)
    h_in = []
    for k in range(nc):
        h_in.append(h)
        h = (np.exp(last[:, :, k])[..., None, None] * h
             + states[:, :, k]).astype(f32)
    # pass 3: y per row tile
    y = np.zeros((B, H, nc, L, P), f32)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(nc):
            for r0 in range(0, L, tile):
                rows = slice(r0, min(r0 + tile, L))
                cr, cl = ch[:, :, k, rows], cum[:, :, k, rows]
                o = np.zeros(cr.shape[:-1] + (P,), f32)
                if k:
                    o = np.exp(cl)[..., None] * _product(cr, h_in[k], split)
                for m0 in range(0, r0 + 1, tile):
                    keys = slice(m0, min(m0 + tile, L))
                    s = _product(cr, np.swapaxes(bh[:, :, k, keys], -1, -2),
                                 split)
                    seg = cl[..., :, None] - cum[:, :, k, None, keys]
                    li = np.arange(rows.start, rows.stop)[:, None]
                    mi = np.arange(keys.start, keys.stop)[None, :]
                    s = np.where(li >= mi, s * np.exp(seg)
                                 * dth[:, :, k, None, keys], f32(0))
                    o = _product(s.astype(f32), xh[:, :, k, keys], split, o)
                y[:, :, k, rows] = o
    return y.reshape(B, H, T, P).transpose(0, 2, 1, 3), h


def _inputs(seed, B, T, H, P, G, N, a_lo=-8.0, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    # dt as the Mamba2 block makes it: softplus around 0.05
    dt = (np.log1p(np.exp(rng.standard_normal((B, T, H)) * 0.5
                          + np.log(np.expm1(0.05)))) * dt_scale
          ).astype(np.float32)
    a = -np.linspace(1.0, -a_lo, H).astype(np.float32)
    b = rng.standard_normal((B, T, G, N)).astype(np.float32)
    c = rng.standard_normal((B, T, G, N)).astype(np.float32)
    return x, dt, a, b, c


def _reference(x, dt, a, b, c, chunk):
    y, h = jops.ssd(*(jnp.asarray(v) for v in (x, dt, a, b, c)),
                    chunk=chunk, impl="interpret")
    return np.asarray(y), np.asarray(h)


# (B, T, H, P, G, N, chunk, a_lo, dt_scale): a ragged 20-row chunk, two
# chunks of 32, two chunks of 80 rows (two row tiles, the second ragged)
# with G = 2, and a strongly decaying head set (a down to -64, small dt)
EMULATED = [(1, 40, 2, 16, 1, 8, 20, -8.0, 1.0),
            (2, 64, 2, 8, 1, 16, 32, -8.0, 1.0),
            (1, 160, 4, 16, 2, 16, 80, -8.0, 1.0),
            (1, 128, 2, 16, 1, 8, 64, -64.0, 0.2)]


@pytest.mark.parametrize("B,T,H,P,G,N,chunk,a_lo,dt_scale", EMULATED)
def test_3xtf32_passes_match_the_reference(B, T, H, P, G, N, chunk, a_lo,
                                           dt_scale):
    x, dt, a, b, c = _inputs(T + N, B, T, H, P, G, N, a_lo, dt_scale)
    want_y, want_h = _reference(x, dt, a, b, c, chunk)
    y, h = _ssd_emulated(x, dt, a, b, c, chunk, split=True)
    assert np.isfinite(y).all() and np.isfinite(h).all()
    np.testing.assert_allclose(y, want_y, **TOL)
    np.testing.assert_allclose(h, want_h, **TOL)


def test_one_tf32_product_misses_the_bound_the_split_holds():
    x, dt, a, b, c = _inputs(3, 1, 160, 4, 16, 2, 16)
    want_y, want_h = _reference(x, dt, a, b, c, 80)
    three, _ = _ssd_emulated(x, dt, a, b, c, 80, split=True)
    one, _ = _ssd_emulated(x, dt, a, b, c, 80, split=False)
    bound = TOL["atol"] + TOL["rtol"] * np.abs(want_y)
    assert (np.abs(three - want_y) <= bound).all()
    assert (np.abs(one - want_y) > bound).any()
    err3 = float(np.abs(three - want_y).max())
    err1 = float(np.abs(one - want_y).max())
    assert 10 * err3 <= err1, (err3, err1)


# --------------------------------------------------------------------------- #
# where the float32 error comes from: the prefix sum
# --------------------------------------------------------------------------- #
def _truth(x, dt, a, b, c):
    """y of the recurrence h_t = exp(dt_t a) h_(t-1) + dt_t b_t x_t^T,
    y_t = c_t h_t, step by step in float64."""
    x, dt, a, b, c = (np.asarray(v, np.float64) for v in (x, dt, a, b, c))
    B, T, H, P = x.shape
    rep = H // b.shape[2]
    bh, ch = np.repeat(b, rep, axis=2), np.repeat(c, rep, axis=2)
    h = np.zeros((B, H, b.shape[3], P))
    y = np.zeros((B, T, H, P))
    for t in range(T):
        h = (np.exp(dt[:, t] * a)[..., None, None] * h
             + dt[:, t, :, None, None] * bh[:, t, :, :, None]
             * x[:, t, :, None, :])
        y[:, t] = np.einsum("bhn,bhnp->bhp", ch[:, t], h)
    return y


def _worst(y, truth):
    """Largest |y - truth| over the 2e-4 abs + rel tier: 1 is the limit."""
    return float((np.abs(y - truth)
                  / (TOL["atol"] + TOL["rtol"] * np.abs(truth))).max())


@pytest.mark.parametrize("seed,T,H", [(7, 512, 8), (9, 512, 16)])
def test_float64_prefix_sum_keeps_the_kernel_at_the_plain_versions_error(
        seed, T, H):
    # the serve path's widths and chunk (N = P = 64, L = 256), a to -8:
    # |cum| reaches ~100 in a chunk.  Against the float64 recurrence, the
    # passes with the kernel's float64 prefix sum are as close as the
    # plain version (float32, torch.cumsum); the float32 warp scan of the
    # first design is 1.5-2.8x farther, the excess a card run sees as the
    # kernel's distance to the plain version
    x, dt, a, b, c = _inputs(seed, 1, T, H, 64, 1, 64)
    truth = _truth(x, dt, a, b, c)
    plain, _ = ref.ssd_chunked_ref(*(torch.from_numpy(v)
                                     for v in (x, dt, a, b, c)), chunk=256)
    kernel, _ = _ssd_emulated(x, dt, a, b, c, 256, split=True)
    warp, _ = _ssd_emulated(x, dt, a, b, c, 256, split=True,
                            scan=_scan_f32_warp)
    w_plain = _worst(plain.numpy(), truth)
    w_kernel, w_warp = _worst(kernel, truth), _worst(warp, truth)
    assert w_kernel <= 1.25 * w_plain, (w_kernel, w_plain)
    assert w_warp > 1.25 * w_plain, (w_warp, w_plain)
