"""The arithmetic of the SSD scan's backward on the tensor cores, emulated
on the CPU (``csrc/ssd_scan_bwd.cu``, ``bwd_mma_3xtf32``).

The kernel computes the gradient (dx, ddt, da, db, dc) of the chunked
scan's (y, h) in passes.  Its products run on ``mma.sync`` m16n8k8 TF32
with every operand split for 3xTF32 (small·big + big·small + big·big into
one float32 accumulator, 8 deep a step):

* D_k = Σ_l exp(cum_l) c_l dy_lᵀ, then G_k, the gradient of the state
  leaving chunk k, by the reverse carry from dh;
* the key pass, per 64-key tile m: the state terms w_m (b_m · G_k) into dx
  and w_m (G_k x_m) into db, and bᵀGx = (b_m · G_k) · x_m; then per 64-row
  tile l ≥ m, Sᵀ = b_m · c_l and DXᵀ = x_m · dy_l, the mask and decay
  dec = exp(cum_l − cum_m) (selected away above the diagonal), s = Sᵀ dec,
  Σ_l s DXᵀ, dx += (s dt_m) dy and db += (DXᵀ dec dt_m) c — the chains
  of dx and db run on from the state term through the chunk's row tiles;
* the row pass, per 64-row tile l: dc = exp(cum_l) dy_l · H_k, then per
  key tile m ≤ l, S = c_l · b_m and DX = dy_l · x_m, A = DX dec dt_m,
  dcum2 = Σ_m S A and dc += A b;
* the dt pass (float64 sums), da and the group sums, as the first design.

The emulation runs those products as :func:`test_torch_ssd._product` does
(the kernel's steps, tiles and chains; the same split) and is held against
``jax.vjp`` of the reference's plain scan (``repro.kernels.ref.
ssd_chunked_ref``) on the cases of ``tests/test_torch_ssd_grad.py`` that
the variant takes: float32 within 2e-5 of each gradient's largest
magnitude and at least 10x closer than the same design with one TF32
product; bfloat16 (widened as it is staged) within 2e-2.  Then the
variant rule, the shared-memory plan and the launch counter.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ref as jref
from repro_torch.kernels import mamba2_ssd as mssd
from repro_torch.kernels import ref

from test_torch_ssd import _product, _scan_f64, _tf32
from test_torch_ssd_grad import CASES, _inputs, _rel

torch.set_num_threads(1)

F32_TOL = 2e-5      # of each gradient's largest magnitude
BF16_TOL = 2e-2
TILE = mssd.TILE
NAMES = ("dx", "ddt", "da", "db", "dc")


def _swap(x):
    return np.swapaxes(x, -1, -2)


def _bf16(x):
    """float32 rounded to bfloat16 (to nearest even), kept as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _bwd_emulated(x, dt, a, b, c, dy, dh, chunk: int, split: bool):
    """(dx, ddt, da, db, dc) as ``bwd_mma_3xtf32`` computes them from the
    states the forward's ``mma_3xtf32`` passes keep; every product as
    :func:`_product` (``split``: 3xTF32, else one TF32 product)."""
    f32 = np.float32
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    L, nc = chunk, T // chunk

    def heads(v, w):            # [B, T, G or H, w] -> [B, H, nc, L, w]
        v = np.repeat(v, H // v.shape[2], axis=2)
        return v.transpose(0, 2, 1, 3).reshape(B, H, nc, L, w)
    xh, dyh, bh, ch = heads(x, P), heads(dy, P), heads(b, N), heads(c, N)
    dth = dt.transpose(0, 2, 1).reshape(B, H, nc, L)
    cum = _scan_f64(dth, a)
    last = cum[..., -1]                                      # [B, H, nc]
    with np.errstate(over="ignore", invalid="ignore"):
        # the forward's states entering each chunk (its passes 1 and 2)
        w = dth * np.exp(last[..., None] - cum)
        s_k = _product(_swap(bh * w[..., None]), xh, split)
        h, h_in = np.zeros((B, H, N, P), f32), []
        for k in range(nc):
            h_in.append(h)
            h = (np.exp(last[:, :, k])[..., None, None] * h
                 + s_k[:, :, k]).astype(f32)
        h_in = np.stack(h_in, 2)
        # D_k and G_k: G_last = dh (or 0), G_(k-1) = exp(cum_last) G_k + D_k
        d_k = _product(_swap(ch * np.exp(cum)[..., None]), dyh, split)
        g = np.zeros((B, H, N, P), f32) if dh is None else dh.astype(f32)
        g_k = [None] * nc
        for k in reversed(range(nc)):
            g_k[k] = g
            g = (np.exp(last[:, :, k])[..., None, None] * g
                 + d_k[:, :, k]).astype(f32)
        g_k = np.stack(g_k, 2)

        dx = np.zeros_like(xh)
        dbh, dch = np.zeros_like(bh), np.zeros_like(ch)
        ddt0, dcum1, dcum2, qm = (np.zeros_like(dth) for _ in range(4))
        pos = np.arange(L)
        # the key pass
        for m0 in range(0, L, TILE):
            keys = slice(m0, min(m0 + TILE, L))
            bk, xk = bh[..., keys, :], xh[..., keys, :]
            cumk, dtk = cum[..., keys], dth[..., keys]
            ek = np.exp(last[..., None] - cumk)
            wk = dtk * ek
            bg = _product(bk, g_k, split)                    # b_m . G
            bgx = np.sum(bg * xk, -1, dtype=f32)
            dxa = bg * wk[..., None]
            dba = _product(xk, _swap(g_k), split) * wk[..., None]
            sd = np.zeros_like(cumk)
            for l0 in range(m0, L, TILE):
                rows = slice(l0, min(l0 + TILE, L))
                cr, dyr, cl = ch[..., rows, :], dyh[..., rows, :], \
                    cum[..., rows]
                st = _product(bk, _swap(cr), split)         # [.., m, l]
                dxt = _product(xk, _swap(dyr), split)
                seen = pos[rows][None, :] >= pos[keys][:, None]
                dec = np.where(seen, np.exp(cl[..., None, :]
                                            - cumk[..., :, None]), f32(0))
                s = (st * dec).astype(f32)
                sd = (sd + np.sum(s * dxt, -1, dtype=f32)).astype(f32)
                dxa = _product(s * dtk[..., None], dyr, split, dxa)
                dba = _product(dxt * dec * dtk[..., None], cr, split, dba)
            dx[..., keys, :], dbh[..., keys, :] = dxa, dba
            ddt0[..., keys] = sd + ek * bgx
            dcum1[..., keys] = -dtk * sd - wk * bgx
            qm[..., keys] = wk * bgx
        # the row pass
        for l0 in range(0, L, TILE):
            rows = slice(l0, min(l0 + TILE, L))
            cr, dyr, cl = ch[..., rows, :], dyh[..., rows, :], cum[..., rows]
            dca = np.exp(cl)[..., None] * _product(dyr, _swap(h_in), split)
            rt = np.sum(cr * dca, -1, dtype=f32)
            for m0 in range(0, l0 + 1, TILE):
                keys = slice(m0, min(m0 + TILE, L))
                bk, xk = bh[..., keys, :], xh[..., keys, :]
                sc = _product(cr, _swap(bk), split)         # [.., l, m]
                dxm = _product(dyr, _swap(xk), split)
                seen = pos[keys][None, :] <= pos[rows][:, None]
                av = np.where(seen, dxm * np.exp(
                    cl[..., :, None] - cum[..., None, keys])
                    * dth[..., None, keys], f32(0)).astype(f32)
                rt = (rt + np.sum(sc * av, -1, dtype=f32)).astype(f32)
                dca = _product(av, bk, split, dca)
            dch[..., rows, :], dcum2[..., rows] = dca, rt
    # the dt pass in float64: dcum, its reverse cumsum r, ddt, da
    f64 = np.float64
    gh = np.sum(g_k.astype(f64) * h_in, axis=(-1, -2))      # [B, H, nc]
    dcum = dcum1.astype(f64) + dcum2
    dcum[..., -1] += np.exp(last.astype(f64)) * gh + qm.sum(-1, dtype=f64)
    r = np.cumsum(dcum[..., ::-1], -1)[..., ::-1]
    ddt = (ddt0 + a[None, :, None, None] * r.astype(f32)).astype(f32)
    da = np.sum(dth * r, axis=(0, 2, 3)).astype(f32)

    def tokens(v):              # [B, H, nc, L, w] -> [B, T, H, w]
        return v.reshape(B, H, T, v.shape[-1]).transpose(0, 2, 1, 3)

    def groups(v):              # the heads of each group summed in order
        v = tokens(v).reshape(B, T, G, H // G, v.shape[-1])
        out = v[:, :, :, 0]
        for r_ in range(1, H // G):
            out = (out + v[:, :, :, r_]).astype(f32)
        return out
    return (tokens(dx), ddt.reshape(B, H, T).transpose(0, 2, 1), da,
            groups(dbh), groups(dch))


def _jax_grads(case, arrays):
    chunk = CASES[case][6]
    x, dt, a, b, c, dy, dh = arrays
    (y, h), vjp = jax.vjp(lambda *p: jref.ssd_chunked_ref(*p, chunk=chunk),
                          *(jnp.asarray(v) for v in (x, dt, a, b, c)))
    jh = jnp.asarray(dh) if dh is not None else jnp.zeros_like(h)
    return [np.asarray(w, np.float32) for w in vjp((jnp.asarray(dy), jh))]


MMA_F32 = sorted(k for k, v in CASES.items()
                 if v[7] == "float32" and v[3] % 8 == 0 and v[5] % 8 == 0)


def test_the_emulated_cases_are_the_variants():
    # every float32 case of the gradient tests whose widths the tensor-core
    # design takes; the others run bwd_simt_recompute
    assert MMA_F32 == ["G<H", "chunks", "one chunk"]
    for case, (_, _, _, p, _, n, _, dtype) in CASES.items():
        want = "bwd_mma_3xtf32" if case in MMA_F32 or dtype == "bfloat16" \
            else "bwd_simt_recompute"
        assert mssd.bwd_variant(getattr(torch, dtype), n, p) == want, case


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("case", MMA_F32)
def test_3xtf32_backward_keeps_float32_accuracy(case, with_dh):
    arrays = _inputs(case, 3, with_dh)
    want = _jax_grads(case, arrays)
    chunk = CASES[case][6]
    three = _bwd_emulated(*arrays, chunk, split=True)
    one = _bwd_emulated(*arrays, chunk, split=False)
    worst3 = worst1 = 0.0
    for name, g3, g1, w in zip(NAMES, three, one, want):
        assert g3.shape == w.shape and np.isfinite(g3).all(), name
        assert _rel(g3, w) <= F32_TOL, (name, _rel(g3, w))
        worst3, worst1 = max(worst3, _rel(g3, w)), max(worst1, _rel(g1, w))
    assert 10 * worst3 <= worst1, (worst3, worst1)


@pytest.mark.parametrize("with_dh", [False, True])
def test_bf16_backward_within_its_tolerance(with_dh):
    # bfloat16 inputs widened to float32 as they are staged, the same
    # route; the gradients rounded to bfloat16 (da stays float32)
    x, dt, a, b, c, dy, dh = _inputs("bf16", 4, with_dh)
    x, dt, b, c, dy = (_bf16(v) for v in (x, dt, b, c, dy))
    arrays = (x, dt, a, b, c, dy, dh)
    want = _jax_grads("bf16", arrays)
    got = _bwd_emulated(*arrays, CASES["bf16"][6], split=True)
    for name, g, w in zip(NAMES, got, want):
        g = g if name == "da" else _bf16(g)
        assert _rel(g, w) <= BF16_TOL, (name, _rel(g, w))


def test_decay_overflow_above_the_diagonal_stays_finite():
    # a chunk of 256 (four 64-row tiles) with a = -8 and dt = 0.06:
    # exp(cum_l - cum_m) above the diagonal overflows float32; selected
    # away before it is multiplied, as the kernel does.  Against the plain
    # backward (the kernel's plain version)
    rng = np.random.default_rng(3)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    x, b, c, dy = draw(1, 256, 2, 8), draw(1, 256, 1, 8), \
        draw(1, 256, 1, 8), draw(1, 256, 2, 8)
    dt = np.full((1, 256, 2), 0.06, np.float32)
    a = np.array([-8.0, -1.0], np.float32)
    assert 255 * 0.06 * 8.0 > np.log(np.finfo(np.float32).max)
    got = _bwd_emulated(x, dt, a, b, c, dy, None, 256, split=True)
    want = ref.ssd_chunked_bwd_ref(*(torch.from_numpy(v)
                                     for v in (x, dt, a, b, c, dy)), None,
                                   chunk=256)
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        assert _rel(g, w.numpy()) <= F32_TOL, (name, _rel(g, w.numpy()))


def test_split_holds_each_operand_to_2_to_the_minus_21():
    # the split the emulation shares with the forward's tests: big is the
    # TF32 rounding, and big + small recovers x to 2**-21 of itself
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    big = _tf32(x)
    from test_torch_ssd import _split
    hi, lo = _split(x)
    np.testing.assert_array_equal(hi, big)
    assert np.all(np.abs(hi + lo - x) <= np.abs(x) * 2.0 ** -21)


# --------------------------------------------------------------------------- #
# the variant rule, the plan and the counter
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,p,mma", [(64, 64, True), (16, 32, True),
                                     (8, 8, True), (128, 128, True),
                                     (128, 64, True), (64, 20, False),
                                     (12, 64, False), (1, 1, False),
                                     (4, 8, False)])
def test_bwd_variant_follows_the_forwards(dtype, n, p, mma):
    want = "bwd_mma_3xtf32" if mma else "bwd_simt_recompute"
    assert mssd.bwd_variant(dtype, n, p) == want
    # where the forward keeps its states, the backward reads them
    assert mma == (mssd.variant(dtype, n, p) == "mma_3xtf32")


@pytest.mark.parametrize("dtype,n,p,err", [
    (torch.float16, 64, 64, TypeError), (torch.float32, 136, 64, ValueError),
    (torch.float32, 64, 256, ValueError)])
def test_bwd_variant_refuses_what_no_design_takes(dtype, n, p, err):
    with pytest.raises(err):
        mssd.bwd_variant(dtype, n, p)


# MmaPlan of csrc/ssd_scan_bwd.cu, in bytes: (key pass, row pass, state
# passes) at each width tile the design is built at (both widths pad to
# the tile of the wider); the key and row passes are the largest
BWD_MMA_PLAN = {64: (105_984, 105_984, 74_240),
                128: (204_288, 204_288, 139_776)}


@pytest.mark.parametrize("n,p,tile", [(64, 64, 64), (8, 56, 64),
                                      (64, 128, 128), (128, 64, 128),
                                      (72, 8, 128), (128, 128, 128)])
def test_bwd_smem_bytes_is_the_c_plan(n, p, tile):
    key, row, state = BWD_MMA_PLAN[tile]
    floats = lambda v: v // 4            # noqa: E731
    own = TILE * 2 * (tile + 4)
    assert floats(key) == own + 4 * TILE + mssd.STAGES * (own + TILE)
    assert floats(row) == own + 2 * TILE + mssd.STAGES * (own + 2 * TILE)
    assert floats(state) == mssd.STAGES * (TILE * 2 * (tile + 8) + TILE)
    assert mssd.bwd_smem_bytes("bwd_mma_3xtf32", n, p) == max(key, row,
                                                              state)
    assert max(key, row, state) <= 232_448


def test_path_widths_fit_two_blocks_an_sm():
    # zamba2's 64 x 64: two blocks of 4 warps share an SM (228 KB, 1 KB
    # reserved a block), as the forward's output pass does
    need = mssd.bwd_smem_bytes("bwd_mma_3xtf32", 64, 64)
    assert 2 * (need + 1024) <= 228 * 1024
    with pytest.raises(ValueError, match="does not take"):
        mssd.bwd_smem_bytes("bwd_mma_3xtf32", 64, 20)
    with pytest.raises(ValueError, match="unknown"):
        mssd.bwd_smem_bytes("bwd_wgmma", 64, 64)


def test_wrapper_refuses_cpu_tensors_and_unknown_backward_variants():
    x = torch.zeros((1, 8, 2, 8))
    dt, a = torch.zeros((1, 8, 2)), torch.zeros(2)
    bc = torch.zeros((1, 8, 1, 8))
    mssd.VARIANT_LAUNCHES.reset()
    with pytest.raises(ValueError, match="CUDA"):
        mssd.ssd_scan_bwd(x, dt, a, bc, bc, x, None, 8)
    with pytest.raises(ValueError, match="CUDA"):
        mssd.ssd_scan_bwd(x, dt, a, bc, bc, x, None, 8, _variant="bwd_simt")
    assert dict(mssd.VARIANT_LAUNCHES) == dict.fromkeys(
        ("mma_3xtf32", "simt", "bwd_mma_3xtf32", "bwd_simt",
         "bwd_simt_recompute"), 0)
