"""Flash attention's kernel choice, shared-memory plan and float32 numerics
on the CPU, and its plain version at gemma-7b's head dim of 256.

On the card ``repro_torch.kernels.ops.flash_attention`` runs one of three
kernels, picked from the type and the head dim alone before the launch
(``jet_flash_attention.variant``): ``mma.sync`` on the tensor cores when D
is a multiple of 8 (rows of 16-byte multiples for ``cp.async``) up to 256,
in bfloat16 (``mma_bf16``) or in float32 through a 3xTF32 split
(``mma_3xtf32``); the first kernel, on the CUDA cores (``simt``), for any
other D <= 128.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); here the 3xTF32 product is emulated in
numpy inside an online-softmax attention to pin the float32 design's
accuracy against the reference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro_torch.kernels import jet_flash_attention as jfa
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)        # tests/test_torch_kernels.py
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


# --------------------------------------------------------------------------- #
# the kernel choice and its shared memory
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,mma", [(16, True), (20, False), (24, True),
                                   (64, True), (80, True), (128, True),
                                   (192, True), (256, True)])
def test_variant_follows_type_and_head_dim(dtype, d, mma):
    want = ("mma_bf16" if dtype == torch.bfloat16 else "mma_3xtf32") \
        if mma else "simt"
    assert jfa.variant(dtype, d) == want
    # the rule: 16-byte rows (D % 8 == 0) go to the tensor cores
    assert mma == (d % 8 == 0)


@pytest.mark.parametrize("dtype,d,err,match", [
    (torch.float16, 64, TypeError, "float32 or bfloat16"),
    (torch.float32, 264, ValueError, "head dim 264"),
    (torch.bfloat16, 264, ValueError, "head dim 264"),
    (torch.float32, 0, ValueError, "head dim 0"),
    (torch.float32, 132, ValueError, "multiple of 8"),
    (torch.bfloat16, 250, ValueError, "multiple of 8"),
])
def test_variant_refuses_what_no_kernel_takes(dtype, d, err, match):
    with pytest.raises(err, match=match):
        jfa.variant(dtype, d)


@pytest.mark.parametrize("name,d", [
    (name, d) for name in ("mma_bf16", "mma_3xtf32")
    for d in (8, 32, 64, 80, 128, 136, 256)] + [("simt", 20), ("simt", 128)])
def test_smem_fits_a_block(name, d):
    assert jfa.smem_bytes(name, d) <= 232448             # 227 KB a block


def test_smem_plan_at_the_path_and_the_widest_heads():
    # serve path: float32, D 64: 272-byte rows, 64 + 2 x 2 x 64 rows,
    # two blocks to an SM (228 KB, 1 KB reserved per block)
    assert jfa.smem_bytes("mma_3xtf32", 64) == 272 * 320
    assert 2 * (jfa.smem_bytes("mma_3xtf32", 64) + 1024) <= 228 * 1024
    # bfloat16 keeps 64-key tiles; float32 halves them past D = 80, for
    # two blocks to an SM at D = 128
    assert jfa.block_kv("mma_bf16", 256) == 64
    assert jfa.block_kv("mma_3xtf32", 80) == 64
    assert jfa.block_kv("mma_3xtf32", 128) == 32
    assert jfa.block_kv("mma_3xtf32", 256) == 32
    assert 2 * (jfa.smem_bytes("mma_3xtf32", 128) + 1024) <= 228 * 1024
    assert jfa.smem_bytes("mma_bf16", 256) == 528 * 320
    assert jfa.smem_bytes("mma_3xtf32", 256) == 1040 * 192
    # a head dim is zero-padded to its tile; the registry's own head dims
    # (32, 64, 80, 128, 256) are tiles
    assert jfa.smem_bytes("mma_bf16", 24) == jfa.smem_bytes("mma_bf16", 32)
    assert [jfa.d_tile(d) for d in (8, 32, 40, 64, 72, 80, 96, 128, 136,
                                    256)] == \
        [32, 32, 64, 64, 80, 80, 128, 128, 256, 256]


# --------------------------------------------------------------------------- #
# the plain version at gemma-7b's head dim
# --------------------------------------------------------------------------- #
# (hq, hkv, t, s, causal, window): GQA causal, GQA window with T < S,
# non-causal MQA
D256 = [(4, 2, 24, 24, True, None), (4, 2, 16, 40, True, 9),
        (4, 1, 8, 20, False, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,t,s,causal,window", D256)
def test_flash_plain_at_head_dim_256_matches_reference(dtype, hq, hkv, t, s,
                                                       causal, window):
    rng = np.random.default_rng(hq * 100 + t + s)
    d = 256
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, hq, t, d), (1, hkv, s, d), (1, hkv, s, d)))
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)),
                              causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (1, hq, t, d)
    interp = jops.flash_attention(*(jnp.asarray(a).astype(jdt)
                                    for a in (q, k, v)),
                                  causal=causal, window=window,
                                  impl="interpret", block_q=8, block_kv=8)
    naive = ref.attention_naive(*(torch.from_numpy(a).to(tdt)
                                  for a in (q, k, v)),
                                causal=causal, window=window)
    tol = TOL if dtype == "float32" else BF16_TOL
    got = got.float().numpy()
    np.testing.assert_allclose(
        got, np.asarray(interp.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(got, naive.float().numpy(), **tol)


# --------------------------------------------------------------------------- #
# the float32 kernel's numerics: 3xTF32 inside the online softmax
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


def _product(a, b, split: bool):
    """a [..., m, k] @ b [..., k, n] as the kernel's mma.sync steps of 8
    along k into one float32 accumulator: with ``split``, small.big +
    big.small + big.big on the split of each operand (:func:`_split`);
    without it, one product of the TF32 roundings (:func:`_tf32`)."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for c in range(0, a.shape[-1], 8):
        ac, bc = a[..., c:c + 8], b[..., c:c + 8, :]
        if split:
            (ab, as_), (bb, bs) = _split(ac), _split(bc)
            acc += as_ @ bb
            acc += ab @ bs
            acc += ab @ bb
        else:
            acc += _tf32(ac) @ _tf32(bc)
    return acc


def _flash_emulated(q, k, v, split: bool, block_kv: int = 64):
    """Causal attention with the kernel's online softmax over 64-key tiles
    and its products emulated: q scaled in float32 first, masked scores
    -1e30, output acc / max(l, 1e-30)."""
    t, d = q.shape[-2:]
    s = k.shape[-2]
    qs = q * np.float32(d ** -0.5)
    m = np.full(q.shape[:-1], -1e30, np.float32)
    l = np.zeros(q.shape[:-1], np.float32)
    acc = np.zeros(q.shape, np.float32)
    rows = np.arange(t)[:, None] + (s - t)
    for s0 in range(0, s, block_kv):
        sc = _product(qs, np.swapaxes(k[..., s0:s0 + block_kv, :], -1, -2),
                      split)
        keys = s0 + np.arange(sc.shape[-1])[None, :]
        sc = np.where(rows >= keys, sc, np.float32(-1e30))
        m_new = np.maximum(m, sc.max(-1))
        p = np.exp(sc - m_new[..., None])
        corr = np.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _product(p, v[..., s0:s0 + block_kv, :],
                                               split)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))[..., None]


def test_3xtf32_keeps_float32_accuracy_in_flash_attention():
    rng = np.random.default_rng(16)
    q, k, v = (rng.standard_normal((1, 4, 256, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        impl="interpret", block_q=64, block_kv=64))
    three = _flash_emulated(q, k, v, split=True)
    one = _flash_emulated(q, k, v, split=False)
    np.testing.assert_allclose(three, want, **TOL)
    err3 = float(np.abs(three - want).max())
    err1 = float(np.abs(one - want).max())
    assert 10 * err3 <= err1, (err3, err1)
    # the split itself: big is a TF32 value within half a TF32 ulp of x,
    # and big + small holds x to 2**-21
    x = rng.standard_normal(4096).astype(np.float32)
    big, small = _split(x)
    assert np.array_equal(big, _tf32_read(big))
    assert np.all(np.abs(big - x) <= 2.0 ** -11 * np.abs(x))
    assert np.all(np.abs(big + small - x) <= 2.0 ** -21 * np.abs(x))
