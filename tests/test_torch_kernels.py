"""The port's model kernels on the CPU against the reference's tiers.

The plain PyTorch versions (``repro_torch.kernels.ref``) that the CUDA
kernels are held to on the card must agree with the reference's Pallas
kernels run by the interpreter and with its pure-JAX tiers, within
``tests/test_kernels.py``'s float32 tolerance of 2e-4.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
# (hq, hkv, t, s, causal, window): GQA, MQA, sliding window, non-causal,
# T < S (right-aligned), and ragged T / S against the 8-row blocks
FLASH_CASES = [
    (4, 4, 16, 16, True, None),
    (4, 2, 16, 16, True, None),
    (8, 1, 16, 16, True, None),
    (4, 2, 16, 16, True, 8),
    (4, 4, 24, 24, True, 5),
    (4, 2, 8, 24, True, None),
    (4, 2, 8, 24, True, 6),
    (4, 4, 16, 16, False, None),
    (4, 2, 10, 30, False, None),
    (4, 2, 13, 13, True, None),
    (2, 1, 19, 21, True, 7),
    (2, 2, 5, 29, False, None),
]


@pytest.mark.parametrize("hq,hkv,t,s,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference_tiers(hq, hkv, t, s, causal, window):
    rng = np.random.default_rng(hq * 1000 + t * 10 + s)
    b, d = 2, 16
    q, k, v = (_normal(rng, (b, hq, t, d)), _normal(rng, (b, hkv, s, d)),
               _normal(rng, (b, hkv, s, d)))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window).numpy()
    interp = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, impl="interpret",
                                  block_q=8, block_kv=8)
    jax_ref = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window, block_kv=8)
    naive = ref.attention_naive(_t(q), _t(k), _t(v), causal=causal,
                                window=window).numpy()
    np.testing.assert_allclose(got, np.asarray(interp), **TOL)
    np.testing.assert_allclose(got, np.asarray(jax_ref), **TOL)
    np.testing.assert_allclose(got, naive, **TOL)


@pytest.mark.parametrize("block_kv", [4, 7, 512])
def test_flash_plain_is_independent_of_the_fragment_size(block_kv):
    rng = np.random.default_rng(block_kv)
    q, k, v = (_t(_normal(rng, (1, 4, 12, 8))), _t(_normal(rng, (1, 2, 20, 8))),
               _t(_normal(rng, (1, 2, 20, 8))))
    got = ref.flash_attention_ref(q, k, v, causal=True, window=9,
                                  block_kv=block_kv)
    want = ref.attention_naive(q, k, v, causal=True, window=9)
    torch.testing.assert_close(got, want, **TOL)


def test_flash_plain_keeps_bfloat16():
    rng = np.random.default_rng(3)
    q, k, v = (_t(_normal(rng, (1, 4, 16, 16))).bfloat16() for _ in range(3))
    got = ops.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = ref.attention_naive(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, rtol=5e-2, atol=5e-2)


def test_decode_attention_naive_matches_reference():
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, (3, 4, 16)), _normal(rng, (3, 20, 2, 16)),
               _normal(rng, (3, 20, 2, 16)))
    lengths = np.array([1, 7, 20], np.int32)
    o, lse = ref.decode_attention_naive(_t(q), _t(k), _t(v), _t(lengths))
    jo, jlse = jref.decode_attention_naive(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v),
                                           jnp.asarray(lengths))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


# --------------------------------------------------------------------------- #
# SSD scan
# --------------------------------------------------------------------------- #
def _ssd_inputs(seed, B, T, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (B, T, H, P))
    dt = np.log1p(np.exp(_normal(rng, (B, T, H)))).astype(np.float32) * 0.5
    a = -np.exp(rng.uniform(-1.0, 1.0, H)).astype(np.float32)
    b = _normal(rng, (B, T, G, N))
    c = _normal(rng, (B, T, G, N))
    return x, dt, a, b, c


# (B, T, H, P, G, N, chunk): one chunk, several carried chunks, G < H,
# chunk larger than T (ops takes min(chunk, T))
SSD_CASES = [
    (1, 16, 2, 8, 1, 4, 16),
    (2, 32, 4, 8, 2, 8, 8),
    (1, 48, 4, 16, 1, 16, 16),
    (2, 24, 6, 4, 3, 8, 8),
    (1, 12, 2, 8, 2, 4, 256),
]


@pytest.mark.parametrize("B,T,H,P,G,N,chunk", SSD_CASES)
def test_ssd_plain_matches_reference_tiers(B, T, H, P, G, N, chunk):
    x, dt, a, b, c = _ssd_inputs(B * 100 + T, B, T, H, P, G, N)
    y, h = ops.ssd(_t(x), _t(dt), _t(a), _t(b), _t(c), chunk=chunk)
    jargs = [jnp.asarray(v) for v in (x, dt, a, b, c)]
    jy, jh = jops.ssd(*jargs, chunk=chunk, impl="interpret")
    ry, rh = jops.ssd(*jargs, chunk=chunk, impl="ref")
    ny, nh = ref.ssd_naive(_t(x), _t(dt), _t(a), _t(b), _t(c))
    for got, want in ((y, jy), (h, jh), (y, ry), (h, rh), (y, ny), (h, nh)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)
    assert y.dtype == torch.float32 and h.dtype == torch.float32


def test_ssd_chunk_contract():
    x, dt, a, b, c = (_t(v) for v in _ssd_inputs(5, 1, 12, 2, 4, 1, 4))
    with pytest.raises(ValueError, match="divide"):
        ops.ssd(x, dt, a, b, c, chunk=5)
    with pytest.raises(ValueError, match="divide"):
        ref.ssd_chunked_ref(x, dt, a, b, c, chunk=5)


# --------------------------------------------------------------------------- #
# dispatch
# --------------------------------------------------------------------------- #
def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    x, dt, a, b, c = (_t(v) for v in _ssd_inputs(6, 1, 8, 2, 4, 1, 4))
    q = _t(_normal(np.random.default_rng(6), (1, 2, 8, 8)))
    ops.reset_launches()
    for impl in ("auto", "ref"):
        ops.flash_attention(q, q, q, impl=impl)
        ops.ssd(x, dt, a, b, c, impl=impl)
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                            "ssd_scan": 0, "decode_attention_paged": 0,
                            "staged_matmul": 0}


def test_dispatch_rejects_cuda_on_cpu_and_unknown_impls():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, q, q, impl="pallas")
    x, dt, a, b, c = (_t(v) for v in _ssd_inputs(7, 1, 8, 2, 4, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(x, dt, a, b, c, impl="cuda")
