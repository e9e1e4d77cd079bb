"""The staged matmul's kernel choice and shared-memory plan on the CPU,
and its plain version against the reference's at the shapes the wgmma
kernel takes.

On the card ``repro_torch.kernels.ops.staged_matmul`` runs one of three
kernels, picked from the operands' type and shape alone before the
launch: float32 on the CUDA cores (``simt_f32``); bfloat16 through wgmma
fed by TMA when K and N are multiples of 8, because TMA reads rows whose
byte stride is a multiple of 16 (in 128 x 256 tiles, ``wgmma_bf16_n256``,
when there are at least 132 of them, one per SM of the H100; else in
128 x 128 tiles, ``wgmma_bf16``); every other bfloat16 shape through
mma.sync (``mma_sync_bf16``).  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import jet_staged_matmul as jsm
from repro_torch.kernels import ops

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype,m,n,k,want", [
    (torch.float32, 1024, 8192, 2048, "simt_f32"),
    (torch.float32, 1000, 1000, 2050, "simt_f32"),
    (torch.float32, 1, 3, 7, "simt_f32"),
    (torch.bfloat16, 1024, 8192, 2048, "wgmma_bf16_n256"),  # zamba2 up-proj
    (torch.bfloat16, 4096, 8192, 5120, "wgmma_bf16_n256"),  # FFN tile
    (torch.bfloat16, 1024, 8192, 640, "wgmma_bf16_n256"),
    (torch.bfloat16, 2048, 2048, 64, "wgmma_bf16"),        # 16 x 8 tiles
    (torch.bfloat16, 2049, 2048, 64, "wgmma_bf16_n256"),   # 17 x 8
    (torch.bfloat16, 2048, 2056, 64, "wgmma_bf16_n256"),   # 16 x 9
    (torch.bfloat16, 200, 8192, 2048, "wgmma_bf16"),       # M ragged
    (torch.bfloat16, 256, 8192, 2048, "wgmma_bf16"),       # 64 wide tiles
    (torch.bfloat16, 256, 264, 512, "wgmma_bf16"),         # N % 128 != 0
    (torch.bfloat16, 128, 128, 72, "wgmma_bf16"),          # K % 64 != 0
    (torch.bfloat16, 64, 256, 8, "wgmma_bf16"),            # K = 8
    (torch.bfloat16, 1, 512, 256, "wgmma_bf16"),           # M = 1
    (torch.bfloat16, 1000, 1000, 2056, "wgmma_bf16"),
    (torch.bfloat16, 1000, 1000, 2050, "mma_sync_bf16"),   # K % 8 != 0
    (torch.bfloat16, 100, 70, 130, "mma_sync_bf16"),       # both ragged
    (torch.bfloat16, 17, 33, 65, "mma_sync_bf16"),
    (torch.bfloat16, 64, 260, 64, "mma_sync_bf16"),        # N % 8 != 0
    (torch.bfloat16, 64, 256, 4, "mma_sync_bf16"),         # K < 8
    (torch.bfloat16, 4096, 8190, 5120, "mma_sync_bf16"),   # large, N % 8
])
def test_variant_follows_type_and_alignment(dtype, m, n, k, want):
    assert jsm.variant(dtype, m, n, k) == want
    if dtype != torch.bfloat16:
        return
    # the rule: bfloat16 rows of K and of N elements, 16-byte strides ...
    assert want.startswith("wgmma") == (k * 2 % 16 == 0 and n * 2 % 16 == 0)
    # ... and 128 x 256 tiles only when they make a full wave of 132 blocks
    if want.startswith("wgmma"):
        wide = -(-m // 128) * -(-n // 256)
        assert (want == "wgmma_bf16_n256") == (wide >= 132)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_variant_refuses_types_no_kernel_takes(dtype):
    with pytest.raises(TypeError):
        jsm.variant(dtype, 128, 128, 128)


@pytest.mark.parametrize("name,bn,stages,nbytes", [
    ("wgmma_bf16", 128, 5, 164944), ("wgmma_bf16_n256", 256, 4, 197696)])
def test_wgmma_ring_shared_memory(name, bn, stages, nbytes):
    bm, tbn, bk = jsm.TILES[name]
    assert (bm, tbn, bk, jsm.STAGES[name]) == (128, bn, 64, stages)
    # a K row of A is one 128-byte swizzle atom; B's columns are TMA boxes
    # of 64 (128 bytes each)
    assert bk * 2 == 128 and bn % 64 == 0
    stage = bm * bk * 2 + (bn // 64) * (bk * 64 * 2)
    assert stage == bn * 128 + 16384
    assert jsm.smem_bytes(name) == stages * stage + 1024 + 2 * 8 * stages
    assert jsm.smem_bytes(name) == nbytes
    assert jsm.smem_bytes(name) <= 232448               # 227 KB a block
    # at least 3 stages, and one block of 384 threads an SM by design
    assert stages >= 3 and 2 * jsm.smem_bytes(name) > 232448


def test_cpu_tensors_run_the_plain_version_and_count_no_variant():
    jsm.VARIANT_LAUNCHES.reset()
    a = torch.ones((16, 8), dtype=torch.bfloat16)
    b = torch.ones((8, 16), dtype=torch.bfloat16)
    got = ops.staged_matmul(a, b)
    assert torch.equal(got, torch.full((16, 16), 8.0, dtype=torch.bfloat16))
    assert dict(jsm.VARIANT_LAUNCHES) == {"simt_f32": 0, "mma_sync_bf16": 0,
                                          "wgmma_bf16": 0,
                                          "wgmma_bf16_n256": 0}


# shapes the wgmma kernel takes: M ragged, N not a multiple of 128, K not
# a multiple of 64, K = 8, M = 1
@pytest.mark.parametrize("m,k,n", [(40, 72, 264), (1, 8, 16), (130, 136, 8),
                                   (33, 200, 96)])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_plain_matches_reference_at_wgmma_shapes(m, k, n, out_dtype):
    assert jsm.variant(torch.bfloat16, m, n, k).startswith("wgmma")
    rng = np.random.default_rng(m * 5 + k + n)
    ja = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    jb = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    jod = jnp.bfloat16 if out_dtype == "bfloat16" else jnp.float32
    want = jops.staged_matmul(ja, jb, impl="interpret", block_m=32,
                              block_n=32, block_k=64, out_dtype=jod)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).bfloat16()
    tod = getattr(torch, out_dtype)
    got = ops.staged_matmul(ta, tb, out_dtype=tod)
    assert got.dtype == tod and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jref.matmul_naive(ja, jb), np.float32), rtol=2e-2,
        atol=2e-2)


def test_plain_is_exact_on_small_integers_as_the_reference():
    """The integer case the card tests hold the wgmma kernel to: here the
    plain version equals the reference's kernel bit for bit."""
    rng = np.random.default_rng(11)
    a = rng.integers(-4, 5, (64, 136)).astype(np.float32)
    b = rng.integers(-4, 5, (136, 40)).astype(np.float32)
    want = jops.staged_matmul(jnp.asarray(a, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16), impl="interpret",
                              block_m=32, block_n=32, block_k=64,
                              out_dtype=jnp.float32)
    got = ops.staged_matmul(torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16(),
                            out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), a @ b)
