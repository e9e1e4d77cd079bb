"""The port's paged KV path on the CPU against the reference.

* The plain paged decode attention (``ops.decode_attention`` on CPU
  tensors) against the reference's pure-JAX tier and its Pallas kernel run
  by the interpreter, within ``tests/test_kernels.py``'s 2e-4; the merge
  of partial results through their lse.
* The plain staged matmul against the reference's Pallas kernel run by the
  interpreter (1e-4 in float32, 2e-2 in bfloat16), and the staging-pool
  arithmetic.
* ``DevicePool`` and ``PagedKV`` step for step against the reference's
  classes: the free bitmap, the page table, the lengths and the pages
  equal after every allocation, short allocation, append, escape append
  and release.

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax.numpy as jnp
from repro.core.pool import DevicePool as JPool
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.jet_staged_matmul import \
    staging_pool_bytes as jstaging_pool_bytes
from repro.serving.kv_cache import PagedKV as JKV
from repro.serving.kv_cache import PagedKVConfig as JKVConfig
from repro_torch.core import DevicePool
from repro_torch.kernels import ops, ref, staging_pool_bytes
from repro_torch.kernels.jet_staged_matmul import TILES, smem_bytes
from repro_torch.serving import PagedKV, PagedKVConfig

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _paged_inputs(seed, b, hq, hkv, d, page, maxp, pool, lengths=None):
    """Pages, a shuffled page table with -1 holes past each length, and
    lengths, as the reference's sweep makes them."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, page * maxp, size=b)
    lengths = np.asarray(lengths, np.int32)
    table = np.full((b, maxp), -1, np.int32)
    free = list(rng.permutation(pool))
    for i in range(b):
        for j in range(-(-int(lengths[i]) // page)):
            table[i, j] = free.pop()
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    return q, kp, vp, table, lengths


# --------------------------------------------------------------------------- #
# paged decode attention
# --------------------------------------------------------------------------- #
# (hq, hkv, page, maxp): tests/test_kernels.py's sweep, plus danube's
# group of 4 at head dim 80 and a one-page table
PAGED = [(4, 2, 8, 4, 32), (8, 8, 4, 6, 32), (8, 2, 16, 2, 32),
         (8, 2, 8, 3, 80), (4, 1, 5, 1, 16)]


@pytest.mark.parametrize("hq,hkv,page,maxp,d", PAGED)
def test_paged_decode_plain_matches_reference(hq, hkv, page, maxp, d):
    q, kp, vp, table, lengths = _paged_inputs(hq * 100 + page, 3, hq, hkv,
                                              d, page, maxp, 24)
    o, lse = ops.decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lengths))
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    o_ref, lse_ref = jref.decode_attention_paged_ref(*jargs)
    o_pl, lse_pl = jops.decode_attention(*jargs, impl="interpret")
    for want_o, want_lse in ((o_ref, lse_ref), (o_pl, lse_pl)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32


def test_paged_decode_plain_matches_the_dense_oracle():
    """Gathered by hand into a contiguous cache, the same sequences give
    the same (o, lse) through ``decode_attention_naive``."""
    q, kp, vp, table, lengths = _paged_inputs(11, 2, 4, 2, 16, 4, 3, 8)
    safe = np.maximum(table, 0)
    kc = kp[safe].reshape(2, 12, 2, 16)
    vc = vp[safe].reshape(2, 12, 2, 16)
    o, lse = ops.decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lengths))
    o_d, lse_d = ref.decode_attention_naive(_t(q), _t(kc), _t(vc),
                                            _t(lengths))
    np.testing.assert_allclose(o.numpy(), o_d.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_d.numpy(), **TOL)


def test_paged_decode_length_zero_row():
    """A length-0 row: the plain version gives the reference's plain value
    (the mean of v over the clamped pages) and the kernel's lse; the
    reference's kernel gives o = 0 there, as the CUDA kernel does."""
    q, kp, vp, table, lengths = _paged_inputs(12, 3, 4, 2, 16, 4, 3, 10,
                                              lengths=[5, 0, 12])
    o, lse = ops.decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lengths))
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    o_ref, lse_ref = jref.decode_attention_paged_ref(*jargs)
    o_pl, lse_pl = jops.decode_attention(*jargs, impl="interpret")
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_pl), **TOL)
    assert np.all(np.asarray(o_pl)[1] == 0.0)
    assert np.abs(o.numpy()[1]).max() > 0.0          # the mean of v
    assert np.all(lse.numpy()[1] == np.float32(-1e30))
    np.testing.assert_allclose(o.numpy()[[0, 2]], np.asarray(o_pl)[[0, 2]],
                               **TOL)


def test_paged_decode_bf16_pages():
    q, kp, vp, table, lengths = _paged_inputs(13, 2, 8, 2, 32, 8, 4, 12)
    kb, vb = _t(kp).bfloat16(), _t(vp).bfloat16()
    o, lse = ops.decode_attention(_t(q).bfloat16(), kb, vb, _t(table),
                                  _t(lengths))
    jargs = [jnp.asarray(q, jnp.bfloat16),
             jnp.asarray(kb.float().numpy(), jnp.bfloat16),
             jnp.asarray(vb.float().numpy(), jnp.bfloat16),
             jnp.asarray(table), jnp.asarray(lengths)]
    o_ref, lse_ref = jref.decode_attention_paged_ref(*jargs)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)


def test_paged_decode_split_table_merges_through_lse():
    """Each half of every table through the decode, merged by
    ``combine_partial_attention``, gives the whole table's output."""
    q, kp, vp, table, lengths = _paged_inputs(14, 3, 8, 2, 16, 4, 6, 24,
                                              lengths=[24, 13, 9])
    o, _ = ops.decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                _t(lengths))
    half = 3 * 4
    parts = [ops.decode_attention(_t(q), _t(kp), _t(vp),
                                  _t(np.ascontiguousarray(tab)), _t(ln))
             for tab, ln in ((table[:, :3], np.minimum(lengths, half)),
                             (table[:, 3:], np.maximum(lengths - half, 0)))]
    # a half with no tokens has lse -1e30 and weight 0 in the merge
    merged = ref.combine_partial_attention(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))
    np.testing.assert_allclose(merged.numpy(), o.numpy(), **TOL)


@given(st.integers(1, 5))
@settings(max_examples=10, deadline=None)
def test_combine_partial_attention_is_exact(n_shards):
    """Sharded partial softmax + combine == unsharded attention, and the
    port's combine == the reference's."""
    b, h, d, s = 2, 2, 8, 8 * n_shards
    rng = np.random.default_rng(n_shards)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    o_full, _ = ref.decode_attention_naive(_t(q), _t(k), _t(v),
                                           torch.full((b,), s))
    parts, lses = [], []
    for i in range(n_shards):
        o, lse = ref.decode_attention_naive(
            _t(q), _t(k[:, i * 8:(i + 1) * 8]), _t(v[:, i * 8:(i + 1) * 8]),
            torch.full((b,), 8))
        parts.append(o)
        lses.append(lse)
    o_comb = ref.combine_partial_attention(torch.stack(parts),
                                           torch.stack(lses))
    np.testing.assert_allclose(o_comb.numpy(), o_full.numpy(), rtol=1e-4,
                               atol=1e-4)
    j_comb = jref.combine_partial_attention(
        jnp.asarray(torch.stack(parts).numpy()),
        jnp.asarray(torch.stack(lses).numpy()))
    np.testing.assert_allclose(o_comb.numpy(), np.asarray(j_comb),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# staged matmul
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (100, 130, 70),
                                   (256, 512, 128), (17, 65, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_matmul_plain_matches_reference_kernel(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    want = jops.staged_matmul(ja, jb, impl="interpret", block_m=32,
                              block_n=32, block_k=64)
    # the same (rounded) operands on both sides
    ta = _t(np.asarray(ja.astype(jnp.float32))).to(tdt)
    tb = _t(np.asarray(jb.astype(jnp.float32))).to(tdt)
    got = ops.staged_matmul(ta, tb)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jref.matmul_naive(ja, jb), np.float32), rtol=tol,
        atol=tol)


def test_staged_matmul_out_dtype():
    rng = np.random.default_rng(3)
    a = _t(rng.standard_normal((9, 20)).astype(np.float32)).bfloat16()
    b = _t(rng.standard_normal((20, 7)).astype(np.float32)).bfloat16()
    got = ops.staged_matmul(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               (a.double() @ b.double()).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bm,bn,bk,nbytes,nbuf", [
    (256, 256, 512, 2, 2), (128, 128, 64, 2, 2), (32, 32, 64, 4, 2),
    (512, 128, 256, 2, 3), (64, 256, 128, 1, 1)])
def test_staging_pool_bytes_match_reference(bm, bn, bk, nbytes, nbuf):
    assert staging_pool_bytes(bm, bn, bk, nbytes, nbuf) == \
        jstaging_pool_bytes(bm, bn, bk, nbytes, nbuf)


def test_cuda_tile_fits_a_block_where_the_tpu_default_does_not():
    assert staging_pool_bytes(256, 256, 512) == 1310720      # 1.25 MB
    assert staging_pool_bytes(256, 256, 512) > 232448         # 227 KB
    assert set(TILES) == {"simt_f32", "mma_sync_bf16", "wgmma_bf16",
                          "wgmma_bf16_n256"}
    assert smem_bytes("simt_f32") == 16896
    assert smem_bytes("mma_sync_bf16") == 40960
    # the register-staged kernels fit static shared memory; the wgmma ring
    # is dynamic shared memory above 48 KB by design, within the 227 KB a
    # block may have
    assert all(smem_bytes(v) <= 48 * 1024
               for v in ("simt_f32", "mma_sync_bf16"))
    assert all(48 * 1024 < smem_bytes(v) <= 232448
               for v in ("wgmma_bf16", "wgmma_bf16_n256"))


# --------------------------------------------------------------------------- #
# DevicePool and PagedKV, step for step against the reference
# --------------------------------------------------------------------------- #
def test_device_pool_matches_reference_step_for_step():
    j, t = JPool.create(6), DevicePool.create(6, device="cpu")
    steps = [("alloc", 2), ("alloc", 1), ("release", [1, -1]),
             ("alloc", 9), ("release", [-1, 3, 5, 0]), ("alloc", 2),
             ("release", [0, 1, 2, 3, 4, 5]), ("alloc", 6), ("alloc", 1),
             ("release", [4, -1, -1])]
    for op, arg in steps:
        if op == "alloc":
            j, j_idx, j_ok = j.alloc(arg)
            t_idx, t_ok = t.alloc(arg)
            np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
            assert bool(t_ok) == bool(j_ok)
        else:
            j = j.release(jnp.asarray(arg, jnp.int32))
            t.release(torch.tensor(arg, dtype=torch.int32))
        np.testing.assert_array_equal(t.free.numpy(), np.asarray(j.free))
        assert int(t.available()) == int(j.available())
    assert t.num_slots == j.num_slots == 6


def _same_store(j, t):
    for name in ("k_pages", "v_pages", "page_table", "lengths"):
        np.testing.assert_array_equal(getattr(t, name).float().numpy(),
                                      np.asarray(getattr(j, name),
                                                 np.float32), err_msg=name)
    np.testing.assert_array_equal(t.pool.free.numpy(),
                                  np.asarray(j.pool.free))


def test_paged_kv_matches_reference_step_for_step():
    """Round-robin appends over three sequences until the pool runs out
    (escape) and one sequence passes ``max_pages_per_seq``, then releases
    and reuse, in the default bfloat16 pages."""
    j = JKV.create(JKVConfig(5, 3, 2, 4, 2), batch=3)
    t = PagedKV.create(PagedKVConfig(5, 3, 2, 4, 2), batch=3, device="cpu")
    rng = np.random.default_rng(5)
    order = [0, 1, 2] * 4 + [0] * 4 + ["r1"] + [1, 2, 2, 2, 1] + ["r0"] \
        + [0, 0, 1]
    oks = []
    for step in order:
        if isinstance(step, str):
            b = int(step[1])
            j = j.release(b)
            t.release(b)
        else:
            k = rng.standard_normal((2, 4)).astype(np.float32)
            v = rng.standard_normal((2, 4)).astype(np.float32)
            j, j_ok = j.append(step, jnp.asarray(k), jnp.asarray(v))
            t_ok = t.append(step, _t(k), _t(v))
            assert bool(t_ok) == bool(j_ok)
            oks.append(bool(t_ok))
        _same_store(j, t)
    assert not all(oks) and any(oks)           # the escape path was taken
    assert int(t.pool.available()) == int(j.pool.available())


def test_paged_kv_default_dtype_is_bfloat16():
    assert PagedKVConfig(1, 1, 1, 1, 1).dtype == torch.bfloat16
    assert JKVConfig(1, 1, 1, 1, 1).dtype == jnp.bfloat16


def test_paged_kv_decode_matches_the_dense_cache():
    """Tokens appended round-robin into a paged store decode like the same
    tokens in a dense cache."""
    cfg = PagedKVConfig(num_pages=16, page_size=4, num_kv_heads=2,
                        head_dim=16, max_pages_per_seq=4,
                        dtype=torch.float32)
    store = PagedKV.create(cfg, batch=3, device="cpu")
    lengths = [13, 6, 9]
    rng = np.random.default_rng(9)
    dense_k = rng.standard_normal((3, 16, 2, 16)).astype(np.float32)
    dense_v = rng.standard_normal((3, 16, 2, 16)).astype(np.float32)
    for pos in range(max(lengths)):
        for b in range(3):
            if pos < lengths[b]:
                assert bool(store.append(b, _t(dense_k[b, pos]),
                                         _t(dense_v[b, pos])))
    table = store.page_table.numpy()
    assert not np.all(np.diff(table[0][table[0] >= 0]) == 1)  # interleaved
    q = _t(rng.standard_normal((3, 8, 16)).astype(np.float32))
    o, lse = ops.decode_attention(q, store.k_pages, store.v_pages,
                                  store.page_table, store.lengths)
    o_d, lse_d = ref.decode_attention_naive(q, _t(dense_k), _t(dense_v),
                                            torch.tensor(lengths))
    np.testing.assert_allclose(o.numpy(), o_d.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_d.numpy(), **TOL)


# --------------------------------------------------------------------------- #
# devices and dispatch
# --------------------------------------------------------------------------- #
def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePool.create(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKV.create(PagedKVConfig(2, 2, 1, 4, 1), batch=1)


def test_cpu_tensors_refuse_the_kernels_and_count_nothing():
    q, kp, vp, table, lengths = (_t(a) for a in _paged_inputs(
        15, 1, 2, 1, 8, 4, 2, 4))
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, kp, vp, table, lengths, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.staged_matmul(a, a.T.contiguous(), impl="cuda")
    ops.reset_launches()
    for impl in ("auto", "ref"):
        ops.decode_attention(q, kp, vp, table, lengths, impl=impl)
        ops.staged_matmul(a, a.T.contiguous(), impl=impl)
    assert ops.LAUNCHES["decode_attention_paged"] == 0
    assert ops.LAUNCHES["staged_matmul"] == 0


def test_staged_matmul_refuses_the_tpu_block_knobs():
    a = torch.zeros((4, 4))
    with pytest.raises(TypeError, match="block_m"):
        ops.staged_matmul(a, a, block_m=32)
    with pytest.raises(TypeError, match="block_k"):
        ops.staged_matmul(a, a, impl="ref", block_k=64)
