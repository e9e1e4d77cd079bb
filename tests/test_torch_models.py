"""The port's serving model stack on the CPU against the reference.

Every module is fed the same numpy inputs and the reference's own
parameters (carried across by ``params_from_jax``), and must compute what
the reference computes in float32: the layers and blocks within 2e-4,
tiny zamba2's prefill logits and states and three decode steps within
2e-3 of the largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, tiny_config as jtiny
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import decoding as jdec
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.parallel.sharding import single_device_ctx
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_arch, tiny_config
from repro_torch.models import api, attention, decoding, layers, ssm
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, tree_from_numpy

torch.set_num_threads(1)

CTX = single_device_ctx()
JCFG = jtiny(ARCHS["zamba2-1.2b"])
CFG = tiny_config(get_arch("zamba2-1.2b"))
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def params():
    jp = japi.init_params(JCFG, jax.random.key(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _close_trees(got, want, tol):
    """``got`` (torch tree) against ``want`` (numpy tree): same layout,
    every leaf within ``tol`` of the leaf's largest magnitude."""
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), got))
    assert tree_w == tree_g
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape
        assert _rel(g, w) <= tol


# --------------------------------------------------------------------------- #
# configs and parameters
# --------------------------------------------------------------------------- #
def test_config_copy_equals_the_reference():
    assert sorted(PORT_ARCHS) == sorted(ARCHS) and len(ARCHS) == 10
    for name, ref in ARCHS.items():
        full = get_arch(name)
        assert dataclasses.asdict(full) == dataclasses.asdict(ref)
        assert transformer.segments(full) == jtr.segments(ref)
        tiny = tiny_config(full)
        assert dataclasses.asdict(tiny) == dataclasses.asdict(jtiny(ref))
        assert transformer.segments(tiny) == jtr.segments(jtiny(ref))
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)


def test_init_params_has_the_reference_layout():
    gen = torch.Generator().manual_seed(0)
    mine = transformer.init_params(CFG, gen, device="cpu")
    theirs = jax.eval_shape(lambda k: jtr.init_params(JCFG, k),
                            jax.random.key(0))
    flat_m, tree_m = jax.tree.flatten(jax.tree.map(lambda t: t.shape, mine,
                                                   is_leaf=torch.is_tensor),
                                      is_leaf=lambda x: isinstance(x, tuple)
                                      and all(isinstance(i, int) for i in x))
    flat_t, tree_t = jax.tree.flatten(jax.tree.map(lambda s: s.shape, theirs),
                                      is_leaf=lambda x: isinstance(x, tuple)
                                      and all(isinstance(i, int) for i in x))
    assert tree_m == tree_t and flat_m == flat_t
    # same scales: zero-init norms, the softplus^-1(0.05) dt bias, a_log
    assert float(mine["final_norm"].abs().max()) == 0.0
    m0 = mine["pattern"][0]["mamba"]
    np.testing.assert_allclose(m0["dt_bias"].numpy(),
                               np.log(np.expm1(0.05)), rtol=1e-6)
    np.testing.assert_allclose(m0["a_log"][0].numpy(),
                               np.log(np.linspace(1.0, 8.0, CFG.ssm_heads)),
                               rtol=1e-6)
    assert abs(float(mine["embed"].std()) - CFG.d_model ** -0.5) < 0.01


def test_init_params_is_seeded():
    a = transformer.init_params(CFG, torch.Generator().manual_seed(3),
                                  device="cpu")
    b = transformer.init_params(CFG, torch.Generator().manual_seed(3),
                                  device="cpu")
    assert torch.equal(a["pattern"][2]["mamba"]["w_z"],
                       b["pattern"][2]["mamba"]["w_z"])


def test_params_from_jax_checks_the_layout(params):
    jp, _ = params
    tree = _np(jp)
    bad = dict(tree)
    bad.pop("shared_attn")
    with pytest.raises(ValueError, match="layout"):
        params_from_jax(bad, CFG)
    short = dict(tree, remainder=())
    with pytest.raises(ValueError, match="remainder"):
        params_from_jax(short, CFG)
    flat = dict(tree, pattern=tuple(jax.tree.map(lambda a: a[0], layer)
                                    for layer in tree["pattern"]))
    with pytest.raises(ValueError, match="stacked"):
        params_from_jax(flat, CFG)


@pytest.mark.parametrize("entry", [
    lambda: api.init_params(CFG, torch.Generator()),
    lambda: api.init_decode_state(CFG, 2, 12),
    lambda: tree_from_numpy({"w": np.zeros(3, np.float32)}),
], ids=["init_params", "init_decode_state", "tree_from_numpy"])
def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_prefill_and_decode_keep_full_fp32_matmuls(params):
    _, tp = params
    toks = torch.tensor([[3, 4, 5, 6]])
    torch.set_float32_matmul_precision("high")
    _, st, lens = api.prefill(tp, CFG, toks, max_len=8)
    assert torch.get_float32_matmul_precision() == "highest"
    torch.set_float32_matmul_precision("high")
    api.decode_step(tp, CFG, st, toks[:, -1], lens)
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def test_rms_norm_scales_by_one_plus_scale():
    rng = np.random.default_rng(0)
    x, s = rng.standard_normal((3, 5, 16)), rng.standard_normal(16) * 0.1
    x, s = x.astype(np.float32), s.astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s))), **TOL)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_rotates_interleaved_pairs(fraction):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None, :] + np.array([[0], [5]])
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 16,
                            fraction, 500.0)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 16,
                              fraction, 500.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(kind):
    jp = _np(jlayers.mlp_init(jax.random.key(2), 16, 32, kind))
    x = np.random.default_rng(2).standard_normal((2, 5, 16)).astype(
        np.float32)
    got = layers.mlp_apply(tree_from_numpy(jp, "cpu"), torch.from_numpy(x),
                           kind)
    want = jlayers.mlp_apply(jp, jnp.asarray(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    st = rng.standard_normal((2, 3, 10)).astype(np.float32) \
        if with_state else None
    y, ns = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if st is None else torch.from_numpy(st))
    jy, jns = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ns.numpy(), np.asarray(jns), **TOL)


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def test_mamba_prefill_and_decode_match():
    jp = _np(jssm.mamba_init(jax.random.key(4), JCFG))
    tp = tree_from_numpy(jp, "cpu")
    x = np.random.default_rng(4).standard_normal((2, 16, 128)).astype(
        np.float32) * 0.5
    y, (conv, h) = ssm.mamba_apply(tp, torch.from_numpy(x), CFG,
                                   return_state=True)
    jy, (jconv, jh) = jssm.mamba_apply(jp, jnp.asarray(x), JCFG, CTX,
                                       return_state=True)
    for g, w in ((y, jy), (conv, jconv), (h, jh)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    x1 = x[:, :1] * 0.7
    y1, (c1, h1) = ssm.mamba_decode(tp, torch.from_numpy(x1), (conv, h), CFG)
    jy1, (jc1, jh1) = jssm.mamba_decode(jp, jnp.asarray(x1), (jconv, jh),
                                        JCFG, CTX)
    for g, w in ((y1, jy1), (c1, jc1), (h1, jh1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mamba_state_init_matches():
    got = ssm.mamba_state_init(CFG, 3)
    want = jssm.mamba_state_init(JCFG, 3)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert got[1].dtype == torch.float32


def test_attention_prefill_and_decode_match():
    jp = _np(jattn.attn_init(jax.random.key(5), JCFG))
    tp = tree_from_numpy(jp, "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 128)).astype(np.float32)
    out, (k, v) = attention.self_attention(tp, torch.from_numpy(x), CFG,
                                           return_kv=True)
    jout, (jk, jv) = jattn.self_attention(jp, jnp.asarray(x), JCFG, CTX,
                                          return_kv=True)
    for g, w in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    s = 16
    ck = rng.standard_normal((2, s, 4, 32)).astype(np.float32)
    cv = rng.standard_normal((2, s, 4, 32)).astype(np.float32)
    lengths = np.array([5, 15], np.int32)    # the second fills the ring
    x1 = rng.standard_normal((2, 1, 128)).astype(np.float32)
    o1, tk, tv = attention.decode_self_attention(
        tp, torch.from_numpy(x1), torch.from_numpy(ck.copy()),
        torch.from_numpy(cv.copy()), torch.from_numpy(lengths), CFG)
    jo1, jk1, jv1 = jattn.decode_self_attention(
        jp, jnp.asarray(x1), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(lengths), JCFG, CTX)
    for g, w in ((o1, jo1), (tk, jk1), (tv, jv1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_shared_block_matches(params):
    jp, tp = params
    x = np.random.default_rng(6).standard_normal((2, 10, 128)).astype(
        np.float32)
    got = transformer._shared_block(tp["shared_attn"], torch.from_numpy(x),
                                    CFG)
    want = jtr._shared_block(jp["shared_attn"], jnp.asarray(x), JCFG, CTX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,s_cache", [(5, 8), (8, 8), (13, 8)])
def test_ring_place_matches(t, s_cache):
    kv = np.random.default_rng(t).standard_normal((2, t, 3, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        decoding._ring_place(torch.from_numpy(kv), s_cache).numpy(),
        np.asarray(jdec._ring_place(jnp.asarray(kv), s_cache)))


# --------------------------------------------------------------------------- #
# the slice: tiny zamba2 prefill and decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("t", [24, 16])
def test_tiny_zamba2_prefill_and_decode_match(params, t):
    jp, tp = params
    toks = np.random.default_rng(t).integers(
        2, JCFG.vocab_size, size=(2, t)).astype(np.int32)
    max_len = t + 8
    jl, js, jlen = japi.prefill(jp, JCFG, CTX, jnp.asarray(toks),
                                max_len=max_len, compute_dtype=jnp.float32)
    tl, ts, tlen = api.prefill(tp, CFG, torch.from_numpy(toks),
                               max_len=max_len)
    assert _rel(tl.numpy(), jl) <= 2e-3
    _close_trees(ts, _np(js), 2e-3)
    assert tlen.tolist() == np.asarray(jlen).tolist()
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.from_numpy(np.array(jtok))
    for _ in range(3):
        jl, js = japi.decode_step(jp, JCFG, CTX, js, jtok, jlen,
                                  compute_dtype=jnp.float32)
        tl, ts = api.decode_step(tp, CFG, ts, ttok, tlen)
        assert _rel(tl.numpy(), jl) <= 2e-3
        jlen, tlen = jlen + 1, tlen + 1
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.from_numpy(np.array(jtok))
    _close_trees(ts, _np(js), 2e-3)


def test_decode_state_layout_matches(params):
    got = api.init_decode_state(CFG, 3, 20, device="cpu")
    want = jax.eval_shape(lambda: jdec.init_decode_state(
        JCFG, 3, 20, dtype=jnp.float32))
    flat_g, tree_g = jax.tree.flatten(jax.tree.map(
        lambda t: np.zeros(0), got))
    flat_w, tree_w = jax.tree.flatten(jax.tree.map(lambda s: np.zeros(0),
                                                   want))
    assert tree_g == tree_w
    shapes_g = [tuple(t.shape) for t in jax.tree.leaves(got)]
    assert shapes_g == [s.shape for s in jax.tree.leaves(want)]


def test_decode_updates_the_state_in_place(params):
    _, tp = params
    st = api.init_decode_state(CFG, 2, 12, device="cpu")
    kv = st["pattern"][5]["kv"][0]
    before = kv.clone()
    _, out = api.decode_step(tp, CFG, st, torch.tensor([3, 4]),
                             torch.tensor([0, 6], dtype=torch.int32))
    assert out is st and out["pattern"][5]["kv"][0] is kv
    assert not torch.equal(kv, before)
    changed = (kv != before).any(-1).any(-1)          # [n_units, B, S]
    assert changed[0, 0, 0] and changed[0, 1, 6]
    assert int(changed.sum()) == 2
