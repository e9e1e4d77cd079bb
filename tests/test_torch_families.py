"""The dense, MoE and xLSTM families of the port on the CPU against the
reference.

The xLSTM blocks are fed the same numpy inputs and the reference's own
weights and must agree within 2e-4.  For each newly served architecture
the tiny config (``tiny_config``) is built by the reference, carried
across by ``params_from_jax``, prefilled and decoded four steps by both
packages: logits and every state leaf within 2e-3 of the largest
magnitude, the tolerance tiny zamba2 is held to.  Danube's window ring is
decoded past an 8-token window, and the engine serves tiny scout and tiny
xlstm token for token as the reference's engine does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, tiny_config as jtiny
from repro.core import jet as jjet
from repro.models import api as japi
from repro.models import decoding as jdec
from repro.models import transformer as jtr
from repro.models import xlstm as jx
from repro.parallel.sharding import single_device_ctx
from repro.serving import engine as jeng
from repro_torch.configs import get_arch, tiny_config
from repro_torch.core import jet as tjet
from repro_torch.models import api, transformer, xlstm
from repro_torch.models.convert import params_from_jax, tree_from_numpy
from repro_torch.serving import engine as teng

torch.set_num_threads(1)

CTX = single_device_ctx()
TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = 2e-3
FAMILIES = ["chatglm3-6b", "gemma-7b", "h2o-danube-1.8b", "starcoder2-15b",
            "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
            "xlstm-125m"]
JXL = jtiny(ARCHS["xlstm-125m"])
XL = tiny_config(get_arch("xlstm-125m"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _close_trees(got, want, tol):
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), got))
    assert tree_w == tree_g
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g, w) <= tol


def _models(arch: str, seed: int = 0, **replace):
    jcfg = dataclasses.replace(jtiny(ARCHS[arch]), **replace)
    cfg = dataclasses.replace(tiny_config(get_arch(arch)), **replace)
    jp = japi.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jp, params_from_jax(_np(jp), cfg, device="cpu")


# --------------------------------------------------------------------------- #
# xLSTM blocks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("t", [64, 256], ids=["one-chunk", "two-chunks"])
def test_mlstm_apply_and_decode_match(t):
    jp = _np(jx.mlstm_init(jax.random.key(1), JXL))
    tp = tree_from_numpy(jp, "cpu")
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, JXL.d_model)).astype(np.float32)
    y, (c, n) = xlstm.mlstm_apply(tp, torch.from_numpy(x), XL,
                                  return_state=True)
    jy, (jc, jn) = jx.mlstm_apply(jp, jnp.asarray(x), JXL, CTX,
                                  return_state=True)
    for g, w in ((y, jy), (c, jc), (n, jn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert c.dtype == n.dtype == torch.float32
    x1 = rng.standard_normal((2, 1, JXL.d_model)).astype(np.float32)
    y1, (c1, n1) = xlstm.mlstm_decode(tp, torch.from_numpy(x1), (c, n), XL)
    jy1, (jc1, jn1) = jx.mlstm_decode(jp, jnp.asarray(x1), (jc, jn), JXL,
                                      CTX)
    for g, w in ((y1, jy1), (c1, jc1), (n1, jn1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_mlstm_prefill_needs_whole_chunks():
    tp = tree_from_numpy(_np(jx.mlstm_init(jax.random.key(1), JXL)), "cpu")
    with pytest.raises(ValueError, match="T % 128"):
        xlstm.mlstm_apply(tp, torch.zeros(1, 200, XL.d_model), XL)


@pytest.mark.parametrize("t", [1, 9])
def test_slstm_apply_and_decode_match(t):
    jp = _np(jx.slstm_init(jax.random.key(2), JXL))
    # the reference initialises the bias to zeros: give it values
    jp["bias"] = np.random.default_rng(0).standard_normal(
        jp["bias"].shape).astype(np.float32) * 0.5
    tp = tree_from_numpy(jp, "cpu")
    rng = np.random.default_rng(t + 10)
    x = rng.standard_normal((2, t, JXL.d_model)).astype(np.float32)
    y, carry = xlstm.slstm_apply(tp, torch.from_numpy(x), XL,
                                 return_state=True)
    jy, jcarry = jx.slstm_apply(jp, jnp.asarray(x), JXL, CTX,
                                return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for g, w in zip(carry, jcarry):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    x1 = rng.standard_normal((2, 1, JXL.d_model)).astype(np.float32)
    y1, c1 = xlstm.slstm_decode(tp, torch.from_numpy(x1), carry, XL)
    jy1, jc1 = jx.slstm_decode(jp, jnp.asarray(x1), jcarry, JXL, CTX)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), **TOL)
    for g, w in zip(c1, jc1):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_state_init_matches(block):
    got = getattr(xlstm, f"{block}_state_init")(XL, 3)
    want = getattr(jx, f"{block}_state_init")(JXL, 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert all(g.dtype == torch.float32 and not g.any() for g in got)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_init_has_the_reference_layout(block):
    mine = getattr(xlstm, f"{block}_init")(
        torch.Generator().manual_seed(0), XL, device="cpu", lead=(2,))
    theirs = jax.eval_shape(
        lambda k: getattr(jx, f"{block}_init")(k, JXL), jax.random.key(0))
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda s: (2,) + s.shape, theirs)
    if block == "mlstm":
        h = XL.num_heads
        assert mine["if_bias"][1].tolist() == [-2.0] * h + [3.0] * h


# --------------------------------------------------------------------------- #
# whole models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_the_reference_layout(arch):
    jcfg = jtiny(ARCHS[arch])
    cfg = tiny_config(get_arch(arch))
    assert transformer.segments(cfg) == jtr.segments(jcfg)
    mine = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    theirs = jax.eval_shape(lambda k: jtr.init_params(jcfg, k),
                            jax.random.key(0))
    got = jax.tree.map(lambda t: tuple(t.shape), mine,
                       is_leaf=torch.is_tensor)
    want = jax.tree.map(lambda s: s.shape, theirs)
    assert jax.tree.structure(got, is_leaf=lambda x: isinstance(x, tuple)
                              and all(isinstance(i, int) for i in x)) == \
        jax.tree.structure(want, is_leaf=lambda x: isinstance(x, tuple)
                           and all(isinstance(i, int) for i in x))
    assert got == want
    assert ("unembed" in mine) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch,edit,match", [
    ("gemma-7b", "add_unembed", "layout"),
    ("llama4-scout-17b-a16e", "drop_unembed", "layout"),
    ("llama4-maverick-400b-a17b", "unstack", "stacked"),
    ("xlstm-125m", "drop_remainder", "remainder"),
], ids=["gemma-tied", "scout-untied", "maverick-period-2", "xlstm"])
def test_params_from_jax_checks_the_new_layouts(arch, edit, match):
    jcfg = jtiny(ARCHS[arch])
    cfg = tiny_config(get_arch(arch))
    tree = _np(japi.init_params(jcfg, jax.random.key(4)))
    assert jax.tree.structure(params_from_jax(tree, cfg, device="cpu")) \
        is not None
    bad = dict(tree)
    if edit == "add_unembed":
        bad["unembed"] = tree["embed"].T
    elif edit == "drop_unembed":
        bad.pop("unembed")
    elif edit == "unstack":
        bad["pattern"] = tuple(jax.tree.map(lambda a: a[0], layer)
                               for layer in tree["pattern"])
    else:
        bad["remainder"] = ()
    with pytest.raises(ValueError, match=match):
        params_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_tiny_prefill_and_decode_match(arch):
    jcfg, cfg, jp, tp = _models(arch)
    t = 32
    toks = np.random.default_rng(5).integers(
        2, jcfg.vocab_size, size=(2, t)).astype(np.int32)
    max_len = t + 8
    jl, js, jlen = japi.prefill(jp, jcfg, CTX, jnp.asarray(toks),
                                max_len=max_len, compute_dtype=jnp.float32)
    tl, ts, tlen = api.prefill(tp, cfg, torch.from_numpy(toks),
                               max_len=max_len)
    assert _rel(tl.numpy(), jl) <= MODEL_TOL
    _close_trees(ts, _np(js), MODEL_TOL)
    assert tlen.tolist() == np.asarray(jlen).tolist()
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    for _ in range(4):
        ttok = torch.from_numpy(np.array(jtok))
        jl, js = japi.decode_step(jp, jcfg, CTX, js, jtok, jlen,
                                  compute_dtype=jnp.float32)
        tl, ts = api.decode_step(tp, cfg, ts, ttok, tlen)
        assert _rel(tl.numpy(), jl) <= MODEL_TOL
        jlen, tlen = jlen + 1, tlen + 1
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    _close_trees(ts, _np(js), MODEL_TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_state_layout_matches(arch):
    jcfg = jtiny(ARCHS[arch])
    cfg = tiny_config(get_arch(arch))
    got = api.init_decode_state(cfg, 3, 20, device="cpu")
    want = jax.eval_shape(lambda: jdec.init_decode_state(
        jcfg, 3, 20, dtype=jnp.float32))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda s: 0, want))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in jax.tree.leaves(got)] == \
        [(s.shape, str(s.dtype)) for s in jax.tree.leaves(want)]


def test_danube_window_ring_decodes_past_the_window():
    """Danube with an 8-token window, decoded token by token from an
    empty ring past three wraps, step for step as the reference; and the
    last step equal to a windowed prefill of the whole sequence."""
    jcfg, cfg, jp, tp = _models("h2o-danube-1.8b", 1, sliding_window=8,
                                num_layers=2)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(1, 24)).astype(np.int32)
    jstate = japi.init_decode_state(jcfg, 1, 8, jnp.float32)
    tstate = api.init_decode_state(cfg, 1, 8, device="cpu")
    assert tstate["pattern"][0]["kv"][0].shape[2] == 8
    jlen = jnp.zeros((1,), jnp.int32)
    tlen = torch.zeros((1,), dtype=torch.int32)
    for i in range(24):
        jl, jstate = japi.decode_step(jp, jcfg, CTX, jstate,
                                      jnp.asarray(toks[:, i]), jlen,
                                      compute_dtype=jnp.float32)
        tl, tstate = api.decode_step(tp, cfg, tstate,
                                     torch.from_numpy(toks[:, i]), tlen)
        assert _rel(tl.numpy(), jl) <= MODEL_TOL
        jlen, tlen = jlen + 1, tlen + 1
    _close_trees(tstate, _np(jstate), MODEL_TOL)
    full, pstate, _ = api.prefill(tp, cfg, torch.from_numpy(toks), max_len=8)
    np.testing.assert_allclose(tl.numpy(), full.numpy(), rtol=5e-3,
                               atol=5e-3)
    # the prefill's ring holds the last 8 tokens where decode put them
    _close_trees(pstate, _np(jstate), MODEL_TOL)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
ENGINE_REQUESTS = [(8, 4), (16, 3), (8, 5), (16, 2)]


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "xlstm-125m"])
def test_engine_serves_the_same_tokens_as_the_reference(arch):
    jcfg, cfg, jp, tp = _models(arch, 3)
    ecfg = dict(max_lanes=2, max_len=32, eos_token=-1)
    je = jeng.ServingEngine(jcfg, jeng.EngineConfig(**ecfg), jp, CTX,
                            jjet.JetConfig(pool_bytes=1 << 20))
    te = teng.ServingEngine(cfg, teng.EngineConfig(**ecfg), tp,
                            tjet.JetConfig(pool_bytes=1 << 20),
                            device="cpu")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, cfg.vocab_size, size=t).astype(np.int32)
               for t, _ in ENGINE_REQUESTS]
    for eng, mod in ((je, jeng), (te, teng)):
        for i, (pr, (_, new)) in enumerate(zip(prompts, ENGINE_REQUESTS)):
            eng.submit(mod.Request(i, pr, new))
        eng.run_until_done(max_ticks=40)
    assert sorted(te.done) == sorted(je.done) == list(range(4))
    for rid, (_, new) in enumerate(ENGINE_REQUESTS):
        assert te.done[rid].generated == je.done[rid].generated
        assert len(te.done[rid].generated) == new
    assert te.jet.stats() == je.jet.stats()
