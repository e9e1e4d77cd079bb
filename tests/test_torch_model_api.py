"""The port's complete model API on the CPU against the reference:
cross-attention over image patches, codebook tokens, ``forward``,
``loss_fn`` and the input specs.

Each tiny model (``tiny_config``) is built once by the reference, carried
across by ``params_from_jax`` and fed the same numpy inputs made from a
seed.  Blocks agree within 2e-4; whole models (logits, every state leaf,
loss, ``lb_loss``) within 2e-3 of the largest magnitude, the tolerance
the served families are held to; the MoE ``overflow`` is equal.  Both
packages run MoE blocks at the config's own capacity factor (the
reference's ``single_device_ctx()`` sets none).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, ShapeConfig as JShapeConfig
from repro.configs import tiny_config as jtiny
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.parallel.sharding import single_device_ctx
from repro_torch.configs import ShapeConfig, get_arch, tiny_config
from repro_torch.core.jet import JetConfig
from repro_torch.models import api, attention, layers, transformer
from repro_torch.models.convert import params_from_jax, tree_from_numpy
from repro_torch.serving.engine import EngineConfig, ServingEngine

torch.set_num_threads(1)

CTX = single_device_ctx()
TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = 2e-3
VISION, MUSIC = "llama-3.2-vision-11b", "musicgen-large"
SEQ = 32
_MODELS: dict = {}


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


def _models(arch: str, **replace):
    """(reference cfg, port cfg, reference params, port params), built
    once per module for each arch and edit."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jtiny(ARCHS[arch]), **replace)
        cfg = dataclasses.replace(tiny_config(get_arch(arch)), **replace)
        jp = japi.init_params(jcfg, jax.random.key(0))
        _MODELS[key] = (jcfg, cfg, jp,
                        params_from_jax(_np(jp), cfg, device="cpu"))
    return _MODELS[key]


def _batch(cfg, seed: int, b: int = 2, t: int = SEQ) -> dict:
    """numpy tokens (``[B, K, T]`` with codebooks), targets and, where
    the model reads them, unit-normal patches: one image a row."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, api.token_shape(
        cfg, b, t)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.num_patches:
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def test_cross_entropy_matches():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(targets))
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("t", [8, 100], ids=["T<P", "T>P"])
def test_cross_attention_matches(t):
    jcfg, cfg, _, _ = _models(VISION)
    jp = _np(jattn.attn_init(jax.random.key(3), jcfg))
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, cfg.num_patches, cfg.d_model)).astype(
        np.float32)
    out, (k, v) = attention.cross_attention(
        tree_from_numpy(jp, "cpu"), torch.from_numpy(x),
        torch.from_numpy(src), cfg, return_kv=True)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(src), jcfg,
                                 CTX)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    # the patch K/V handed to the decode state: the reference's xkv
    kv_shape = (2, cfg.num_patches, cfg.num_kv_heads, cfg.hd)
    for got, w in ((k, jp["wk"]), (v, jp["wv"])):
        np.testing.assert_allclose(got.numpy(), (src @ w).reshape(kv_shape),
                                   **TOL)


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def _shapes(tree, is_torch: bool):
    leaf = (lambda t: tuple(t.shape)) if is_torch else (lambda s: s.shape)
    return jax.tree.map(leaf, tree, is_leaf=torch.is_tensor)


@pytest.mark.parametrize("arch", [VISION, MUSIC])
def test_init_params_has_the_reference_layout(arch):
    jcfg, cfg, _, _ = _models(arch)
    mine = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    theirs = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                            jax.random.key(0))
    is_shape = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(i, int) for i in x)
    got, want = _shapes(mine, True), _shapes(theirs, False)
    assert jax.tree.structure(got, is_leaf=is_shape) == \
        jax.tree.structure(want, is_leaf=is_shape)
    assert got == want
    if cfg.num_codebooks:
        assert tuple(mine["embed"].shape) == (4, cfg.vocab_size, cfg.d_model)
        assert abs(float(mine["embed"].std()) - cfg.d_model ** -0.5) < 0.01
    else:
        cross = mine["pattern"][4]
        assert set(cross) == {"ln1", "attn", "ln_x", "xattn", "ln2", "ffn"}


@pytest.mark.parametrize("arch,edit", [(VISION, "drop_xattn"),
                                       (MUSIC, "flat_embed")])
def test_params_from_jax_checks_the_cross_and_codebook_layouts(arch, edit):
    _, cfg, jp, _ = _models(arch)
    bad = _np(jp)
    if edit == "drop_xattn":
        pattern = list(bad["pattern"])
        pattern[4] = {k: v for k, v in pattern[4].items()
                      if k not in ("ln_x", "xattn")}
        bad["pattern"] = tuple(pattern)
        match = "cross-attention"
    else:
        bad["embed"] = bad["embed"].reshape(-1, cfg.d_model)
        match = "embed"
    with pytest.raises(ValueError, match=match):
        params_from_jax(bad, cfg, device="cpu")


# --------------------------------------------------------------------------- #
# prefill and decode: patches, codebooks
# --------------------------------------------------------------------------- #
def _prefill_and_decode(arch, batch, steps: int = 4, **replace):
    """Prefill ``batch`` and decode ``steps`` greedy tokens in both
    packages (a codebook model takes the argmax tiled over its K
    codebooks, as the reference's smoke test does); logits after every
    step and every state leaf at both ends within ``MODEL_TOL``."""
    jcfg, cfg, jp, tp = _models(arch, **replace)
    t = batch["tokens"].shape[-1]
    jl, js, jlen = japi.prefill(jp, jcfg, CTX, jnp.asarray(batch["tokens"]),
                                None if "patches" not in batch else
                                jnp.asarray(batch["patches"]),
                                max_len=t + steps, compute_dtype=jnp.float32)
    tb = _torch(batch)
    tl, ts, tlen = api.prefill(tp, cfg, tb["tokens"], tb.get("patches"),
                               max_len=t + steps)
    assert _rel(tl.numpy(), jl) <= MODEL_TOL
    _close_trees(ts, _np(js), MODEL_TOL)
    assert tlen.tolist() == np.asarray(jlen).tolist()
    for _ in range(steps):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        if cfg.num_codebooks:
            jtok = jnp.tile(jtok[:, None], (1, cfg.num_codebooks))
        jl, js = japi.decode_step(jp, jcfg, CTX, js, jtok, jlen,
                                  compute_dtype=jnp.float32)
        tl, ts = api.decode_step(tp, cfg, ts, torch.from_numpy(
            np.array(jtok)), tlen)
        assert _rel(tl.numpy(), jl) <= MODEL_TOL
        jlen, tlen = jlen + 1, tlen + 1
    _close_trees(ts, _np(js), MODEL_TOL)
    return ts


def test_tiny_vision_prefill_and_decode_match():
    """Two rows, two images: the cross-attention state ``xkv`` holds each
    row's own patch K/V."""
    _, cfg, _, _ = _models(VISION)
    batch = _batch(cfg, 1)
    state = _prefill_and_decode(VISION, batch)
    xk = state["pattern"][4]["xkv"][0]                 # [n_units, B, P, ..]
    assert tuple(xk.shape) == (1, 2, cfg.num_patches, cfg.num_kv_heads,
                               cfg.hd)
    assert not torch.allclose(xk[:, 0], xk[:, 1])


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_tiny_musicgen_prefill_and_decode_match(tie):
    """``[2, 4, T]`` codebook prompts and ``[2, 4]`` decode tokens; tied,
    the head is the first codebook's table."""
    _, cfg, _, tp = _models(MUSIC, tie_embeddings=tie)
    assert ("unembed" in tp) == (not tie)
    _prefill_and_decode(MUSIC, _batch(cfg, 2), tie_embeddings=tie)


# --------------------------------------------------------------------------- #
# forward and loss, every architecture
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_and_loss_match(arch):
    jcfg, cfg, jp, tp = _models(arch)
    batch = _batch(cfg, 3)
    (jl, jaux), (jloss, jm) = jax.jit(lambda p, b: (
        japi.forward(p, jcfg, CTX, b["tokens"], b.get("patches"),
                     compute_dtype=jnp.float32),
        japi.loss_fn(p, jcfg, CTX, b, compute_dtype=jnp.float32)))(
        jp, _jax(batch))
    tb = _torch(batch)
    tl, taux = api.forward(tp, cfg, tb["tokens"], tb.get("patches"))
    loss, metrics = api.loss_fn(tp, cfg, tb)
    assert tuple(tl.shape) == (2, SEQ, cfg.vocab_size)
    assert _rel(tl.numpy(), jl) <= MODEL_TOL
    assert abs(float(loss) - float(jloss)) <= MODEL_TOL * abs(float(jloss))
    assert float(metrics["loss"]) == float(loss)
    for name in ("lb_loss", "overflow"):
        assert float(taux[name]) == float(metrics[name])
    assert abs(float(metrics["lb_loss"]) - float(jm["lb_loss"])) <= \
        MODEL_TOL * max(abs(float(jm["lb_loss"])), 1e-12)
    assert float(metrics["overflow"]) == float(jm["overflow"])
    if cfg.num_experts:
        assert float(metrics["lb_loss"]) > 0.0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_last_logits_equal_forward(arch):
    """The reference's own consistency check, on the port alone."""
    _, cfg, _, tp = _models(arch)
    tb = _torch(_batch(cfg, 4))
    full, _ = api.forward(tp, cfg, tb["tokens"], tb.get("patches"))
    last, _, _ = api.prefill(tp, cfg, tb["tokens"], tb.get("patches"))
    assert _rel(last.numpy(), full[:, -1].numpy()) <= MODEL_TOL


# --------------------------------------------------------------------------- #
# input specs
# --------------------------------------------------------------------------- #
def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match(arch, kind):
    """At full size (meta tensors take no memory): the reference's names,
    shapes and dtypes, the decode state tree included; and the tiny
    model's ``synthetic_inputs`` fill those specs."""
    shape = ShapeConfig(f"s-{kind}", kind, 4096, 8)
    cfg = get_arch(arch)
    got = api.input_specs(cfg, shape)
    want = japi.input_specs(ARCHS[arch], JShapeConfig(
        shape.name, kind, shape.seq_len, shape.global_batch))
    assert list(got) == list(want)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda s: 0, want))
    leaves = jax.tree.leaves(got)
    assert all(t.device.type == "meta" for t in leaves)
    assert [(tuple(t.shape), _dtype_name(t.dtype)) for t in leaves] == \
        [(s.shape, _dtype_name(s.dtype)) for s in jax.tree.leaves(want)]
    assert api.token_shape(cfg, 3, 5) == japi.token_shape(ARCHS[arch], 3, 5)

    tiny = tiny_config(cfg)
    small = ShapeConfig(shape.name, kind, 16, 2)
    specs = api.input_specs(tiny, small, torch.float32)
    made = api.synthetic_inputs(tiny, small, torch.Generator().manual_seed(5),
                                torch.float32, device="cpu")
    assert list(made) == list(specs)
    assert [(tuple(t.shape), t.dtype, t.device.type)
            for t in jax.tree.leaves(made)] == \
        [(tuple(t.shape), t.dtype, "cpu") for t in jax.tree.leaves(specs)]
    for name in ("tokens", "targets"):
        if name in made:
            tok = made[name]
            assert int(tok.min()) >= 0 and int(tok.max()) < tiny.vocab_size
    if kind == "decode":
        assert made["lengths"].tolist() == [15, 15]
        assert not any(bool(t.any()) for t in jax.tree.leaves(made["state"]))
    if "patches" in made:
        assert abs(float(made["patches"].std()) - 1.0) < 0.05


def test_synthetic_inputs_are_seeded_and_need_the_card_by_default():
    cfg = tiny_config(get_arch(VISION))
    shape = ShapeConfig("s", "train", 16, 2)
    a, b = (api.synthetic_inputs(cfg, shape, torch.Generator().manual_seed(9),
                                 device="cpu") for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["patches"].dtype == torch.bfloat16        # the reference's
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            api.synthetic_inputs(cfg, shape, torch.Generator())


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", [VISION, MUSIC])
def test_engine_refuses_patch_and_codebook_archs(arch):
    _, cfg, _, tp = _models(arch)
    with pytest.raises(ValueError, match="model API"):
        ServingEngine(cfg, EngineConfig(max_lanes=2, max_len=32), tp,
                      JetConfig(pool_bytes=1 << 20), device="cpu")
