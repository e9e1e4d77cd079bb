"""The port's int8 compression, AdamW and train step on the CPU against
the reference.

* Compression: blockwise and row-wise int8 codes equal to the
  reference's or off by at most one (a float32 quotient landing on the
  other side of a half), scales within one float32 ulp; zero and extreme
  rows; ``compression_ratio``.
* AdamW: ``schedule`` at the reference test's steps; five updates from
  the same gradients with float32 and int8 moments, parameters within
  1e-6 relative; ``lr`` and ``grad_norm`` within 1e-6; the norm reported
  before clipping.
* The train step: three steps of ``make_train_step`` against the
  reference's jitted step from one carried state (``state_from_jax``),
  with ``accum_steps`` 1 and 2: losses within 1e-5 relative, the same
  ``lr``, ``grad_norm`` within 1e-5 relative.  Parameters are compared
  under an absolute 2 lr a step: AdamW's first steps move a weight by
  about lr times the sign of its gradient, so a gradient within rounding
  of zero may step the other way in one package (|delta| <= 2 lr).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import ARCHS, tiny_config as jtiny
from repro.data.pipeline import for_arch as jfor_arch
from repro.optim import adamw as jadamw
from repro.parallel import compression as jcomp
from repro.parallel.sharding import single_device_ctx
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.train import steps as jsteps
from repro_torch import _tree
from repro_torch.configs import get_arch, tiny_config
from repro_torch.models.convert import state_from_jax
from repro_torch.optim import adamw
from repro_torch.parallel import compression as comp
from repro_torch.train import steps

torch.set_num_threads(1)

OPT_TOL = 1e-6     # AdamW: the same float32 operations in both packages
LOSS_TOL = 1e-5    # a train step's loss, relative


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _ulps(got, want) -> int:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return int(np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64)).max()) \
        if got.size else 0


# --------------------------------------------------------------------------- #
# compression
# --------------------------------------------------------------------------- #
def _arrays():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 300)) * 3).astype(np.float32)
    x[1] = 0.0                                  # a zero row
    x[2, 7] = 3e38                              # an extreme value
    x[3] = rng.standard_normal(300).astype(np.float32) * 1e-30
    x[4, ::2] *= 1e4
    return {"mixed": x, "odd length": x[:, :257].copy(),
            "3-d": (rng.standard_normal((2, 3, 40)) * 0.1).astype(
                np.float32)}


@pytest.mark.parametrize("name", sorted(_arrays()))
@pytest.mark.parametrize("kind", ["blockwise", "rowwise"])
def test_int8_codes_and_scales_match(name, kind):
    x = _arrays()[name]
    quant = {"blockwise": (comp.quantize_int8, jcomp.quantize_int8),
             "rowwise": (comp.quantize_int8_rowwise,
                         jcomp.quantize_int8_rowwise)}[kind]
    q, s = quant[0](torch.from_numpy(x))
    jq, js = quant[1](jnp.asarray(x))
    assert q.dtype == torch.int8 and tuple(q.shape) == jq.shape
    assert tuple(s.shape) == js.shape
    assert np.abs(q.numpy().astype(np.int32)
                  - np.asarray(jq).astype(np.int32)).max() <= 1
    assert _ulps(s.numpy(), js) <= 1
    if kind == "blockwise":
        got = comp.dequantize_int8(q, s, x.shape)
        want = jcomp.dequantize_int8(jq, js, x.shape)
    else:
        got = comp.dequantize_int8_rowwise(q, s)
        want = jcomp.dequantize_int8_rowwise(jq, js)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_rowwise_zero_rows_and_extremes():
    q, s = comp.quantize_int8_rowwise(torch.zeros((4, 8)))
    assert int(q.abs().max()) == 0
    assert float(comp.dequantize_int8_rowwise(q, s).abs().max()) == 0.0
    q, _ = comp.quantize_int8_rowwise(torch.tensor([[1.0, -2.0, 0.5, 2.0]]))
    assert int(q.abs().max()) == 127


@pytest.mark.parametrize("shape", [(7,), (256,), (1000, 3), (4, 4, 300)])
def test_compression_ratio_matches(shape):
    assert comp.compression_ratio(shape) == jcomp.compression_ratio(shape)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #
def test_schedule_matches_at_the_reference_steps():
    o = adamw.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    jo = jadamw.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    for step in (0, 9, 10, 50, 99, 150):
        got = adamw.schedule(torch.tensor(step, dtype=torch.int32), o)
        want = jadamw.schedule(jnp.int32(step), jo)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= OPT_TOL * float(want)
    assert float(adamw.schedule(torch.tensor(0), o)) == pytest.approx(0.1)
    assert float(adamw.schedule(torch.tensor(9), o)) == pytest.approx(1.0)


def _tree_np(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "b": (rng.standard_normal((48,)) * 0.1).astype(np.float32),
            "stack": (rng.standard_normal((3, 8, 16)),
                      rng.standard_normal((3, 16)).astype(np.float32))}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_five_updates_match(int8):
    params = _tree_np(0)
    params["stack"] = tuple(a.astype(np.float32) for a in params["stack"])
    grads = jax.tree.map(lambda a: a * 0.1, _tree_np(1))
    grads["stack"] = tuple(a.astype(np.float32) for a in grads["stack"])
    o = adamw.OptConfig(lr=1e-2, int8_moments=int8, warmup_steps=2)
    jo = jadamw.OptConfig(lr=1e-2, int8_moments=int8, warmup_steps=2)
    tp = _tree.tree_map(torch.from_numpy, params)
    tg = _tree.tree_map(torch.from_numpy, grads)
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray,
                                                             grads)
    st, jst = adamw.init(tp, o), jadamw.init(jp, jo)
    for _ in range(5):
        tp, st, stats = adamw.update(tg, st, tp, o)
        jp, jst, jstats = jadamw.update(jg, jst, jp, jo)
        for k in ("lr", "grad_norm"):
            assert abs(float(stats[k]) - float(jstats[k])) <= \
                OPT_TOL * abs(float(jstats[k]))
    for (path, got), want in zip(_tree.flatten(tp), jax.tree.leaves(jp)):
        assert got.dtype == torch.float32, path
        assert _rel(got.numpy(), want) <= OPT_TOL, path
    # the moments: the same structure, codes and scales
    flat_m = _tree.flatten(st["m"])
    assert [_tree.key(p) for p, _ in flat_m] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jst["m"])[0]]
    for (_, got), want in zip(flat_m, jax.tree.leaves(jst["m"])):
        assert got.dtype == {np.dtype(np.int8): torch.int8,
                             np.dtype(np.float32): torch.float32}[
            np.asarray(want).dtype]
        assert _rel(got.numpy().astype(np.float64), want) <= OPT_TOL
    assert int(st["count"]) == int(jst["count"]) == 5
    assert st["count"].dtype == torch.int32 and st["count"].dim() == 0


def test_update_leaves_its_inputs_and_clips_after_the_norm():
    o = adamw.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    params = {"w": torch.ones(4)}
    st = adamw.init(params, o)
    big = {"w": torch.full((4,), 1e6)}
    new_p, new_st, stats = adamw.update(big, st, params, o)
    assert float(stats["grad_norm"]) > 1e6     # the norm before clipping
    assert torch.equal(params["w"], torch.ones(4))
    assert int(st["count"]) == 0 and int(new_st["count"]) == 1
    # clipped to norm 1: each of the 4 moment entries is (1 - b1) / 2
    torch.testing.assert_close(new_st["m"]["w"],
                               torch.full((4,), 0.1 * 0.5))


def test_int8_moments_track_float32():
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32))}
    grads = {"w": torch.from_numpy((rng.standard_normal((64, 64)) * 0.1
                                    ).astype(np.float32))}
    o32, o8 = adamw.OptConfig(lr=1e-2), adamw.OptConfig(lr=1e-2,
                                                        int8_moments=True)
    p32 = p8 = params
    s32, s8 = adamw.init(params, o32), adamw.init(params, o8)
    for _ in range(5):
        p32, s32, _ = adamw.update(grads, s32, p32, o32)
        p8, s8, _ = adamw.update(grads, s8, p8, o8)
    assert float((p32["w"] - p8["w"]).abs().max()) < \
        0.05 * float(p32["w"].abs().max())
    assert s8["m"]["w"]["q"].dtype == torch.int8
    assert tuple(s8["m"]["w"]["s"].shape) == (64,)


def test_compressed_pod_grads_is_a_mesh_knob():
    """The flag acts only on a mesh with a ``pod`` axis (the reference's
    ``want_pod``): without one the step is the exact step, bit for bit,
    and carries the residuals ``err`` (bfloat16 zeros) unchanged."""
    cfg = dataclasses.replace(tiny_config(get_arch("h2o-danube-1.8b")),
                              num_layers=2)
    exact, flag = adamw.OptConfig(), adamw.OptConfig(compressed_pod_grads=True)
    s0 = steps.init_state(cfg, flag, torch.Generator().manual_seed(0), "cpu")
    assert all(e.dtype == torch.bfloat16 and not e.any()
               for e in _tree.leaves(s0["err"]))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    s1, m1 = steps.make_train_step(cfg, flag)(s0, batch)
    s2, m2 = steps.make_train_step(cfg, exact)(
        {k: v for k, v in s0.items() if k != "err"}, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(
        _tree.leaves(s1["params"]), _tree.leaves(s2["params"])))
    assert s1["err"] is s0["err"]


# --------------------------------------------------------------------------- #
# the train step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,accum", [("h2o-danube-1.8b", 1),
                                        ("h2o-danube-1.8b", 2),
                                        ("llama4-scout-17b-a16e", 1)])
def test_train_steps_match_the_reference(arch, accum):
    jcfg = dataclasses.replace(jtiny(ARCHS[arch]), num_layers=2)
    cfg = dataclasses.replace(tiny_config(get_arch(arch)), num_layers=2)
    lr = 1e-3
    jo = jadamw.OptConfig(lr=lr, warmup_steps=1, total_steps=10)
    o = adamw.OptConfig(lr=lr, warmup_steps=1, total_steps=10)
    jstate = jsteps.init_state(jcfg, jo, jax.random.key(0))
    state = state_from_jax(_np(jstate), cfg, "cpu")
    jstep = jax.jit(jsteps.make_train_step(jcfg, single_device_ctx(), jo,
                                           jnp.float32, accum_steps=accum))
    step = steps.make_train_step(cfg, o, accum_steps=accum)
    data = jfor_arch(jcfg, JShapeConfig("t", "train", 16, 4))
    for i in range(3):
        batch = data.next_batch()
        if accum > 1:
            batch = {k: v.reshape((accum, v.shape[0] // accum)
                                  + v.shape[1:]) for k, v in batch.items()}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert sorted(m) == sorted(jm) == ["grad_norm", "lb_loss", "loss",
                                           "lr", "overflow"]
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            LOSS_TOL * abs(float(jm["loss"]))
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=LOSS_TOL)
        assert float(m["overflow"]) == pytest.approx(float(jm["overflow"]),
                                                     abs=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        for got, want in zip(_tree.leaves(state["params"]),
                             jax.tree.leaves(jstate["params"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=2 * lr * (i + 1))


def test_init_and_abstract_state_have_the_reference_layout():
    cfg = tiny_config(get_arch("h2o-danube-1.8b"))
    jcfg = jtiny(ARCHS["h2o-danube-1.8b"])
    for int8 in (False, True):
        o = adamw.OptConfig(int8_moments=int8)
        got = steps.abstract_state(cfg, o)
        want = jsteps.abstract_state(jcfg, jadamw.OptConfig(
            int8_moments=int8))
        flat = _tree.flatten(got)
        jflat = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [_tree.key(p) for p, _ in flat] == [
            "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p) for p, _ in jflat]
        for (_, t), (_, s) in zip(flat, jflat):
            assert t.device.type == "meta"
            assert tuple(t.shape) == s.shape
            assert str(t.dtype).split(".")[-1] == str(s.dtype)
    state = steps.init_state(cfg, adamw.OptConfig(),
                             torch.Generator().manual_seed(0), "cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


def test_eval_step_matches_the_loss():
    cfg = tiny_config(get_arch("h2o-danube-1.8b"))
    state = steps.init_state(cfg, adamw.OptConfig(),
                             torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "targets": torch.ones((2, 8), dtype=torch.int32)}
    m = steps.make_eval_step(cfg)(state["params"], batch)
    _, want = steps.make_train_step(cfg, adamw.OptConfig())(state, batch)
    assert float(m["loss"]) == float(want["loss"])
    assert not m["loss"].requires_grad
