"""The port's MoE block on the CPU against the reference.

The capacity dispatch (``moe_apply``, the serving path) and the port's
plain version (``moe_dense_ref``) are fed the reference's own expert
weights and the same numpy tokens, and must give what the reference's
``moe_dense_ref`` gives: ``y`` and ``lb_loss`` within 2e-4, ``overflow``
equal, and the same tokens kept.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, tiny_config as jtiny
from repro.models import moe as jmoe
from repro.parallel.sharding import single_device_ctx
from repro_torch.configs import get_arch, tiny_config
from repro_torch.models import moe
from repro_torch.models.convert import tree_from_numpy
from repro_torch.models.layers import mlp_apply

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
JSCOUT = jtiny(ARCHS["llama4-scout-17b-a16e"])
SCOUT = tiny_config(get_arch("llama4-scout-17b-a16e"))
# (mlp, shared expert, capacity factor): 4.0 keeps every token of the
# 2 x 24 batch, 0.5 sends some past their expert's 6 slots
CASES = [("swiglu", True, 4.0), ("swiglu", False, 4.0),
         ("gelu", True, 4.0), ("gelu", False, 4.0),
         ("geglu", True, 4.0), ("swiglu", True, 0.5), ("gelu", False, 0.5)]


def _cfgs(mlp: str, shared: bool):
    kw = dict(mlp=mlp, shared_expert=shared)
    return dataclasses.replace(JSCOUT, **kw), dataclasses.replace(SCOUT, **kw)


def _inputs(jcfg, seed: int, shape=(2, 24)):
    jp = jax.tree.map(np.asarray,
                      jmoe.moe_init(jax.random.key(seed), jcfg))
    x = np.random.default_rng(seed).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    return jp, x


def _recorder(log):
    return lambda idx, keep, margin: log.append(
        (idx.clone(), keep.clone(), margin.clone()))


@pytest.mark.parametrize("mlp,shared,cf", CASES,
                         ids=[f"{m}-{'shared' if s else 'routed'}-cf{c}"
                              for m, s, c in CASES])
def test_dispatch_and_plain_version_match_the_reference(mlp, shared, cf):
    jcfg, cfg = _cfgs(mlp, shared)
    jp, x = _inputs(jcfg, 0)
    tp = tree_from_numpy(jp, "cpu")
    jy, jaux = jmoe.moe_dense_ref(jp, jnp.asarray(x), jcfg, cf)
    routes = []
    for fn in (moe.moe_apply, moe.moe_dense_ref):
        y, aux = fn(tp, torch.from_numpy(x), cfg, cf,
                    on_route=_recorder(routes))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(float(aux["lb_loss"]),
                                   float(jaux["lb_loss"]), **TOL)
        assert float(aux["overflow"]) == float(jaux["overflow"])
    (idx_d, keep_d, m_d), (idx_r, keep_r, m_r) = routes
    assert torch.equal(idx_d, idx_r) and torch.equal(keep_d, keep_r)
    assert torch.equal(m_d, m_r) and bool((m_d >= 0).all())
    assert (float(jaux["overflow"]) > 0) == (cf < 1.0)


def test_overflow_keeps_the_first_tokens_of_each_expert():
    """Past capacity the later tokens of an expert take the escape path:
    they get only the shared expert's output."""
    jcfg, cfg = _cfgs("swiglu", True)
    jp, x = _inputs(jcfg, 1)
    tp = tree_from_numpy(jp, "cpu")
    routes = []
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg, 0.5,
                           on_route=_recorder(routes))
    idx, keep, _ = routes[0]
    c = moe.capacity(0.5, idx.numel(), cfg.num_experts)
    for e in range(cfg.num_experts):
        mine = keep[idx == e]
        assert mine.tolist() == [i < c for i in range(mine.numel())]
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    shared_only = mlp_apply(tp["shared"], xt, cfg.mlp)
    dropped = ~keep
    assert bool(dropped.any())
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model)[dropped].numpy(),
                               shared_only[dropped].numpy(), **TOL)
    assert float(aux["overflow"]) == float(dropped.float().mean())


@pytest.mark.parametrize("lanes", [1, 4, 8])
def test_decode_dispatch_counts_every_lane(lanes):
    """One token a lane: the capacity counts every lane of the step, as
    the reference's does (4 lanes, 16 experts: one slot an expert)."""
    jcfg, cfg = _cfgs("swiglu", True)
    jcfg = dataclasses.replace(jcfg, num_experts=16)
    cfg = dataclasses.replace(cfg, num_experts=16)
    jp, x = _inputs(jcfg, 2, (lanes, 1))
    tp = tree_from_numpy(jp, "cpu")
    ctx = single_device_ctx()
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, ctx)
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert float(aux["overflow"]) == float(jaux["overflow"])
    assert moe.capacity(cfg.capacity_factor, lanes, 16) == \
        jmoe.capacity(jcfg.capacity_factor, lanes, 16) == 1


@pytest.mark.parametrize("cf,n,e", [(1.25, 1024, 16), (1.25, 4, 16),
                                    (1.0, 7, 4), (2.0, 48, 128),
                                    (0.5, 48, 4)])
def test_capacity_matches_the_reference(cf, n, e):
    assert moe.capacity(cf, n, e) == jmoe.capacity(cf, n, e)


def test_router_helpers_match_the_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((40, 6)).astype(np.float32)
    idx, gate, probs = moe._route_top1(torch.from_numpy(logits))
    jidx, jgate, jprobs = jmoe._route_top1(jnp.asarray(logits))
    assert idx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(float(moe._aux_losses(probs, idx, 6)),
                               float(jmoe._aux_losses(jprobs, jidx, 6)),
                               **TOL)


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_expert_ffn_matches_the_reference(mlp):
    jcfg, _ = _cfgs(mlp, False)
    jp, _ = _inputs(jcfg, 4)
    x = np.random.default_rng(4).standard_normal(
        (jcfg.num_experts, 5, jcfg.d_model)).astype(np.float32)
    got = moe._expert_ffn(tree_from_numpy(jp, "cpu"), torch.from_numpy(x),
                          mlp)
    want = jmoe._expert_ffn(jp, jnp.asarray(x), mlp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mlp,shared", [("swiglu", True), ("gelu", False)])
def test_moe_init_has_the_reference_layout(mlp, shared):
    jcfg, cfg = _cfgs(mlp, shared)
    mine = moe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu",
                        lead=(3,))
    theirs = jax.eval_shape(lambda k: jmoe.moe_init(k, jcfg),
                            jax.random.key(0))
    want = jax.tree.map(lambda s: (3,) + s.shape, theirs)
    got = jax.tree.map(lambda t: tuple(t.shape), mine)
    assert got == want
    assert abs(float(mine["router"].std()) - cfg.d_model ** -0.5) < 0.01


# --------------------------------------------------------------------------- #
# the card script's router near-tie check
# --------------------------------------------------------------------------- #
def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _route(idx, keep, margin):
    return (torch.tensor(idx), torch.tensor(keep), torch.tensor(margin))


# (margin of the flipped token in the plain run, position of a token whose
# slot moved, expected cuts, excused): 16 tokens, 3 MoE layers, token 10's
# expert differs at layer 1
ROUTE_CASES = [(None, None, [16, 16, 16, 16], True),
               (5e-5, 12, [16, 16, 10, 10], True),
               (0.5, 12, [16, 16, 10, 10], False),
               (5e-5, 3, [16, 16, 10, 10], False)]


@pytest.mark.parametrize("margin,moved,cuts,excused", ROUTE_CASES,
                         ids=["same", "near-tie", "confident", "slot-before"])
def test_card_route_check_excuses_only_near_ties(margin, moved, cuts,
                                                 excused):
    """``chip_smoke.route_cuts``: a token whose expert differs between the
    kernel and plain prefills is excused only at a plain router margin
    below 1e-4, a token whose slot moved only after it; the rows from the
    flipped token on are left out of later layers."""
    cs = _chip_smoke()
    t = 16
    idx = [i % 4 for i in range(t)]
    plain_margin = [0.5] * t
    if margin is not None:
        plain_margin[10] = margin
    plain = [_route(idx, [True] * t, plain_margin)] * 3
    kidx, kkeep = list(idx), [True] * t
    if margin is not None:
        kidx[10] = (idx[10] + 1) % 4
        kkeep[moved] = False
    kernel = [plain[0], _route(kidx, kkeep, plain_margin), plain[0]]
    got_cuts, report = cs.route_cuts(kernel, plain, t)
    assert got_cuts == cuts
    assert report["routes_excused"] is excused
    assert bool(report["route_flips"]) == (margin is not None)
