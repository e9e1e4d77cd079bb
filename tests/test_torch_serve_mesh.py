"""The port's prefill and decode over a process mesh on 8 gloo ranks
against the reference's single-device ``prefill`` / ``decode_step`` on
the CPU.

The reference serves on a mesh by placing global arrays (GSPMD); what it
computes is its single-device function, which runs here.  A module
fixture writes each case's prompt (numpy, seeded) and the reference's
parameters (``jax.random.key(0)``, carried across with
``models.convert``), starts ``tests/torch_serve_mesh_port.py`` (the port
only, 8 spawned ranks, one thread each) and computes the reference's
prefill and greedy decode while it runs.  Each case prefills and decodes
``STEPS`` greedy tokens (the argmax, tiled over a codebook model's
codebooks); the prefill's and every step's logits, gathered whole on
rank 0, and the final state, gathered by
``models.decoding.decode_state_specs``, must lie within ``MODEL_TOL``
(2e-3 of each one's largest magnitude, ``tests/test_torch_model_api.py``'s
tier) of the reference's, and the greedy tokens must be equal.  A mesh
of one rank must give ``ctx=None``'s logits, tokens and state bit for
bit.  Float32 throughout; the MoE at a capacity factor that drops no
token.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, tiny_config as jtiny
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.parallel.sharding import single_device_ctx
from repro_torch.configs import get_arch, tiny_config
from repro_torch.kernels import ref as kref
from repro_torch.models import decoding
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import Mesh, P, ParallelCtx

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 360          # the port joins its ranks in 300
MODEL_TOL = 2e-3             # of each tensor's largest magnitude
STEPS = 6
MOE_AMPLE_CF = 16.0


def _case(name, arch, mesh, b, t, max_len, replace=None, ctx=None):
    return dict(name=name, arch=arch, mesh=list(mesh), b=b, t=t,
                max_len=max_len, steps=STEPS, replace=replace or {},
                ctx=ctx or {}, params=f"{arch}/{json.dumps(replace or {})}")


MESH_CASES = [
    # window 64 over 4 model ranks (16 slots a rank): decode writes slots
    # 62, 63, then 0-3, crossing from rank 3's block to rank 0's
    _case("danube_2x4", "h2o-danube-1.8b", (2, 4), 4, 62, 80),
    # a 70-token prompt rolls the 64-slot ring before it is split
    _case("danube_4x2", "h2o-danube-1.8b", (4, 2), 4, 70, 80),
    # Mamba2 states batch-split, the shared attention's 32 slots split 4
    # ways: ranks 2 and 3 start with no valid slot (rank 3 keeps none)
    _case("zamba2_2x4", "zamba2-1.2b", (2, 4), 4, 16, 32),
    _case("xlstm_4x2", "xlstm-125m", (4, 2), 4, 16, 24),
    # 8 experts over 8 model ranks (the prefill's all-to-all body, the
    # decode body); 4 query heads on 8 ranks: attention unsplit
    _case("scout_1x8", "llama4-scout-17b-a16e", (1, 8), 2, 16, 24,
          replace={"num_experts": 8},
          ctx={"moe_capacity_factor": MOE_AMPLE_CF}),
    # 2 KV heads on 4 model ranks (projected whole); xkv batch-split
    _case("vision_2x4", "llama-3.2-vision-11b", (2, 4), 4, 16, 24),
    _case("musicgen_2x4", "musicgen-large", (2, 4), 4, 16, 24),
    # a batch of 1 replicated over pod and data; slots over model
    _case("chatglm_batch1_2x2x2", "chatglm3-6b", (2, 2, 2), 1, 20, 40),
    _case("danube_no_seq_parallel_2x4", "h2o-danube-1.8b", (2, 4), 4, 62,
          80, ctx={"seq_parallel_decode": False}),
]
ONE_RANK = [_case("danube_one_rank", "h2o-danube-1.8b", (1, 1), 2, 62, 80)]
# moe_ep's decode body alone, one token a lane, 6 lanes a data block over
# 4 model ranks: 8 experts, one slot each (capacity factor 1) or plenty
MOE_DECODE = [dict(name=f"moe_decode_cf{cf:g}", arch="llama4-scout-17b-a16e",
                   replace={"num_experts": 8}, mesh=[2, 4], b=12, cf=cf)
              for cf in (1.0, MOE_AMPLE_CF)]
MOE_TOL = 2e-4               # tests/test_torch_moe.py's


def _jcfg(c):
    return dataclasses.replace(jtiny(ARCHS[c["arch"]]), **c["replace"])


def _inputs() -> dict:
    rng = np.random.default_rng(17)
    out = {}
    for c in MESH_CASES + ONE_RANK:
        cfg = _jcfg(c)
        out[f"{c['name']}/tokens"] = rng.integers(
            0, cfg.vocab_size, japi.token_shape(cfg, c["b"], c["t"])
        ).astype(np.int32)
        if cfg.num_patches:
            out[f"{c['name']}/patches"] = rng.standard_normal(
                (c["b"], cfg.num_patches, cfg.d_model)).astype(np.float32)
    for c in MOE_DECODE:
        out[f"{c['name']}/x"] = rng.standard_normal(
            (c["b"], 1, _jcfg(c).d_model)).astype(np.float32)
    return out


def _params() -> dict:
    out = {}
    for c in MESH_CASES + ONE_RANK:
        if c["params"] not in out:
            out[c["params"]] = jax.tree.map(np.asarray, japi.init_params(
                _jcfg(c), jax.random.key(0)))
    for c in MOE_DECODE:
        out[c["name"]] = jax.tree.map(np.asarray, jmoe.moe_init(
            jax.random.key(1), _jcfg(c)))
    return out


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reference(c, inputs, params) -> dict:
    """The reference's single-device prefill and greedy decode of case
    ``c``: logits of each, the tokens fed, the final state."""
    cfg = _jcfg(c)
    ctx = single_device_ctx(moe_capacity_factor=c["ctx"].get(
        "moe_capacity_factor"))
    jp = jax.tree.map(jnp.asarray, params[c["params"]])
    tok = jnp.asarray(inputs[f"{c['name']}/tokens"])
    patches = inputs.get(f"{c['name']}/patches")
    pre = jax.jit(lambda p, t, x: japi.prefill(
        p, cfg, ctx, t, x, max_len=c["max_len"], compute_dtype=jnp.float32))
    step = jax.jit(lambda p, s, t, n: japi.decode_step(
        p, cfg, ctx, s, t, n, compute_dtype=jnp.float32))
    logits, state, lengths = pre(jp, tok, None if patches is None
                                 else jnp.asarray(patches))
    seen, fed = [np.asarray(logits)], []
    for _ in range(c["steps"]):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        if cfg.num_codebooks:
            nxt = jnp.tile(nxt[:, None], (1, cfg.num_codebooks))
        fed.append(np.asarray(nxt))
        logits, state = step(jp, state, nxt, lengths)
        lengths = lengths + 1
        seen.append(np.asarray(logits))
    return {"logits": seen, "tokens": np.stack(fed), "state": _flat(state)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("serve_mesh")
    inputs, params = _inputs(), _params()
    np.savez(work / "inputs.npz", **inputs)
    with open(work / "params.pkl", "wb") as f:
        pickle.dump(params, f)
    (work / "cases.json").write_text(json.dumps(
        {"mesh": MESH_CASES, "one_rank": ONE_RANK, "moe_decode": MOE_DECODE}))
    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = open(work / "port.log", "w")
    port = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_serve_mesh_port.py"),
         str(work)], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        ref = {c["name"]: _reference(c, inputs, params)
               for c in MESH_CASES + ONE_RANK}
    finally:
        try:
            rc = port.wait(timeout=max(1.0, RUN_TIMEOUT_S
                                       - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            port.kill()
            port.wait()
            rc = "timeout"
        log.close()
    text = (work / "port.log").read_text()
    assert rc == 0, f"the port's ranks failed ({rc}):\n{text[-6000:]}"
    return ref, dict(np.load(work / "port.npz")), inputs, params


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _prefixed(out: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


def _check(port: dict, ref: dict, name: str) -> None:
    for i, want in enumerate(ref["logits"]):
        got = port[f"{name}/logits/{i}"]
        assert got.shape == want.shape
        assert _rel(got, want) <= MODEL_TOL, (name, i, _rel(got, want))
    assert np.array_equal(port[f"{name}/tokens"], ref["tokens"]), name
    got = _prefixed(port, f"{name}/state")
    assert sorted(got) == sorted(ref["state"]), name
    worst = {k: _rel(got[k], v) for k, v in ref["state"].items()
             if np.abs(v).max() > 0}
    assert max(worst.values()) <= MODEL_TOL, (name, worst)


@pytest.mark.parametrize("name", [c["name"] for c in MESH_CASES])
def test_sharded_serve_matches_the_reference(runs, name):
    ref, port, _, _ = runs
    _check(port, ref[name], name)


@pytest.mark.parametrize("name", [c["name"] for c in ONE_RANK])
def test_one_rank_mesh_is_the_unsharded_path_bit_for_bit(runs, name):
    ref, port, _, _ = runs
    _check(port, ref[name], name)
    mesh, one = _prefixed(port, name), _prefixed(port, name + "/unsharded")
    shared = [k for k in mesh if not k.startswith("unsharded/")]
    assert sorted(shared) == sorted(one)
    for k in shared:
        assert np.array_equal(mesh[k], one[k]), k


@pytest.mark.parametrize("c", MOE_DECODE, ids=[c["name"] for c in MOE_DECODE])
def test_moe_ep_decode_body_matches_the_reference(runs, c):
    """``moe_ep``'s decode body (every model rank routes the block's lanes
    and serves its experts' share; the combine is a sum): y within
    ``MOE_TOL`` of the reference's single-device MoE on each data block,
    whose capacity counts every lane of the block, and each block's
    ``lb_loss`` and ``overflow`` that block's figures; at capacity factor
    1 some block drops a token."""
    _, port, inputs, params = runs
    cfg = _jcfg(c)
    params = jax.tree.map(jnp.asarray, params[c["name"]])
    x = inputs[f"{c['name']}/x"]
    n = c["b"] // c["mesh"][0]
    ys, figs = [], []
    for i in range(c["mesh"][0]):
        y, aux = jmoe.moe_dense_ref(params, jnp.asarray(x[i * n:(i + 1) * n]),
                                    cfg, c["cf"])
        ys.append(np.asarray(y))
        figs.append([float(aux["lb_loss"]), float(aux["overflow"])])
    assert _rel(port[f"{c['name']}/y"], np.concatenate(ys)) <= MOE_TOL
    got, want = port[f"{c['name']}/figures"], np.array(figs)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5)
    assert np.abs(got[:, 1] - want[:, 1]).max() <= 1e-7, (got, want)
    if c["cf"] < MOE_AMPLE_CF:
        assert want[:, 1].max() > 0
    else:
        assert want[:, 1].max() == 0


# --------------------------------------------------------------------------- #
# the layout rule and the empty block, no ranks
# --------------------------------------------------------------------------- #
def _shapes_ctx(shape, axes=("data", "model"), **kw) -> ParallelCtx:
    return ParallelCtx(mesh=Mesh(axes, shape),
                       data_axes=tuple(a for a in axes if a != "model"), **kw)


@pytest.mark.parametrize("arch,b,want_kv,want_other", [
    ("zamba2-1.2b", 4, P(None, "data", "model", None, None),
     P(None, "data", None, None)),
    ("zamba2-1.2b", 1, P(None, None, "model", None, None),
     P(None, None, None, None)),
    ("llama-3.2-vision-11b", 4, P(None, "data", "model", None, None),
     P(None, "data", None, None, None))])
def test_decode_state_specs_rule(arch, b, want_kv, want_other):
    """KV caches by ``kv_cache_spec``, every other leaf by its batch; a
    batch no data prefix divides is replicated.  zamba2's ``other`` is
    the conv state; vision's the patch K/V."""
    cfg = tiny_config(get_arch(arch))
    state = decoding.init_decode_state(cfg, b, 32, torch.float32, "meta")
    specs = decoding.decode_state_specs(state, _shapes_ctx((2, 4)))
    layer = len(specs["pattern"]) - 1
    assert specs["pattern"][layer]["kv"] == (want_kv, want_kv)
    other = specs["pattern"][layer]["mamba" if "mamba" in
                                    specs["pattern"][layer] else "xkv"][0]
    assert other == want_other


def test_decode_state_specs_without_seq_parallel():
    cfg = tiny_config(get_arch("h2o-danube-1.8b"))
    state = decoding.init_decode_state(cfg, 4, 64, torch.float32, "meta")
    on = decoding.decode_state_specs(state, _shapes_ctx((2, 4)))
    off = decoding.decode_state_specs(
        state, _shapes_ctx((2, 4), seq_parallel_decode=False))
    assert on["pattern"][0]["kv"][0] == P(None, "data", "model", None, None)
    assert off["pattern"][0]["kv"][0] == P(None, "data", None, None, None)
    # 64 slots do not split over 6 model ranks: whole
    six = decoding.decode_state_specs(state, _shapes_ctx((2, 6)))
    assert six["pattern"][0]["kv"][0] == P(None, "data", None, None, None)


def test_an_empty_slot_block_weighs_nothing_in_the_combine(monkeypatch):
    """A block with no valid slot: the plain decode gives lse = -1e30 +
    log(S/m) and o = the mean of v; ``srq_combine`` over it and a block
    with a valid slot (its all-gathers replaced by the two ranks' stacked
    blocks) gives the valid block's o exactly, from either rank, in
    either order."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 32, generator=g)
    k, v = (torch.randn(2, 8, 2, 32, generator=g) for _ in range(2))
    o0, lse0 = kref.decode_attention_naive(q, k, v, torch.zeros(2).int())
    o1, lse1 = kref.decode_attention_naive(q, k, v, torch.full((2,), 3))
    assert torch.allclose(o0, v.mean(1).repeat_interleave(2, 1))
    assert torch.allclose(lse0, torch.full_like(lse0, -1e30 + np.log(8)))
    for ranks in (((o0, lse0), (o1, lse1)), ((o1, lse1), (o0, lse0))):
        gathered = {3: torch.stack([o for o, _ in ranks]),
                    2: torch.stack([lse for _, lse in ranks])}
        monkeypatch.setattr(collectives, "all_gather",
                            lambda x, group, tiled: gathered[x.dim()])
        for o, lse in ranks:
            assert torch.equal(collectives.srq_combine(o, lse, None), o1)
