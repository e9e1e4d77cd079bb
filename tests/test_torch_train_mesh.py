"""The port's sharded train step on 8 gloo ranks against the reference's
single-device step on the CPU.

The reference's own checks of the sharded step (``tests/multidev_driver.py``:
``distributed_train_step_matches_single_device``,
``accum_microbatching_matches_full_batch``,
``compressed_pod_grads_train_step``, ``moe_arch_distributed_train_step``)
assert that the sharded step equals the single-device step, and the
reference's single-device step runs here, so the port is held to it.  A
module fixture writes the reference's ``init_state`` (``jax.random.key(0)``)
and numpy-seeded batches, starts ``tests/torch_train_mesh_port.py`` (the
port only, 8 spawned ranks) and the training launcher under
``torch.distributed.run``, and computes the reference's figures while they
run.  Tolerances: the loss within 1e-5 relative, the gradient norm within
1e-4 relative, every gathered gradient leaf within 1e-4 of its largest
magnitude, new parameters within the reference check's 5e-3; where a case
reruns a reference check it keeps that check's tiers.

MoE models: a rank's ``lb_loss`` is the one ``moe_ep`` returns on its data
block, the mean over the model ranks of each rank's share of the tokens,
and the sharded loss is the mean over the data blocks of CE + 0.01 *
lb_loss / L.  Its oracle is the mean over the data blocks of ``jax.grad``
of the reference's single-device ``loss_fn`` on each block, with the
reference's dense MoE reporting that same ``lb_loss`` (the reference's
``_route_top1`` and ``_aux_losses`` on each share; y unchanged), at a
capacity factor that drops no token.
"""
import contextlib
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
from repro.optim import adamw as jadamw
from repro.parallel.sharding import single_device_ctx
from repro.train import steps as jsteps
from repro_torch import _tree
from repro_torch.configs import get_arch, tiny_config
from repro_torch.models import transformer
from repro_torch.models.convert import state_from_jax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 480          # the port joins its ranks in 420
CLI_TIMEOUT_S = 300
LOSS_TOL = 1e-5              # relative
NORM_TOL = 1e-4              # relative
GRAD_TOL = 1e-4              # of each leaf's largest magnitude
PARAM_TOL = dict(rtol=5e-3, atol=5e-3)    # the reference check's
ACCUM_TOL = dict(rtol=2e-3, atol=2e-3)    # the reference check's
POD_TOL = dict(rtol=0.1, atol=2e-3)       # the reference check's
MOE_TOL = 2e-4
MOE_AMPLE_CF = 16.0
B, T = 8, 16
ARCH_B, ARCH_T = 4, 32       # the ten archs: one sequence a data block
MOE_ARCHS = ("llama4-maverick-400b-a17b", "llama4-scout-17b-a16e")


def _step(name, arch, mesh, state, data, layers=None, **kw):
    return dict(name=name, arch=arch, layers=layers, mesh=list(mesh),
                state=state, batch=data, **kw)


STEPS = [
    # (a) distributed_train_step_matches_single_device
    _step("chatglm_4x2", "chatglm3-6b", (4, 2), "chatglm", "b8", 2),
    _step("chatglm_2x4", "chatglm3-6b", (2, 4), "chatglm", "b8", 2),
    _step("gemma_8x1", "gemma-7b", (8, 1), "gemma", "b8", 2),
    # (c) accum_microbatching_matches_full_batch
    _step("gemma_2x4", "gemma-7b", (2, 4), "gemma", "b8", 2),
    _step("gemma_2x4_accum4", "gemma-7b", (2, 4), "gemma", "b8", 2,
          accum=4),
    # (d) compressed_pod_grads_train_step
    _step("chatglm_pod_exact", "chatglm3-6b", (2, 2, 2), "chatglm", "b4", 2),
    _step("chatglm_pod", "chatglm3-6b", (2, 2, 2), "chatglm_pod", "b4", 2,
          pod=True),
    # (e) moe_arch_distributed_train_step
    _step("scout_cf16", "llama4-scout-17b-a16e", (4, 2), "scout", "scout",
          2, cf=MOE_AMPLE_CF),
    _step("scout_cf8", "llama4-scout-17b-a16e", (4, 2), "scout", "scout",
          2, cf=8.0),
    # (g) int8 moments
    _step("chatglm_int8", "chatglm3-6b", (4, 2), "chatglm_int8", "b8", 2,
          int8=True),
] + [  # (b) every arch, one step on (4, 2)
    _step(f"arch_{a}", a, (4, 2), f"arch_{a}", f"arch_{a}",
          cf=MOE_AMPLE_CF if a in MOE_ARCHS else None)
    for a in sorted(ARCHS)]
# test_torch_multidev's ample-capacity meshes: name, mesh, experts, fsdp,
# jet, x
MOE = [
    ("moe_ep_equals_dense_ref", (2, 4), 4, False, False, (4, 16)),
    ("moe_ep_jet_staged", (4, 2), 4, True, True, (4, 16)),
    ("moe_ep_fsdp_allgather", (4, 2), 4, True, False, (4, 16)),
    ("moe_ep_decode", (1, 8), 8, False, False, (4, 1)),
]
CASES = {
    "steps": STEPS,
    "moe": [dict(name=n, mesh=list(m), experts=e, shared=True,
                 cf=MOE_AMPLE_CF, fsdp=f, jet=j) for n, m, e, f, j, _ in MOE],
    "gather": dict(arch="chatglm3-6b", layers=2, mesh=[4, 2],
                   state="chatglm", batch="b8"),
    "remat": dict(arch="chatglm3-6b", layers=2, mesh=[4, 2],
                  state="chatglm", batch="b8"),
    "adamw": dict(arch="chatglm3-6b", layers=2, mesh=[4, 2],
                  state="chatglm_int8", int8=True),
    "loop": dict(arch="h2o-danube-1.8b", layers=2, mesh=[4, 2],
                 resume_mesh=[2, 4], steps=6, fault=4, batch=8, seq=16),
}
STATES = {  # name: arch, layers, OptConfig
    "chatglm": ("chatglm3-6b", 2, {}),
    "chatglm_pod": ("chatglm3-6b", 2, {"compressed_pod_grads": True}),
    "chatglm_int8": ("chatglm3-6b", 2, {"int8_moments": True}),
    "gemma": ("gemma-7b", 2, {}),
    "scout": ("llama4-scout-17b-a16e", 2, {}),
    **{f"arch_{a}": (a, None, {}) for a in ARCHS},
}


def _jcfg(arch, layers=None):
    cfg = jtiny(ARCHS[arch])
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _opt(kw):
    return jadamw.OptConfig(lr=1e-3, **kw)


def _batch(rng, cfg, b, t) -> dict:
    out = {"tokens": rng.integers(0, cfg.vocab_size, japi.token_shape(
        cfg, b, t)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.num_patches:
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _batches() -> dict:
    rng = np.random.default_rng(11)
    out = {"b8": _batch(rng, _jcfg("chatglm3-6b", 2), B, T),
           "b4": _batch(rng, _jcfg("chatglm3-6b", 2), 4, T),
           "scout": _batch(rng, _jcfg("llama4-scout-17b-a16e", 2), 4, T)}
    for a in sorted(ARCHS):
        out[f"arch_{a}"] = _batch(rng, _jcfg(a), ARCH_B, ARCH_T)
    return out


def _moe_inputs(rng) -> dict:
    out = {}
    for name, _, experts, _, _, xs in MOE:
        cfg = dataclasses.replace(_jcfg("llama4-scout-17b-a16e"),
                                  num_experts=experts, shared_expert=True)
        shapes = jax.eval_shape(
            lambda: jmoe.moe_init(jax.random.key(0), cfg))
        for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
            key = "/".join(str(p.key) for p in path)
            fan_in = s.shape[-2] if len(s.shape) > 1 else 1
            out[f"moe/{name}/p/{key}"] = (rng.standard_normal(s.shape)
                                          * fan_in ** -0.5).astype(np.float32)
        out[f"moe/{name}/x"] = rng.standard_normal(
            xs + (cfg.d_model,)).astype(np.float32)
        out[f"moe/{name}/w"] = rng.standard_normal(
            xs + (cfg.d_model,)).astype(np.float32)
    return out


def _states() -> dict:
    out = {}
    for name, (arch, layers, kw) in STATES.items():
        s = jsteps.init_state(_jcfg(arch, layers), _opt(kw), jax.random.key(0))
        s = jax.tree.map(np.asarray, s)
        if "err" in s:   # numpy has no bfloat16 of its own; exact in f32
            s["err"] = jax.tree.map(lambda e: e.astype(np.float32), s["err"])
        out[name] = s
    return out


def _adamw_grads(states) -> dict:
    """Numpy-seeded gradients of the int8 AdamW case's parameters."""
    rng = np.random.default_rng(9)
    return {f"adamw/grad/{k}": (rng.standard_normal(v.shape) * 1e-2
                                ).astype(np.float32)
            for k, v in _flat(states[CASES["adamw"]["state"]]["params"])
            .items()}


def _flat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@contextlib.contextmanager
def _share_lb(m: int):
    """The reference's dense MoE with ``lb_loss`` the mean over ``m``
    equal shares of the tokens (``moe_ep``'s figure on one data block)."""
    orig = jmoe.moe_dense_ref

    def dense(params, x, cfg, cap_factor):
        y, aux = orig(params, x, cfg, cap_factor)
        xt = x.reshape(-1, x.shape[-1])
        n = xt.shape[0] // m
        lbs = []
        for r in range(m):
            idx, _, probs = jmoe._route_top1(xt[r * n:(r + 1) * n]
                                             @ params["router"])
            lbs.append(jmoe._aux_losses(probs, idx, cfg.num_experts))
        return y, {**aux, "lb_loss": sum(lbs) / m}
    jmoe.moe_dense_ref = dense
    try:
        yield
    finally:
        jmoe.moe_dense_ref = orig


def _grads(cfg, params, batch, cf, blocks: int, model: int):
    """(loss, grads): ``jax.grad`` of the reference's single-device
    ``loss_fn`` on the whole batch, or for an MoE model the mean over
    ``blocks`` data blocks with the share ``lb_loss`` of ``model`` ranks."""
    ctx = single_device_ctx(moe_capacity_factor=cf)
    fn = jax.jit(jax.value_and_grad(
        lambda p, bb: japi.loss_fn(p, cfg, ctx, bb, jnp.float32)[0]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if not cfg.num_experts:
        loss, g = fn(params, jb)
        return float(loss), _flat(g)
    with _share_lb(model):
        n = batch["targets"].shape[0] // blocks
        parts = [fn(params, {k: v[i * n:(i + 1) * n]
                             for k, v in jb.items()})
                 for i in range(blocks)]
    loss = float(np.mean([float(p[0]) for p in parts]))
    g = jax.tree.map(lambda *xs: sum(xs) / blocks, *[p[1] for p in parts])
    return loss, _flat(g)


# the reference figures each step case is held to
WANT = {"chatglm_4x2": ("grads", "step"), "chatglm_2x4": ("grads", "step"),
        "gemma_8x1": ("grads", "step"), "gemma_2x4": ("grads", "step"),
        "gemma_2x4_accum4": ("step",),
        "chatglm_pod_exact": ("grads", "step"), "scout_cf16": ("grads",),
        "chatglm_int8": ("step",),
        **{f"arch_{a}": ("grads",) for a in ARCHS}}


def _reference(states, batches, inputs) -> dict:
    ref, memo = {}, {}
    jparams = {n: jax.tree.map(jnp.asarray, s["params"])
               for n, s in states.items()}
    for c in STEPS:
        want = WANT.get(c["name"], ())
        cfg = _jcfg(c["arch"], c["layers"])
        opt_cfg = _opt(STATES[c["state"]][2])
        data, blocks = batches[c["batch"]], c["mesh"][-2]
        if len(c["mesh"]) == 3:
            blocks *= c["mesh"][0]
        accum = c.get("accum", 1)
        if "grads" in want:
            key = ("grads", c["state"], c["batch"], c.get("cf"), blocks,
                   c["mesh"][-1] if cfg.num_experts else 1)
            if key not in memo:
                memo[key] = _grads(cfg, jparams[c["state"]], data,
                                   c.get("cf"), blocks, c["mesh"][-1])
            ref[c["name"], "loss"], ref[c["name"], "grads"] = memo[key]
        if "step" in want:
            # the reference's single-device step of the same kind
            key = ("step", c["state"], c["batch"], accum)
            if key not in memo:
                jb = {k: jnp.asarray(v.reshape((accum, v.shape[0] // accum)
                                               + v.shape[1:])
                                     if accum > 1 else v)
                      for k, v in data.items()}
                step = jax.jit(jsteps.make_train_step(
                    cfg, single_device_ctx(), opt_cfg, jnp.float32,
                    accum_steps=accum))
                s1, m1 = step(jax.tree.map(jnp.asarray, states[c["state"]]),
                              jb)
                memo[key] = (float(m1["loss"]), float(m1["grad_norm"]),
                             _flat(s1["params"]), _flat(s1["opt"]))
            (ref[c["name"], "step_loss"], ref[c["name"], "grad_norm"],
             ref[c["name"], "params"], ref[c["name"], "opt"]) = memo[key]
    c = CASES["adamw"]
    st = states[c["state"]]
    flat_g = _adamw_grads(states)
    grads = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(flat_g["adamw/grad/" + "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in p)]),
        st["params"])
    _, new_opt, stats = jadamw.update(
        grads, jax.tree.map(jnp.asarray, st["opt"]),
        jax.tree.map(jnp.asarray, st["params"]),
        _opt(STATES[c["state"]][2]))
    ref["adamw", "opt"] = _flat(new_opt)
    ref["adamw", "grad_norm"] = float(stats["grad_norm"])
    for name, _, experts, _, _, _ in MOE:
        cfg = dataclasses.replace(_jcfg("llama4-scout-17b-a16e"),
                                  num_experts=experts, shared_expert=True)
        pre = f"moe/{name}/p/"
        params = {}
        for k in inputs:
            if k.startswith(pre):
                *head, leaf = k[len(pre):].split("/")
                d = params
                for h in head:
                    d = d.setdefault(h, {})
                d[leaf] = jnp.asarray(inputs[k])
        x, w = (jnp.asarray(inputs[f"moe/{name}/{n}"]) for n in "xw")

        def f(p, xx):
            y, _ = jmoe.moe_dense_ref(p, xx, cfg, MOE_AMPLE_CF)
            return jnp.sum(y * w)
        gp, gx = jax.grad(f, argnums=(0, 1))(params, x)
        ref["moe", name] = {"dx": np.asarray(gx), **{
            f"grad/{k}": v for k, v in _flat(gp).items()}}
    return ref


def _launch(work: Path, mesh: str, nproc: int) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--arch", "h2o-danube-1.8b",
            "--tiny", "--device", "cpu", "--steps", "10", "--batch", "4",
            "--seq", "16", "--mesh", mesh,
            "--ckpt-dir", str(work / f"cli_{mesh}"), "--ckpt-every", "100"]
    if nproc > 1:
        args = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(nproc)] + args
    log = open(work / f"cli_{mesh}.log", "w")
    return subprocess.Popen([sys.executable] + args, env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=str(work)), log


def _wait(proc, log, limit_s, what, path):
    try:
        rc = proc.wait(timeout=max(1.0, limit_s))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    log.close()
    text = Path(path).read_text()
    assert rc == 0, f"{what} failed ({rc}):\n{text[-6000:]}"
    return text


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_mesh")
    states, batches = _states(), _batches()
    inputs = _moe_inputs(np.random.default_rng(5))
    for name, bt in batches.items():
        inputs.update({f"batch/{name}/{k}": v for k, v in bt.items()})
    inputs.update(_adamw_grads(states))
    np.savez(work / "inputs.npz", **inputs)
    with open(work / "states.pkl", "wb") as f:
        pickle.dump(states, f)
    (work / "cases.json").write_text(json.dumps(CASES))
    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = open(work / "port.log", "w")
    port = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_train_mesh_port.py"),
         str(work)], env=env, stdout=log, stderr=subprocess.STDOUT)
    clis = [(_launch(work, m, n), m) for m, n in (("2x2", 4), ("1x1", 1))]
    try:
        ref = _reference(states, batches, inputs)
    finally:
        _wait(port, log, RUN_TIMEOUT_S - (time.monotonic() - t0), "port",
              work / "port.log")
        cli = {m: _wait(p, lg, CLI_TIMEOUT_S - (time.monotonic() - t0),
                        f"launch.train --mesh {m}", work / f"cli_{m}.log")
               for (p, lg), m in clis}
    port_out = [dict(np.load(work / f"port_rank{r}.npz")) for r in range(8)]
    return ref, port_out, cli, states


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _prefixed(out: dict, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


def _check_grads(port0, ref, name):
    got = _prefixed(port0, f"{name}/grads")
    want = ref[name, "grads"]
    assert sorted(got) == sorted(want)
    worst = {k: _rel(got[k], want[k]) for k in want}
    assert max(worst.values()) <= GRAD_TOL, worst


def _check_loss(port, ref, name, key="loss"):
    losses = {float(o[f"{name}/loss"]) for o in port}
    assert len(losses) == 1, losses          # every rank holds the same
    want = ref[name, key]
    assert abs(losses.pop() - want) <= LOSS_TOL * abs(want)


@pytest.mark.parametrize("name", ["chatglm_4x2", "chatglm_2x4",
                                  "gemma_8x1"])
def test_distributed_step_matches_single_device(runs, name):
    """(a): loss, gradient norm, every gathered gradient leaf and the new
    parameters against the reference's single-device step; on (2, 4)
    chatglm3's 2 KV heads do not divide the 4 model ranks."""
    ref, port, _, _ = runs
    _check_loss(port, ref, name)
    _check_loss(port, ref, name, "step_loss")
    assert abs(float(port[0][f"{name}/grad_norm"]) - ref[name, "grad_norm"]
               ) <= NORM_TOL * ref[name, "grad_norm"]
    _check_grads(port[0], ref, name)
    got = _prefixed(port[0], f"{name}/params")
    for k, want in ref[name, "params"].items():
        np.testing.assert_allclose(got[k], want, **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_one_sharded_step(runs, arch):
    """(b): each tiny arch, one step on (4, 2): SSM, xLSTM,
    cross-attention, codebooks and MoE under EP included."""
    ref, port, _, _ = runs
    name = f"arch_{arch}"
    _check_loss(port, ref, name)
    _check_grads(port[0], ref, name)
    assert np.isfinite(float(port[0][f"{name}/grad_norm"]))


def test_accum_microbatching_matches_full_batch(runs):
    """(c): accum 4 on (2, 4) against the full batch (the reference
    check's 2e-3), each against the reference's single-device step of the
    same kind."""
    ref, port, _, _ = runs
    full, acc = "gemma_2x4", "gemma_2x4_accum4"
    p0 = port[0]
    assert abs(float(p0[f"{full}/loss"]) - float(p0[f"{acc}/loss"])) < 2e-3
    pf, pa = (_prefixed(p0, f"{n}/params") for n in (full, acc))
    for k in pf:
        np.testing.assert_allclose(pa[k], pf[k], **ACCUM_TOL, err_msg=k)
    for n in (full, acc):
        _check_loss(port, ref, n, "step_loss")
        got = _prefixed(p0, f"{n}/params")
        for k, want in ref[n, "params"].items():
            np.testing.assert_allclose(got[k], want, **PARAM_TOL,
                                       err_msg=k)
    _check_grads(p0, ref, full)


def test_compressed_pod_grads_train_step(runs):
    """(d): on (2, 2, 2) the compressed step within the reference check's
    tiers of the exact one; the residuals finite, nonzero and fed back in
    step 2; the exact step within (a)'s tiers of the reference."""
    ref, port, _, _ = runs
    ex, cp = "chatglm_pod_exact", "chatglm_pod"
    p0 = port[0]
    assert abs(float(p0[f"{ex}/loss"]) - float(p0[f"{cp}/loss"])) < 2e-2
    pe, pc = (_prefixed(p0, f"{n}/params") for n in (ex, cp))
    for k in pe:
        np.testing.assert_allclose(pc[k], pe[k], **POD_TOL, err_msg=k)
    err = _prefixed(p0, f"{cp}/err")
    assert err and all(np.isfinite(e).all() for e in err.values())
    assert max(float(np.abs(e).max()) for e in err.values()) > 0
    assert float(p0[f"{cp}/fed_back_diff"]) > 0
    assert all(np.isfinite(float(o[f"{cp}/loss2"])) for o in port)
    _check_loss(port, ref, ex)
    _check_grads(p0, ref, ex)
    got = _prefixed(p0, f"{ex}/params")
    for k, want in ref[ex, "params"].items():
        np.testing.assert_allclose(got[k], want, **PARAM_TOL, err_msg=k)


def test_moe_arch_trains_under_expert_parallelism(runs):
    """(e): tiny scout on (4, 2).  At capacity factor 16 no block drops a
    token and the gradients are the mean over the 4 data blocks of the
    reference's (module docstring); at 8 the loss is finite (the
    reference check's assertion)."""
    ref, port, _, _ = runs
    _check_loss(port, ref, "scout_cf16")
    _check_grads(port[0], ref, "scout_cf16")
    assert float(port[0]["scout_cf16/overflow"]) == 0.0
    assert all(np.isfinite(float(o["scout_cf8/loss"])) for o in port)


@pytest.mark.parametrize("name", [m[0] for m in MOE])
def test_moe_ep_backward_matches_dense_ref(runs, name):
    """(f): ``moe_ep`` forward and backward of sum(y * w) against
    ``jax.grad`` of the reference's ``moe_dense_ref``: dx, the router,
    the expert stacks and the shared expert within 2e-4 of each one's
    largest magnitude."""
    ref, port, _, _ = runs
    want = ref["moe", name]
    got = _prefixed(port[0], f"moe/{name}")
    assert sorted(got) == sorted(want)
    worst = {k: _rel(got[k], want[k]) for k in want}
    assert max(worst.values()) <= MOE_TOL, worst


def test_int8_moments_row_scales_over_blocks(runs):
    """(g): int8 moments on (4, 2).  One AdamW update of the blocks from
    the same gradients as the reference's single-device update: the row
    scales within 1e-6 relative and the codes within one step (a row's
    max over the whole row, all-reduced over the ranks that hold it).
    The full int8 train step: new parameters at (a)'s tier, scales at its
    gradient tier (the moments carry the gradients' rounding), codes
    within one step."""
    ref, port, _, _ = runs
    assert abs(float(port[0]["adamw/grad_norm"]) - ref["adamw", "grad_norm"]
               ) <= 1e-6 * ref["adamw", "grad_norm"]
    for prefix, want, scale_tol in (
            ("adamw/opt", ref["adamw", "opt"], 1e-6),
            ("chatglm_int8/opt", ref["chatglm_int8", "opt"], GRAD_TOL)):
        got = _prefixed(port[0], prefix)
        scales = [k for k in want if k.endswith("/s")]
        # a leaf whose rows are cut over the model ranks is among them
        assert any(k.endswith("attn/wq/s") for k in scales)
        for k in want:
            if k.endswith("/s"):
                assert _rel(got[k], want[k]) <= scale_tol, (prefix, k)
            elif k.endswith("/q"):
                assert np.abs(got[k].astype(np.int32)
                              - want[k].astype(np.int32)).max() <= 1, k
    got = _prefixed(port[0], "chatglm_int8/params")
    for k, want in ref["chatglm_int8", "params"].items():
        np.testing.assert_allclose(got[k], want, **PARAM_TOL, err_msg=k)


def test_bf16_weight_gather_casts_before_the_gather(runs):
    """(h): the bfloat16 forward's loss is bit-equal with the cast before
    or after the gathers; before, every gather of a pattern unit's block
    moves bfloat16, and only the embedding's and the unembedding's
    (gathered whole over data and model, in float32 as the reference
    keeps them) move float32."""
    _, port, _, _ = runs
    for out in port:
        assert np.array_equal(out["gather/first/loss"],
                              out["gather/after/loss"])
        after, first = out["gather/after/dtypes"], out["gather/first/dtypes"]
        assert len(after) == len(first)
        assert set(after) == {"float32"}
        assert list(first).count("float32") == 4
        assert list(first).count("bfloat16") == len(first) - 4 > 0


def test_remat_layer_out_equals_full_on_a_mesh(runs):
    """(i) on (4, 2): ``remat="layer_out"`` bitwise equal to ``"full"``."""
    _, port, _, _ = runs
    for out in port:
        assert np.array_equal(out["remat/full/loss"],
                              out["remat/layer_out/loss"])
        full = _prefixed(out, "remat/full/grads")
        lo = _prefixed(out, "remat/layer_out/grads")
        assert full and all(np.array_equal(full[k], lo[k]) for k in full)


def test_remat_layer_out_equals_full_without_a_mesh():
    """(i) on no mesh, as in the reference: bitwise equal to ``"full"``."""
    cfg = tiny_config(get_arch("llama4-scout-17b-a16e"))
    jcfg = jtiny(ARCHS["llama4-scout-17b-a16e"])
    params = state_from_jax(jax.tree.map(np.asarray, jsteps.init_state(
        jcfg, jadamw.OptConfig(), jax.random.key(0))), cfg, "cpu")["params"]
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng, jcfg, 2, 16)
             .items()}
    out = {}
    for remat in ("full", "layer_out"):
        live = [p.clone().requires_grad_(True)
                for p in _tree.leaves(params)]
        loss, _ = transformer.loss_fn(_tree.unflatten(params, live), cfg,
                                      batch, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, live))
    assert torch.equal(out["full"][0], out["layer_out"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["full"][1],
                                                 out["layer_out"][1]))


def test_loop_fault_and_elastic_resume(runs):
    """(j): ``loop.run`` on (4, 2) with a fault at step 4, resumed on
    (4, 2) and on (2, 4): the final loss within 1e-5 of straight
    through."""
    _, port, _, _ = runs
    for out in port:
        straight = out["loop/straight"]
        assert list(out["loop/final_steps"]) == [6, 6, 6]
        for run in ("resumed", "elastic"):
            got = out[f"loop/{run}"]
            assert len(got) == 2           # steps 5 and 6 after the resume
            assert abs(got[-1] - straight[-1]) <= 1e-5 * abs(straight[-1])
        assert np.isfinite(straight).all() and len(straight) == 6


def _cli_losses(text: str, step: int = 10) -> list:
    """The losses logged for ``step``: one line a printing rank.  A step
    slower than the straggler monitor's limit logs a line of its own as
    well, which depends on the machine's load, so only ``step``'s count."""
    return [float(line.split()[3]) for line in text.splitlines()
            if line.startswith("step ") and int(line.split()[1]) == step]


def test_launch_train_mesh_matches_one_process(runs):
    """(k): ``launch.train --mesh 2x2`` on 4 gloo ranks through
    ``torch.distributed.run``: the logged loss within 1e-5 of ``--mesh
    1x1``; rank 0 alone prints."""
    _, _, cli, _ = runs
    mesh, one = _cli_losses(cli["2x2"]), _cli_losses(cli["1x1"])
    assert len(mesh) == len(one) == 1
    assert abs(mesh[0] - one[0]) <= 1e-5 * abs(one[0])
    assert cli["2x2"].count("final step 10") == 1
    assert "mesh 2x2, cpu" in cli["2x2"]
