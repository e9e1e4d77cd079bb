"""The port's distribution layer on 8 gloo ranks against the reference's
on 8 host CPU devices.

A module fixture writes numpy-seeded inputs and a one-process checkpoint
(the reference's ``init_state`` and ``ckpt.save``), then runs
``tests/torch_multidev_ref.py`` (the JAX package only, the meshes of its
own multi-device checks) and ``tests/torch_multidev_port.py`` (the port
only, 8 spawned ranks) side by side, each under a time limit.  Each case
below holds one check; where it reruns a reference check
(``tests/multidev_driver.py``) it keeps that check's tolerance, and
counts, codes and kept sets are held exactly:

* the MoE under expert parallelism (``moe_ep``): equal to the dense
  oracle with ample capacity on a (2, 4) data x model mesh, through the
  staged expert FFN (FSDP shards on a ring over ``data``) and through the
  plain FSDP all-gather on (4, 2), past capacity, in the decode body (4
  lanes x 1 token over 8 model ranks), and past capacity at 4 model
  ranks with no shared expert (overflow and the kept set exact).  Each
  rank's block of y against the reference's, and its ``lb_loss`` /
  ``overflow`` against the reference device's own (its data block's;
  data coordinate 0's is what the reference hands back);
* the staged collectives on rings of 8 and 4;
* GPipe over a 2-stage ``pod`` axis, forward and stage gradients, against
  the reference's sequential stack and ``jax.grad`` of it;
* ``compressed_psum`` over 4 ranks, two rounds of error feedback;
* elastic restore of the checkpoint onto a 2 x 4 mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import ARCHS, tiny_config as jtiny
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.launch.mesh import ctx_for_mesh
from repro_torch.parallel.sharding import Mesh, P

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 300          # each side; the port joins its ranks in 240
MOE_TOL = dict(rtol=2e-4, atol=2e-4)      # the reference checks'
D = 128                                   # tiny scout's d_model
MOE = [  # name, mesh (data, model), experts, shared, cf, fsdp, jet, x
    ("moe_ep_equals_dense_ref", (2, 4), 4, True, 16.0, False, False,
     (4, 16)),
    ("moe_ep_jet_staged_matches_dense_ref", (4, 2), 4, True, 16.0, True,
     True, (4, 16)),
    ("moe_ep_capacity_escape", (2, 4), 4, True, 0.3, False, False, (4, 16)),
    ("moe_ep_fsdp_allgather", (4, 2), 4, True, 16.0, True, False, (4, 16)),
    ("moe_ep_decode", (1, 8), 8, True, 16.0, False, False, (4, 1)),
    ("moe_ep_overflow_4_ranks", (2, 4), 4, False, 0.5, False, False,
     (4, 16)),
]
CASES = {
    "moe": [dict(name=n, mesh=list(m), experts=e, shared=s, cf=cf, fsdp=f,
                 jet=j) for n, m, e, s, cf, f, j, _ in MOE],
    "rings": {"ring": 8, "frags": 2, "window": 4},
    "srq": {"ranks": 4},
    "gpipe": {"stages": 2},
    "cpsum": {"ranks": 4},
    "elastic": {"arch": "gemma-7b", "layers": 2, "mesh": [2, 4]},
}


def _moe_inputs(rng, name, experts, shared, xshape) -> dict:
    cfg = dataclasses.replace(jtiny(ARCHS["llama4-scout-17b-a16e"]),
                              num_experts=experts, shared_expert=shared)
    shapes = jax.eval_shape(lambda: jmoe.moe_init(jax.random.key(0), cfg))
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(p.key) for p in path)
        fan_in = s.shape[-2] if len(s.shape) > 1 else 1
        out[f"moe/{name}/p/{key}"] = (rng.standard_normal(s.shape)
                                      * fan_in ** -0.5).astype(np.float32)
    out[f"moe/{name}/x"] = rng.standard_normal(xshape + (D,)).astype(
        np.float32)
    return out


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    inp = {}
    for name, _, e, s, _, _, _, xs in MOE:
        inp.update(_moe_inputs(rng, name, e, s, xs))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp.update({"ring_ag/x": f32(16, 64), "ring_ag/w": f32(64, 32),
                "ring_rs/y": f32(8, 16, 64), "win_ag/x": f32(64, 8),
                "srq/q": f32(2, 2, 8), "srq/k": f32(2, 32, 2, 8),
                "srq/v": f32(2, 32, 2, 8),
                "gpipe/w": f32(6, 16, 16) * 16 ** -0.5,
                "gpipe/x": f32(4, 8, 16),
                "cpsum/g1": f32(4, 512), "cpsum/g2": f32(4, 512)})
    return inp


def _run(script: str, work: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    log = open(work / f"{script}.log", "w")
    return subprocess.Popen([sys.executable, str(ROOT / "tests" / script),
                             str(work)], env=env, stdout=log,
                            stderr=subprocess.STDOUT), log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("multidev")
    np.savez(work / "inputs.npz", **_inputs())
    (work / "cases.json").write_text(json.dumps(CASES))
    el = CASES["elastic"]
    cfg = dataclasses.replace(jtiny(ARCHS[el["arch"]]),
                              num_layers=el["layers"])
    state = jsteps.init_state(cfg, jadamw.OptConfig(), jax.random.key(0))
    jckpt.save(state, str(work / "ckpt"), step=7, extra={"step": 7})
    t0 = time.monotonic()
    started = [_run(s, work) for s in ("torch_multidev_ref.py",
                                       "torch_multidev_port.py")]
    for (proc, log), script in zip(started, ("ref", "port")):
        try:
            rc = proc.wait(timeout=max(1.0, RUN_TIMEOUT_S
                                       - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        text = (work / f"torch_multidev_{script}.py.log").read_text()
        assert rc == 0, f"{script} side failed ({rc}):\n{text[-6000:]}"
    ref = dict(np.load(work / "ref_out.npz"))
    port = [dict(np.load(work / f"port_rank{r}.npz")) for r in range(8)]
    return ref, port


def _moe(name):
    return next(m for m in MOE if m[0] == name)


def _block(full, mesh, coords, b):
    """Rank ``coords``' block of the reference's full y (batch over the
    data axis where it divides, as ``moe.ep_local``)."""
    ctx = ctx_for_mesh(Mesh(("data", "model"), mesh))
    return ctx.shard(torch.from_numpy(full), ctx.act_for(b),
                     {"data": int(coords[0]), "model": int(coords[1])}
                     ).numpy()


@pytest.mark.parametrize("name", [m[0] for m in MOE])
def test_moe_ep_matches_the_reference(runs, name):
    ref, port = runs
    _, mesh, experts, shared, cf, fsdp, jet, xs = _moe(name)
    for out in port:
        coords = out[f"{name}/coords"]
        flat = int(coords[0]) * mesh[1] + int(coords[1])
        np.testing.assert_allclose(
            out[f"{name}/y"], _block(ref[f"{name}/y"], mesh, coords, xs[0]),
            **MOE_TOL)
        if cf >= 16.0:   # past capacity EP sizes slabs by a rank's tokens
            np.testing.assert_allclose(
                out[f"{name}/y"],
                _block(ref[f"{name}/y_dense"], mesh, coords, xs[0]),
                **MOE_TOL)
        # the device's own figures (its data block's), not a data mean
        np.testing.assert_allclose(out[f"{name}/lb_loss"],
                                   ref[f"{name}/lb_loss"][flat], **MOE_TOL)
        assert float(out[f"{name}/overflow"]) == \
            float(ref[f"{name}/overflow"][flat])
        assert bool(out[f"{name}/apply_equal"])   # moe_apply(ctx=) is EP
        d_loc = D // mesh[0] if fsdp else D
        assert tuple(out[f"{name}/e_in_shape"]) == (experts // mesh[1],
                                                    d_loc, 256)
    # what the reference hands back on the host: data coordinate 0's
    assert float(ref[f"{name}/overflow"][0]) == float(
        port[0][f"{name}/overflow"])
    if cf >= 16.0:
        assert all(float(o[f"{name}/overflow"]) == 0.0 for o in port)
        assert float(ref[f"{name}/overflow_dense"]) == 0.0
    else:
        assert float(ref[f"{name}/overflow"][0]) > 0.0
    if mesh[0] > 1:   # the data blocks' own figures differ
        assert len({float(o[f"{name}/lb_loss"]) for o in port}) > 1


def test_moe_ep_overflow_keeps_the_reference_tokens(runs):
    """At 4 model ranks past capacity (no shared expert): each rank routes
    rows [r·n, (r+1)·n) of its data block; the tokens it keeps are those
    whose y the reference leaves non-zero, exactly."""
    ref, port = runs
    name = "moe_ep_overflow_4_ranks"
    _, (dsz, msz), _, _, _, _, _, (b, t) = _moe(name)
    y = ref[f"{name}/y"].reshape(dsz, b // dsz * t, D)
    n = b // dsz * t // msz
    kept_ref = np.abs(y).max(-1) > 0                   # [data, tokens]
    kept = np.zeros_like(kept_ref)
    for out in port:
        dc, mc = (int(c) for c in out[f"{name}/coords"])
        kept[dc, mc * n:(mc + 1) * n] = out[f"{name}/kept"]
    assert np.array_equal(kept, kept_ref)
    assert 0 < kept.sum() < kept.size
    # overflow: the model-rank mean of each rank's dropped share
    for out in port:
        dc = int(out[f"{name}/coords"][0])
        assert float(out[f"{name}/overflow"]) == pytest.approx(
            1.0 - kept[dc].mean(), abs=1e-7)


def test_moe_ep_refuses_grad(runs):
    """``moe_ep`` no longer refuses grad: under it, each rank's block of
    d(sum y)/dx on (2, 4) equals ``jax.grad`` of the reference's dense
    oracle (the full backward: ``tests/test_torch_train_mesh.py``)."""
    ref, port = runs
    name = "moe_ep_equals_dense_ref"
    _, mesh, _, _, _, _, _, xs = _moe(name)
    for out in port:
        np.testing.assert_allclose(
            out[f"{name}/dx"],
            _block(ref[f"{name}/dx_dense"], mesh, out[f"{name}/coords"],
                   xs[0]), **MOE_TOL)


def test_ring_allgather_matmul(runs):
    ref, port = runs
    for out in port:
        r = int(out["rings/rank"])
        np.testing.assert_allclose(out["ring_allgather_matmul/y"],
                                   ref["ring_allgather_matmul/y"][r],
                                   rtol=1e-4, atol=1e-4)


def test_ring_reduce_scatter(runs):
    ref, port = runs
    want = ref["ring_reduce_scatter/y"].reshape(8, 16, 8)
    for out in port:
        r = int(out["rings/rank"])
        np.testing.assert_allclose(out["ring_reduce_scatter/y"], want[r],
                                   rtol=1e-4, atol=1e-4)


def test_windowed_allgather(runs):
    ref, port = runs
    for out in port:
        r = int(out["rings/rank"])
        np.testing.assert_allclose(out["windowed_allgather/y"],
                                   ref["windowed_allgather/y"][r],
                                   rtol=1e-5, atol=1e-5)


def test_srq_combine_distributed_decode(runs):
    ref, port = runs
    for out in port:
        np.testing.assert_allclose(out["srq_combine/o"],
                                   ref["srq_combine/o"][0],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["srq_combine/o"],
                                   ref["srq_combine/whole"],
                                   rtol=1e-4, atol=1e-4)


def test_gpipe_matches_the_sequential_stack(runs):
    """Forward and each stage's layer gradients against the reference's
    sequential stack and ``jax.grad`` of it, at its check's 5e-4."""
    ref, port = runs
    stages = CASES["gpipe"]["stages"]
    per = ref["gpipe/grad"].shape[0] // stages
    for out in port:
        s = int(out["gpipe/stage"])
        np.testing.assert_allclose(out["gpipe/y"], ref["gpipe/y"],
                                   rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(out["gpipe/grad"],
                                   ref["gpipe/grad"][s * per:(s + 1) * per],
                                   rtol=5e-4, atol=5e-4)


def test_compressed_psum_error_feedback(runs):
    ref, port = runs
    g1 = _inputs()["cpsum/g1"]
    for out in port:
        r = int(out["cpsum/rank"])
        for i in (1, 2):
            assert np.array_equal(out[f"cpsum/q{i}"], ref[f"cpsum/q{i}"][r])
            np.testing.assert_allclose(out[f"cpsum/s{i}"],
                                       ref[f"cpsum/s{i}"][r], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(out[f"cpsum/mean{i}"],
                                       ref[f"cpsum/mean{i}"][r], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(out[f"cpsum/err{i}"],
                                       ref[f"cpsum/err{i}"][r], rtol=0,
                                       atol=1e-6)
        # the reference check's bound: int8 error within a scale step
        assert np.abs(out["cpsum/mean1"] - g1.mean(0)).max() < \
            np.abs(g1).max() / 127 + 1e-3


def test_elastic_reshard_roundtrip(runs):
    """Every leaf's full value exactly the checkpoint's, and each rank's
    block shape the reference's ``addressable_shards`` shape at the same
    mesh position."""
    ref, port = runs
    keys = [k[len("elastic/full/"):] for k in ref
            if k.startswith("elastic/full/")]
    assert keys and all(f"elastic/full/{k}" in port[0] for k in keys)
    for r, out in enumerate(port):
        assert int(out["elastic/extra_step"]) == 7
        for k in keys:
            assert np.array_equal(out[f"elastic/full/{k}"],
                                  ref[f"elastic/full/{k}"]), k
            assert tuple(out[f"elastic/shape/{k}"]) == \
                tuple(ref[f"elastic/shapes/{k}"][r]), k
    sharded = [k for k in keys if tuple(ref[f"elastic/shapes/{k}"][0])
               != ref[f"elastic/full/{k}"].shape]
    assert sharded, "no leaf was sharded"


def test_spec_entries_normalize_as_partition_specs():
    assert P(("data",), None) == ("data", None)
    assert P((), "model") == (None, "model")
    assert P(("pod", "data")) == (("pod", "data"),)
