"""The port's sharding rules against the reference's, with no process.

For each of the ten architectures at full size, on the meshes (16, 16)
and (2, 16, 16) of production and the tests' (2, 4) and (4, 2), with
FSDP on and off: the port's ``train.steps.param_specs``,
``opt_state_specs`` (float32 and int8 moments), ``state_specs`` and
``batch_specs`` over its abstract state (meta tensors), and the
context's ``kv_cache_spec``, ``act_for``, ``spec_weight`` and sizes,
against the reference's over ``jax.eval_shape`` and an ``AbstractMesh``.
Every spec equal, entry for entry, leaf for leaf.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCHS
from repro.launch import mesh as jmesh
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch import _tree
from repro_torch.configs import get_arch, tiny_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe
from repro_torch.optim import adamw
from repro_torch.parallel import compat
from repro_torch.parallel.sharding import (Mesh, NamedSharding, P,
                                           single_device_ctx)
from repro_torch.train import steps

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
CASES = [(a, m, f) for a in sorted(ARCHS) for m in MESHES
         for f in (True, False)]
BATCHES = (1, 2, 3, 4, 8, 16, 32, 64, 256, 512)
KV = [(b, s) for b in (1, 2, 8, 32) for s in (1, 7, 64, 4096)]


@functools.lru_cache(maxsize=None)
def _states(arch: str, int8: bool):
    """(reference ShapeDtypeStruct state, port meta state)."""
    return (jsteps.abstract_state(ARCHS[arch],
                                  jadamw.OptConfig(int8_moments=int8)),
            steps.abstract_state(get_arch(arch),
                                 adamw.OptConfig(int8_moments=int8)))


def _ctxs(mesh: str, fsdp: bool):
    shape, axes = MESHES[mesh]
    return (jmesh.ctx_for_mesh(AbstractMesh(shape, axes), fsdp=fsdp),
            tmesh.ctx_for_mesh(Mesh(axes, shape), fsdp=fsdp))


def _ref_specs(specs) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_specs(specs, like) -> dict:
    """The spec at each leaf of ``like`` (spec trees are walked through
    the tree they describe, since a spec is a tuple)."""
    out = {}
    for path, _ in _tree.flatten(like):
        s = specs
        for k in path:
            s = s[k]
        assert isinstance(s, P), (path, s)
        out[_tree.key(path)] = tuple(s)
    return out


@pytest.mark.parametrize("arch,mesh,fsdp", CASES,
                         ids=[f"{a}-{m}-{'fsdp' if f else 'nofsdp'}"
                              for a, m, f in CASES])
def test_specs_equal_the_reference(arch, mesh, fsdp):
    jctx, ctx = _ctxs(mesh, fsdp)
    assert ctx.data_axes == jctx.data_axes
    assert (ctx.dp_size, ctx.model_size) == (jctx.dp_size, jctx.model_size)
    for a in MESHES[mesh][1]:
        assert ctx.axis_size(a) == jctx.axis_size(a)
    for int8 in (False, True):
        jstate, state = _states(arch, int8)
        want = _ref_specs(jsteps.state_specs(jstate, jctx))
        got = _port_specs(steps.state_specs(state, ctx), state)
        assert got == want
        # the parameter specs alone, and the moments against them
        assert _port_specs(steps.param_specs(state["params"], ctx),
                           state["params"]) == _ref_specs(
            jsteps.param_specs(jstate["params"], jctx))
        if int8:   # every int8 moment's scale drops its code's last dim
            assert any(k.endswith("/s") for k in got)
    for b in BATCHES:
        jbatch = {"tokens": jax.ShapeDtypeStruct((b, 128), "int32"),
                  "patches": jax.ShapeDtypeStruct((b, 16, 64), "float32")}
        batch = {k: torch.empty(v.shape, device="meta")
                 for k, v in jbatch.items()}
        assert _port_specs(steps.batch_specs(batch, ctx), batch) == \
            _ref_specs(jsteps.batch_specs(jbatch, jctx))
        assert ctx.batch_axes_for(b) == jctx.batch_axes_for(b)
        assert tuple(ctx.act_for(b)) == tuple(jctx.act_for(b))
        assert tuple(ctx.act_for(b, 3)) == tuple(jctx.act_for(b, 3))
    for b, s in KV:
        for sp in (True, False):
            ctx.seq_parallel_decode = jctx.seq_parallel_decode = sp
            assert tuple(ctx.kv_cache_spec(b, s)) == \
                tuple(jctx.kv_cache_spec(b, s)), (b, s, sp)
    for shape, tp, fs in (((4096, 1024), 1, 0), ((6, 4096, 8), 1, 2),
                          ((16, 5120, 8192), 0, 1), ((7, 3), 0, 1),
                          ((32, 32), None, 0), ((32, 32), 1, 1)):
        assert tuple(ctx.spec_weight(shape, tp, fs)) == \
            tuple(jctx.spec_weight(shape, tp, fs)), (shape, tp, fs)


def test_production_mesh_and_blocks():
    """The production meshes are shapes only; a block by spec tiles the
    full tensor exactly once over the mesh's coordinates, row-major over
    a dim's axes."""
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert m.axis_sizes == shape and m.device_mesh is None
        with pytest.raises(RuntimeError, match="shapes only"):
            m.group("model")
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    t = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    sh = NamedSharding(mesh, P(("pod", "data"), "model"))
    seen = torch.zeros_like(t)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                c = {"pod": pod, "data": data, "model": model}
                blk = sh.shard(t, c)
                assert blk.shape == (2, 3, 4)
                assert int(blk[0, 0, 0]) == t[(pod * 2 + data) * 2,
                                              model * 3, 0]
                seen[sh.index(t.shape, c)] += 1
    assert bool((seen == 1).all())       # 8 coordinates, 8 blocks
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(mesh, P("model")).index((3, 4), c)


def test_moe_apply_without_a_mesh_is_the_dispatch():
    """A context with no mesh keeps the single-card dispatch, at the
    context's capacity factor unless the call names one; ``moe_ep``
    needs a mesh."""
    cfg = tiny_config(get_arch("llama4-scout-17b-a16e"))
    g = torch.Generator().manual_seed(0)
    params = moe.moe_init(g, cfg)
    x = torch.randn(2, 24, cfg.d_model, generator=g)
    ctx = single_device_ctx(moe_capacity_factor=0.5)
    for got, want in ((moe.moe_apply(params, x, cfg, ctx=ctx),
                       moe.moe_apply(params, x, cfg, 0.5)),
                      (moe.moe_apply(params, x, cfg, 4.0, ctx=ctx),
                       moe.moe_apply(params, x, cfg, 4.0))):
        assert torch.equal(got[0], want[0])
        assert float(got[1]["overflow"]) == float(want[1]["overflow"])
    assert float(moe.moe_apply(params, x, cfg, ctx=ctx)[1]["overflow"]) > 0
    with pytest.raises(ValueError, match="mesh"):
        moe.moe_ep(params, x, cfg, ctx)


def test_farm_dispatch_probe_counts_cuda_devices():
    ok, reason = compat.farm_dispatch_probe(min_devices=10 ** 6)
    assert not ok and "need >= 1000000" in reason
    assert compat.farm_dispatch_probe(min_devices=0)[0]
