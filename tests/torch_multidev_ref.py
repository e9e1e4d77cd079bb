"""The reference side of ``tests/test_torch_multidev.py``: the JAX
package's distribution layer on 8 host CPU devices.

    PYTHONPATH=src python tests/torch_multidev_ref.py WORK_DIR

reads ``WORK_DIR/cases.json`` and ``WORK_DIR/inputs.npz`` (numpy-seeded,
written by the test), runs the reference functions on the meshes of the
reference's own multi-device checks (``tests/multidev_driver.py``) and
writes their outputs to ``WORK_DIR/ref_out.npz``.  A replicated output
(``out_specs=P()``) is saved per device, in mesh order, since under
``check_vma=False`` each device keeps its own value.  Imports the
reference package only.
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.checkpoint import ckpt  # noqa: E402
from repro.configs import ARCHS, tiny_config  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.launch.mesh import ctx_for_mesh  # noqa: E402
from repro.models.moe import moe_dense_ref, moe_ep  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.parallel import collectives as coll  # noqa: E402
from repro.parallel.compat import shard_map  # noqa: E402
from repro.parallel.compression import (compressed_psum,  # noqa: E402
                                        quantize_int8_rowwise)
from repro.train import steps as steps_mod  # noqa: E402


def subtree(inp, prefix: str) -> dict:
    """The nested dict saved under ``prefix`` (keys joined by '/')."""
    out: dict = {}
    for k in inp.files:
        if k.startswith(prefix):
            *head, leaf = k[len(prefix):].split("/")
            d = out
            for h in head:
                d = d.setdefault(h, {})
            d[leaf] = jnp.asarray(inp[k])
    return out


def per_device(a, mesh) -> np.ndarray:
    """Each device's own buffer of ``a``, stacked in mesh order."""
    by_id = {s.device.id: np.asarray(s.data) for s in a.addressable_shards}
    return np.stack([by_id[d.id] for d in mesh.devices.flat])


def moe_case(c: dict, inp, out: dict) -> None:
    name = c["name"]
    cfg = dataclasses.replace(tiny_config(ARCHS["llama4-scout-17b-a16e"]),
                              num_experts=c["experts"],
                              shared_expert=c["shared"])
    params = subtree(inp, f"moe/{name}/p/")
    x = jnp.asarray(inp[f"moe/{name}/x"])
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"))
    ctx = ctx_for_mesh(mesh, moe_capacity_factor=c["cf"], fsdp=c["fsdp"],
                       jet_collectives=c["jet"])
    with mesh:
        y, aux = jax.jit(lambda p, xx: moe_ep(p, xx, cfg, ctx))(params, x)
    y_ref, aux_ref = moe_dense_ref(params, x, cfg, cap_factor=c["cf"])
    if name == "moe_ep_equals_dense_ref":    # the port's moe_ep under grad
        out[f"{name}/dx_dense"] = np.asarray(jax.grad(
            lambda xx: moe_dense_ref(params, xx, cfg, c["cf"])[0].sum())(x))
    out[f"{name}/y"] = np.asarray(y)
    out[f"{name}/y_dense"] = np.asarray(y_ref)
    for k in ("lb_loss", "overflow"):
        out[f"{name}/{k}"] = per_device(aux[k], mesh)
        out[f"{name}/{k}_dense"] = np.asarray(aux_ref[k])


def rings(c: dict, inp, out: dict) -> None:
    m = c["ring"]
    mesh = jax.make_mesh((m,), ("model",))

    def agm(x_blk, w_blk):
        return coll.ring_allgather_matmul(x_blk, w_blk, "model", m,
                                          frags=c["frags"])
    got = jax.jit(shard_map(agm, mesh=mesh, in_specs=(P(), P("model", None)),
                            out_specs=P(), check_vma=False))(
        inp["ring_ag/x"], inp["ring_ag/w"])
    out["ring_allgather_matmul/y"] = per_device(got, mesh)

    def rs(y_blk):
        return coll.ring_reduce_scatter(y_blk[0], "model", m)
    out["ring_reduce_scatter/y"] = np.asarray(jax.jit(shard_map(
        rs, mesh=mesh, in_specs=(P("model", None, None),),
        out_specs=P("model"), check_vma=False))(inp["ring_rs/y"]))

    def wag(x_blk):
        return coll.windowed_allgather(x_blk, "model", m, window=c["window"])
    got = jax.jit(shard_map(wag, mesh=mesh, in_specs=(P("model", None),),
                            out_specs=P(), check_vma=False))(inp["win_ag/x"])
    out["windowed_allgather/y"] = per_device(got, mesh)


def srq(c: dict, inp, out: dict) -> None:
    m = c["ranks"]
    mesh = jax.make_mesh((m,), ("model",))
    q, k, v = (jnp.asarray(inp[f"srq/{n}"]) for n in "qkv")
    b, s = q.shape[0], k.shape[1]
    want, _ = kref.decode_attention_naive(q, k, v,
                                          jnp.full((b,), s, jnp.int32))

    def body(q_full, k_blk, v_blk):
        o, lse = kref.decode_attention_naive(
            q_full, k_blk, v_blk,
            jnp.full((q_full.shape[0],), k_blk.shape[1], jnp.int32))
        return coll.srq_combine(o, lse, "model")
    got = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(None, "model", None, None),
                  P(None, "model", None, None)),
        out_specs=P(), check_vma=False))(q, k, v)
    out["srq_combine/o"] = per_device(got, mesh)
    out["srq_combine/whole"] = np.asarray(want)


def gpipe(c: dict, inp, out: dict) -> None:
    """The sequential stack the reference's GPipe check holds its
    pipeline to, and ``jax.grad`` of it (the check's pipeline itself
    needs ``jax.set_mesh`` under this jax)."""
    w, x = jnp.asarray(inp["gpipe/w"]), jnp.asarray(inp["gpipe/x"])
    d = w.shape[-1]

    def seq_apply(w_all, xm):
        def layer(h, wi):
            return jnp.tanh(h @ wi), None
        y, _ = jax.lax.scan(layer, xm.reshape(-1, d), w_all)
        return y.reshape(xm.shape)

    out["gpipe/y"] = np.asarray(jax.vmap(lambda xm: seq_apply(w, xm))(x))
    out["gpipe/grad"] = np.asarray(jax.grad(lambda ww: jax.vmap(
        lambda xm: seq_apply(ww, xm))(x).sum())(w))


def cpsum(c: dict, inp, out: dict) -> None:
    m = c["ranks"]
    mesh = jax.make_mesh((m,), ("pod",))

    def body(g_blk, err):
        mean, new_err = compressed_psum(g_blk[0], err[0], "pod")
        return mean, new_err[None]
    step = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("pod", None), P("pod", None)),
        out_specs=(P(), P("pod", None)), check_vma=False))
    err = np.zeros_like(inp["cpsum/g1"])
    for i in (1, 2):                 # two rounds: the error fed back
        g = inp[f"cpsum/g{i}"]
        codes = [quantize_int8_rowwise(jnp.asarray(g[r] + err[r]))
                 for r in range(m)]
        out[f"cpsum/q{i}"] = np.stack([np.asarray(q) for q, _ in codes])
        out[f"cpsum/s{i}"] = np.stack([np.asarray(s) for _, s in codes])
        mean, err = step(jnp.asarray(g), jnp.asarray(err))
        err = np.asarray(err)
        out[f"cpsum/mean{i}"] = per_device(mean, mesh)
        out[f"cpsum/err{i}"] = np.asarray(err)


def elastic(c: dict, work: str, out: dict) -> None:
    """The checkpoint the test saved from one process, restored onto a
    2 x 4 mesh with the state's shardings."""
    cfg = dataclasses.replace(tiny_config(ARCHS[c["arch"]]),
                              num_layers=c["layers"])
    mesh = jax.make_mesh(tuple(c["mesh"]), ("data", "model"))
    ctx = ctx_for_mesh(mesh)
    like = steps_mod.abstract_state(cfg, adamw.OptConfig())
    specs = steps_mod.state_specs(like, ctx)
    shardings = jax.tree.map(lambda s: ctx.sharding(s), specs,
                             is_leaf=lambda x: isinstance(x, P))
    with mesh:
        restored, extra = ckpt.restore(os.path.join(work, "ckpt"), like,
                                       shardings=shardings)
    out["elastic/extra_step"] = np.asarray(extra["step"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"elastic/full/{key}"] = np.asarray(leaf)
        by_id = {s.device.id: s.data.shape for s in leaf.addressable_shards}
        out[f"elastic/shapes/{key}"] = np.array(
            [by_id[d.id] for d in mesh.devices.flat]).reshape(
            mesh.size, leaf.ndim)


def main(work: str) -> None:
    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    inp = np.load(os.path.join(work, "inputs.npz"))
    out: dict = {}
    for c in cases["moe"]:
        moe_case(c, inp, out)
    rings(cases["rings"], inp, out)
    srq(cases["srq"], inp, out)
    gpipe(cases["gpipe"], inp, out)
    cpsum(cases["cpsum"], inp, out)
    elastic(cases["elastic"], work, out)
    np.savez(os.path.join(work, "ref_out.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1])
