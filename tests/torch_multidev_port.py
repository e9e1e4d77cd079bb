"""The port side of ``tests/test_torch_multidev.py``: the port's
distribution layer on 8 gloo ranks, one CPU process a rank.

    PYTHONPATH=src python tests/torch_multidev_port.py WORK_DIR

reads ``WORK_DIR/cases.json`` and ``WORK_DIR/inputs.npz`` (the inputs the
reference side reads), spawns 8 ranks that meet through a file store,
and each rank writes what it holds to ``WORK_DIR/port_rank<r>.npz``:
its blocks, its figures and its mesh coordinates.  A collective that
waits more than 60 s raises; a rank still running 20 s before the join
limit ``JOIN_S`` prints its stack and exits, and the spawn's ranks are
killed at the limit, so a hung collective fails the run with each
rank's traceback.  Imports the port only.
"""
import dataclasses
import faulthandler
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 8
JOIN_S = 240.0
COLLECTIVE_TIMEOUT_S = 60.0


def subtree(inp, prefix: str) -> dict:
    """The nested dict saved under ``prefix`` (keys joined by '/')."""
    out: dict = {}
    for k in inp.files:
        if k.startswith(prefix):
            *head, leaf = k[len(prefix):].split("/")
            d = out
            for h in head:
                d = d.setdefault(h, {})
            d[leaf] = inp[k]
    return out


def moe_case(c: dict, inp, out: dict) -> None:
    from repro_torch.configs import get_arch, tiny_config
    from repro_torch.launch.mesh import ctx_for_mesh, small_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.convert import tree_from_numpy
    name = c["name"]
    cfg = dataclasses.replace(tiny_config(get_arch("llama4-scout-17b-a16e")),
                              num_experts=c["experts"],
                              shared_expert=c["shared"])
    params = tree_from_numpy(subtree(inp, f"moe/{name}/p/"), "cpu")
    x = torch.from_numpy(inp[f"moe/{name}/x"])
    mesh = small_host_mesh(WORLD, model=c["mesh"][1])
    assert mesh.axis_sizes == tuple(c["mesh"])
    ctx = ctx_for_mesh(mesh, moe_capacity_factor=c["cf"], fsdp=c["fsdp"],
                       jet_collectives=c["jet"])
    local, xl = moe.ep_local(params, x, ctx)
    routes = []
    with torch.no_grad():
        y, aux = moe.moe_ep(local, xl, cfg, ctx,
                            on_route=lambda i, k, m: routes.append((i, k)))
    (idx, kept), = routes
    with torch.no_grad():      # the model's entry: moe_apply with the ctx
        y_apply, _ = moe.moe_apply(local, xl, cfg, ctx=ctx)
    out[f"{name}/apply_equal"] = np.array(bool(torch.equal(y_apply, y)))
    out[f"{name}/y"] = y.numpy()
    out[f"{name}/lb_loss"] = aux["lb_loss"].numpy()
    out[f"{name}/overflow"] = aux["overflow"].numpy()
    out[f"{name}/idx"] = idx.numpy()
    out[f"{name}/kept"] = kept.numpy()
    out[f"{name}/coords"] = np.array([mesh.coord("data"),
                                      mesh.coord("model")])
    out[f"{name}/e_in_shape"] = np.array(local["e_in"].shape)
    if c["name"] == "moe_ep_equals_dense_ref":
        # under grad: this rank's block of d(sum y)/dx
        xg = xl.clone().requires_grad_(True)
        moe.moe_ep(local, xg, cfg, ctx)[0].sum().backward()
        out[f"{name}/dx"] = xg.grad.numpy()


def rings(c: dict, inp, out: dict) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as coll
    mesh = make_mesh((c["ring"],), ("model",))
    g, r, m = mesh.group("model"), mesh.coord("model"), c["ring"]
    x, w = (torch.from_numpy(inp[f"ring_ag/{n}"]) for n in "xw")
    dk = w.shape[0] // m
    out["ring_allgather_matmul/y"] = coll.ring_allgather_matmul(
        x, w[r * dk:(r + 1) * dk], g, frags=c["frags"]).numpy()
    y = torch.from_numpy(inp["ring_rs/y"])
    out["ring_reduce_scatter/y"] = coll.ring_reduce_scatter(y[r], g).numpy()
    xs = torch.from_numpy(inp["win_ag/x"])
    n0 = xs.shape[0] // m
    out["windowed_allgather/y"] = coll.windowed_allgather(
        xs[r * n0:(r + 1) * n0], g, window=c["window"]).numpy()
    out["rings/rank"] = np.array(r)


def srq(c: dict, inp, out: dict) -> None:
    from repro_torch.kernels import ref as kref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as coll
    m = c["ranks"]
    mesh = make_mesh((WORLD // m, m), ("rep", "model"))
    r = mesh.coord("model")
    q, k, v = (torch.from_numpy(inp[f"srq/{n}"]) for n in "qkv")
    sk = k.shape[1] // m
    kb, vb = k[:, r * sk:(r + 1) * sk], v[:, r * sk:(r + 1) * sk]
    o, lse = kref.decode_attention_naive(
        q, kb, vb, torch.full((q.shape[0],), sk, dtype=torch.int32))
    out["srq_combine/o"] = coll.srq_combine(o, lse,
                                            mesh.group("model")).numpy()


def gpipe(c: dict, inp, out: dict) -> None:
    """Two stages over ``pod``: forward, broadcast from the last stage,
    and the gradient of the sum of the (uniform) output in each stage's
    layers."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import pipeline as pp
    s = c["stages"]
    mesh = make_mesh((WORLD // s, s), ("rep", "pod"))
    g, r = mesh.group("pod"), mesh.coord("pod")
    w, x = (torch.from_numpy(inp[f"gpipe/{n}"]) for n in "wx")
    d = w.shape[-1]
    w_stage = pp.stack_stages(w, s)[r].clone().requires_grad_(True)

    def stage_fn(h):
        hh = h.reshape(-1, d)
        for wi in w_stage:
            hh = torch.tanh(hh @ wi)
        return hh.reshape(h.shape)

    y = pp.broadcast_from_last(pp.gpipe(stage_fn, x, g, s), g, s)
    (grad,) = torch.autograd.grad(y.sum(), [w_stage])
    out["gpipe/y"] = y.detach().numpy()
    out["gpipe/grad"] = grad.numpy()
    out["gpipe/stage"] = np.array(r)


def cpsum(c: dict, inp, out: dict) -> None:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.compression import (compressed_psum,
                                                  quantize_int8_rowwise)
    m = c["ranks"]
    mesh = make_mesh((WORLD // m, m), ("rep", "pod"))
    g, r = mesh.group("pod"), mesh.coord("pod")
    err = torch.zeros(inp["cpsum/g1"].shape[1:])
    for i in (1, 2):                 # two rounds: the error fed back
        x = torch.from_numpy(inp[f"cpsum/g{i}"])[r]
        q, s = quantize_int8_rowwise(x + err)   # the codes on the wire
        out[f"cpsum/q{i}"], out[f"cpsum/s{i}"] = q.numpy(), s.numpy()
        mean, err = compressed_psum(x, err, g)
        out[f"cpsum/mean{i}"], out[f"cpsum/err{i}"] = mean.numpy(), \
            err.numpy()
    out["cpsum/rank"] = np.array(r)


def elastic(c: dict, work: str, out: dict) -> None:
    """The reference's one-process checkpoint restored onto a 2 x 4 mesh:
    each rank keeps its block of every leaf; the blocks gathered back."""
    from repro_torch import _tree
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_arch, tiny_config
    from repro_torch.launch.mesh import ctx_for_mesh, make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    cfg = dataclasses.replace(tiny_config(get_arch(c["arch"])),
                              num_layers=c["layers"])
    ctx = ctx_for_mesh(make_mesh(tuple(c["mesh"]), ("data", "model")))
    like = steps.abstract_state(cfg, adamw.OptConfig())
    specs = steps.state_specs(like, ctx)
    shardings = _tree.tree_map(lambda _, s: ctx.sharding(s), like, specs)
    restored, extra = ckpt.restore(os.path.join(work, "ckpt"), like,
                                   device="cpu", shardings=shardings)
    out["elastic/extra_step"] = np.array(extra["step"])
    for (path, leaf), (_, sh) in zip(_tree.flatten(restored),
                                     _tree.flatten(shardings)):
        key = _tree.key(path)
        out[f"elastic/shape/{key}"] = np.array(leaf.shape)
        out[f"elastic/full/{key}"] = ctx.gather(leaf, sh.spec).numpy()


def rank_main(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    # a rank still running near the join limit prints where it waits
    faulthandler.dump_traceback_later(JOIN_S - 20, exit=True)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_group
    init_group("gloo", rank, WORLD, os.path.join(work, "store"),
               COLLECTIVE_TIMEOUT_S)
    try:
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
        np.savez(os.path.join(work, f"port_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def main(work: str) -> int:
    procs = mp.start_processes(rank_main, args=(work,), nprocs=WORLD,
                               start_method="spawn", join=False)
    deadline = time.monotonic() + JOIN_S
    try:
        while not procs.join(timeout=1.0):
            if time.monotonic() > deadline:
                alive = [i for i, p in enumerate(procs.processes)
                         if p.is_alive()]
                print(f"ranks {alive} still running after {JOIN_S} s",
                      file=sys.stderr)
                return 1
    except mp.ProcessRaisedException:
        traceback.print_exc()
        return 1
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
