"""The port side of ``tests/test_torch_train_mesh.py``: the sharded train
step on 8 gloo ranks, one CPU process a rank.

    PYTHONPATH=src python tests/torch_train_mesh_port.py WORK_DIR

reads ``WORK_DIR/cases.json``, ``WORK_DIR/inputs.npz`` (batches and
MoE inputs) and ``WORK_DIR/states.pkl`` (the reference's train states,
numpy leaves, written by the test), spawns 8 ranks that meet through a
file store, and writes ``WORK_DIR/port_rank<r>.npz``: rank 0 the whole
gradients and parameters each case gathers back, every rank the figures
it holds.  A collective that waits more than 60 s raises; a rank still
running 20 s before the join limit ``JOIN_S`` prints its stack and
exits, so a hung collective fails the run with each rank's traceback.
Imports the port only.
"""
import dataclasses
import faulthandler
import json
import os
import pickle
import shutil
import sys
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 8
JOIN_S = 420.0
COLLECTIVE_TIMEOUT_S = 60.0
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
_MESHES: dict = {}


def mesh(shape):
    """The mesh of ``shape`` over the 8 ranks, made once a shape."""
    from repro_torch.launch.mesh import make_mesh
    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(shape, AXES[len(shape)], "cpu")
    return _MESHES[shape]


def ctx_for(shape, **kw):
    from repro_torch.launch.mesh import ctx_for_mesh
    return ctx_for_mesh(mesh(shape), **kw)


def arch(c: dict):
    from repro_torch.configs import get_arch, tiny_config
    cfg = tiny_config(get_arch(c["arch"]))
    if c.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=c["layers"])
    return cfg


def batch(inp, name: str, accum: int = 1) -> dict:
    out = {}
    for k in inp.files:
        if k.startswith(f"batch/{name}/"):
            v = torch.from_numpy(inp[k])
            if accum > 1:
                v = v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
            out[k.rsplit("/", 1)[1]] = v
    return out


def opt(c: dict):
    from repro_torch.optim import adamw
    return adamw.OptConfig(lr=1e-3, int8_moments=c.get("int8", False),
                           compressed_pod_grads=c.get("pod", False))


def put(out: dict, prefix: str, tree) -> None:
    from repro_torch import _tree
    for path, leaf in _tree.flatten(tree):
        out[f"{prefix}/{_tree.key(path)}"] = leaf.detach().float().numpy() \
            if leaf.is_floating_point() else leaf.numpy()


def step_case(c: dict, inp, states, out: dict) -> None:
    """One sharded train step from the reference's state: the gradients
    (``loss_and_grads``), the step's figures and the new state, gathered
    whole on rank 0."""
    from repro_torch.models.convert import state_from_jax
    from repro_torch.train import steps
    name, accum = c["name"], c.get("accum", 1)
    cfg, opt_cfg = arch(c), opt(c)
    ctx = ctx_for(c["mesh"], moe_capacity_factor=c.get("cf"),
                  bf16_weight_gather=c.get("bf16_gather", False))
    whole = state_from_jax(states[c["state"]], cfg, "cpu")
    specs = steps.state_specs(whole, ctx)
    state = ctx.shard_tree(whole, specs)
    full = batch(inp, c["batch"], accum)
    local = steps.shard_batch(full, ctx, accum)
    rank0 = torch.distributed.get_rank() == 0
    step = steps.make_train_step(cfg, opt_cfg, accum_steps=accum,
                                 remat=c.get("remat", "full"), ctx=ctx)
    new, m = step(state, local)
    out[f"{name}/loss_rank"] = np.array(float(m["loss"]))
    for k in ("loss", "grad_norm", "lb_loss", "overflow"):
        out[f"{name}/{k}"] = np.array(float(m[k]))
    new_whole = ctx.gather_tree(new, specs)
    if accum == 1:
        g, loss, _ = steps.loss_and_grads(cfg, state["params"], local,
                                          remat=c.get("remat", "full"),
                                          ctx=ctx, specs=specs["params"])
        g_whole = ctx.gather_tree(g, specs["params"])
        if rank0:
            put(out, f"{name}/grads", g_whole)
    if rank0:
        put(out, f"{name}/params", new_whole["params"])
        if c.get("int8"):
            put(out, f"{name}/opt", new_whole["opt"])
        if "err" in new_whole:
            put(out, f"{name}/err", new_whole["err"])
    if c.get("pod"):
        # step 2 from step 1's state: the residuals fed back, against the
        # same step with them zeroed
        from repro_torch import _tree
        new2, m2 = step(new, local)
        new2z, _ = step(dict(new, err=_tree.tree_map(torch.zeros_like,
                                                     new["err"])), local)
        p2 = ctx.gather_tree(new2["params"], specs["params"])
        p2z = ctx.gather_tree(new2z["params"], specs["params"])
        out[f"{name}/loss2"] = np.array(float(m2["loss"]))
        if rank0:
            diff = max(float((a - b).abs().max()) for a, b in zip(
                _tree.leaves(p2), _tree.leaves(p2z)))
            out[f"{name}/fed_back_diff"] = np.array(diff)


def adamw_case(c: dict, inp, states, out: dict) -> None:
    """One int8 AdamW update of this rank's blocks from the same whole
    gradients the reference's single-device update takes."""
    from repro_torch import _tree
    from repro_torch.models.convert import state_from_jax
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    cfg = arch(c)
    ctx = ctx_for(c["mesh"])
    whole = state_from_jax(states[c["state"]], cfg, "cpu")
    grads = _tree.unflatten(whole["params"], [
        torch.from_numpy(inp[f"adamw/grad/{_tree.key(p)}"])
        for p, _ in _tree.flatten(whole["params"])])
    specs = steps.state_specs(whole, ctx)
    local = ctx.shard_tree(whole, specs)
    g = ctx.shard_tree(grads, specs["params"])
    _, new_opt, stats = adamw.update(g, local["opt"], local["params"],
                                     opt(c), specs["params"], ctx)
    opt_whole = ctx.gather_tree(new_opt, specs["opt"])
    out["adamw/grad_norm"] = np.array(float(stats["grad_norm"]))
    if torch.distributed.get_rank() == 0:
        put(out, "adamw/opt", opt_whole)


def moe_grad_case(c: dict, inp, out: dict) -> None:
    """``moe_ep`` forward and backward of sum(y * w) on this rank's block,
    the gradients summed over the ranks to the whole batch's."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, tiny_config
    from repro_torch.models import moe
    from repro_torch.models.convert import tree_from_numpy
    name = c["name"]
    cfg = dataclasses.replace(tiny_config(get_arch("llama4-scout-17b-a16e")),
                              num_experts=c["experts"],
                              shared_expert=c["shared"])
    pre = f"moe/{name}/p/"
    params = _nest(tree_from_numpy(
        {k[len(pre):]: inp[k] for k in inp.files if k.startswith(pre)},
        "cpu"))
    x = torch.from_numpy(inp[f"moe/{name}/x"])
    w = torch.from_numpy(inp[f"moe/{name}/w"])
    ctx = ctx_for(c["mesh"], moe_capacity_factor=c["cf"], fsdp=c["fsdp"],
                  jet_collectives=c["jet"])
    local, xl = moe.ep_local(params, x, ctx)
    local = {k: (v.clone().requires_grad_(True) if k != "shared" else
                 {n: t.clone().requires_grad_(True) for n, t in v.items()})
             for k, v in local.items()}
    xl = xl.clone().requires_grad_(True)
    wl = ctx.shard(w, ctx.act_for(x.shape[0]))
    y, _ = moe.moe_ep(local, xl, cfg, ctx)
    (y * wl).sum().backward()
    mg, dg = ctx.mesh.group("model"), ctx.mesh.group("data")
    fs = "data" if moe._fsdp_gather(ctx, x.shape[-1]) else None
    specs = {"e_gate": (ctx.model_axis, fs, None),
             "e_in": (ctx.model_axis, fs, None),
             "e_out": (ctx.model_axis, None, fs)}
    from repro_torch.parallel.sharding import P
    grads = {}
    for k in ("router", "e_gate", "e_in", "e_out"):
        g = local[k].grad
        if k == "router" or fs is None:       # not summed over data yet
            dist.all_reduce(g, group=dg)
        grads[k] = g if k == "router" else ctx.gather(g, P(*specs[k]))
    for n, t in local["shared"].items():
        dist.all_reduce(t.grad, group=dg)
        grads[f"shared/{n}"] = t.grad
    dx = ctx.gather(xl.grad, ctx.act_for(x.shape[0]))
    if torch.distributed.get_rank() == 0:
        out[f"moe/{name}/dx"] = dx.numpy()
        for k, g in grads.items():
            out[f"moe/{name}/grad/{k}"] = g.numpy()


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *head, leaf = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = v
    return out


def gather_case(c: dict, inp, states, out: dict) -> None:
    """``bf16_weight_gather``: the forward loss in bfloat16 with the cast
    before and after the gathers, and the type and count of the gathers
    each makes."""
    import torch.distributed as dist
    from repro_torch.models import transformer
    from repro_torch.models.convert import state_from_jax
    from repro_torch.train import steps
    cfg = arch(c)
    whole = state_from_jax(states[c["state"]], cfg, "cpu")
    local_b = steps.shard_batch(batch(inp, c["batch"]), ctx_for(c["mesh"]))
    real = dist.all_gather
    for first in (False, True):
        ctx = ctx_for(c["mesh"], bf16_weight_gather=first)
        specs = steps.param_specs(whole["params"], ctx)
        params = ctx.shard_tree(whole["params"], specs)
        seen = []

        def spy(parts, t, group=None, **kw):
            seen.append(str(t.dtype).replace("torch.", ""))
            return real(parts, t, group=group, **kw)
        dist.all_gather = spy
        try:
            with torch.no_grad():
                loss, _ = transformer.loss_fn(params, cfg, local_b,
                                              torch.bfloat16, ctx=ctx,
                                              specs=specs)
        finally:
            dist.all_gather = real
        tag = "first" if first else "after"
        out[f"gather/{tag}/loss"] = loss.float().numpy()
        out[f"gather/{tag}/dtypes"] = np.array(seen)


def remat_case(c: dict, inp, states, out: dict) -> None:
    """``remat="layer_out"`` against ``"full"``: loss and gradients."""
    from repro_torch.models.convert import state_from_jax
    from repro_torch.train import steps
    cfg = arch(c)
    ctx = ctx_for(c["mesh"])
    whole = state_from_jax(states[c["state"]], cfg, "cpu")
    specs = steps.param_specs(whole["params"], ctx)
    params = ctx.shard_tree(whole["params"], specs)
    local_b = steps.shard_batch(batch(inp, c["batch"]), ctx)
    for remat in ("full", "layer_out"):
        g, loss, _ = steps.loss_and_grads(cfg, params, local_b, remat=remat,
                                          ctx=ctx, specs=specs)
        out[f"remat/{remat}/loss"] = loss.numpy()
        put(out, f"remat/{remat}/grads", g)


def loop_case(c: dict, work: str, out: dict) -> None:
    """``loop.run`` straight through on ``mesh``, and with a fault at
    ``fault`` resumed on ``mesh`` and on ``resume_mesh``."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.train import loop
    cfg, opt_cfg = arch(c), opt(c)
    rank = dist.get_rank()

    def run(shape, d, fault=None):
        data = pipeline.for_arch(cfg, ShapeConfig("t", "train", c["seq"],
                                                  c["batch"]), seed=3)
        lc = loop.LoopConfig(total_steps=c["steps"], ckpt_every=2,
                             ckpt_dir=os.path.join(work, d), log_every=1)

        def inject(step):
            if fault is not None and step == fault:
                raise RuntimeError("injected fault")
        return loop.run(cfg, opt_cfg, lc, data,
                        torch.Generator().manual_seed(0), inject,
                        device="cpu", ctx=ctx_for(shape))

    straight = run(c["mesh"], "loop_straight")
    try:
        run(c["mesh"], "loop_fault", fault=c["fault"])
        raise AssertionError("the fault was not raised")
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
    if rank == 0:
        shutil.copytree(os.path.join(work, "loop_fault"),
                        os.path.join(work, "loop_fault2"))
    resumed = run(c["mesh"], "loop_fault")
    elastic = run(c["resume_mesh"], "loop_fault2")
    out["loop/straight"] = np.array([h["loss"] for h in straight["history"]])
    out["loop/resumed"] = np.array([h["loss"] for h in resumed["history"]])
    out["loop/elastic"] = np.array([h["loss"] for h in elastic["history"]])
    out["loop/final_steps"] = np.array([straight["final_step"],
                                        resumed["final_step"],
                                        elastic["final_step"]])


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
        with open(os.path.join(work, "states.pkl"), "rb") as f:
            states = pickle.load(f)   # written by the test, numpy leaves
        inp = np.load(os.path.join(work, "inputs.npz"))
        out: dict = {}
        timing = {}
        for c in cases["steps"]:
            t0 = time.monotonic()
            step_case(c, inp, states, out)
            timing[c["name"]] = time.monotonic() - t0
        for c in cases["moe"]:
            moe_grad_case(c, inp, out)
        adamw_case(cases["adamw"], inp, states, out)
        gather_case(cases["gather"], inp, states, out)
        remat_case(cases["remat"], inp, states, out)
        loop_case(cases["loop"], work, out)
        out["timing"] = np.array(json.dumps(timing))
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
