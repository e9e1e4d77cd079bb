"""The port side of ``tests/test_torch_serve_mesh.py``: the sharded prefill
and decode on 8 gloo ranks, one CPU process a rank.

    PYTHONPATH=src python tests/torch_serve_mesh_port.py WORK_DIR

reads ``WORK_DIR/cases.json``, ``WORK_DIR/inputs.npz`` (each case's
prompt, and its patches where the model reads them) and
``WORK_DIR/params.pkl`` (the reference's parameters, numpy leaves,
written by the test), spawns 8 ranks that meet through a file store, and
runs each case: the whole parameters cut to this rank's blocks
(``train.steps.param_specs``), the prompt to its batch block, the
prefill and ``steps`` greedy decode steps over the case's mesh (the
argmax of the gathered logits fed back, tiled over the codebooks), the
final state gathered by ``models.decoding.decode_state_specs``.  Rank 0
writes ``WORK_DIR/port.npz``: each case's gathered logits after the
prefill and every step, its tokens and its final state.  Then rank 0
alone runs the ``one_rank`` cases on a mesh of one rank (a gloo group of
its own) beside ``ctx=None``.  A collective that waits more than 60 s
raises; a rank still running 20 s before the join limit ``JOIN_S``
prints its stack and exits.  The ``moe_decode`` cases run ``moe_ep``'s
decode body alone on one token a lane (``WORK_DIR/params.pkl`` holds
their MoE parameters).  Imports the port only.
"""
import dataclasses
import faulthandler
import json
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 8
JOIN_S = 300.0
COLLECTIVE_TIMEOUT_S = 60.0
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
_MESHES: dict = {}


def mesh(shape):
    """The mesh of ``shape`` over the group that is up, made once a
    shape."""
    from repro_torch.launch.mesh import make_mesh
    shape = tuple(shape)
    if shape not in _MESHES:
        _MESHES[shape] = make_mesh(shape, AXES[len(shape)], "cpu")
    return _MESHES[shape]


def arch(c: dict):
    from repro_torch.configs import get_arch, tiny_config
    return dataclasses.replace(tiny_config(get_arch(c["arch"])),
                               **c.get("replace", {}))


def greedy(logits: torch.Tensor, cfg) -> torch.Tensor:
    """The next tokens: the argmax, tiled over a codebook model's K."""
    tok = logits.argmax(-1).to(torch.int32)
    if cfg.num_codebooks:
        tok = tok[:, None].expand(-1, cfg.num_codebooks).contiguous()
    return tok


def put(out: dict, prefix: str, tree) -> None:
    from repro_torch import _tree
    for path, leaf in _tree.flatten(tree):
        out[f"{prefix}/{_tree.key(path)}"] = leaf.detach().float().numpy()


def serve(c: dict, inp, params_np, ctx):
    """Prefill and ``c["steps"]`` greedy steps of case ``c`` with ``ctx``
    (None: the one-card path): the whole logits of each, the tokens fed
    and the whole final state."""
    from repro_torch.models import decoding
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.sharding import P
    from repro_torch.train import steps
    cfg = arch(c)
    name = c["name"]
    whole = params_from_jax(params_np[c["params"]], cfg, "cpu")
    tokens = torch.from_numpy(inp[f"{name}/tokens"])
    patches = torch.from_numpy(inp[f"{name}/patches"]) \
        if f"{name}/patches" in inp.files else None
    b = tokens.shape[0]
    if ctx is None:
        params, specs, s_specs = whole, None, None
        local = lambda t: t                               # noqa: E731
        gather = lambda t: t                              # noqa: E731
    else:
        specs = steps.param_specs(whole, ctx)
        params = ctx.shard_tree(whole, specs)
        s_specs = decoding.decode_state_specs(decoding.init_decode_state(
            cfg, b, c["max_len"], torch.float32, "meta"), ctx)
        ax = ctx.batch_axes_for(b) or None

        def local(t):
            return ctx.shard(t, P(ax, *([None] * (t.dim() - 1))))

        def gather(t):
            return ctx.gather(t, P(ax, *([None] * (t.dim() - 1))))
    with torch.no_grad():
        logits, state, lengths = decoding.prefill(
            params, cfg, local(tokens),
            None if patches is None else local(patches),
            max_len=c["max_len"], ctx=ctx, specs=specs)
        seen, fed = [gather(logits)], []
        for _ in range(c["steps"]):
            tok = greedy(seen[-1], cfg)
            fed.append(tok)
            logits, state = decoding.decode_step(
                params, cfg, state, local(tok), lengths, ctx=ctx,
                specs=specs, state_specs=s_specs)
            lengths = lengths + 1
            seen.append(gather(logits))
        if ctx is not None:
            state = ctx.gather_tree(state, s_specs)
    return seen, fed, state


def record(out: dict, name: str, seen, fed, state) -> None:
    for i, lg in enumerate(seen):
        out[f"{name}/logits/{i}"] = lg.numpy()
    out[f"{name}/tokens"] = torch.stack(fed).numpy()
    put(out, f"{name}/state", state)


def moe_decode_case(c: dict, inp, params_np, ctx, out: dict) -> None:
    """``moe_ep``'s decode body on this rank's block of one token a lane
    (``[B_loc, 1, D]``, fewer tokens than model ranks): y gathered whole,
    and every data block's ``lb_loss`` and ``overflow``."""
    from repro_torch.models import moe
    from repro_torch.models.convert import tree_from_numpy
    from repro_torch.parallel.collectives import all_gather
    cfg = arch(c)
    name = c["name"]
    params = tree_from_numpy(params_np[name], "cpu")
    x = torch.from_numpy(inp[f"{name}/x"])
    local, xl = moe.ep_local(params, x, ctx)
    assert xl.shape[0] * xl.shape[1] % ctx.model_size, "not the decode body"
    with torch.no_grad():
        y, aux = moe.moe_ep(local, xl, cfg, ctx, cap_factor=c["cf"])
    y = ctx.gather(y, ctx.act_for(x.shape[0]))
    figs = all_gather(torch.stack([aux["lb_loss"], aux["overflow"]]),
                      ctx.mesh.group("data"), tiled=False)
    if torch.distributed.get_rank() == 0:
        out[f"{name}/y"] = y.numpy()
        out[f"{name}/figures"] = figs.numpy()


def rank_main(rank: int, work: str) -> None:
    torch.set_num_threads(1)
    # a rank still running near the join limit prints where it waits
    faulthandler.dump_traceback_later(JOIN_S - 20, exit=True)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    import torch.distributed as dist
    from repro_torch.launch.mesh import ctx_for_mesh, init_group
    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    with open(os.path.join(work, "params.pkl"), "rb") as f:
        params_np = pickle.load(f)   # written by the test, numpy leaves
    inp = np.load(os.path.join(work, "inputs.npz"))
    out: dict = {}
    timing = {}
    init_group("gloo", rank, WORLD, os.path.join(work, "store"),
               COLLECTIVE_TIMEOUT_S)
    try:
        for c in cases["mesh"]:
            t0 = time.monotonic()
            ctx = ctx_for_mesh(mesh(c["mesh"]), **c.get("ctx", {}))
            seen, fed, state = serve(c, inp, params_np, ctx)
            if rank == 0:
                record(out, c["name"], seen, fed, state)
            timing[c["name"]] = time.monotonic() - t0
        for c in cases["moe_decode"]:
            moe_decode_case(c, inp, params_np, ctx_for_mesh(mesh(
                c["mesh"])), out)
    finally:
        dist.destroy_process_group()
        _MESHES.clear()
    if rank == 0:
        # a mesh of one rank beside ctx=None, in a group of its own
        init_group("gloo", 0, 1, os.path.join(work, "store_one"),
                   COLLECTIVE_TIMEOUT_S)
        try:
            for c in cases["one_rank"]:
                t0 = time.monotonic()
                ctx = ctx_for_mesh(mesh(c["mesh"]), **c.get("ctx", {}))
                record(out, c["name"], *serve(c, inp, params_np, ctx))
                record(out, c["name"] + "/unsharded",
                       *serve(c, inp, params_np, None))
                timing[c["name"]] = time.monotonic() - t0
        finally:
            dist.destroy_process_group()
        out["timing"] = np.array(json.dumps(timing))
        np.savez(os.path.join(work, "port.npz"), **out)


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
