"""The real-rank side of ``tests/test_torch_dryrun.py``: the sharded
train step, prefill and decode step of tiny configs traced on rank 0 of
8 gloo ranks, one CPU process a rank, against which the test holds the
dry-run's placeholder trace.

    PYTHONPATH=src python tests/torch_dryrun_ranks.py OUT_JSON

spawns the ranks, which meet through a file store beside ``OUT_JSON``;
each builds a tiny config's train state from a seed, takes its blocks,
and traces one step of ``train.steps.make_train_step(..., ctx=)`` on the
(data 2, model 4) mesh with ``launch.hlo_analysis.trace``; then, for
``SERVE_ARCHS``, ``models.decoding.prefill`` of a prompt of ``SEQ``
tokens and ``decode_step`` against a zero cache of ``SEQ`` slots, under
``torch.no_grad()``.  Rank 0 writes the collectives of each (op, operand
and result shapes and types, group size, in order) to ``OUT_JSON``,
keyed by the arch, and by ``arch/prefill`` and ``arch/decode``.  A rank that waits more than ``JOIN_S``
for the others raises.  Imports the port only.
"""
import json
import os
import sys

import torch
import torch.multiprocessing as mp

WORLD = 8
MESH = (2, 4)
ARCHS = ("h2o-danube-1.8b", "zamba2-1.2b", "llama4-scout-17b-a16e")
SERVE_ARCHS = ("h2o-danube-1.8b", "zamba2-1.2b")
BATCH, SEQ = 4, 32
JOIN_S = 180.0               # the ranks' meeting and each collective


def collectives(ops) -> list:
    """The collectives of a trace as JSON rows: [name, inputs, outputs,
    group]."""
    return json.loads(json.dumps([[op.name, op.inputs, op.outputs, op.group]
                                  for op in ops if op.coll]))


def serve_collectives(name: str, ctx) -> dict:
    """The collectives of this rank's prefill and decode step of the tiny
    ``name`` (parameters from a seed, a synthetic prompt, a zero cache)."""
    from repro_torch import _tree
    from repro_torch.configs import ShapeConfig, get_arch, tiny_config
    from repro_torch.launch import hlo_analysis
    from repro_torch.models import api, decoding
    from repro_torch.train import steps
    cfg = tiny_config(get_arch(name))
    params = api.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    specs = steps.param_specs(params, ctx)
    params = _tree.tree_map(torch.Tensor.clone,
                            ctx.shard_tree(params, specs))
    out = {}
    for kind in ("prefill", "decode"):
        inp = api.synthetic_inputs(cfg, ShapeConfig("ranks", kind, SEQ,
                                                    BATCH),
                                   torch.Generator().manual_seed(1),
                                   torch.float32, "cpu")
        if kind == "prefill":
            batch = steps.shard_batch(inp, ctx)

            def fn():
                return decoding.prefill(params, cfg, batch["tokens"],
                                        max_len=SEQ, ctx=ctx, specs=specs)
        else:
            s_specs = decoding.decode_state_specs(inp["state"], ctx)
            state = _tree.tree_map(torch.Tensor.clone, ctx.shard_tree(
                inp["state"], s_specs))
            tokens, lengths = steps.shard_batch((inp["tokens"],
                                                 inp["lengths"]), ctx)

            def fn():
                return decoding.decode_step(params, cfg, state, tokens,
                                            lengths, ctx=ctx, specs=specs,
                                            state_specs=s_specs)
        with torch.no_grad():
            out[f"{name}/{kind}"] = collectives(hlo_analysis.trace(fn).ops)
    return out


def rank_main(rank: int, out: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch import _tree
    from repro_torch.configs import ShapeConfig, get_arch, tiny_config
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import ctx_for_mesh, init_group, make_mesh
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    init_group("gloo", rank, WORLD, out + ".store", timeout_s=JOIN_S)
    try:
        ctx = ctx_for_mesh(make_mesh(MESH, ("data", "model"), "cpu"))
        res = {}
        for name in ARCHS:
            cfg = tiny_config(get_arch(name))
            opt = adamw.OptConfig()
            state = steps.init_state(
                cfg, opt, torch.Generator().manual_seed(0), "cpu")
            state = _tree.tree_map(torch.Tensor.clone,
                                   steps.shard_state(state, ctx))
            batch = api.synthetic_inputs(
                cfg, ShapeConfig("ranks", "train", SEQ, BATCH),
                torch.Generator().manual_seed(1), torch.float32, "cpu")
            batch = steps.shard_batch(batch, ctx)
            step = steps.make_train_step(cfg, opt, torch.float32, ctx=ctx)
            res[name] = collectives(hlo_analysis.trace(step, state,
                                                       batch).ops)
        for name in SERVE_ARCHS:
            res.update(serve_collectives(name, ctx))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main(out: str) -> int:
    if os.path.exists(out + ".store"):
        os.remove(out + ".store")
    mp.start_processes(rank_main, args=(out,), nprocs=WORLD,
                       start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
