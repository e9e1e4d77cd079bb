"""The real-rank side of ``tests/test_torch_dryrun.py``: the sharded
train step of tiny configs traced on rank 0 of 8 gloo ranks, one CPU
process a rank, against which the test holds the dry-run's placeholder
trace.

    PYTHONPATH=src python tests/torch_dryrun_ranks.py OUT_JSON

spawns the ranks, which meet through a file store beside ``OUT_JSON``;
each builds a tiny config's train state from a seed, takes its blocks,
and traces one step of ``train.steps.make_train_step(..., ctx=)`` on the
(data 2, model 4) mesh with ``launch.hlo_analysis.trace``.  Rank 0 writes
each arch's collectives (op, operand and result shapes and types, group
size, in order) to ``OUT_JSON``.  A rank that waits more than ``JOIN_S``
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
BATCH, SEQ = 4, 32
JOIN_S = 180.0               # the ranks' meeting and each collective


def collectives(ops) -> list:
    """The collectives of a trace as JSON rows: [name, inputs, outputs,
    group]."""
    return json.loads(json.dumps([[op.name, op.inputs, op.outputs, op.group]
                                  for op in ops if op.coll]))


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
