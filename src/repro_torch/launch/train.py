"""Training launcher (``repro.launch.train``), on the card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --tiny --device cpu --steps 2 --batch 2 --seq 32

The reference's flags, plus ``--device`` and ``--seed``.  ``--mesh 1x1``
(the default) trains in this one process, with an MoE capacity factor of
2.0 as the reference's.  ``--mesh DxM`` (data x model) or ``PxDxM``
(pod x data x model) trains the sharded step with one process a rank,
started by ``torch.distributed.run``, which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``:

  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch h2o-danube-1.8b --tiny \\
      --device cpu --mesh 2x2 --steps 2 --batch 4 --seq 32

gloo on CPU processes with ``--device cpu``, NCCL with one card a rank
otherwise.  Rank 0 prints the loss, the mean over the data blocks.
``single`` and ``multi``, the 256- and 512-chip production meshes, have
no processes to run on here and raise: their programs are the dry-run's
(ROADMAP Queue 1 A4c).  The reference's ``--host-devices`` (JAX's host
device count) has no counterpart.  On the card every family trains
through the kernels: the SSD families (zamba2-1.2b) through the SSD
scan's backward kernel, the attention families through flash
attention's.
"""
from __future__ import annotations

import argparse
import math
import os

from ..train.loop import BUILD_DIR


def parse_mesh(text: str):
    """``"DxM"`` -> ((D, M), ("data", "model")); ``"PxDxM"`` adds
    ``pod``."""
    if text in ("single", "multi"):
        raise ValueError(f"--mesh {text}: the production mesh of "
                         f"{256 if text == 'single' else 512} chips has no "
                         f"processes to run on here; its program is the "
                         f"dry-run's (launch.dryrun, ROADMAP Queue 1 A4c)")
    try:
        shape = tuple(int(v) for v in text.split("x"))
    except ValueError:
        shape = ()
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}
    if len(shape) not in axes or min(shape) < 1:
        raise ValueError(f"--mesh {text!r}: want DxM or PxDxM, e.g. 2x4")
    return shape, axes[len(shape)]


def _mesh_ctx(shape, axes, device: str):
    """This process's rank of the mesh: the process group from the
    variables ``torch.distributed.run`` sets, gloo on CPU processes and
    NCCL with one card a rank otherwise."""
    import datetime

    import torch
    import torch.distributed as dist

    from .mesh import ctx_for_mesh, make_mesh
    need = math.prod(shape)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise ValueError(
            f"--mesh {'x'.join(map(str, shape))} needs {need} ranks, one "
            f"process each; this process is one of {world}: start it with "
            f"python -m torch.distributed.run --nproc-per-node {need}")
    cpu = device == "cpu"
    dev = torch.device("cpu") if cpu else \
        torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if not cpu:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl",
                            timeout=datetime.timedelta(seconds=300),
                            **({} if cpu else {"device_id": dev}))
    return ctx_for_mesh(make_mesh(shape, axes)), dev


def main(argv=None) -> None:
    from ..configs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM process mesh (one rank a process; "
                         "start with torch.distributed.run)")
    ap.add_argument("--tiny", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--ckpt-dir", default=str(BUILD_DIR / "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "layer_out", "none"])
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    shape, axes = parse_mesh(args.mesh)

    import torch

    from .._device import resolve_device
    from ..configs import ShapeConfig, get_arch, tiny_config
    from ..data import pipeline
    from ..optim import adamw
    from ..train import loop as loop_mod

    dev = resolve_device(args.device)
    ctx, rank = None, 0
    if math.prod(shape) > 1:
        ctx, dev = _mesh_ctx(shape, axes, dev.type)
        rank = torch.distributed.get_rank()
    cfg = get_arch(args.arch)
    if args.tiny:
        cfg = tiny_config(cfg)
    shape_cfg = ShapeConfig("cli", "train", args.seq, args.batch)
    data = pipeline.for_arch(cfg, shape_cfg, seed=args.seed)
    opt_cfg = adamw.OptConfig(lr=args.lr, int8_moments=args.int8_moments,
                              total_steps=args.steps)
    loop_cfg = loop_mod.LoopConfig(total_steps=args.steps,
                                   ckpt_every=args.ckpt_every,
                                   ckpt_dir=args.ckpt_dir)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    try:
        out = loop_mod.run(cfg, opt_cfg, loop_cfg, data, gen,
                           accum_steps=args.accum, device=dev,
                           remat=args.remat,
                           cap_factor=None if ctx else 2.0, ctx=ctx)
    finally:
        if ctx is not None:
            torch.distributed.destroy_process_group()
    if rank:
        return
    for h in out["history"]:
        print(f"step {h['step']:5d} loss {h['loss']:.6f} "
              f"dt {h['dt']*1e3:.0f}ms"
              + (" [straggler]" if h["straggler"] else ""))
    where = f"mesh {args.mesh}, {dev.type}" if ctx else str(dev)
    print(f"final step {out['final_step']}, "
          f"straggler flags: {out['straggler_flags']} (on {where})")


if __name__ == "__main__":
    main()
