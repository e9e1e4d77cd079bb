"""Training launcher (``repro.launch.train``), on the card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --tiny --device cpu --steps 2 --batch 2 --seq 32

The reference's flags, plus ``--device``.  ``--mesh`` takes only
``1x1``, where the reference trains with an MoE capacity factor of 2.0
and so does this launcher; a larger mesh needs ROADMAP Queue 1 A4 and
raises.  The reference's ``--host-devices`` (JAX's host device count)
has no counterpart.  On the card the SSD families (zamba2-1.2b) raise:
the SSD scan has no backward kernel yet.
"""
from __future__ import annotations

import argparse

from ..train.loop import BUILD_DIR


def main(argv=None) -> None:
    from ..configs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1x1",
                    help="1x1 only: one card (larger meshes: ROADMAP "
                         "Queue 1 A4)")
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
    if args.mesh != "1x1":
        raise ValueError(f"--mesh {args.mesh}: the port trains on one card "
                         f"(1x1); a device mesh is ROADMAP Queue 1 A4")

    import torch

    from .._device import resolve_device
    from ..configs import ShapeConfig, get_arch, tiny_config
    from ..data import pipeline
    from ..optim import adamw
    from ..train import loop as loop_mod

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.tiny:
        cfg = tiny_config(cfg)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    data = pipeline.for_arch(cfg, shape, seed=args.seed)
    opt_cfg = adamw.OptConfig(lr=args.lr, int8_moments=args.int8_moments,
                              total_steps=args.steps)
    loop_cfg = loop_mod.LoopConfig(total_steps=args.steps,
                                   ckpt_every=args.ckpt_every,
                                   ckpt_dir=args.ckpt_dir)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = loop_mod.run(cfg, opt_cfg, loop_cfg, data, gen,
                       accum_steps=args.accum, device=dev, remat=args.remat,
                       cap_factor=2.0)
    for h in out["history"]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"dt {h['dt']*1e3:.0f}ms"
              + (" [straggler]" if h["straggler"] else ""))
    print(f"final step {out['final_step']}, "
          f"straggler flags: {out['straggler_flags']} (on {dev})")


if __name__ == "__main__":
    main()
