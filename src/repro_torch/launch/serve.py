"""Serving launcher: batched requests through the Jet-admitted engine, on
the card unless ``--device cpu`` (the counterpart of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --tiny --device cpu --requests 6 --prompt-len 16 --max-new 8

``--arch`` takes every architecture of the registry; llama-3.2-vision-11b
and musicgen-large raise ``ValueError`` (the engine feeds token prompts;
their patches and codebook tokens go through ``repro_torch.models.api``).
xlstm-125m's prefill needs a prompt length that is a multiple of 128
above 128 tokens.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    from ..configs import ARCHS
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .._device import resolve_device
    from ..configs import get_arch, tiny_config
    from ..models import api as model_api
    from ..serving.engine import EngineConfig, Request, ServingEngine

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.tiny:
        cfg = tiny_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_api.init_params(cfg, gen, device=dev)
    engine = ServingEngine(cfg, EngineConfig(max_lanes=args.lanes,
                                             max_len=args.max_len),
                           params, device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = rng.integers(2, cfg.vocab_size,
                              size=args.prompt_len).astype(np.int32)
        engine.submit(Request(i, prompt, args.max_new))
    engine.run_until_done(max_ticks=args.requests * (args.max_new + 4))
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in engine.done.values())
    print(f"served {len(engine.done)}/{args.requests} requests, "
          f"{total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s) on {dev}")
    print("jet:", engine.jet.stats())


if __name__ == "__main__":
    main()
