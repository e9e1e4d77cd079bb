#!/usr/bin/env python3
"""Prefill latency of zamba2-1.2b through the port's kernels, per prompt
length, on one CUDA card.

    python3 tools/prefill_times.py [--root CHECKOUT] [--reps 5]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout),
so that two checkouts can be compared by running the script once for each
on the same card.  Builds full-width zamba2-1.2b in float32 with seeded
random weights, then for each prompt length of the serve path times
``api.prefill`` (wall clock, a sync on either side) after one warm-up,
``--reps`` times.  Prints one JSON line: the card (``nvidia-smi`` name
and power limit), the root, and for each length the median and minimum
milliseconds.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

LENGTHS = (64, 128, 256, 512, 1024)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("prefill_times: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    cfg, dev = get_arch("zamba2-1.2b"), torch.device("cuda")
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(7)
    out = {}
    for n in LENGTHS:
        tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(1, n))
                               .astype(np.int64)).to(dev)
        api.prefill(params, cfg, tok, max_len=1280)
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.prefill(params, cfg, tok, max_len=1280)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[n] = {"median_ms": statistics.median(times),
                  "min_ms": min(times)}
    print(json.dumps({"card": card, "root": str(root),
                      "prefill_ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
