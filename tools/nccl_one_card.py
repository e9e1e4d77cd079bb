#!/usr/bin/env python3
"""Can NCCL put two ranks on one card?  Spawns ``--ranks`` processes that
all bind card 0 and start an NCCL group through a file store, then
all-reduce a small tensor.  Prints the card (``nvidia-smi`` name and
power limit), then one JSON line a rank: the all-reduce's result, or the
error NCCL raised.  Exits 0 either way, nonzero only if a rank neither
finished nor failed within ``--timeout`` seconds (its processes are
killed then).

    python3 tools/nccl_one_card.py [--ranks 2] [--timeout 120]

This is why ``chip_smoke.py`` runs the distribution layer on a one-rank
mesh: NCCL 2.28.9 refuses a second rank on the same device
("Duplicate GPU detected").
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rank_main(rank: int, world: int, store: str) -> None:
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import init_group
    try:
        init_group("nccl", rank, world, store, timeout_s=60,
                   device=torch.device("cuda:0"))
        t = torch.full((4,), float(rank + 1), device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(json.dumps({"rank": rank, "result": t.tolist()}), flush=True)
        dist.destroy_process_group()
    except Exception as e:    # noqa: BLE001 -- the finding is the error
        last = str(e).strip().splitlines()
        print(json.dumps({"rank": rank, "error": type(e).__name__,
                          "message": [ln for ln in last if ln][-3:],
                          "traceback": traceback.format_exc()[-600:]}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("nccl_one_card: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"torch": torch.__version__,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "ranks": args.ranks, "card": 0}), flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        procs = mp.start_processes(
            rank_main, args=(args.ranks, os.path.join(d, "store")),
            nprocs=args.ranks, start_method="spawn", join=False)
        deadline = time.monotonic() + args.timeout
        try:
            while not procs.join(timeout=1.0):
                if time.monotonic() > deadline:
                    print(json.dumps({"error": f"ranks still running "
                                               f"after {args.timeout} s"}))
                    return 1
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
