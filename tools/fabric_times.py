#!/usr/bin/env python3
"""Wall time per tick of the dense fabric tick on incast48, on one CUDA
card, eager and (where the checkout has it) as a captured CUDA graph.

    python3 tools/fabric_times.py [--root CHECKOUT] [--reps 2] [--chains 1,8]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout),
so that two checkouts can be compared by running the script once for each
on the same card, in turns.  The grid is ``chip_smoke.py``'s main path:
``benchmarks/bench_fabric.py``'s 48-point incast grid (receiver mode x
PFC x 12 burst sizes, 8 senders) at 2 ms (2000 ticks).  After a
20-tick warm-up, ``run_fabric_sweep`` is timed ``--reps`` times a mode
(wall clock; the engine synchronises at its end): ``eager`` is the loop
that issues every kernel from the host (``graph=False``, or the only
loop of a checkout without the graph), ``graph`` the captured replay
(capture included).  ``--chains 1,8,32`` also times the graph at each
chain length (ticks a captured graph chains), in turns, each with its
capture's seconds apart from the replays' ms/tick.  Then a 50-tick eager
run under ``torch.profiler`` counts the kernels a tick.  Prints one JSON
line: the card (``nvidia-smi`` name and power limit), the root, ms/tick
of each rep by mode, the chain timings, the kernels a tick, and the
host's CPU count.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BURSTS_MB = [0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0]


def incast48(sim_time_s: float):
    from repro_torch.fabric import fabric_grid, incast
    return fabric_grid(
        lambda mode, pfc, burst_mb: incast(
            n_senders=8, mode=mode, pfc=pfc, burst_mb=burst_mb,
            sim_time_s=sim_time_s),
        mode=["ddio", "jet"], pfc=[False, True], burst_mb=BURSTS_MB)[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--chains", default="",
                    help="comma-separated chain lengths: also time the "
                    "graph at each (capture apart from the replays)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fabric_times: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fabric import run_fabric_sweep
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    modes = {"eager": {}}
    if "graph" in inspect.signature(run_fabric_sweep).parameters:
        modes = {"eager": {"graph": False}, "graph": {"graph": "auto"}}
    for kw in modes.values():
        run_fabric_sweep(incast48(20e-6), **kw)
    scens = incast48(0.002)
    ms = {m: [] for m in modes}
    for _ in range(args.reps):
        for m, kw in modes.items():
            t0 = time.perf_counter()
            run_fabric_sweep(scens, **kw)
            ms[m].append((time.perf_counter() - t0) / 2000 * 1e3)
    chains = {}
    if args.chains:
        from repro_torch.fabric.vector import FabricRun, FabricSweepParams
        fsp = FabricSweepParams.from_scenarios(scens)
        order = [int(c) for c in args.chains.split(",")]
        for _ in range(args.reps):          # ascending, then descending
            for c in order:
                run = FabricRun(fsp, chain=c)
                t0 = time.perf_counter()
                run.run()
                chains.setdefault(c, []).append(
                    {"capture_s": run.capture_s, "ms_per_tick":
                     (time.perf_counter() - t0) / fsp.ticks * 1e3})
            order.reverse()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # idle time on both sides: the profiler keeps only the device
        # records it places inside the session (chip_smoke.profiled)
        time.sleep(0.5)
        run_fabric_sweep(incast48(50e-6), **modes["eager"])
        torch.cuda.synchronize()
        time.sleep(0.5)
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and getattr(e, "device_time_total", 0) > 0)
    print(json.dumps({"card": card, "root": str(root), "ms_per_tick": ms,
                      "chains": chains, "kernels_per_tick": kernels / 50,
                      "host_cpus": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
