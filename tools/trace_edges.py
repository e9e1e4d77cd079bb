#!/usr/bin/env python3
"""Does ``torch.profiler`` see every water-fill kernel that a replayed
CUDA graph of the dense fabric tick executes, with and without idle time
at the edges of its session?  Needs one CUDA card.

    python3 tools/trace_edges.py [--pads 0,0.2] [--reps 3] [--windows 250]

The grid is ``chip_smoke.py``'s main path: incast48 (8 senders, receiver
mode x PFC x 12 burst sizes) at 2 ms, 2,000 ticks, through the captured
graph.  For each pad (seconds of idle time inside the session before
the first replay and after the final synchronize), each rep traces a
fresh run whole, and then one run in windows of each ``--windows``
length (one session a window).  A session counts the grants and admit
kernels by name from the profiler's raw device records; the launch
counts kept on the card (``fused.LAUNCHES``) say how many ran.  A JSON
line a session set: the pad, the window (null: whole), by-name totals,
the device counts, the short sessions (by name, ran), and where the
first and last device records fell against the host's clock (ms after
the first replay was issued; ms before the final synchronize returned,
negative when a record landed after it).  Then the card line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BURSTS_MB = [0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0]


def incast48(sim_time_s: float):
    from repro_torch.fabric import fabric_grid, incast
    return fabric_grid(
        lambda mode, pfc, burst_mb: incast(
            n_senders=8, mode=mode, pfc=pfc, burst_mb=burst_mb,
            sim_time_s=sim_time_s),
        mode=["ddio", "jet"], pfc=[False, True], burst_mb=BURSTS_MB)[0]


def session(advance, pad: float) -> dict:
    """One profiler session over ``advance()``: water-fills by name and
    the edges of the device records on the host's clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        h0 = time.time_ns()
        advance()
        torch.cuda.synchronize()
        h1 = time.time_ns()
        time.sleep(pad)
    cuda = torch.autograd.DeviceType.CUDA
    first = last = None
    grants = admit = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        first = start if first is None else min(first, start)
        last = end if last is None else max(last, end)
        if "grants_kernel" in e.name():
            grants += 1
        elif "admit_kernel" in e.name():
            admit += 1
    return {"grants": grants, "admit": admit,
            "head_ms": (first - h0) * 1e-6 if first is not None else None,
            "tail_ms": (h1 - last) * 1e-6 if last is not None else None}


def traced(fsp, pad: float, window) -> dict:
    from repro_torch.fabric import fused
    from repro_torch.fabric.vector import FabricRun
    run = FabricRun(fsp)
    fused.reset_launches()
    if window is None:
        parts = [(fsp.ticks, session(run.run, pad))]
    else:
        parts = [(window, session(lambda: run.chain.run(window), pad))
                 for _ in range(fsp.ticks // window)]
    ran = fused.LAUNCHES.read()
    return {"pad_s": pad, "window": window,
            "grants": sum(p["grants"] for _, p in parts),
            "admit": sum(p["admit"] for _, p in parts),
            "device": ran, "sessions": len(parts),
            "short": [[p["grants"], 4 * n] for n, p in parts
                      if p["grants"] != 4 * n or p["admit"] != n],
            "head_ms": [p["head_ms"] for _, p in parts][:8],
            "tail_ms": [p["tail_ms"] for _, p in parts][:8]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pads", default="0,0.2")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--windows", default="250")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_edges: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.fabric.vector import FabricSweepParams
    fsp = FabricSweepParams.from_scenarios(incast48(0.002))
    windows = [int(w) for w in args.windows.split(",") if w]
    traced(fsp, 0.0, 500)                       # warm-up
    for pad in (float(p) for p in args.pads.split(",")):
        for _ in range(args.reps):
            print(json.dumps(traced(fsp, pad, None)), flush=True)
        for w in windows:
            print(json.dumps(traced(fsp, pad, w)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
