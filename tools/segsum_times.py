#!/usr/bin/env python3
"""Time the sparse tick's segment sum (``fused.seg_sum``) of one checkout
on one CUDA card, at the pod path's shapes and at a large one.

    python3 tools/segsum_times.py [--root CHECKOUT] [--iters 2000]

Imports ``repro_torch`` from ``CHECKOUT/src`` (default: this checkout), so
that two checkouts can be compared by running the script once for each on
the same card, in turns.  The shapes are ``chip_smoke.py``'s ``seg_sum``
rows: the plans of ``pod_incast_grid`` at 256 and 1,024 hosts (a slot row
into the (TC, port) bins, every slot entry into them, a slot row into the
ports; at 1,024 hosts also slot 5, 768 of its 769 entries in one bin) and
[4096, 24576] values into 12,291 bins.  For each kernel variant the
checkout has (``_variant``; one otherwise), at each shape: CUDA-event
milliseconds a call over back-to-back calls, the host's microseconds a
call (no sync in the loop) and the kernel's device microseconds a launch
(``torch.profiler``, averaged over the launches it recorded).  Prints one
JSON line with the card (``nvidia-smi`` name and power limit).
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def shapes():
    """(label, rows, bin index, bins) of every timed shape."""
    import numpy as np
    from repro_torch.fabric import pod_incast_grid
    from repro_torch.fabric.vector import FabricSweepParams, _seg_plans
    out = []
    for job, (pods, leaves) in (("pod256", (4, 4)), ("pod1024", (4, 16))):
        fsp = FabricSweepParams.from_scenarios(pod_incast_grid(
            pods=pods, leaves_per_pod=leaves, hosts_per_leaf=16,
            burst_mb=0.2, sim_time_s=1e-5)[0], sparse=True)
        plans = _seg_plans(fsp, "cpu")
        picks = [("slot row -> (TC, port)", plans["qp_k"][1]),
                 ("all slots -> (TC, port)", plans["qp_flat"]),
                 ("slot row -> port", plans["po_k"][1])]
        if job == "pod1024":
            picks.append(("slot 5 -> (TC, port)", plans["qp_k"][5]))
        for what, pl in picks:
            out.append((f"{job} {what}", fsp.n_points, pl.idx.numpy(),
                        pl.size))
    out.append(("large", 4096,
                np.random.default_rng(60).integers(0, 3 * 4097, 24576),
                3 * 4097))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("segsum_times: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fabric import fused
    variants = (list(fused.SEG_VARIANTS)
                if "_variant" in inspect.signature(fused.seg_sum).parameters
                else ["default"])
    rows_out = []
    for label, rows, idx, size in shapes():
        rng = np.random.default_rng(1)
        vals = torch.from_numpy(rng.choice(
            np.array([1e8, 1.0, -1e8, 0.3, -2.5, 0.0], np.float32),
            size=(rows, idx.size))).cuda()
        plan = fused.seg_plan(idx, size, "cuda")
        iters = args.iters if label != "large" else 20
        row = {"case": label, "shape": [rows, int(idx.size)], "bins": size,
               "longest": int(np.diff(plan.offsets.cpu().numpy()).max())}
        for var in variants:
            kw = {} if var == "default" else {"_variant": var}

            def call():
                return fused.seg_sum(vals, plan, **kw)
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                call()
            b.record()
            torch.cuda.synchronize()
            ms = a.elapsed_time(b) / iters
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            host = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
                time.sleep(0.1)
            ev = [e for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0
                  and "seg_sum" in e.key]
            count = sum(e.count for e in ev)
            dev_us = (sum(e.device_time_total for e in ev) / count
                      if count else None)
            row[var] = {"ms": ms, "host_us": host, "device_us": dev_us,
                        "kernels": sorted({e.key[:60] for e in ev})}
        rows_out.append(row)
    print(json.dumps({"tool": "segsum_times", "root": str(root),
                      "card": card_line(), "rows": rows_out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
