#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Each phase prints one JSON line:

1. ``card``: the card's name and power limit (``nvidia-smi``), the
   PyTorch/CUDA versions, and the CUDA kernels' build from the sources
   in the checkout (seconds, ptxas register report).
2. ``kernel``: each CUDA kernel at the main path's shape and at one large
   shape, on seeded inputs, held against its plain PyTorch version on the
   card bit for bit; per-call time of both from CUDA events, and the
   bound (bytes moved over the card's memory rate).
3. ``main_path``: the fabric bench's 48-point, 8-sender incast grid
   (receiver mode x PFC x 12 burst sizes) at full width, depth cut from
   20 ms to 2 ms, through ``run_fabric_sweep`` on the card.  Every launch
   counter must move by exactly 4 (grants) / 1 (admit) per tick, and the
   float32 card run must match a float64 CPU run of the same grid within
   5e-4 relative on goodput and incast completion, with identical finite
   masks.
4. ``profile``: a 50-tick run of the same grid under ``torch.profiler``:
   kernels launched per tick, device busy share, the water-fills' device
   time per launch and the top kernels by device time.

Then the card line as ``nvidia-smi`` prints it, the ``kernels`` summary
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
nonzero; without CUDA, or without the package beside it, the script exits
nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TOL = 5e-4                  # bench_floors.json dev_goodput_vs_numpy
SIM_TIME_S = 0.002          # depth cut: 20 ms -> 2 ms (2000 ticks)
BURSTS_MB = [0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0]
KERNEL_SOURCE = "src/repro_torch/csrc/fused_waterfill.cu"
REPLACES = {"priority_grants": "src/repro/fabric/fused.py:99",
            "priority_admit": "src/repro/fabric/fused.py:142"}
LARGE = (4096, 3, 4096)


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def incast_grid(sim_time_s: float):
    """``benchmarks/bench_fabric.py:_incast_grid`` in the port's terms."""
    from repro_torch.fabric import fabric_grid, incast
    scens, _ = fabric_grid(
        lambda mode, pfc, burst_mb: incast(
            n_senders=8, mode=mode, pfc=pfc, burst_mb=burst_mb,
            sim_time_s=sim_time_s),
        mode=["ddio", "jet"], pfc=[False, True], burst_mb=BURSTS_MB)
    return scens


def rel(a, b) -> float:
    """Max relative deviation; inf when the finite masks differ."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        return math.inf
    m = np.isfinite(b)
    if not m.any():
        return 0.0
    return float(np.max(np.abs(a[m] - b[m])
                        / np.maximum(np.abs(b[m]), 1e-9)))


def cuda_ms(fn, iters: int) -> float:
    """Per-call time from CUDA events around ``iters`` back-to-back calls
    (after a warm-up): device time when the card is the bottleneck, the
    host's issue time per call when the calls are too small to be."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def waterfill_inputs(shape, seed: int):
    """Seeded inputs on the card: demands with zeros, all-False ``can``
    rows, zero budgets (the edge cases of the water-fill)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    g, q, n = shape
    demand = rng.uniform(0.0, 4.0, shape).astype(np.float32)
    demand[rng.random(shape) < 0.2] = 0.0
    can = rng.random(shape) < 0.7
    can[0] = False
    budget = rng.uniform(0.0, 6.0, (g, n)).astype(np.float32)
    budget[:, rng.random(n) < 0.1] = 0.0
    crumb = np.full((g, n), 1e-3, np.float32)
    return [torch.from_numpy(a).cuda() for a in (demand, can, budget,
                                                 crumb)]


def bitwise_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def kernel_phase(name: str, shape, seed: int, iters: int) -> dict:
    """Hold one kernel against its plain version at ``shape``."""
    from repro_torch.fabric import fused
    demand, can, budget, crumb = waterfill_inputs(shape, seed)
    g, q, n = shape
    if name == "priority_grants":
        def kernel():
            return fused.priority_grants(demand, can, budget, crumb)

        def plain():
            return fused.priority_grants_ref(demand, can, budget, crumb)
        # demand + can + out per cell, budget + crumb per column
        nbytes = g * q * n * (4 + 1 + 4) + g * n * (4 + 4)
        ops = g * q * n * 7
    else:
        def kernel():
            return fused.priority_admit(demand, budget)

        def plain():
            return fused.priority_admit_ref(demand, budget)
        nbytes = g * q * n * (4 + 4) + g * n * 4
        ops = g * q * n * 2
    got, want = kernel(), plain()
    import torch
    torch.cuda.synchronize()
    equal = bitwise_equal(got, want)
    err = float((got - want).abs().max().item()) if got.numel() else 0.0
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    row = {"name": name, "shape": list(shape), "bitwise_equal": equal,
           "max_abs_err": err, "ms": cuda_ms(kernel, iters),
           "plain_ms": cuda_ms(plain, iters),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    emit("kernel", **row)
    check(equal, f"{name} kernel != plain version at {list(shape)}")
    return row


def main_path() -> dict:
    import torch
    from repro_torch.fabric import fused
    from repro_torch.fabric.vector import (FabricSweepParams,
                                           run_fabric_sweep)
    scens = incast_grid(SIM_TIME_S)
    fsp = FabricSweepParams.from_scenarios(scens)
    ticks = fsp.ticks
    # warm-up on the same grid shape (CUDA context, cuBLAS handles)
    run_fabric_sweep(incast_grid(20e-6))
    fused.reset_launches()
    t0 = time.perf_counter()
    res = run_fabric_sweep(scens, impl="auto")
    wall = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    t0 = time.perf_counter()
    oracle = run_fabric_sweep(scens, device="cpu", dtype=torch.float64)
    cpu_wall = time.perf_counter() - t0
    G, F = fsp.n_points, fsp.n_flows
    dev = {k: rel(res[k], oracle[k]) for k in
           ("flow_goodput_gbps", "incast_completion_us",
            "victim_goodput_gbps", "flow_delivered_bytes")}
    out = {"points": G, "flows": F, "ports": fsp.n_ports,
           "receivers": fsp.n_recv, "ticks": ticks,
           "sim_time_s": SIM_TIME_S, "wall_s": wall,
           "ms_per_tick": wall / ticks * 1e3, "launches": launches,
           "cpu_float64_wall_s": cpu_wall,
           "dev_goodput": dev["flow_goodput_gbps"],
           "dev_incast_fct": dev["incast_completion_us"],
           "dev_victim_goodput": dev["victim_goodput_gbps"],
           "dev_delivered_bytes": dev["flow_delivered_bytes"],
           "incast_finite": int(sum(
               math.isfinite(x) for x in res["incast_completion_us"])),
           "pause_fanout_max": int(res["pause_fanout"].max()),
           "cnps_total": float(res["recv_cnp_count"].sum())}
    emit("main_path", **out)
    check(launches["priority_grants"] == 4 * ticks,
          f"grants launched {launches['priority_grants']}x, want "
          f"{4 * ticks}")
    check(launches["priority_admit"] == ticks,
          f"admit launched {launches['priority_admit']}x, want {ticks}")
    check(res["flow_goodput_gbps"].shape == (G, F), "goodput shape")
    check(res["incast_completion_us"].shape == (G,), "completion shape")
    import numpy as np
    check(bool(np.isfinite(res["flow_goodput_gbps"]).all()),
          "non-finite goodput")
    check(dev["flow_goodput_gbps"] <= TOL,
          f"goodput deviates {dev['flow_goodput_gbps']} > {TOL}")
    check(dev["incast_completion_us"] <= TOL,
          f"incast completion deviates {dev['incast_completion_us']} > "
          f"{TOL} (inf = finite masks differ)")
    return out


def profile_phase() -> None:
    """Kernel launches per tick and device busy share over a short run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fabric.vector import run_fabric_sweep
    scens = incast_grid(50e-6)
    ticks = 50
    run_fabric_sweep(scens)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_fabric_sweep(scens)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in rows)
    busy_us = sum(e.device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.device_time_total)[:8]
    # device time per launch of the port's own kernels on the main path
    own = {name: [e for e in rows if f"{name}_kernel" in e.key]
           for name in ("grants", "admit")}
    emit("profile", ticks=ticks, wall_s=wall,
         kernels_per_tick=launches / ticks,
         device_busy_us_per_tick=busy_us / ticks,
         device_busy_share=busy_us * 1e-6 / wall if wall else None,
         own_kernels={name: {
             "count": sum(e.count for e in es),
             "device_us_per_launch": sum(e.device_time_total for e in es)
             / max(1, sum(e.count for e in es))}
             for name, es in own.items()},
         top=[{"kernel": e.key[:80], "count": e.count,
               "device_us": e.device_time_total} for e in top])


def run() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    try:
        card = card_line()
        t0 = time.perf_counter()
        builds = _build.build_all()
        emit("card", nvidia_smi=card, torch=torch.__version__,
             cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
             build_s=time.perf_counter() - t0, builds=builds,
             ptxas=[ln.strip() for log in _build.BUILD_LOG.values()
                    for ln in log.splitlines() if "registers" in ln])
        rows = {}
        for name, main_shape, seed in (
                ("priority_grants", (48, 3, 14), 1),
                ("priority_admit", (48, 3, 2), 2)):
            rows[name] = kernel_phase(name, main_shape, seed, iters=2000)
            kernel_phase(name, LARGE, seed + 10, iters=20)
        main = main_path()
        profile_phase()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": main["launches"][name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None}
        for name, r in rows.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
