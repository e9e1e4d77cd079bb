#!/usr/bin/env python3
"""The engine-served families alone on one CUDA card: ``chip_smoke.py``'s
two flash rows at the dense and MoE prefill shapes and its three family
serve phases (``serve_danube``, ``serve_scout`` with ``moe_dispatch``
and ``ep_moe``, ``serve_xlstm``), with the same checks, in about a minute; then, for
each phase's model, a ``profile_family`` line: one prefill of its
longest prompt up to 1,024 tokens and 4 four-lane decode steps under
``torch.profiler`` (kernels a step, device busy µs and share over the
step's wall, the top kernels by device time).

    python3 tools/serve_families.py [--phases serve_scout,...]

Builds the kernels from this checkout's sources, then prints the card
(``nvidia-smi`` name and power limit), the JSON lines of each phase as
``chip_smoke.py`` prints them, the seconds of each phase, and exits
nonzero if a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECODE_STEPS = 4


def profile_family(cs, phase: str, dev) -> dict:
    """Prefill and decode of one family phase's model under the
    profiler (fresh seeded weights, a prompt of the phase's lengths)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    arch, layers, prompt_lens, max_len, _ = cs.FAMILY_SERVES[phase]
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.empty_cache()
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    t = max(n for n in prompt_lens if n <= 1024)
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        2, cfg.vocab_size, size=(1, t))).to(dev)
    state = api.init_decode_state(cfg, 4, max_len, device=dev)
    lanes_tok = torch.full((4,), 5, dtype=torch.int32, device=dev)
    lengths = torch.full((4,), t, dtype=torch.int32, device=dev)
    api.prefill(params, cfg, tok, max_len=max_len)          # warm
    api.decode_step(params, cfg, state, lanes_tok, lengths)
    torch.cuda.synchronize()
    out = {"phase": "profile_family", "of": phase, "prompt": t}
    for name, steps in (("prefill", 1), ("decode", DECODE_STEPS)):
        with cs.profiled() as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                if name == "prefill":
                    api.prefill(params, cfg, tok, max_len=max_len)
                else:
                    api.decode_step(params, cfg, state, lanes_tok, lengths)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in rows)
        top = sorted(rows, key=lambda e: -e.device_time_total)[:5]
        out[name] = {
            "steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "kernels_per_step": sum(e.count for e in rows) / steps,
            "device_busy_us_per_step": busy / steps,
            "device_busy_share": busy * 1e-6 / wall,
            "top": [{"kernel": e.key[:70], "count": e.count,
                     "device_us": e.device_time_total} for e in top]}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of the family phases")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_families: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import _build
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    seconds = {"build": time.perf_counter() - t0}
    phases = args.phases.split(",") if args.phases else list(
        cs.FAMILY_SERVES)
    try:
        cs.flash_phase("danube-1.8b prefill", 1, 32, 8, 1024, 1024, 80,
                       True, 4096, "float32", 39, iters=20, plain_iters=3,
                       expect="mma_3xtf32")
        cs.flash_phase("llama4-scout prefill", 1, 40, 8, 1024, 1024, 128,
                       True, None, "float32", 40, iters=20, plain_iters=3,
                       expect="mma_3xtf32")
        for phase in phases:
            t1 = time.perf_counter()
            cs.family_phase(phase, torch.device("cuda"))
            seconds[phase] = time.perf_counter() - t1
    except cs.SmokeFailure as e:
        print(f"serve_families: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        cs.close_nccl()
    for phase in phases:
        profile_family(cs, phase, torch.device("cuda"))
    print(json.dumps({"phase": "serve_families_s", **seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
