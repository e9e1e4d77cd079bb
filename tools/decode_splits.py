#!/usr/bin/env python3
"""The paged decode kernel's device time against its split count, and the
host cost of its wrapper, piece by piece, on one CUDA card.

    python3 tools/decode_splits.py

Uses the ``kernel`` rows' inputs of ``chip_smoke.py`` (zamba2's shared
attention, danube-1.8b, starcoder2-15b, gemma-7b, llama4-scout; seeded).
For each row and each forced split count S (and the plan's own), prints
one JSON line with the device microseconds per call of the split kernel
plus the merge (``torch.profiler``, inputs under the L2 cycled through
copies, as ``chip_smoke.py`` does) and of the merge alone.  Then one line
with the host microseconds per call (no sync inside the timed loop) of
``ops.decode_attention`` at zamba2's row and of each piece of the
wrapper, and last the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)


def sweep(cs, jd, torch) -> None:
    rows = [("zamba2", 6, 32, 32, 64, 16, cs.SERVE_PROMPTS, "float32"),
            ("danube-1.8b", 4, 32, 8, 80, 32, [4096, 1, 777, 3000],
             "float32"),
            ("starcoder2-15b", 8, 48, 4, 128, 16,
             [1, 17, 300, 1000, 2048, 4097, 6000, 8192], "bfloat16"),
            ("gemma-7b", 8, 16, 16, 256, 16,
             [1, 300, 1000, 2048, 4096, 4097, 6000, 8192], "bfloat16"),
            ("llama4-scout", 32, 40, 8, 128, 16, [32768] * 32, "bfloat16")]
    sms = jd.sm_count(torch.cuda.current_device())
    for name, b, hq, hkv, d, page, lens, dt in rows:
        tdt = getattr(torch, dt)
        q, kp, vp, table, ln = cs.paged_inputs(b, hq, hkv, d, page, lens,
                                               tdt, 3, False)
        copies = max(1, min(8, -(-int(2 * cs.L2_BYTES)
                                 // (2 * kp.numel() * kp.element_size()))))
        sets = [(kp, vp)] + [(kp.clone(), vp.clone())
                             for _ in range(copies - 1)]
        maxp = table.shape[1]
        auto = jd.plan(tdt, tdt, b, hq, hkv, d, page, maxp, sms)["splits"]
        out = {}
        for s in sorted(set(SPLITS) | {auto}):
            pl = jd.plan(tdt, tdt, b, hq, hkv, d, page, maxp, sms, s)
            fn = cs.cycled(lambda k, v, s=s: jd.decode_attention_paged(
                q, k, v, table, ln, splits=s), sets)
            dev = cs.device_us(fn, list(pl["kernels"]), calls=10)
            out[s] = {"device_us": sum(dev.values()),
                      "merge_us": dev.get("decode_merge_kernel", 0.0)}
        print(json.dumps({"row": name, "plan_splits": auto, "by_splits": out}),
              flush=True)
        del sets, q, kp, vp
        torch.cuda.empty_cache()


def host(cs, jd, ops, torch, calls: int = 500) -> None:
    q, kp, vp, table, ln = cs.paged_inputs(6, 32, 32, 64, 16,
                                           cs.SERVE_PROMPTS, torch.float32,
                                           3, False)
    b, hq, d = q.shape
    n_pool, page, hkv, _ = kp.shape
    maxp = table.shape[1]
    sms = jd.sm_count(torch.cuda.current_device())
    p = jd.plan(q.dtype, kp.dtype, b, hq, hkv, d, page, maxp, sms)
    part = torch.empty(p["splits"] * b * hq * (d + 2), device="cuda")
    out, lse = torch.empty_like(q), torch.empty((b, hq), device="cuda")
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            ln.data_ptr(), out.data_ptr(), lse.data_ptr(), part.data_ptr(),
            b, hq, hkv, d, n_pool, page, maxp, d ** -0.5, 0, 0, 0, sms,
            torch.cuda.current_stream().cuda_stream)
    lib = jd._lib()
    pieces = {
        "ops.decode_attention": lambda: ops.decode_attention(q, kp, vp,
                                                             table, ln),
        "wrapper": lambda: jd.decode_attention_paged(q, kp, vp, table, ln),
        "checks": lambda: jd._check(q, kp, vp, table, ln),
        "three torch.empty": lambda: (
            torch.empty_like(q), torch.empty((b, hq), device=q.device),
            torch.empty(p["splits"] * b * hq * (d + 2), device=q.device)),
        "current_stream": lambda: torch.cuda.current_stream(
            q.device).cuda_stream,
        "ctypes call, both launches": lambda:
            lib.decode_attention_paged_fwd(*args),
    }
    res = {}
    for name, fn in pieces.items():
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            res.setdefault(name, []).append(
                (time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    print(json.dumps({"host_us_per_call": res, "row": "zamba2",
                      "splits": p["splits"]}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_splits: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import jet_decode_attention as jd
    from repro_torch.kernels import ops
    sweep(cs, jd, torch)
    host(cs, jd, ops, torch)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
