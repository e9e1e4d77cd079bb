#!/usr/bin/env python3
"""Time the flash attention backward's tensor-core passes under other tile
plans, on one CUDA card.

    python3 tools/flash_bwd_plans.py [--plans NAME=SPEC ...] [--rows ...]

Each plan is a copy of ``csrc/flash_attention_bwd.cu`` whose ``Plan``
stage sizes (and ring depth, and the float32 flush interval) differ from
the source's at some type and head-dim tile; the copies are built in
parallel under ``build/flash_bwd_plans/`` (``nvcc``, the package's
flags) and called
through ``ctypes`` like the package's own library.  A SPEC is a comma list
of ``<f32|bf16>/<head-dim tile>/<bq|bk>=<rows>`` overrides (``bq``: the
dk/dv pass's query rows a stage; ``bk``: the dq pass's keys a stage),
``stages=<n>`` and ``flush=<rows>`` (``kFlushRows``: float32 adds its
accumulators into the output every that many rows); ``current`` (the
source as it is) is always built.  The default plans are the ones the
source's choices were made from:

* ``first``: the plan first shipped (float32 at D = 128 and bfloat16 at
  D = 256 with 32-row dk/dv stages, float32's dq stage 32 at D = 128);
* ``wide80``: 64-row stages for float32 at D = 80 (one block an SM);
* ``dq64``: float32's dq stage 64 at D = 80 and 32 at D = 128;
* ``mixed80``: float32 at D = 80 with a 64-row dk/dv stage, 32-key dq;
* ``stages3``: a 3-deep ring;
* ``flush512``, ``noflush``: float32's accumulators flushed every 512
  rows, or never (one tensor-core accumulator chained over every row).

For each row (``chip_smoke.py``'s backward rows: the train path's
danube shape, a binding window, vision's cross-attention, MHA at D = 64,
gemma-7b in bfloat16) every plan's gradients are compared with
``current``'s and with the plain version's (``ref.flash_attention_bwd_ref``
on the card; largest deviation over dq, dk, dv, relative to each one's
largest magnitude: stage sizes move no product's summation order within
a pass, so 0.0 is expected against ``current`` unless the flush moves),
then each plan is timed by CUDA events over
back-to-back calls in turns (the plans in order, then in reverse), and
``current``'s three kernels are timed by ``torch.profiler`` (device ms a
call by pass).  Prints the card line, each build's ptxas registers and
spills of the tensor-core kernels, then one JSON line a row.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DEFAULT_PLANS = {
    "first": "f32/128/bq=32,f32/128/bk=32,bf16/256/bq=32",
    "wide80": "f32/80/bq=64,f32/80/bk=64",
    "dq64": "f32/80/bk=64,f32/128/bk=32",
    "mixed80": "f32/80/bq=64",
    "stages3": "stages=3",
    "flush512": "flush=512",
    "noflush": "flush=1073741824",
}
ROWS = {  # b, hq, hkv, t, s, d, causal, window, dtype, iters
    "path": (2, 32, 8, 4096, 4096, 80, True, 4096, "float32", 3),
    "window": (1, 32, 8, 1024, 1024, 80, True, 256, "float32", 10),
    "vision": (1, 32, 8, 1024, 1600, 128, False, None, "float32", 5),
    "mha64": (1, 32, 32, 1024, 1024, 64, True, None, "float32", 10),
    "gemma_bf16": (1, 16, 16, 1024, 1024, 256, True, None, "bfloat16", 10),
}
_BQ = re.compile(r"static constexpr int kBQ =(.*?);", re.S)
_BK = re.compile(r"static constexpr int kBK =(.*?);", re.S)


def plan_source(src: str, spec: str) -> str:
    """The backward's source with the overrides of ``spec`` put in front
    of ``Plan``'s own stage-size expressions."""
    over = {"bq": [], "bk": []}
    for item in filter(None, spec.split(",")):
        key, val = item.split("=")
        if key == "stages":
            src = src.replace("constexpr int kStages = 2;",
                              f"constexpr int kStages = {int(val)};")
            continue
        if key == "flush":
            src = re.sub(r"constexpr int kFlushRows = \d+;",
                         f"constexpr int kFlushRows = {int(val)};", src)
            continue
        ty, dt, which = key.split("/")
        cond = ("kF32" if ty == "f32" else "!kF32") + f" && DT == {int(dt)}"
        over[which].append((cond, int(val)))
    for which, pat in (("bq", _BQ), ("bk", _BK)):
        base = pat.search(src).group(1).strip()
        expr = f"({base})"
        for cond, val in over[which]:
            expr = f"({cond}) ? {val} : {expr}"
        src = pat.sub(f"static constexpr int k{which.upper()} = {expr};",
                      src, count=1)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", nargs="*", default=None,
                    help="NAME=SPEC; default: the plans listed above")
    ap.add_argument("--rows", nargs="*", default=list(ROWS),
                    choices=list(ROWS))
    args = ap.parse_args()
    import torch
    import chip_smoke as C
    from repro_torch import _build
    from repro_torch.kernels import jet_flash_attention as jfa
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("flash_bwd_plans: no CUDA card", file=sys.stderr)
        return 2
    plans = dict(DEFAULT_PLANS) if args.plans is None else dict(
        p.split("=", 1) for p in args.plans)
    plans = {"current": "", **plans}
    print(C.card_line(), flush=True)
    csrc = ROOT / "src/repro_torch/csrc"
    out = ROOT / "build/flash_bwd_plans"
    out.mkdir(parents=True, exist_ok=True)
    src = (csrc / "flash_attention_bwd.cu").read_text()
    (out / "mma_sync.cuh").write_text((csrc / "mma_sync.cuh").read_text())

    def build(name):
        path = out / f"bwd_{name}.cu"
        path.write_text(plan_source(src, plans[name]))
        so = out / f"bwd_{name}.so"
        r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                            str(so), str(path)], capture_output=True,
                           text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on plan {name}:\n{r.stderr}")
        rep = C.flash_bwd_build(r.stdout + r.stderr)
        return name, {k: v for k, v in rep.items() if "_mma/" in k}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(plans)) as ex:
        reports = dict(ex.map(build, plans))
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "plans": plans, "ptxas": reports}), flush=True)
    libs = {}
    for name in plans:
        lib = ctypes.CDLL(str(out / f"bwd_{name}.so"))
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i32] * 8 + [
            ctypes.c_float, i32, i32, p]
        libs[name] = lib

    def call(lib, q, k, v, o, do, lse, causal, window):
        b, hq, t, d = q.shape
        hkv, s = k.shape[1], k.shape[2]
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        t_pad = -(-t // jfa.BWD_PAD_T) * jfa.BWD_PAD_T
        stats = torch.empty((b, hq, t_pad, 2), device=q.device)
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, hq, hkv, t, s, d, int(causal),
            int(window or 0), d ** -0.5,
            0 if q.dtype == torch.float32 else 1, 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return dq, dk, dv

    cuda = torch.autograd.DeviceType.CUDA
    for label in args.rows:
        b, hq, hkv, t, s, d, causal, window, dtype, iters = ROWS[label]
        tdt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(1)
        q, k, v, do = (torch.randn(sh, generator=g, device="cuda").to(tdt)
                       for sh in ((b, hq, t, d), (b, hkv, s, d),
                                  (b, hkv, s, d), (b, hq, t, d)))
        o, lse = jfa.flash_attention(q, k, v, causal, window, with_lse=True)
        base = call(libs["current"], q, k, v, o, do, lse, causal, window)
        plain = ref.flash_attention_bwd_ref(q, k, v, do, causal, window)
        row = {"row": label, "q": [b, hq, t, d], "kv": [b, hkv, s, d],
               "dtype": dtype, "dev_vs_current": {}, "dev_vs_plain": {},
               "ms": {}}

        def dev(xs, ys):
            return [float((x.float() - y.float()).abs().max()
                          / y.float().abs().max()) for x, y in zip(xs, ys)]
        for name, lib in libs.items():
            got = call(lib, q, k, v, o, do, lse, causal, window)
            row["dev_vs_current"][name] = max(dev(got, base))
            row["dev_vs_plain"][name] = dev(got, plain)
            del got
        del plain
        for name in [*libs, *reversed(list(libs))]:
            lib = libs[name]
            row["ms"].setdefault(name, []).append(C.cuda_ms(
                lambda: call(lib, q, k, v, o, do, lse, causal, window),
                iters, warmup=1))
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call(libs["current"], q, k, v, o, do, lse, causal, window)
            torch.cuda.synchronize()
        by = {}
        for e in prof.profiler.kineto_results.events():
            mt = re.search(r"bwd_(delta|dkdv_mma|dq_mma)", e.name())
            if e.device_type() == cuda and mt:
                by[mt.group(1)] = by.get(mt.group(1), 0.0) \
                    + e.duration_ns() * 1e-6 / 3
        row["current_device_ms_by_pass"] = by
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
