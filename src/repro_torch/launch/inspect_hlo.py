"""Collective inspector (``repro.launch.inspect_hlo``): trace one dry-run
cell and print every collective with its shape, group size, count and
ring-model bytes, heaviest first — the profiling view the perf loop
works from.

The trace is unrolled (``launch.hlo_analysis``): identical calls (same
op, shapes, group and issuing frames) merge into one row whose ``count``
stands where the reference's ``trip_mult`` stood.  ``block`` is the tail
of the port's frames that issued the call (:func:`block`).

  PYTHONPATH=src python -m repro_torch.launch.inspect_hlo \\
      --arch chatglm3-6b --shape train_4k [--mesh single] [--variant '{...}']
"""
from __future__ import annotations

import argparse
import json
import math
from collections import defaultdict
from typing import List

from . import hlo_analysis
from .dryrun import build_cell, cell_mesh, placeholder_group
from .mesh import make_mesh


_LOWER = ("parallel.", "kernels.", "_tree.")    # frames below the model's


def block(path: str) -> str:
    """The model's last two frames of an issuing ``path`` (module and
    function, the package's first level dropped) and the first frame
    below them (``backward``: a collective's gradient)."""
    frames = path.split("/")
    i = len(frames)
    while i and frames[i - 1].startswith(_LOWER):
        i -= 1
    head = [f.split(".", 1)[-1] for f in frames[max(0, i - 2):i]]
    tail = [frames[i].rsplit(".", 1)[-1]] if i < len(frames) else []
    return "/".join(head + tail)


def inspect(trace: List[hlo_analysis.Op], top: int = 25) -> List[dict]:
    """The collectives of a traced call's ops, identical calls merged,
    heaviest (ring-model bytes over all calls) first: ``op`` (the c10d
    op), ``kind`` (the reference's type), ``shape`` (the result's, up to
    three), ``dtype``, ``groups``, ``count``, ``bytes_one`` (one call's
    result), ``bytes_total`` and ``block``."""
    merged = defaultdict(int)
    for op in trace:
        if op.coll:
            merged[op] += 1
    rows = []
    for op, count in merged.items():
        size = hlo_analysis.nbytes(op.outputs)
        rows.append({
            "op": op.name.split(".")[1], "kind": op.coll,
            "shape": "+".join(str(list(s)) for s, _ in op.outputs[:3]),
            "dtype": op.outputs[0][1] if op.outputs else "",
            "groups": op.group, "count": count, "bytes_one": size,
            "bytes_total": count * hlo_analysis.ring_bytes(op.coll, size,
                                                           op.group),
            "block": block(op.path)})
    rows.sort(key=lambda r: -r["bytes_total"])
    return rows[:top]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    variant = json.loads(args.variant) if args.variant else {}

    shape, axes = cell_mesh(args.mesh, variant)
    with placeholder_group(math.prod(shape)):
        fn, cargs = build_cell(args.arch, args.shape,
                               make_mesh(shape, axes, "cpu"), variant)
        ops = hlo_analysis.trace(fn, *cargs).ops
    rows = inspect(ops, args.top)
    total = defaultdict(float)
    for r in rows:
        total[r["kind"]] += r["bytes_total"]
    print(f"{'op':24s} {'shape':44s} {'dtype':9s} {'grp':>4s} "
          f"{'count':>6s} {'GB_total':>9s}  block")
    for r in rows:
        print(f"{r['op']:24s} {r['shape'][:44]:44s} {r['dtype']:9s} "
              f"{r['groups']:4d} {r['count']:6d} "
              f"{r['bytes_total']/1e9:9.2f}  {r['block']}")
    print("\nper-type totals (top rows only):",
          {k: f"{v/1e9:.1f}GB" for k, v in total.items()})


if __name__ == "__main__":
    main()
