"""Sweep farm: a scenario grid run as fixed-shape chunks on the card.

:func:`repro_torch.fabric.vector.run_fabric_sweep` runs a structure-
sharing grid as one captured run, which is wrong once grids reach
overnight size: the whole ``[G, ...]`` state sits on the card at once, a
new grid size captures a new CUDA graph, and nothing survives a killed
run.  This module is the run-farm layer on top of it:

* **Fixed-shape chunks.**  :func:`repro_torch.fabric.scenarios.chunk_plan`
  splits the grid into chunks of one or two shapes (full chunks and one
  power-of-two-padded remainder), each padded by repeating its first real
  scenario.  Every chunk is packed under the full grid's structure
  **envelope** (:meth:`FabricSweepParams.envelope`), so all chunks of one
  shape share a ``structure_key`` and run on one built
  :class:`~repro_torch.fabric.vector.FabricRun` (:func:`vector.cached_run`,
  which re-arms it with :meth:`FabricRun.load`): after the first chunk of
  each shape no chunk captures a new graph.  Grid points are independent
  lanes of the tick and every result is per point, so the merged results
  equal the monolithic run bit for bit at fixed dt.

* **Dispatch.**  ``workers <= 1`` runs the chunks in this process, a
  thread packing chunk k + 1 while the card runs chunk k, round-robin
  over ``torch.cuda.device_count()`` cards (or the one device asked
  for).  Each chunk's run waits for its card before the next chunk
  starts, so the cards take turns: they add memory, not overlap.
  ``workers > 1`` starts a ``spawn`` pool: each worker rebuilds
  the grid from a picklable :class:`GridSpec` (scenario objects embed
  receiver-config closures and do not pickle) and writes its own result
  shards, so a killed parent loses nothing.  The kernels are built in
  the parent first, so no two workers compile one source at once.  A
  worker that fails raises in the parent.

* **Versioned artifacts and resume.**  Every run writes
  ``experiments/runs/<run_id>/`` (manifest, per-chunk shards, merged
  table; :mod:`repro_torch.fabric.artifacts`).  ``resume=True`` re-reads
  the manifest, checks the grid's hash and runs only the chunks whose
  shards are missing or do not load.

``device=None`` runs on the card and raises without one; the CPU runs
only when asked (``device="cpu"``).  Nothing falls back to the CPU or to
a plain version.  Command line::

    python -m repro_torch.fabric.farm --grid pod_storm --workers 4
    python -m repro_torch.fabric.farm --grid incast --quick --device cpu
    python -m repro_torch.fabric.farm --grid incast --chunk 16 --resume \\
        --run-id run-20260809-...

The card's memory is bounded by the chunk size, not the grid size;
results stream to disk as chunks finish.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device, resolve_dtype
from . import artifacts as A
from . import fused
from . import vector as V
from .scenarios import build_grid, chunk_plan

# set by _worker_init in pool workers: the rebuilt grid and the run's
# settings
_WORKER: dict = {}

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class GridSpec:
    """Picklable recipe for a named grid (workers rebuild from this)."""
    name: str
    quick: bool = False
    overrides: Optional[dict] = None

    def build(self):
        return build_grid(self.name, quick=self.quick,
                          **(self.overrides or {}))

    def to_json(self) -> dict:
        return {"name": self.name, "quick": self.quick,
                "overrides": self.overrides or {}}


def _resolve_grid(grid, quick: bool, overrides: Optional[dict]
                  ) -> Tuple[List, List[dict], Optional[GridSpec]]:
    """Accept a grid name, a GridSpec, or a raw scenario list."""
    if isinstance(grid, GridSpec):
        scens, points = grid.build()
        return scens, points, grid
    if isinstance(grid, str):
        spec = GridSpec(grid, quick=quick, overrides=overrides)
        scens, points = spec.build()
        return scens, points, spec
    scens = list(grid)
    return scens, [{} for _ in scens], None


def _pick_sparse(scens: Sequence, incidence: str) -> bool:
    if incidence not in ("auto", "dense", "sparse"):
        raise ValueError(f"unknown incidence {incidence!r}")
    return incidence == "sparse" or (
        incidence == "auto"
        and any(bool(s.topology.super_spines) for s in scens))


def _pad_chunk(scens: Sequence, entry: dict) -> Tuple[List, int]:
    """Chunk scenarios padded to the chunk's dispatch shape.

    Padding repeats the chunk's first scenario: a duplicate of a real
    point adds nothing to the any-over-points capability flags or ring
    maxima (the envelope floors those anyway), and its lane is sliced
    off before results leave this module.
    """
    real = list(scens[entry["start"]:entry["stop"]])
    n_pad = entry["padded"] - len(real)
    return real + [real[0]] * n_pad, len(real)


def _pack_chunk(scens: Sequence, entry: dict, sparse: bool,
                envelope: dict):
    padded, n_real = _pad_chunk(scens, entry)
    fsp = V.FabricSweepParams.from_scenarios(padded, sparse=sparse,
                                             envelope=envelope)
    return fsp, n_real


def _execute_packed(fsp, n_real: int, device: torch.device,
                    dtype: torch.dtype) -> Tuple[Dict[str, np.ndarray],
                                                 dict]:
    """Run one packed chunk on a cached run and slice off the padding.
    Returns the results and the chunk's counts: new runs built
    (``captures``), the kernel launches counted during the run (on the
    card, a replay's are added there) and the launches captured for one
    tick times the ticks (``launches_captured``)."""
    c0 = V.GRAPH_CAPTURES
    run = V.cached_run(fsp, device=device, dtype=dtype)
    before = fused.LAUNCHES.read()
    out = run.run()
    after = fused.LAUNCHES.read()
    out = {k: np.asarray(v)[:n_real] for k, v in out.items()}
    return out, {"captures": V.GRAPH_CAPTURES - c0,
                 "launches": {k: after[k] - before[k] for k in after},
                 "launches_captured": run.launches_captured()}


def _on(device: torch.device):
    """Make ``device`` the current card while a chunk runs on it."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _dtype_name(dtype: torch.dtype) -> str:
    return {v: k for k, v in _DTYPES.items()}[dtype]


def _record(entry: dict, wall: float, items: dict, device,
            worker: str) -> dict:
    return {"chunk": entry["chunk"], "start": entry["start"],
            "stop": entry["stop"], "padded": entry["padded"],
            "wall_s": wall, **items, "device": str(device),
            "worker": worker}


# --------------------------------------------------------------------------- #
# In-process dispatch (round-robin over the cards)
# --------------------------------------------------------------------------- #
def _device_cycle(device: torch.device) -> List[torch.device]:
    """Devices to round-robin chunks over: every card for ``cuda`` with
    no index, else the one device asked for."""
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _run_chunks_inprocess(scens, plan, todo, sparse, envelope, device,
                          dtype, rdir: Optional[str]) -> List[dict]:
    """Run the ``todo`` chunks in this process.

    Packing (scenario padding and parameter packing, numpy) overlaps the
    card's run: while chunk k runs, a thread packs chunk k + 1.  Each
    finished chunk is sliced to its real points and streamed to its
    shard before the next one runs, so memory tracks the chunk shape,
    not the grid.
    """
    from concurrent.futures import ThreadPoolExecutor

    devices = _device_cycle(device)
    records = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(_pack_chunk, scens, plan[todo[0]], sparse,
                          envelope)
        for i, k in enumerate(todo):
            fsp, n_real = nxt.result()
            if i + 1 < len(todo):
                nxt = pool.submit(_pack_chunk, scens, plan[todo[i + 1]],
                                  sparse, envelope)
            dev = devices[i % len(devices)]
            t0 = time.perf_counter()
            with _on(dev):
                out, items = _execute_packed(fsp, n_real, dev, dtype)
            rec = _record(plan[k], time.perf_counter() - t0, items, dev,
                          "inprocess")
            if rdir is not None:
                A.save_chunk(rdir, k, out, meta=rec)
            else:
                rec["results"] = out
            records.append(rec)
    return records


# --------------------------------------------------------------------------- #
# Multiprocess dispatch (spawn pool; workers rebuild the grid by name)
# --------------------------------------------------------------------------- #
def _worker_init(spec_json: dict, sparse: bool, envelope: dict,
                 device: str, dtype: str, threads: int, rdir: str) -> None:
    """Pool initializer: rebuild the grid once per worker process; the
    worker computes with the parent's CPU thread count."""
    torch.set_num_threads(threads)
    spec = GridSpec(spec_json["name"], spec_json["quick"],
                    spec_json["overrides"] or None)
    scens, _ = spec.build()
    _WORKER.update(scens=scens, sparse=sparse, envelope=envelope,
                   device=resolve_device(device), dtype=_DTYPES[dtype],
                   rdir=rdir)


def _worker_run_chunk(entry: dict) -> dict:
    """Run one chunk inside a pool worker; the worker writes the shard
    itself, so a killed parent cannot lose finished work."""
    w = _WORKER
    t0 = time.perf_counter()
    fsp, n_real = _pack_chunk(w["scens"], entry, w["sparse"],
                              w["envelope"])
    with _on(w["device"]):
        out, items = _execute_packed(fsp, n_real, w["device"], w["dtype"])
    rec = _record(entry, time.perf_counter() - t0, items, w["device"],
                  f"pid{os.getpid()}")
    A.save_chunk(w["rdir"], entry["chunk"], out, meta=rec)
    return rec


def _run_chunks_pool(spec: GridSpec, plan, todo, sparse, envelope,
                     device, dtype, workers: int, rdir: str) -> List[dict]:
    import multiprocessing as mp

    if device.type == "cuda":
        # build the kernels once here, so no two workers compile one
        # source into the build directory at the same time
        fused._lib()
        if sparse:
            fused._seg_lib()
    ctx = mp.get_context("spawn")   # a forked child cannot use CUDA
    n = min(workers, len(todo))
    with ctx.Pool(n, initializer=_worker_init,
                  initargs=(spec.to_json(), sparse, envelope, str(device),
                            _dtype_name(dtype), torch.get_num_threads(),
                            rdir)) as pool:
        records = pool.map(_worker_run_chunk, [plan[k] for k in todo],
                           chunksize=1)
    return records


# --------------------------------------------------------------------------- #
# The farm entry point
# --------------------------------------------------------------------------- #
def run_farm(grid: Union[str, GridSpec, Sequence],
             workers: int = 0,
             chunk_size: int = 16,
             device=None,
             dtype: Optional[torch.dtype] = None,
             incidence: str = "auto",
             quick: bool = False,
             grid_overrides: Optional[dict] = None,
             out_dir: str = A.DEFAULT_RUNS_DIR,
             run_id: Optional[str] = None,
             resume: bool = False,
             artifacts: bool = True) -> dict:
    """Run a scenario grid as fixed-shape chunks and gather versioned
    artifacts.

    ``grid`` is a registry name (:data:`repro_torch.fabric.scenarios
    .GRIDS`), a :class:`GridSpec`, or a raw scenario list (in-process
    only: raw lists cannot cross to spawn workers).  ``device`` and
    ``dtype`` are :func:`run_fabric_sweep`'s (``None``: the card, float32).
    Returns ``{"run_id", "run_dir", "manifest", "results", "points"}``
    where ``results`` is the merged ``{metric: array[G]}`` table in input
    order, bit-identical at fixed dt to ``run_fabric_sweep(grid)`` run
    monolithically.

    Each chunk's record in the manifest holds ``captures``, the runs it
    built (:data:`vector.GRAPH_CAPTURES`; 0 after the first chunk of each
    shape), and its kernel launches.  ``resume=True`` with an existing
    ``run_id`` skips chunks whose shards already load; the manifest
    records which chunks ran in which invocation (``records[k]
    ["worker"]``).  ``artifacts=False`` keeps everything in memory
    (implies no resume).
    """
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    scens, points, spec = _resolve_grid(grid, quick, grid_overrides)
    if not scens:
        raise ValueError("empty grid")
    if workers > 1 and spec is None:
        warnings.warn("raw scenario lists cannot be shipped to worker "
                      "processes (unpicklable closures); running "
                      "in-process instead — pass a named grid for "
                      "multiprocess dispatch", RuntimeWarning,
                      stacklevel=2)
        workers = 0
    if workers > 1 and not artifacts:
        raise ValueError("multiprocess dispatch requires artifacts "
                         "(workers stream shards to disk)")

    sparse = _pick_sparse(scens, incidence)
    full = V.FabricSweepParams.from_scenarios(scens, sparse=sparse)
    envelope = full.envelope()
    plan = chunk_plan(len(scens), chunk_size)
    fingerprint = A.config_hash(scens)

    rdir = None
    done: List[int] = []
    if artifacts:
        run_id = run_id or A.new_run_id()
        rdir = A.run_dir(run_id, out_dir)
        prev = A.read_manifest(rdir)
        if resume and prev is not None:
            if prev.get("config_hash") != fingerprint:
                raise ValueError(
                    f"resume mismatch: run {run_id} was recorded for a "
                    f"different grid (hash {prev.get('config_hash')} != "
                    f"{fingerprint})")
            done = A.completed_chunks(rdir, len(plan))
        manifest = {
            "run_id": run_id, "status": "running",
            "grid": spec.to_json() if spec else {"name": "<inline>"},
            "n_points": len(scens), "chunk_size": chunk_size,
            "chunks": len(plan), "plan": plan,
            "device": str(dev), "dtype": _dtype_name(dt),
            "engine": "sparse" if sparse else "dense",
            "envelope": {k: (bool(v) if isinstance(v, (bool, np.bool_))
                             else int(v)) for k, v in envelope.items()},
            "structure_key": full.structure_key,
            "config_hash": fingerprint, "git_sha": A.git_sha(),
            "workers": workers, "records": (prev or {}).get("records",
                                                            []),
        }
        A.write_manifest(rdir, manifest)
    else:
        manifest = {"run_id": run_id or "<in-memory>",
                    "status": "running", "records": []}

    todo = [e["chunk"] for e in plan if e["chunk"] not in set(done)]
    t0 = time.perf_counter()
    if todo:
        if workers > 1:
            new_recs = _run_chunks_pool(spec, plan, todo, sparse, envelope,
                                        dev, dt, workers, rdir)
        else:
            new_recs = _run_chunks_inprocess(scens, plan, todo, sparse,
                                             envelope, dev, dt, rdir)
    else:
        new_recs = []
    wall = time.perf_counter() - t0

    if rdir is not None:
        results = A.merge_chunks(rdir, plan, len(scens))
        kept = [r for r in manifest["records"]
                if r["chunk"] not in set(todo)]
        manifest["records"] = sorted(kept + new_recs,
                                     key=lambda r: r["chunk"])
        manifest["status"] = "complete"
        manifest["wall_s"] = wall
        manifest["resumed_chunks"] = sorted(done)
        A.write_manifest(rdir, manifest)
    else:
        results: Dict[str, np.ndarray] = {}
        for rec in new_recs:
            out = rec.pop("results")
            for k, v in out.items():
                if k not in results:
                    results[k] = np.zeros((len(scens),) + v.shape[1:],
                                          v.dtype)
                results[k][rec["start"]:rec["stop"]] = v
        manifest["records"] = new_recs
        manifest["status"] = "complete"
        manifest["wall_s"] = wall

    return {"run_id": manifest["run_id"], "run_dir": rdir,
            "manifest": manifest, "results": results,
            "points": points}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fabric.farm",
        description="Run a scenario grid as a chunked sweep farm.")
    ap.add_argument("--grid", required=True,
                    help="named grid from repro_torch.fabric.scenarios"
                         ".GRIDS")
    ap.add_argument("--workers", type=int, default=0,
                    help="worker processes (<=1: in-process dispatch)")
    ap.add_argument("--chunk", type=int, default=16,
                    help="grid points per chunk")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu")
    ap.add_argument("--dtype", default=None, choices=sorted(_DTYPES),
                    help="float32 (default; the card's only type) or "
                         "float64 (CPU)")
    ap.add_argument("--incidence", default="auto",
                    choices=("auto", "dense", "sparse"))
    ap.add_argument("--quick", action="store_true",
                    help="use the registry's shrunken smoke axes")
    ap.add_argument("--out-dir", default=A.DEFAULT_RUNS_DIR)
    ap.add_argument("--run-id", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="skip chunks whose shards already exist")
    args = ap.parse_args(argv)

    res = run_farm(args.grid, workers=args.workers,
                   chunk_size=args.chunk, device=args.device,
                   dtype=_DTYPES.get(args.dtype),
                   incidence=args.incidence, quick=args.quick,
                   out_dir=args.out_dir, run_id=args.run_id,
                   resume=args.resume)
    m = res["manifest"]
    ran = [r for r in m["records"] if r["chunk"]
           not in set(m.get("resumed_chunks", []))]
    print(f"run {res['run_id']}: {m['n_points']} points, "
          f"{m['chunks']} chunks ({len(m.get('resumed_chunks', []))} "
          f"resumed), engine={m['engine']}, device={m['device']}, "
          f"dtype={m['dtype']}, wall={m['wall_s']:.2f}s, "
          f"captures={sum(r['captures'] for r in ran)}")
    if res["run_dir"]:
        print(f"artifacts: {res['run_dir']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
