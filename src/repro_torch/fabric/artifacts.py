"""Versioned run artifacts for farm sweeps (the same layout as the JAX
package's, so the shards of either load with the other's
:func:`load_chunk`).

A farm run writes everything it learns under one directory::

    experiments/runs/<run_id>/
        manifest.json        # grid spec, chunk plan, envelope, git SHA,
                             # engine, per-chunk status + timings
        chunk_0000.npz       # per-chunk FabricResult shards (real points
        chunk_0001.npz       #   only -- padding is sliced off on save)
        ...
        result.npz           # merged [G] metric table, input order

The manifest is the resume contract: a restarted run re-reads it, checks
which ``chunk_*.npz`` shards exist and are loadable, and dispatches only
the missing chunks (see :func:`repro_torch.fabric.farm.run_farm`).
Shards are written atomically (tmp file + ``os.replace``) so a killed
run can never leave a half-written shard that a resume would trust.

Everything here is plain numpy + json on purpose: artifacts must be
readable without torch and from any process.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_RUNS_DIR = os.path.join("experiments", "runs")

_MANIFEST = "manifest.json"
_RESULT = "result.npz"


def new_run_id(prefix: str = "run") -> str:
    """Timestamped, collision-resistant run id (sortable by start time)."""
    stamp = time.strftime("%Y%m%d-%H%M%S")
    salt = os.urandom(3).hex()
    return f"{prefix}-{stamp}-{salt}"


def git_sha(repo_dir: Optional[str] = None) -> str:
    """Current git commit (short), or ``"unknown"`` outside a checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo_dir, capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except OSError:
        return "unknown"


def config_hash(scens: Sequence) -> str:
    """Cheap fingerprint of a scenario grid: point count + names.

    Scenario names encode every axis value the builders sweep, so two
    grids with equal hashes ran the same points in the same order —
    which is exactly what a resume must check before trusting shards.
    """
    import hashlib
    h = hashlib.sha256()
    h.update(str(len(scens)).encode())
    for sc in scens:
        h.update(getattr(sc, "name", repr(sc)).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def run_dir(run_id: str, out_dir: str = DEFAULT_RUNS_DIR) -> str:
    return os.path.join(out_dir, run_id)


def chunk_path(rdir: str, chunk: int) -> str:
    return os.path.join(rdir, f"chunk_{chunk:04d}.npz")


def _atomic_write_bytes(path: str, write_fn) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, path)


def write_manifest(rdir: str, manifest: dict) -> None:
    os.makedirs(rdir, exist_ok=True)
    _atomic_write_bytes(
        os.path.join(rdir, _MANIFEST),
        lambda f: f.write(json.dumps(manifest, indent=2,
                                     sort_keys=True).encode()))


def read_manifest(rdir: str) -> Optional[dict]:
    path = os.path.join(rdir, _MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_chunk(rdir: str, chunk: int, results: Dict[str, np.ndarray],
               meta: Optional[dict] = None) -> str:
    """Persist one chunk's (already de-padded) result arrays + metadata."""
    os.makedirs(rdir, exist_ok=True)
    path = chunk_path(rdir, chunk)
    payload = {k: np.asarray(v) for k, v in results.items()}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    _atomic_write_bytes(path, lambda f: np.savez(f, **payload))
    return path


def load_chunk(rdir: str, chunk: int):
    """Load one shard -> ``(results, meta)``; ``None`` if missing/corrupt."""
    path = chunk_path(rdir, chunk)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            results = {k: z[k] for k in z.files if k != "__meta__"}
            meta = json.loads(z["__meta__"].tobytes().decode()) \
                if "__meta__" in z.files else {}
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None
    return results, meta


def completed_chunks(rdir: str, n_chunks: int) -> List[int]:
    """Chunk indices whose shards exist *and* load cleanly."""
    done = []
    for k in range(n_chunks):
        if load_chunk(rdir, k) is not None:
            done.append(k)
    return done


def merge_chunks(rdir: str, plan: Sequence[dict],
                 n_points: int) -> Dict[str, np.ndarray]:
    """Stitch every chunk shard back into [G]-length arrays (input
    order), persist as ``result.npz`` and return the merged table."""
    merged: Dict[str, np.ndarray] = {}
    for entry in plan:
        loaded = load_chunk(rdir, entry["chunk"])
        if loaded is None:
            raise FileNotFoundError(
                f"missing chunk shard {entry['chunk']} in {rdir}; "
                "run is incomplete — resume it first")
        results, _ = loaded
        for k, v in results.items():
            if k not in merged:
                merged[k] = np.zeros((n_points,) + v.shape[1:], v.dtype)
            merged[k][entry["start"]:entry["stop"]] = v
    _atomic_write_bytes(os.path.join(rdir, _RESULT),
                        lambda f: np.savez(f, **merged))
    return merged


def load_result(rdir: str) -> Optional[Dict[str, np.ndarray]]:
    path = os.path.join(rdir, _RESULT)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def list_runs(out_dir: str = DEFAULT_RUNS_DIR) -> List[dict]:
    """Manifests of every run under ``out_dir``, newest first."""
    if not os.path.isdir(out_dir):
        return []
    runs = []
    for name in sorted(os.listdir(out_dir), reverse=True):
        m = read_manifest(os.path.join(out_dir, name))
        if m is not None:
            runs.append(m)
    return runs
