"""Async, atomic checkpoints (``repro.checkpoint.ckpt``), in the
reference's layout, so that either package reads the other's:

    <dir>/step_<N:08d>/manifest.json + leaf_<i:05d>.npy per leaf

Leaves are keyed by their path (``pattern/0/attn/wq``: dict keys and
sequence indices, JAX's order) and numbered in sorted key order.  A save
writes ``step_<N>.tmp`` and renames it, so a crashed writer never
corrupts the latest checkpoint; ``keep_last`` trims history.  The
reference's ``restore(..., shardings)`` places leaves on a target mesh
(elastic reshard), a mesh knob (ROADMAP Queue 1 A4); here ``device``
says where the restored tensors go.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import _tree
from .._device import DeviceLike, resolve_device


def _host(tree) -> Dict[str, np.ndarray]:
    """key -> a host copy of each leaf, as numpy."""
    out = {}
    for path, leaf in _tree.flatten(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                raise TypeError(f"{_tree.key(path)}: bfloat16 has no numpy "
                                f"type; checkpoints hold numpy arrays")
            leaf = leaf.detach().to("cpu", copy=True).numpy()
        out[_tree.key(path)] = np.asarray(leaf)
    return out


def _write(flat: Dict[str, np.ndarray], directory: str, step: int,
           extra: Optional[dict], keep_last: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for i, (key, arr) in enumerate(sorted(flat.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _trim(directory, keep_last)
    return final


def save(tree, directory: str, step: int, extra: Optional[dict] = None,
         keep_last: int = 3) -> str:
    """Synchronous atomic save; returns the committed path."""
    return _write(_host(tree), directory, step, extra, keep_last)


class AsyncSaver:
    """Background-thread checkpoint writer (one in flight at a time).
    :meth:`save` copies the tree to host memory before it returns, so the
    caller may go on updating its tensors."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None

    def save(self, tree, directory: str, step: int,
             extra: Optional[dict] = None, keep_last: int = 3) -> None:
        self.wait()
        flat = _host(tree)                # snapshot before returning

        def work():
            self.last_path = _write(flat, directory, step, extra, keep_last)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str, like, step: Optional[int] = None,
            device: DeviceLike = None):
    """Restore into the structure of ``like`` (a tree of tensors, meta
    tensors included, or arrays) -> (tree, extra).  Leaves go to
    ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for p, _ in _tree.flatten(like):
        meta = manifest["leaves"][_tree.key(p)]
        arr = np.load(os.path.join(path, meta["file"]))
        out.append(torch.from_numpy(arr).to(dev))
    return _tree.unflatten(like, out), manifest.get("extra", {})


def _trim(directory: str, keep_last: int) -> None:
    steps = sorted([d for d in os.listdir(directory)
                    if d.startswith("step_") and not d.endswith(".tmp")])
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d))
