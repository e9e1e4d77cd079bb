"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds).  Libraries are built at
first use into ``build/repro_torch/`` at the repository root, keyed by a
hash of the source, of the local headers it includes and of the flags
(:func:`source_key`), so a checkout builds its own kernels and a changed
source or header never loads a stale library.  Nothing here runs at
import time: the CPU tests import every module on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
_LIBS: Dict[str, ctypes.CDLL] = {}
# per source: seconds the build took in this process (0.0 = reused) and
# nvcc's report (ptxas registers / spills per kernel)
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([str(Path(home) / "bin" / "nvcc")] if home else []) \
        + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH) — the CUDA kernels are built from source")


def source_key(src: Path) -> str:
    """Hash of ``src``, of every header it includes by ``#include "..."``
    that lies beside it (and of theirs, in turn), and of the nvcc flags."""
    h, seen = hashlib.sha256(), set()

    def add(path: Path) -> None:
        if path in seen:
            return
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text + b"\0")
        for inc in _INCLUDE.findall(text):
            dep = path.parent / inc.decode()
            if dep.is_file():
                add(dep)
    add(src)
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` as a shared library, building it first if
    this source has not been built yet.  A failed build raises."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{source_key(src)}.so"
    t0 = time.perf_counter()
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src}:\n{BUILD_LOG[name]}")
        os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib


def build_all() -> Dict[str, float]:
    """Build every ``csrc/*.cu`` at once (one nvcc per source, all started
    together); returns the seconds each build took."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        list(ex.map(library, names))
    return {n: BUILD_SECONDS[n] for n in names}
