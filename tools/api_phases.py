#!/usr/bin/env python3
"""The model API phases alone on one CUDA card: ``chip_smoke.py``'s
flash row at llama-3.2-vision's cross-attention shape and its
``api_vision`` and ``api_musicgen`` phases, with the same checks, in
about a minute and a half.

    python3 tools/api_phases.py

Builds the kernels from this checkout's sources, then prints the card
(``nvidia-smi`` name and power limit), the JSON lines of the row and of
each phase as ``chip_smoke.py`` prints them, the seconds of each phase,
and exits nonzero if a check fails.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("api_phases: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import _build
    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    seconds = {"build": time.perf_counter() - t0}
    try:
        cs.flash_phase("llama-3.2-vision cross-attention", 1, 32, 8, 1024,
                       1600, 128, False, None, "float32", 41, iters=20,
                       plain_iters=3, expect="mma_3xtf32")
        for phase in cs.API_PHASES:
            t1 = time.perf_counter()
            cs.api_phase(phase, torch.device("cuda"))
            seconds[phase] = time.perf_counter() - t1
    except cs.SmokeFailure as e:
        print(f"api_phases: FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"phase": "api_phases_s", **seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
