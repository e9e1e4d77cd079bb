"""Fault-tolerant training loop (``repro.train.loop``).

* an async checkpoint every ``ckpt_every`` steps (atomic commit,
  keep-last-k) and a final one;
* crash or preemption recovery: on restart the loop resumes from the
  latest step with the data cursor fast-forwarded, so the batches are
  the ones the uninterrupted run saw; a ``KeyboardInterrupt`` first
  writes a synchronous checkpoint at the step boundary, and any other
  error lets the checkpoint in flight commit before it propagates;
* a fault injection hook (tests simulate a node failure mid-run);
* a straggler monitor: an EWMA of step wall time, and a step slower than
  ``straggler_factor`` times it raises a flag.

The loop trains on one card; restoring a checkpoint onto a mesh (elastic
rescale) is ``checkpoint.ckpt.restore(..., shardings=)``, and a loop over
a mesh needs the sharded train step (ROADMAP Queue 1 A4b).  A step's time ``dt`` covers the device's
work: reading ``float(metrics["loss"])`` waits for it.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..checkpoint import ckpt
from ..configs.base import ArchConfig
from ..optim import adamw
from . import steps as steps_mod

# checkpoints stay inside the checkout by default (``build/`` is ignored
# by git)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = str(BUILD_DIR / "repro_ckpt")
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    straggler_ewma: float = 0.9


class StragglerMonitor:
    """Per-step wall-time EWMA; flags outliers (the straggler-mitigation
    hook: on a fleet the flag keys host replacement or data
    rebalancing)."""

    def __init__(self, factor: float, ewma: float):
        self.factor = factor
        self.alpha = ewma
        self.mean: Optional[float] = None
        self.flags = 0

    def observe(self, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        is_straggler = dt > self.factor * self.mean
        self.mean = self.alpha * self.mean + (1 - self.alpha) * dt
        if is_straggler:
            self.flags += 1
        return is_straggler


def run(cfg: ArchConfig, opt_cfg: adamw.OptConfig, loop_cfg: LoopConfig,
        data: Iterable[Dict[str, np.ndarray]],
        generator: Optional[torch.Generator],
        fault_injector: Optional[Callable[[int], None]] = None,
        state: Optional[Dict[str, Any]] = None,
        compute_dtype=None, accum_steps: int = 1, *,
        device: DeviceLike = None, remat: str = "full",
        cap_factor: Optional[float] = None) -> Dict[str, Any]:
    """Run (or resume) training on ``device`` (CUDA unless the caller
    asks for the CPU) -> ``{"state", "history", "straggler_flags",
    "final_step"}``.  Without ``state`` it resumes from the latest
    checkpoint in ``loop_cfg.ckpt_dir``, or starts from parameters drawn
    from ``generator``.  ``accum_steps > 1`` splits each batch into
    microbatches ``[A, B/A, ...]``; ``remat`` and ``cap_factor`` go to
    :func:`steps.make_train_step`."""
    dev = resolve_device(device)
    compute_dtype = compute_dtype or torch.float32
    train_step = steps_mod.make_train_step(
        cfg, opt_cfg, compute_dtype, accum_steps=accum_steps, remat=remat,
        cap_factor=cap_factor)
    saver = ckpt.AsyncSaver()
    data_it = iter(data)

    start_step = 0
    if state is None:
        latest = ckpt.latest_step(loop_cfg.ckpt_dir)
        if latest is not None:
            like = steps_mod.abstract_state(cfg, opt_cfg)
            state, extra = ckpt.restore(loop_cfg.ckpt_dir, like, device=dev)
            start_step = int(extra.get("step", latest))
            # fast-forward the data cursor for an identical resume
            for _ in range(int(extra.get("cursor", start_step))):
                next(data_it)
        else:
            state = steps_mod.init_state(cfg, opt_cfg, generator, dev)

    monitor = StragglerMonitor(loop_cfg.straggler_factor,
                               loop_cfg.straggler_ewma)
    history = []
    step = start_step
    try:
        while step < loop_cfg.total_steps:
            if fault_injector is not None:
                fault_injector(step)
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in next(data_it).items()}
            if accum_steps > 1:
                batch = {k: v.reshape((accum_steps,
                                       v.shape[0] // accum_steps)
                                      + tuple(v.shape[1:]))
                         for k, v in batch.items()}
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            straggle = monitor.observe(dt)
            step += 1
            if step % loop_cfg.log_every == 0 or straggle:
                history.append({"step": step, "loss": loss, "dt": dt,
                                "straggler": straggle})
            if step % loop_cfg.ckpt_every == 0:
                saver.save(state, loop_cfg.ckpt_dir, step,
                           extra={"step": step, "cursor": step},
                           keep_last=loop_cfg.keep_last)
    except KeyboardInterrupt:
        # preemption: a synchronous checkpoint at the step boundary
        saver.wait()
        ckpt.save(state, loop_cfg.ckpt_dir, step,
                  extra={"step": step, "cursor": step},
                  keep_last=loop_cfg.keep_last)
        raise
    except BaseException:
        # a fault: the checkpoint in flight commits before the error
        # propagates, so no writer outlives the run (a restart in the same
        # process would otherwise race it on the same directory)
        saver.wait()
        raise
    saver.wait()
    ckpt.save(state, loop_cfg.ckpt_dir, step,
              extra={"step": step, "cursor": step},
              keep_last=loop_cfg.keep_last)
    return {"state": state, "history": history,
            "straggler_flags": monitor.flags, "final_step": step}
