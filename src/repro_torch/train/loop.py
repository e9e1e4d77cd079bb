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

On a mesh (``ctx``) every rank runs the loop on its blocks: it draws the
same global batch from the pipeline and keeps its block, so the data
cursor is the step on every rank and a resume reproduces the stream; a
checkpoint gathers the whole leaves, rank 0 writes them and the ranks
meet at a barrier after the last one, so the files are the one-card
layout (either package reads them); a resume restores each rank's blocks
through ``ckpt.restore(..., shardings=)``, on the same mesh or another
(elastic).  The loss logged is the mean over the data blocks, the same
on every rank.  A step's time ``dt`` covers the device's work: reading
``float(metrics["loss"])`` waits for it.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import _tree
from .._device import DeviceLike, resolve_device
from ..checkpoint import ckpt
from ..configs.base import ArchConfig
from ..optim import adamw
from ..parallel.sharding import ParallelCtx
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


class _Saver:
    """Checkpoints of this rank's state: on one card the async writer; on
    a mesh the whole leaves gathered on every rank (a collective) and
    written by rank 0."""

    def __init__(self, ctx: Optional[ParallelCtx], specs):
        self.ctx, self.specs = ctx, specs
        self.mesh = ctx is not None and ctx.have_mesh
        self.writer = ckpt.AsyncSaver()

    def _whole(self, state):
        return self.ctx.gather_tree(state, self.specs) if self.mesh \
            else state

    def save(self, state, loop_cfg: "LoopConfig", step: int,
             sync: bool = False) -> None:
        whole = self._whole(state)
        if self.mesh and dist.get_rank() != 0:
            return
        extra = {"step": step, "cursor": step}
        if sync:
            self.writer.wait()
            ckpt.save(whole, loop_cfg.ckpt_dir, step, extra=extra,
                      keep_last=loop_cfg.keep_last)
        else:
            self.writer.save(whole, loop_cfg.ckpt_dir, step, extra=extra,
                             keep_last=loop_cfg.keep_last)

    def wait(self) -> None:
        self.writer.wait()

    def barrier(self) -> None:
        if self.mesh:
            dist.barrier()


def run(cfg: ArchConfig, opt_cfg: adamw.OptConfig, loop_cfg: LoopConfig,
        data: Iterable[Dict[str, np.ndarray]],
        generator: Optional[torch.Generator],
        fault_injector: Optional[Callable[[int], None]] = None,
        state: Optional[Dict[str, Any]] = None,
        compute_dtype=None, accum_steps: int = 1, *,
        device: DeviceLike = None, remat: str = "full",
        cap_factor: Optional[float] = None,
        ctx: Optional[ParallelCtx] = None) -> Dict[str, Any]:
    """Run (or resume) training on ``device`` (CUDA unless the caller
    asks for the CPU) -> ``{"state", "history", "straggler_flags",
    "final_step"}``.  Without ``state`` it resumes from the latest
    checkpoint in ``loop_cfg.ckpt_dir``, or starts from parameters drawn
    from ``generator``.  ``accum_steps > 1`` splits each batch into
    microbatches ``[A, B/A, ...]``; ``remat`` and ``cap_factor`` go to
    :func:`steps.make_train_step`.  ``ctx`` with a mesh: this rank's part
    of the sharded run (module docstring); ``data`` yields global batches
    and ``state``, when given, is this rank's blocks."""
    dev = resolve_device(device)
    compute_dtype = compute_dtype or torch.float32
    mesh = ctx is not None and ctx.have_mesh
    train_step = steps_mod.make_train_step(
        cfg, opt_cfg, compute_dtype, accum_steps=accum_steps, remat=remat,
        cap_factor=cap_factor, ctx=ctx)
    like = steps_mod.abstract_state(cfg, opt_cfg)
    specs = steps_mod.state_specs(like, ctx) if mesh else None
    saver = _Saver(ctx, specs)
    data_it = iter(data)

    start_step = 0
    if state is None:
        saver.barrier()      # a previous run's rank 0 has written all
        latest = ckpt.latest_step(loop_cfg.ckpt_dir)
        if latest is not None:
            shardings = _tree.tree_map(lambda _, s: ctx.sharding(s), like,
                                       specs) if mesh else None
            state, extra = ckpt.restore(loop_cfg.ckpt_dir, like, device=dev,
                                        shardings=shardings)
            start_step = int(extra.get("step", latest))
            # fast-forward the data cursor for an identical resume
            for _ in range(int(extra.get("cursor", start_step))):
                next(data_it)
        else:
            state = steps_mod.init_state(cfg, opt_cfg, generator, dev)
            if mesh:
                state = _tree.tree_map(lambda t: t.clone(),
                                       ctx.shard_tree(state, specs))

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
            if mesh:
                batch = steps_mod.shard_batch(batch, ctx, accum_steps)
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
                saver.save(state, loop_cfg, step)
    except KeyboardInterrupt:
        # preemption: a synchronous checkpoint at the step boundary
        saver.save(state, loop_cfg, step, sync=True)
        raise
    except BaseException:
        # a fault: the checkpoint in flight commits before the error
        # propagates, so no writer outlives the run (a restart in the same
        # process would otherwise race it on the same directory)
        saver.wait()
        raise
    saver.save(state, loop_cfg, step, sync=True)
    saver.barrier()
    return {"state": state, "history": history,
            "straggler_flags": monitor.flags, "final_step": step}
