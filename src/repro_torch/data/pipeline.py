"""Deterministic, checkpointable, host-sharded synthetic token pipeline
(``repro.data.pipeline``), the port's own numpy copy: its batches are the
reference's, bit for bit.

Each process materialises only its slice of the global batch
(``process_index`` / ``process_count``), the cursor is a single integer
(the step), and resuming from a checkpoint reproduces the exact stream.
Tokens are a hash-mixed sequence in which every odd position is a fixed
function of the token before it, so next-token loss can fall.  Batches
are numpy arrays; the training loop moves them to the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    num_codebooks: int = 0
    num_patches: int = 0
    d_model: int = 0
    seed: int = 0
    process_index: int = 0
    process_count: int = 1


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 16)) * np.uint64(0x45D9F3B)
    x = (x ^ (x >> 16)) * np.uint64(0x45D9F3B)
    return x ^ (x >> 16)


class SyntheticPipeline:
    """Iterator over batches; ``cursor`` is the only state."""

    def __init__(self, cfg: PipelineConfig, cursor: int = 0):
        self.cfg = cfg
        self.cursor = cursor
        if cfg.global_batch % cfg.process_count:
            raise ValueError("global batch must divide across hosts")
        self.local_batch = cfg.global_batch // cfg.process_count

    def _tokens(self, step: int, rows: np.ndarray, t: int) -> np.ndarray:
        c = self.cfg
        base = _mix(np.uint64(c.seed) + np.uint64(step) * np.uint64(1 << 20)
                    + rows.astype(np.uint64)[:, None] * np.uint64(7919))
        pos = np.arange(t, dtype=np.uint64)[None, :]
        raw = _mix(base + pos * np.uint64(2654435761))
        tok = (raw % np.uint64(c.vocab_size)).astype(np.int64)
        # every odd position is a fixed mix of the token before it
        n_odd = tok[:, 1::2].shape[1]
        tok[:, 1::2] = (tok[:, 0::2][:, :n_odd] * 31 + 7) % c.vocab_size
        return tok.astype(np.int32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        step = self.cursor
        self.cursor += 1
        row0 = self.cfg.process_index * self.local_batch
        rows = np.arange(row0, row0 + self.local_batch)
        t = c.seq_len + 1
        if c.num_codebooks:
            toks = np.stack([self._tokens(step * 131 + k, rows, t)
                             for k in range(c.num_codebooks)], axis=1)
            batch = {"tokens": toks[:, :, :-1],
                     "targets": toks[:, 0, 1:]}
        else:
            toks = self._tokens(step, rows, t)
            batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if c.num_patches:
            rng = np.random.default_rng(c.seed * 7 + step)
            batch["patches"] = rng.standard_normal(
                (self.local_batch, c.num_patches, c.d_model),
                dtype=np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def for_arch(arch: ArchConfig, shape: ShapeConfig, seed: int = 0,
             global_batch: Optional[int] = None,
             seq_len: Optional[int] = None) -> SyntheticPipeline:
    return SyntheticPipeline(PipelineConfig(
        vocab_size=arch.vocab_size,
        global_batch=global_batch or shape.global_batch,
        seq_len=seq_len or shape.seq_len,
        num_codebooks=arch.num_codebooks,
        num_patches=arch.num_patches,
        d_model=arch.d_model,
        seed=seed,
    ))
