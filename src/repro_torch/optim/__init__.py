"""Optimizers (``repro.optim``): AdamW with optional 8-bit moments and
its learning-rate schedule."""
from .adamw import OptConfig, global_norm, init, schedule, update

__all__ = ["OptConfig", "global_norm", "init", "schedule", "update"]
