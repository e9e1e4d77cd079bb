"""Atomic, async checkpoints (``repro.checkpoint``)."""
from .ckpt import AsyncSaver, latest_step, restore, save

__all__ = ["AsyncSaver", "latest_step", "restore", "save"]
