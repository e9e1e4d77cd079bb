"""Config registry of the port: ``get_arch(name)`` / ``--arch <id>``.

The port serves the architectures whose whole path it has; so far that is
zamba2-1.2b.  ``tiny_config`` is the reference's reduction for CPU tests
(small widths and layers, structure kept), copied unchanged so that both
packages build the same tiny model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import SHAPES, ArchConfig, ShapeConfig
from .zamba2_1_2b import CONFIG as _zamba2

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [_zamba2]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(ARCHS)}")
    return ARCHS[name]


def tiny_config(arch: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small widths/layers,
    few experts, tiny vocab — structure preserved."""
    kw = dict(
        num_layers=min(arch.num_layers, _tiny_layers(arch)),
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(arch.num_kv_heads,
                                4 if arch.num_kv_heads >= arch.num_heads
                                else 2)),
        head_dim=32 if arch.head_dim else 0,
        d_ff=256 if arch.d_ff else 0,
        vocab_size=512,
        num_experts=min(arch.num_experts, 4),
        num_patches=64 if arch.num_patches else 0,
        ssm_state=min(arch.ssm_state, 16),
        ssm_head_dim=32 if arch.ssm_state else arch.ssm_head_dim,
        sliding_window=64 if arch.sliding_window else None,
        name=arch.name + "-tiny",
    )
    return dataclasses.replace(arch, **kw)


def _tiny_layers(arch: ArchConfig) -> int:
    # keep enough layers to include one of each special block
    n = 2
    for cadence in (arch.moe_every if arch.num_experts else 0,
                    arch.attn_every, arch.slstm_every,
                    arch.cross_attn_every):
        if cadence:
            n = max(n, cadence + 1)
    return n


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeConfig", "get_arch",
           "tiny_config"]
