"""Config registry of the port: ``get_arch(name)`` / ``--arch <id>``.

The registry holds all ten architectures of the reference, each config
file copied unchanged, and the model API (``repro_torch.models.api``)
runs all ten.  The serving engine runs the eight it feeds with token
prompts: the dense attention models (chatglm3-6b, gemma-7b,
h2o-danube-1.8b, starcoder2-15b), the MoE ones (llama4-scout-17b-a16e,
llama4-maverick-400b-a17b), xlstm-125m and zamba2-1.2b.
llama-3.2-vision-11b (cross-attention over image patches) and
musicgen-large (codebook tokens) run through the model API only.
``tiny_config`` is the reference's reduction for CPU tests (small widths
and layers, structure kept), copied unchanged so that both packages build
the same tiny model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import SHAPES, ArchConfig, ShapeConfig, eligible
from .chatglm3_6b import CONFIG as _chatglm3
from .gemma_7b import CONFIG as _gemma
from .h2o_danube_1_8b import CONFIG as _danube
from .llama4_maverick_400b_a17b import CONFIG as _maverick
from .llama4_scout_17b_a16e import CONFIG as _scout
from .llama_3_2_vision_11b import CONFIG as _vision
from .musicgen_large import CONFIG as _musicgen
from .starcoder2_15b import CONFIG as _starcoder2
from .xlstm_125m import CONFIG as _xlstm
from .zamba2_1_2b import CONFIG as _zamba2

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [
    _maverick, _scout, _chatglm3, _danube, _starcoder2, _gemma,
    _musicgen, _xlstm, _vision, _zamba2,
]}


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


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeConfig", "eligible",
           "get_arch", "tiny_config"]
