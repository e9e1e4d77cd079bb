"""Carry the reference's parameters across.

``params_from_jax`` takes the tree the reference's ``init_params`` builds
(dicts and tuples of arrays, as numpy) and returns the same tree as torch
tensors: the port keeps the reference's layout (pattern tuple with leaves
stacked ``[n_units, ...]`` (expert stacks and xLSTM blocks alike),
remainder tuple, ``shared_attn``, ``final_norm``, ``unembed`` unless the
embedding is tied; a codebook model's ``embed`` is ``[K, V, D]``, a
cross-attention layer adds ``ln_x`` and ``xattn``), so the carry is a
plain mapping, and both
packages then compute the same function.  ``state_from_jax`` carries a
whole train state across (parameters, AdamW moments, float32 or int8
``{"q", "s"}``, the step count), so both packages step from one state.
It reads arrays through ``numpy.asarray`` and imports nothing of the
reference.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from .transformer import segments, tree_map


def tree_from_numpy(tree: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Dicts, tuples and lists of arrays -> the same tree of tensors on
    ``device`` (CUDA unless the caller asks for the CPU; a copy; floating
    leaves cast to ``dtype`` when it is given)."""
    return _to_tensors(tree, resolve_device(device), dtype)


def _to_tensors(tree: Any, device: torch.device,
                dtype: Optional[torch.dtype]) -> Any:
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_tensors(v, device, dtype) for v in tree)
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, cfg: ArchConfig, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's parameter tree (numpy leaves) -> the port's, on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    pattern, n_units, rem = segments(cfg)
    want = {"embed", "pattern", "remainder", "final_norm"}
    if "mamba_attn" in pattern + rem:
        want.add("shared_attn")
    if not cfg.tie_embeddings:
        want.add("unembed")
    if set(tree) != want:
        raise ValueError(f"parameter tree has {sorted(tree)}, the layout of "
                         f"{cfg.name} wants {sorted(want)}")
    if len(tree["pattern"]) != len(pattern) or \
            len(tree["remainder"]) != len(rem):
        raise ValueError(f"{len(tree['pattern'])} pattern / "
                         f"{len(tree['remainder'])} remainder layers, "
                         f"{cfg.name} has {len(pattern)} / {len(rem)}")
    embed = (cfg.vocab_size, cfg.d_model)
    if cfg.num_codebooks:
        embed = (cfg.num_codebooks,) + embed
    if tuple(np.shape(tree["embed"])) != embed:
        raise ValueError(f"embed is {np.shape(tree['embed'])}, the layout "
                         f"of {cfg.name} wants {embed}")
    for where, kinds, layers in (("pattern", pattern, tree["pattern"]),
                                 ("remainder", rem, tree["remainder"])):
        for pos, (kind, layer) in enumerate(zip(kinds, layers)):
            if ("xattn" in layer) != (kind == "attn_cross"):
                raise ValueError(f"{where} position {pos} ({kind}): the "
                                 f"cross-attention layout of {cfg.name} "
                                 f"wants ln_x and xattn only in attn_cross")
    for pos, layer in enumerate(tree["pattern"]):
        lead = set()
        tree_map(lambda leaf: lead.add(np.shape(leaf)[:1]), layer)
        if lead != {(n_units,)}:
            raise ValueError(f"pattern position {pos} is not stacked over "
                             f"{n_units} units")
    return tree_from_numpy(tree, device, dtype)


def state_from_jax(state: Any, cfg: ArchConfig, device: DeviceLike = None
                   ) -> dict:
    """The reference's train state (``repro.train.steps.init_state``'s
    tree, numpy leaves) -> the port's (``repro_torch.train.steps``), on
    ``device`` (CUDA unless the caller asks for the CPU): ``params`` via
    :func:`params_from_jax`, ``opt`` ``{"m", "v", "count"}`` and ``step``
    leaf for leaf, types kept (int8 moment codes, int32 counts)."""
    if set(state) != {"params", "opt", "step"}:
        raise ValueError(f"train state has {sorted(state)}; want params, "
                         f"opt and step (the compressed_pod_grads "
                         f"residuals 'err' need a device mesh: ROADMAP "
                         f"Queue 1 A4)")
    opt = state["opt"]
    if set(opt) != {"m", "v", "count"}:
        raise ValueError(f"optimizer state has {sorted(opt)}; want m, v, "
                         f"count")
    return {"params": params_from_jax(state["params"], cfg, device),
            "opt": tree_from_numpy(opt, device),
            "step": tree_from_numpy(state["step"], device)}
