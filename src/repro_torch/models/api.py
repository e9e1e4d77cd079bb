"""Model API (``repro.models.api``): the entry points, and the inputs of
every architecture per input shape.

``input_specs`` and ``abstract_params`` return tensors on the ``meta``
device (shapes and types, no memory): PyTorch's counterpart of the
reference's ``ShapeDtypeStruct``s.  ``synthetic_inputs`` draws concrete
inputs of those specs from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ArchConfig, ShapeConfig
from . import decoding, transformer

init_params = transformer.init_params
forward = transformer.forward
loss_fn = transformer.loss_fn
prefill = decoding.prefill
decode_step = decoding.decode_step
init_decode_state = decoding.init_decode_state
decode_state_specs = decoding.decode_state_specs
shard_decode_state = decoding.shard_decode_state


def abstract_params(cfg: ArchConfig, dtype=torch.float32):
    """The parameter tree on the ``meta`` device: shapes and types, no
    memory (the reference's ``eval_shape`` of ``init_params``)."""
    return transformer.init_params(cfg, None, dtype, "meta")


def token_shape(cfg: ArchConfig, batch: int, seq: int):
    if cfg.num_codebooks:
        return (batch, cfg.num_codebooks, seq)
    return (batch, seq)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta-device stand-ins for every input of the step function of
    ``shape.kind`` (``train``, ``prefill`` or ``decode``: one new token
    against a cache of ``shape.seq_len``)."""
    b, t = shape.global_batch, shape.seq_len

    def spec(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        out = {"tokens": spec(token_shape(cfg, b, t))}
        if shape.kind == "train":
            out["targets"] = spec((b, t))
        if cfg.num_patches:
            out["patches"] = spec((b, cfg.num_patches, cfg.d_model), dtype)
        return out
    tok = (b, cfg.num_codebooks) if cfg.num_codebooks else (b,)
    return {"tokens": spec(tok),
            "state": decoding.init_decode_state(cfg, b, t, dtype, "meta"),
            "lengths": spec((b,))}


def synthetic_inputs(cfg: ArchConfig, shape: ShapeConfig,
                     generator: torch.Generator, dtype=torch.bfloat16,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Concrete inputs of ``input_specs`` on ``device`` (CUDA unless the
    caller asks for the CPU; ``generator`` lives there too): tokens and
    targets uniform in ``[0, vocab)``, ``lengths = seq_len - 1``, a zero
    decode state, unit-normal patches."""
    device = resolve_device(device)
    out: Dict[str, Any] = {}
    for name, s in input_specs(cfg, shape, dtype).items():
        if name == "state":
            out[name] = decoding.init_decode_state(
                cfg, shape.global_batch, shape.seq_len, dtype, device)
        elif name in ("tokens", "targets"):
            out[name] = torch.randint(0, cfg.vocab_size, s.shape,
                                      generator=generator, dtype=s.dtype,
                                      device=device)
        elif name == "lengths":
            out[name] = torch.full(s.shape, shape.seq_len - 1,
                                   dtype=s.dtype, device=device)
        else:
            out[name] = torch.randn(s.shape, generator=generator,
                                    dtype=torch.float32,
                                    device=device).to(s.dtype)
    return out


__all__ = ["abstract_params", "decode_state_specs", "decode_step",
           "forward", "init_decode_state", "init_params", "input_specs",
           "loss_fn", "prefill", "shard_decode_state", "synthetic_inputs",
           "token_shape"]
