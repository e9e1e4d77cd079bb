"""Mamba2 block (``repro.models.ssm``): projections, causal depthwise conv,
the chunked SSD scan (the ``ssd_scan`` kernel; under grad on the card
``SSDScan``, whose backward is the ``ssd_scan_bwd`` kernel) and the gated
output; one-token decode runs the plain recurrence.

The conv stays the reference's sum of shifted products (no cuDNN, so no
TF32 convolution on the card).  The reference's ``ParallelCtx`` argument
is dropped: the port runs on one card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import normal

CONV_K = 4


def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int, int, int]:
    d_in = 2 * cfg.d_model
    return d_in, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state


def mamba_init(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, device=None, lead: tuple = ()) -> dict:
    d = cfg.d_model
    d_in, h, p, g, n = mamba_dims(cfg)
    conv_ch = d_in + 2 * g * n
    s = d ** -0.5

    def const(values: torch.Tensor) -> torch.Tensor:
        return values.to(dtype=dtype, device=device).expand(
            lead + values.shape).clone()

    return {
        "w_xbc": normal(lead + (d, conv_ch), s, generator, dtype, device),
        "w_z": normal(lead + (d, d_in), s, generator, dtype, device),
        "w_dt": normal(lead + (d, h), s, generator, dtype, device),
        # softplus^-1(0.05)
        "dt_bias": const(torch.full((h,), math.log(math.expm1(0.05)))),
        "a_log": const(torch.log(torch.linspace(1.0, 8.0, h))),
        "d_skip": const(torch.ones((h,))),
        "conv_w": normal(lead + (CONV_K, conv_ch), 0.3, generator, dtype,
                         device),
        "conv_b": const(torch.zeros((conv_ch,))),
        "w_out": normal(lead + (d_in, d), d_in ** -0.5, generator, dtype,
                        device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along T. x: [B, T, C]; w: [K, C].
    ``state``: [B, K-1, C] left context (decode).  Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    y = sum(xp[:, i:i + t, :] * w[i] for i in range(k)) + b
    return y, xp[:, -(k - 1):, :]


def mamba_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False, impl: str = "auto"):
    """Prefill. x: [B, T, D] -> [B, T, D] (and (conv_state, h) when
    ``return_state``)."""
    b, t, d = x.shape
    d_in, h, p, g, n = mamba_dims(cfg)
    xbc, conv_state = _causal_conv(x @ params["w_xbc"], params["conv_w"],
                                   params["conv_b"])
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(b, t, h, p)
    bmat = xbc[..., d_in:d_in + g * n].reshape(b, t, g, n)
    cmat = xbc[..., d_in + g * n:].reshape(b, t, g, n)
    dt = F.softplus(x @ params["w_dt"] + params["dt_bias"])
    a = -torch.exp(params["a_log"].float())
    y, h_t = ops.ssd(xs.contiguous(), dt.contiguous(), a,
                     bmat.contiguous(), cmat.contiguous(),
                     chunk=min(256, t), impl=impl)
    y = y + params["d_skip"][None, None, :, None] * xs
    y = y.reshape(b, t, d_in) * F.silu(x @ params["w_z"])
    out = y @ params["w_out"]
    if return_state:
        return out, (conv_state, h_t)
    return out


def mamba_decode(params: dict, x: torch.Tensor, state, cfg: ArchConfig):
    """One-token decode by the plain recurrence. x: [B, 1, D];
    state = (conv_state [B,K-1,C], h [B,H,N,P]) -> (out [B,1,D],
    new_state)."""
    b = x.shape[0]
    d_in, h, p, g, n = mamba_dims(cfg)
    conv_state, h_ssm = state
    xbc, conv_state = _causal_conv(x @ params["w_xbc"], params["conv_w"],
                                   params["conv_b"], conv_state)
    xbc = F.silu(xbc)[:, 0]                            # [B, C]
    xs = xbc[..., :d_in].reshape(b, h, p)
    bm = xbc[..., d_in:d_in + g * n].reshape(b, g, n)
    cm = xbc[..., d_in + g * n:].reshape(b, g, n)
    bm = bm.repeat_interleave(h // g, dim=1)           # [B, H, N]
    cm = cm.repeat_interleave(h // g, dim=1)
    dt = F.softplus(x[:, 0] @ params["w_dt"] + params["dt_bias"])
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt * a)[..., None, None]         # [B, H, 1, 1]
    h_new = h_ssm * decay + (dt[..., None, None] * bm[..., :, None]
                             * xs[..., None, :].float())
    y = torch.einsum("bhn,bhnp->bhp", cm.float(), h_new)
    y = y.to(x.dtype) + params["d_skip"][None, :, None] * xs
    y = y.reshape(b, 1, d_in) * F.silu(x @ params["w_z"])
    return y @ params["w_out"], (conv_state, h_new)


def mamba_state_init(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None, lead: tuple = ()):
    d_in, h, p, g, n = mamba_dims(cfg)
    conv_ch = d_in + 2 * g * n
    return (torch.zeros(lead + (batch, CONV_K - 1, conv_ch), dtype=dtype,
                        device=device),
            torch.zeros(lead + (batch, h, n, p), dtype=torch.float32,
                        device=device))
