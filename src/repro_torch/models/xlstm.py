"""xLSTM blocks (``repro.models.xlstm``): mLSTM (matrix memory,
chunk-parallel) and sLSTM (scalar memory, a sequential recurrence with
block-diagonal recurrent weights).

As in the reference, the input and forget gates are sigmoids (bounded, so
no max-stabiliser state), and the recurrent states are float32 whatever
the compute type.  The reference's ``lax.scan`` over chunks (mLSTM) and
over time steps (sLSTM) becomes a Python loop.  The reference's
``ParallelCtx`` argument is dropped: the port runs on one card.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import normal


def _dims(cfg: ArchConfig) -> Tuple[int, int]:
    return cfg.num_heads, cfg.hd


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #
def mlstm_init(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, device=None, lead: tuple = ()) -> dict:
    d = cfg.d_model
    h, dh = _dims(cfg)
    s = d ** -0.5
    bias = torch.cat([torch.full((h,), -2.0), torch.full((h,), 3.0)])
    return {
        "wq": normal(lead + (d, h * dh), s, generator, dtype, device),
        "wk": normal(lead + (d, h * dh), s, generator, dtype, device),
        "wv": normal(lead + (d, h * dh), s, generator, dtype, device),
        "wo": normal(lead + (h * dh, d), (h * dh) ** -0.5, generator, dtype,
                     device),
        "w_if": normal(lead + (d, 2 * h), s, generator, dtype, device),
        "if_bias": bias.to(dtype=dtype, device=device).expand(
            lead + bias.shape).clone(),
    }


def mlstm_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = 128, return_state: bool = False):
    """Chunk-parallel mLSTM. x: [B, T, D]; T a multiple of the chunk
    ``min(chunk, T)``."""
    b, t, d = x.shape
    h, dh = _dims(cfg)
    L = min(chunk, t)
    if t % L:
        raise ValueError(f"mLSTM prefill needs T % {L} == 0, got T = {t}")
    q = (x @ params["wq"]).reshape(b, t, h, dh).float() * (dh ** -0.5)
    k = (x @ params["wk"]).reshape(b, t, h, dh).float()
    v = (x @ params["wv"]).reshape(b, t, h, dh).float()
    gates = x @ params["w_if"] + params["if_bias"]
    ig = torch.sigmoid(gates[..., :h].float())              # [B,T,H]
    lf = F.logsigmoid(gates[..., h:].float())
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    cmat = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    nvec = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, t, L):
        qq, kk, vv = q[:, c0:c0 + L], k[:, c0:c0 + L], v[:, c0:c0 + L]
        ii, ff = ig[:, c0:c0 + L], lf[:, c0:c0 + L]
        cum = torch.cumsum(ff, dim=1)                        # [B,L,H]
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        dec = torch.where(tril, torch.exp(seg), 0.0) * ii[:, None, :, :]
        sc = torch.einsum("blhd,bmhd->blmh", qq, kk) * dec
        num = torch.einsum("blmh,bmhv->blhv", sc, vv)
        den = sc.sum(dim=2)                                  # [B,L,H]
        dq = torch.exp(cum)
        num = num + dq[..., None] * torch.einsum("blhk,bhkv->blhv", qq,
                                                 cmat)
        den = den + dq * torch.einsum("blhk,bhk->blh", qq, nvec)
        ys.append(num / torch.clamp(torch.abs(den)[..., None], min=1.0))
        to_end = torch.exp(cum[:, -1:, :] - cum) * ii        # [B,L,H]
        decay = torch.exp(cum[:, -1, :])
        cmat = (decay[..., None, None] * cmat +
                torch.einsum("blh,blhk,blhv->bhkv", to_end, kk, vv))
        nvec = (decay[..., None] * nvec +
                torch.einsum("blh,blhk->bhk", to_end, kk))
    y = torch.cat(ys, dim=1).reshape(b, t, h * dh).to(x.dtype)
    out = y @ params["wo"]
    if return_state:
        return out, (cmat, nvec)
    return out


def mlstm_decode(params: dict, x: torch.Tensor, state, cfg: ArchConfig):
    """x: [B,1,D]; state = (C [B,H,Dk,Dv], n [B,H,Dk])."""
    b = x.shape[0]
    h, dh = _dims(cfg)
    cmat, nvec = state
    x0 = x[:, 0]
    q = (x0 @ params["wq"]).reshape(b, h, dh).float() * (dh ** -0.5)
    k = (x0 @ params["wk"]).reshape(b, h, dh).float()
    v = (x0 @ params["wv"]).reshape(b, h, dh).float()
    gates = x0 @ params["w_if"] + params["if_bias"]
    ig = torch.sigmoid(gates[..., :h].float())
    fg = torch.sigmoid(gates[..., h:].float())
    cmat = fg[..., None, None] * cmat + \
        ig[..., None, None] * k[..., :, None] * v[..., None, :]
    nvec = fg[..., None] * nvec + ig[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, cmat)
    den = torch.einsum("bhk,bhk->bh", q, nvec)
    y = num / torch.clamp(torch.abs(den)[..., None], min=1.0)
    out = y.reshape(b, 1, h * dh).to(x.dtype) @ params["wo"]
    return out, (cmat, nvec)


def mlstm_state_init(cfg: ArchConfig, batch: int, device=None,
                     lead: tuple = ()):
    h, dh = _dims(cfg)
    return (torch.zeros(lead + (batch, h, dh, dh), dtype=torch.float32,
                        device=device),
            torch.zeros(lead + (batch, h, dh), dtype=torch.float32,
                        device=device))


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #
def slstm_init(generator: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32, device=None, lead: tuple = ()) -> dict:
    d = cfg.d_model
    h, dh = _dims(cfg)
    s = d ** -0.5
    return {
        # input projections for (z, i, f, o)
        "w_x": normal(lead + (d, 4 * d), s, generator, dtype, device),
        # block-diagonal recurrent weights, one [Dh, 4Dh] block per head
        "r_h": normal(lead + (h, dh, 4 * dh), dh ** -0.5, generator, dtype,
                      device),
        "bias": torch.zeros(lead + (4 * d,), dtype=dtype, device=device),
        "wo": normal(lead + (d, d), s, generator, dtype, device),
    }


def _slstm_cell(params, cfg, xproj_t, carry):
    """One recurrent step. xproj_t: [B, 4D]; carry = (hidden, c, n)."""
    h_heads, dh = _dims(cfg)
    hidden, c, n = carry                     # [B,D] each
    b = hidden.shape[0]
    hh = hidden.reshape(b, h_heads, dh)
    # float32 carry against compute-dtype weights: the product in float32,
    # as the reference's einsum promotes
    rec = torch.einsum("bhk,hkm->bhm", hh,
                       params["r_h"].to(hh.dtype)).reshape(b, 4 * cfg.d_model)
    za, ia, fa, oa = torch.chunk(xproj_t + rec + params["bias"], 4, dim=-1)
    z = torch.tanh(za)
    i = torch.sigmoid(ia)
    f = torch.sigmoid(fa)
    o = torch.sigmoid(oa)
    c = f * c + i * z
    n = f * n + i
    hidden = o * c / torch.clamp(torch.abs(n), min=1.0)
    return hidden, c, n


def slstm_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Sequential sLSTM. x: [B, T, D] (a loop over T: inherently
    serial)."""
    b, t, d = x.shape
    xproj = x @ params["w_x"]                # [B, T, 4D]
    carry = slstm_state_init(cfg, b, x.device)
    hs = []
    for i in range(t):
        carry = _slstm_cell(params, cfg, xproj[:, i], carry)
        hs.append(carry[0])
    y = torch.stack(hs, dim=1).to(x.dtype) @ params["wo"]
    if return_state:
        return y, carry
    return y


def slstm_decode(params: dict, x: torch.Tensor, state, cfg: ArchConfig):
    xproj = x[:, 0] @ params["w_x"]
    carry = _slstm_cell(params, cfg, xproj, state)
    y = carry[0][:, None, :].to(x.dtype) @ params["wo"]
    return y, carry


def slstm_state_init(cfg: ArchConfig, batch: int, device=None,
                     lead: tuple = ()):
    return tuple(torch.zeros(lead + (batch, cfg.d_model),
                             dtype=torch.float32, device=device)
                 for _ in range(3))
