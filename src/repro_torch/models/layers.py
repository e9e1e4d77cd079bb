"""Shared neural layers (``repro.models.layers``): RMS norm, RoPE (full or
partial), MLP variants, the initialisers and the cross-entropy loss.

Three conventions of the reference that PyTorch habit would get wrong:
``rms_norm`` multiplies by ``(1 + scale)`` (zero-initialised scales);
``apply_rope`` rotates *interleaved* pairs ``(0::2, 1::2)``, not the two
halves; gelu is the tanh form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.collectives import copy_to_model, reduce_from_model


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale)).to(x.dtype)


def init_rms(d: int, dtype=torch.float32, device=None,
             lead: tuple = ()) -> torch.Tensor:
    return torch.zeros(lead + (d,), dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(hd: int, fraction: float, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary fraction of the head dim."""
    rot = int(hd * fraction) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                         device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, hd: int,
               fraction: float = 1.0,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: broadcastable to [..., T].

    ``fraction < 1`` rotates the leading ``fraction*hd`` dims and passes
    the rest through."""
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    inv = rope_freqs(hd, fraction, theta, x.device)            # [rot/2]
    ang = positions[..., None].float() * inv                    # [...,T,r/2]
    cos = torch.cos(ang)[..., None, :]                          # [...,T,1,r/2]
    sin = torch.sin(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def _gelu(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


def mlp_tp(d_ff: int, tp):
    """``tp`` (a ``parallel.sharding.TP``) where the model axis divides
    the FFN width, else None (the MLP runs unsplit)."""
    return tp if tp is not None and d_ff % tp.size == 0 else None


def mlp_apply(params: dict, x: torch.Tensor, kind: str,
              tp=None) -> torch.Tensor:
    """The MLP.  ``tp``: tensor-parallel over the model axis, ``w_in``
    and ``w_gate`` this rank's column blocks and ``w_out`` its row block;
    the input is ``copy_to_model``'d and the output the all-reduce of the
    ranks' parts (``reduce_from_model``, a ``"layer_out"`` tensor)."""
    if tp is not None:
        x = copy_to_model(x, tp.group)
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = act(x @ params["w_gate"]) * (x @ params["w_in"])
        out = h @ params["w_out"]
    else:
        out = _gelu(x @ params["w_in"]) @ params["w_out"]
    return out if tp is None else reduce_from_model(out, tp.group)


def normal(shape, std: float, generator: torch.Generator, dtype,
           device) -> torch.Tensor:
    """``std`` times a standard normal draw from ``generator`` (the
    counterpart of ``jax.random.normal(key, shape) * std``; the numbers
    differ from JAX's, the distribution does not).  Initialisers take a
    ``lead`` shape: one draw of ``lead + shape`` stands for the reference's
    ``jax.vmap`` of the initialiser over stacked units."""
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=device)
    return (out * std).to(dtype)


def mlp_init(generator: torch.Generator, d: int, f: int, kind: str,
             dtype=torch.float32, device=None, lead: tuple = ()) -> dict:
    p = {"w_in": normal(lead + (d, f), d ** -0.5, generator, dtype, device),
         "w_out": normal(lead + (f, d), f ** -0.5, generator, dtype,
                         device)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = normal(lead + (d, f), d ** -0.5, generator, dtype,
                             device)
    return p


def embed_init(generator: torch.Generator, v: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return normal((v, d), d ** -0.5, generator, dtype, device)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token CE with the z-loss term, in float32.  logits
    [..., V]; targets [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse ** 2)
    return loss
