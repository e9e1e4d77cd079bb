"""Mixture-of-Experts with SRQ-style capacity dispatch and escape
(``repro.models.moe``, paper §4.1).

Each expert owns a fixed-capacity slab ``[C, D]`` (the SRQ's pre-posted
WQEs).  Tokens are sorted into their expert's slab in token order; those
past its capacity take the *escape* path: they skip the expert (the
residual carries them) and are counted in ``overflow``.

Two implementations of one function:

* :func:`moe_apply` — the single-card capacity dispatch, the serving
  path: the reference's expert-parallel body (``_ep_body``) at one model
  rank, its two ``all_to_all``s removed.  The expert FFN runs as batched
  products ``[E, C, D] @ [E, D, F]``, which the reference computes outside
  any Pallas kernel too.
* :func:`moe_dense_ref` — the plain version: every expert on every
  token, masked by route and capacity.

Both rank a token within its expert in token order (a stable sort here, a
``cumsum`` there), so they keep the same tokens and report the same
``overflow``.  The mesh paths (``moe_ep``, its decode body, the staged
expert FFN) are not ported.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import _gelu, mlp_apply, mlp_init, normal

# on_route(expert ids [n], kept [n], top-2 router probability margin [n])
RouteObserver = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], None]


def moe_init(generator: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32, device=None, lead: tuple = ()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": normal(lead + (d, e), d ** -0.5, generator, dtype, device),
        "e_in": normal(lead + (e, d, f), d ** -0.5, generator, dtype,
                       device),
        "e_out": normal(lead + (e, f, d), f ** -0.5, generator, dtype,
                        device),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["e_gate"] = normal(lead + (e, d, f), d ** -0.5, generator, dtype,
                             device)
    if cfg.shared_expert:
        p["shared"] = mlp_init(generator, d, f, cfg.mlp, dtype, device, lead)
    return p


def _expert_ffn(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: [E, C, D] through per-expert stacked weights."""
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = act(torch.bmm(x, p["e_gate"])) * torch.bmm(x, p["e_in"])
    else:
        h = _gelu(torch.bmm(x, p["e_in"]))
    return torch.bmm(h, p["e_out"])


def _route_top1(logits: torch.Tensor):
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idx = torch.max(probs, dim=-1)
    return idx, gate, probs


def _aux_losses(probs: torch.Tensor, idx: torch.Tensor,
                e: int) -> torch.Tensor:
    """Switch-style load-balance loss."""
    frac = torch.mean(F.one_hot(idx, e).float(), dim=0)
    mean_p = torch.mean(probs, dim=0)
    return e * torch.sum(frac * mean_p)


def capacity(cf: float, n_tokens: int, e: int) -> int:
    """Slots a slab.  ``n_tokens`` is every token of the call: in decode
    that counts the idle lanes too, as in the reference."""
    return max(1, int(cf * n_tokens / e))


def _observe(on_route: Optional[RouteObserver], idx, keep, probs) -> None:
    if on_route is not None:
        top = torch.topk(probs, 2, dim=-1).values
        on_route(idx, keep, top[:, 0] - top[:, 1])


# --------------------------------------------------------------------------- #
def moe_dense_ref(params: dict, x: torch.Tensor, cfg: ArchConfig,
                  cap_factor: float,
                  on_route: Optional[RouteObserver] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """The plain version: every expert on every token, masked by routing
    and capacity.  x: [B, T, D]."""
    b, t, d = x.shape
    e, n = cfg.num_experts, b * t
    xt = x.reshape(n, d)
    idx, gate, probs = _route_top1(xt @ params["router"])
    c = capacity(cap_factor, n, e)
    onehot = F.one_hot(idx, e)
    rank = torch.cumsum(onehot, dim=0) * onehot     # 1-based within expert
    keep = torch.gather(rank, 1, idx[:, None])[:, 0] <= c
    y_all = _expert_ffn(params, xt.expand(e, n, d), cfg.mlp)
    y = y_all[idx, torch.arange(n, device=x.device)]
    y = y * (gate * keep)[:, None].to(y.dtype)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, cfg.mlp)
    _observe(on_route, idx, keep, probs)
    aux = {"lb_loss": _aux_losses(probs, idx, e),
           "overflow": 1.0 - torch.mean(keep.float())}
    return y.reshape(b, t, d), aux


def moe_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
              cap_factor: Optional[float] = None,
              on_route: Optional[RouteObserver] = None
              ) -> Tuple[torch.Tensor, Dict]:
    """The capacity dispatch on one card.  x: [B, T, D].  Returns
    ``(y, {"lb_loss", "overflow"})``.  ``on_route``, when given, sees each
    token's expert, whether it kept its slot, and its router's top-2
    probability margin."""
    cf = cap_factor or cfg.capacity_factor
    b, t, d = x.shape
    e, n = cfg.num_experts, b * t
    dev = x.device
    xt = x.reshape(n, d)
    idx, gate, probs = _route_top1(xt @ params["router"])
    c = capacity(cf, n, e)
    order = torch.sort(idx, stable=True).indices
    se = idx[order]                                  # sorted expert ids
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    rank = torch.arange(n, device=dev) - starts[se]
    kept = rank < c
    dest = torch.where(kept, se * c + rank, e * c)   # overflow -> trash slot
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=dev)
    buf[dest] = xt[order]
    out = _expert_ffn(params, buf[:-1].reshape(e, c, d), cfg.mlp)
    flat = torch.cat([out.reshape(e * c, d),
                      torch.zeros((1, d), dtype=out.dtype, device=dev)])
    y = torch.zeros_like(xt)
    y[order] = flat[dest] * kept[:, None].to(out.dtype)
    y = y * gate[:, None].to(y.dtype)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt, cfg.mlp)
    keep = torch.empty_like(kept)
    keep[order] = kept
    _observe(on_route, idx, keep, probs)
    aux = {"lb_loss": _aux_losses(probs, idx, e),
           "overflow": 1.0 - torch.mean(keep.float())}
    return y.reshape(b, t, d), aux
