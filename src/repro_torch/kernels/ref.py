"""Plain PyTorch versions of the model kernels, op for op the reference's
pure-JAX tiers (``repro.kernels.ref``).

Two tiers, as in the reference:

* ``*_naive`` — the simplest math (the ground truth of the tests);
* ``*_ref`` — the memory-efficient forms (a loop over KV fragments or
  over chunks) that are the plain versions of the CUDA kernels: the CPU
  runs them, and the card runs them only when asked (``impl="ref"``) to
  hold a kernel against them.

``decode_attention_naive`` is what one-token decode runs on every device,
over the dense ring cache, as in the reference.  ``decode_attention_paged_ref``
(the plain version of ``csrc/decode_attention.cu``) gathers a paged cache
and defers to it; ``matmul_naive`` is the plain version of
``csrc/staged_matmul.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# matmul
# --------------------------------------------------------------------------- #
def matmul_naive(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a:[M,K] @ b:[K,N] with float32 products and sums, cast to
    ``out_dtype`` (default: a's type)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


# --------------------------------------------------------------------------- #
# attention (prefill)
# --------------------------------------------------------------------------- #
def _gqa_expand(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """[B, Hkv, S, D] -> [B, Hq, S, D] by repeating kv heads."""
    return k.repeat_interleave(num_q_heads // k.shape[1], dim=1)


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-softmax attention. q:[B,Hq,T,D] k/v:[B,Hkv,S,D] -> [B,Hq,T,D]."""
    b, hq, t, d = q.shape
    kf = _gqa_expand(k, hq).float()
    vf = _gqa_expand(v, hq).float()
    qf = q.float() * (d ** -0.5)
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf)
    t_idx = torch.arange(t, device=q.device)[:, None]
    s_idx = torch.arange(kf.shape[2], device=q.device)[None, :]
    # right-aligned causality: prefill (T == S) and decode-style (T < S)
    offset = kf.shape[2] - t
    mask = torch.ones((t, kf.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= (t_idx + offset) >= s_idx
    if window is not None:
        mask &= (t_idx + offset) - s_idx < window
    if kv_len is not None:
        mask = (mask[None] & (s_idx[None] < kv_len[:, None, None]))[:, None]
    else:
        mask = mask[None, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vf).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        block_kv: int = 512) -> torch.Tensor:
    """Online-softmax attention over ``block_kv`` KV fragments: the plain
    version of ``csrc/flash_attention.cu``.  Only the (m, l, acc) carry
    persists across fragments."""
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    nblk = -(-s // block_kv)
    pad = nblk * block_kv - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    kb = k.reshape(b, hkv, nblk, block_kv, d).float()
    vb = v.reshape(b, hkv, nblk, block_kv, d).float()
    qf = q.float() * (d ** -0.5)
    qg = qf.reshape(b, hkv, group, t, d)

    t_idx = torch.arange(t, device=q.device)[:, None] + (s - t)
    m = torch.full((b, hkv, group, t), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, group, t), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, hkv, group, t, d), dtype=torch.float32,
                      device=q.device)
    for j in range(nblk):
        sc = torch.einsum("bhgtd,bhsd->bhgts", qg, kb[:, :, j])
        s_idx = j * block_kv + torch.arange(block_kv,
                                            device=q.device)[None, :]
        mask = s_idx < s  # padding
        if causal:
            mask = mask & (t_idx >= s_idx)
        if window is not None:
            mask = mask & (t_idx - s_idx < window)
        sc = sc.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgts,bhsd->bhgtd", p,
                                                   vb[:, :, j])
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, hq, t, d).to(q.dtype)


# --------------------------------------------------------------------------- #
# decode attention
# --------------------------------------------------------------------------- #
def decode_attention_naive(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, lengths: torch.Tensor):
    """q:[B,Hq,D]; contiguous k/v:[B,S,Hkv,D]; lengths:[B].
    Returns (o:[B,Hq,D], lse:[B,Hq])."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    group = hq // hkv
    qf = q.float().reshape(b, hkv, group, d) * (d ** -0.5)
    sc = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    mask = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    sc = sc.masked_fill(~mask[:, None, None], NEG_INF)
    m = sc.amax(dim=-1)
    p = torch.exp(sc - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float()) \
        / torch.clamp(l[..., None], min=1e-30)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o.reshape(b, hq, d).to(q.dtype), lse.reshape(b, hq)


def decode_attention_paged_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               page_table: torch.Tensor,
                               lengths: torch.Tensor):
    """Paged oracle. k_pages:[P,page,Hkv,D], page_table:[B,maxp] (-1 =
    hole).  Gathers each sequence's pages into a contiguous view (holes
    read page 0, and entries past the pool its last page, as the
    reference's gather clamps) and defers to
    :func:`decode_attention_naive`.  A
    length-0 row gives the mean of v over its gathered pages here, and 0
    from the kernel; both give the same lse."""
    b, maxp = page_table.shape
    page = k_pages.shape[1]
    safe = torch.clamp(page_table, 0, k_pages.shape[0] - 1).long()
    kc = k_pages[safe].reshape(b, maxp * page, *k_pages.shape[2:])
    vc = v_pages[safe].reshape(b, maxp * page, *v_pages.shape[2:])
    return decode_attention_naive(q, kc, vc, lengths)


def combine_partial_attention(o_parts: torch.Tensor,
                              lse_parts: torch.Tensor) -> torch.Tensor:
    """Merge per-shard partial attention: o_parts:[S,B,H,D],
    lse_parts:[S,B,H] -> o:[B,H,D], a softmax over the shards' lse."""
    m = lse_parts.amax(dim=0, keepdim=True)
    w = torch.exp(lse_parts - m)
    w = w / torch.clamp(w.sum(dim=0, keepdim=True), min=1e-30)
    return (o_parts * w[..., None]).sum(dim=0)


# --------------------------------------------------------------------------- #
# Mamba2 SSD scan
# --------------------------------------------------------------------------- #
def ssd_naive(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor,
              h0: Optional[torch.Tensor] = None):
    """Sequential SSD oracle: x:[B,T,H,P] dt:[B,T,H] a:[H] (negative)
    b,c:[B,T,G,N] -> (y:[B,T,H,P], h:[B,H,N,P]).
    h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_t^T ;  y_t = c_t h_t"""
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    bx = b.repeat_interleave(H // G, dim=2).float()
    cx = c.repeat_interleave(H // G, dim=2).float()
    xf, dtf = x.float(), dt.float()
    h = h0.float() if h0 is not None else torch.zeros(
        (B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dtf[:, t] * a)[..., None, None]
        h = h * decay + (dtf[:, t, :, None, None] * bx[:, t, :, :, None]
                         * xf[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cx[:, t], h))
    return torch.stack(ys, 1).to(x.dtype), h


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int = 256,
                    h0: Optional[torch.Tensor] = None):
    """Chunked SSD, the plain version of ``csrc/ssd_scan.cu``: a masked
    decay-attention within each chunk and an (N, P) state carried from
    chunk to chunk.  T must divide by ``chunk``."""
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if T % chunk:
        raise ValueError(f"sequence length {T} must divide by the chunk "
                         f"{chunk} (pad the sequence)")
    L, nc = chunk, T // chunk
    rep = H // G
    bxc = b.repeat_interleave(rep, dim=2).float().reshape(B, nc, L, H, N)
    cxc = c.repeat_interleave(rep, dim=2).float().reshape(B, nc, L, H, N)
    xf = x.float().reshape(B, nc, L, H, P)
    dtf = dt.float().reshape(B, nc, L, H)
    h = h0.float() if h0 is not None else torch.zeros(
        (B, H, N, P), dtype=torch.float32, device=x.device)
    il = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ys = []
    for ci in range(nc):
        xc, dtc, bc, cc = xf[:, ci], dtf[:, ci], bxc[:, ci], cxc[:, ci]
        cum = torch.cumsum(dtc * a, dim=1)                   # [B,L,H]
        # intra-chunk masked attention; exp(seg) above the diagonal may
        # overflow, so it is selected away, never multiplied by 0
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # [B,L,L,H]
        dec = torch.where(il[None, :, :, None], torch.exp(seg), 0.0)
        sc = torch.einsum("blhn,bmhn->blmh", cc, bc) * dec
        y_intra = torch.einsum("blmh,bmh,bmhp->blhp", sc, dtc, xc)
        # inter-chunk state contribution
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "blhn,bhnp->blhp", cc, h)
        # state update
        to_end = torch.exp(cum[:, -1:, :] - cum)             # [B,L,H]
        h = (torch.exp(cum[:, -1, :])[..., None, None] * h
             + torch.einsum("blhn,blh,blhp->bhnp", bc, dtc * to_end, xc))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(B, T, H, P)
    return y.to(x.dtype), h
