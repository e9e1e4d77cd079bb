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

import math
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


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True,
                            window: Optional[int] = None):
    """(dq, dk, dv): autograd's gradient of :func:`flash_attention_ref` at
    upstream ``dout``, the plain version of
    ``csrc/flash_attention_bwd.cu``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, dout)


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
        # intra-chunk masked attention; above the diagonal seg is positive
        # and exp(seg) may overflow, so seg is selected away before the
        # exp (to -inf: exp gives 0 and autograd's gradient through it 0,
        # where inf * 0 would give NaN)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # [B,L,L,H]
        dec = torch.exp(torch.where(il[None, :, :, None], seg, -math.inf))
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


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                        dh: Optional[torch.Tensor] = None, chunk: int = 256):
    """(dx, ddt, da, db, dc): the gradient of :func:`ssd_chunked_ref`'s
    (y, h) at upstream dy and dh (None: h unused), from zero initial
    state, written out chunk by chunk in the passes of
    ``csrc/ssd_scan_bwd.cu`` (not by autograd): its plain version.
    Gradients come in the inputs' types, da in float32.

    Per (b, h) and chunk k, l and m its steps: cum the in-chunk prefix
    sum of dt a, dec_lm = exp(cum_l - cum_m) for m <= l (selected away
    above), s_lm = (c_l . b_m) dec_lm, w_m = dt_m exp(cum_last - cum_m),
    H_k the state entering chunk k and G_k the gradient of the state
    leaving it (G_last = dh).

    1. the states H_k, as the forward carries them;
    2. D_k = sum_l exp(cum_l) c_l dy_l^T, and the reverse carry
       G_(k-1) = exp(cum_last) G_k + D_k;
    3. the intra-chunk terms, with DX_lm = dy_l . x_m and
       A_lm = DX_lm dec_lm dt_m:
       dx_m = dt_m sum_l s_lm dy_l + w_m G^T b_m,
       db_m = sum_l A_lm c_l + w_m G x_m (per head),
       dc_l = sum_m A_lm b_m + exp(cum_l) H dy_l (per head),
       ddt_m (direct) = sum_l s_lm DX_lm + exp(cum_last - cum_m) b_m^T G x_m,
       and dcum, the gradient of cum: T_lm = s_lm dt_m DX_lm enters as
       + row sums - column sums, Q_m = w_m b_m^T G x_m as - Q_m, and
       exp(cum_l) c_l^T H dy_l; the last row adds
       exp(cum_last) <G, H> + sum_m Q_m;
    4. r = the reverse in-chunk cumsum of dcum: ddt = direct + a r,
       da = sum over batch and time of dt r, and db, dc summed over the
       heads of each group."""
    B, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if T % chunk:
        raise ValueError(f"sequence length {T} must divide by the chunk "
                         f"{chunk} (pad the sequence)")
    L, nc, rep = chunk, T // chunk, H // G
    dev = x.device
    xc = x.float().reshape(B, nc, L, H, P)
    dyc = dy.float().reshape(B, nc, L, H, P)
    dtc = dt.float().reshape(B, nc, L, H)
    bc = b.float().repeat_interleave(rep, dim=2).reshape(B, nc, L, H, N)
    cc = c.float().repeat_interleave(rep, dim=2).reshape(B, nc, L, H, N)
    af = a.float()
    cum = torch.cumsum(dtc * af, dim=2)                     # [B,nc,L,H]
    last = cum[:, :, -1]                                     # [B,nc,H]
    il = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [B,nc,l,m,H]
    dec = torch.exp(torch.where(il[:, :, None], seg, -math.inf))
    ecum = torch.exp(cum)
    to_end = torch.exp(last[:, :, None] - cum)
    w = dtc * to_end

    # 1. the states entering each chunk
    s_k = torch.einsum("bklhn,bklh,bklhp->bkhnp", bc, w, xc)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
    hs = []
    for k in range(nc):
        hs.append(h)
        h = torch.exp(last[:, k])[..., None, None] * h + s_k[:, k]
    hk = torch.stack(hs, 1)                                  # [B,nc,H,N,P]

    # 2. each chunk's gradient into its entering state, carried back
    d_k = torch.einsum("bklhn,bklh,bklhp->bkhnp", cc, ecum, dyc)
    g = torch.zeros_like(h) if dh is None else dh.float()
    gs = [g] * nc
    for k in reversed(range(nc)):
        gs[k] = g
        g = torch.exp(last[:, k])[..., None, None] * g + d_k[:, k]
    gk = torch.stack(gs, 1)                                  # [B,nc,H,N,P]

    # 3. the intra-chunk terms
    cb = torch.einsum("bklhn,bkmhn->bklmh", cc, bc)
    dxm = torch.einsum("bklhp,bkmhp->bklmh", dyc, xc)        # DX_lm
    s = cb * dec
    dtm = dtc[:, :, None]                                    # [B,nc,1,m,H]
    amat = dxm * dec * dtm
    tmat = s * dtm * dxm
    gx = torch.einsum("bkhnp,bkmhp->bkmhn", gk, xc)          # G x_m
    bgx = (bc * gx).sum(-1)                                  # b_m^T G x_m
    hdy = torch.einsum("bkhnp,bklhp->bklhn", hk, dyc)        # H dy_l
    dx = (torch.einsum("bklmh,bklhp->bkmhp", s * dtm, dyc)
          + w[..., None] * torch.einsum("bkmhn,bkhnp->bkmhp", bc, gk))
    db_h = torch.einsum("bklmh,bklhn->bkmhn", amat, cc) + w[..., None] * gx
    dc_h = torch.einsum("bklmh,bkmhn->bklhn", amat, bc) \
        + ecum[..., None] * hdy
    ddt = (s * dxm).sum(2) + to_end * bgx
    q = w * bgx
    dcum = tmat.sum(3) - tmat.sum(2) + ecum * (cc * hdy).sum(-1) - q
    dcum[:, :, -1] += torch.exp(last) * (gk * hk).sum((-2, -1)) + q.sum(2)

    # 4. the reverse cumsum into ddt and da; the group sums
    r = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = ddt + af * r
    da = (dtc * r).sum((0, 1, 2))
    db = db_h.reshape(B, T, G, rep, N).sum(3)
    dc = dc_h.reshape(B, T, G, rep, N).sum(3)
    return (dx.reshape(B, T, H, P).to(x.dtype),
            ddt.reshape(B, T, H).to(dt.dtype), da, db.to(b.dtype),
            dc.to(c.dtype))
