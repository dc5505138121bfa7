"""Plain PyTorch versions of the kernels (same layouts, same contracts as
the JAX oracles in ``repro.kernels.ref``): the attention kernels, the
paged ones included (they gather the logical view through the block table
and score like the contiguous ones), the Mamba2 SSD chunk, the RWKV6
recurrence and the row RMSNorm, with the unfused sequences that form its
row (the residual add, Zamba2's concat, Mamba2's gate).

They are the CPU execution path of ``kernels/ops.py`` and the yardstick
the CUDA kernels are held against on the card. Attention: mask
``0 <= k_pos <= q_pos`` plus an optional ``window``/``chunk``, masked
scores at the finite ``NEG_INF``, softmax in float32, output in
``q.dtype``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor,
                   window: Optional[int], chunk: Optional[int]) -> torch.Tensor:
    """Boolean mask, broadcasting ``qpos`` against ``kpos``."""
    ok = (kpos >= 0) & (kpos <= qpos)
    if window is not None:
        ok &= kpos > qpos - window
    if chunk is not None:
        ok &= torch.div(kpos, chunk, rounding_mode="floor") == \
            torch.div(qpos, chunk, rounding_mode="floor")
    return ok


def flash_attention(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                    chunk: Optional[int] = None):
    """q: (B,Hq,Sq,hd); k/v: (B,Hkv,Sk,hd); *_pos: (B,S). -> (B,Hq,Sq,hd_v)."""
    hd = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(hd)
    ok = attention_mask(q_pos[:, None, :, None], k_pos[:, None, None, :],
                        window, chunk)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(q.dtype)


def decode_attention(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                     chunk: Optional[int] = None):
    """q: (B,Hq,hd); k: (B,Hkv,W,hd); v: (B,Hkv,W,hd_v); q_pos: (B,);
    k_pos: (B,W). -> (B,Hq,hd_v)."""
    out = flash_attention(q[:, :, None, :], k, v, q_pos[:, None], k_pos,
                          window, chunk)
    return out[:, :, 0, :]


def logical_view(pages: torch.Tensor, block_tbl: torch.Tensor) -> torch.Tensor:
    """(Hkv,P+1,ps,hd) pool -> (B,Hkv,M*ps,hd) per-slot logical cache view
    through the (B,M) block table. Unmapped pages (-1) read the trash page
    (the pool's last page) and are masked by their -1 logical positions."""
    trash = pages.shape[1] - 1
    safe = torch.where(block_tbl < 0, torch.full_like(block_tbl, trash),
                       block_tbl).long()
    g = pages[:, safe]                                 # (Hkv, B, M, ps, hd)
    H, B, M, ps, hd = g.shape
    return g.transpose(0, 1).reshape(B, H, M * ps, hd)


def paged_decode_attention(q, k_pages, v_pages, block_tbl, q_pos, k_pos,
                           window: Optional[int] = None,
                           chunk: Optional[int] = None):
    """q: (B,Hq,hd); k_pages/v_pages: (Hkv,P+1,ps,*); block_tbl: (B,M)
    int32; q_pos: (B,); k_pos: (B,M*ps) logical. Gather the logical view
    through the block table, then score exactly like ``decode_attention``."""
    return decode_attention(q, logical_view(k_pages, block_tbl),
                            logical_view(v_pages, block_tbl),
                            q_pos, k_pos, window, chunk)


def chunked_prefill_attention(q, k_pages, v_pages, block_tbl, q_pos, k_pos,
                              window: Optional[int] = None,
                              chunk: Optional[int] = None):
    """q: (B,Hq,S,hd); k_pages/v_pages: (Hkv,P+1,ps,*); block_tbl: (B,M);
    q_pos: (B,S) (-1 = pad query); k_pos: (B,M*ps) logical. The chunk's own
    keys are already in the pool, so ``k_pos <= q_pos`` gives causality
    inside the chunk; scored exactly like ``flash_attention`` on the
    gathered logical view."""
    return flash_attention(q, logical_view(k_pages, block_tbl),
                           logical_view(v_pages, block_tbl),
                           q_pos, k_pos, window, chunk)


def ssd_chunk(x, dt, A, Bm, Cm):
    """x: (B,H,nc,cl,P); dt: (B,H,nc,cl); A: (H,); Bm/Cm: (B,H,nc,cl,N).
    Returns (y_intra, h_chunk, decay) in float32, as the kernel:
    y_intra[t] = sum_{s<=t} exp(cum[t]-cum[s]) (C_t.B_s) dt_s x_s,
    h_chunk = sum_s exp(cum[-1]-cum[s]) dt_s x_s (x) B_s,
    decay = exp(cum[-1]), with cum the prefix sum of dt*A in the chunk."""
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    cum = torch.cumsum(dtf * A.float()[None, :, None, None], dim=-1)
    xdt = xf * dtf[..., None]
    cl = x.shape[3]
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=x.device))
    # masked before the exp: above the diagonal cum[t] - cum[s] > 0 can pass
    # 88.7 over a long chunk, and exp's inf there would make autograd's
    # gradient 0 * inf = nan (the values are the same either way)
    W = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~tri, -math.inf))
    CB = Cf @ Bf.transpose(-1, -2)                      # (B,H,nc,t,s)
    y = (CB * W) @ xdt
    emit = torch.exp(cum[..., -1:] - cum)               # (B,H,nc,cl)
    h = (xdt * emit[..., None]).transpose(-1, -2) @ Bf  # (B,H,nc,P,N)
    return y, h, torch.exp(cum[..., -1])


def wkv6(r, k, v, w, u, s0):
    """r/k/v/w: (B,H,T,hd), any strides; u: (H,hd); s0: (B,H,hd,hd).
    The RWKV6 recurrence per (batch, head), in float32 whatever the input
    type: out_t = r_t (S + u (x) k_t v_t), then S = diag(w_t) S + k_t v_t.
    Returns (out (B,H,T,hd), s_final (B,H,hd,hd)), float32."""
    S = s0.float()
    uu = u.float()[..., :, None]
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = (a[:, :, t].float() for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", rt, S + uu * kv))
        S = wt[..., :, None] * S + kv
    return torch.stack(outs, dim=2), S


def rmsnorm(x, scale, eps: float):
    """x: (..., d); scale: (d,). Statistics in float32, output in
    ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def add_rmsnorm(x, delta, scale, eps: float):
    """s = x + delta (the residual stream), then rmsnorm(s). -> (s, y)"""
    s = x + delta
    return s, rmsnorm(s, scale, eps)


def cat_rmsnorm(x, e, scale, eps: float, delta=None):
    """rmsnorm of concat([x, e]) on the last dim; with ``delta``, x + delta
    first and (x + delta, y) returned."""
    if delta is None:
        return rmsnorm(torch.cat([x, e], dim=-1), scale, eps)
    s = x + delta
    return s, rmsnorm(torch.cat([s, e], dim=-1), scale, eps)


def gated_rmsnorm(y, z, scale, eps: float, dtype):
    """rmsnorm of (y * silu(z)) cast to ``dtype`` (Mamba2's gated norm)."""
    return rmsnorm((y * F.silu(z)).to(dtype), scale, eps)
