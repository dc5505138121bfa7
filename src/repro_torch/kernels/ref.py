"""Plain PyTorch versions of the attention kernels (same layouts, same
contracts as the JAX oracles in ``repro.kernels.ref``).

They are the CPU execution path of ``kernels/ops.py`` and the yardstick
the CUDA kernels are held against on the card: mask
``0 <= k_pos <= q_pos`` plus an optional ``window``/``chunk``, masked
scores at the finite ``NEG_INF``, softmax in float32, output in
``q.dtype``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

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
