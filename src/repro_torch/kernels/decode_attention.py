"""Wrapper of the hand-written CUDA decode kernel ``csrc/decode_attention.cu``
(the port of the Pallas TPU kernel ``repro.kernels.decode_attention``).

One block per (batch, kv head) scores the whole GQA group against each
K/V row once. K and V are read through their strides, so the model passes
``cache["k"].transpose(1, 2)`` — a view of the (B, W, Hkv, hd) cache —
and no per-step copy of the cache is ever made.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, check_common

GROUPS = (1, 2, 4, 8)

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def _row_aligned(t: torch.Tensor) -> bool:
    """Every (b, h, s) row starts on a 16-byte boundary with unit d stride:
    the kernel reads K rows with 16-byte vector loads."""
    e = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * e) % 16 == 0 for s in t.stride()[:-1]))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: Optional[int] = None,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,hd); k: (B,Hkv,W,hd); v: (B,Hkv,W,hd_v); q_pos: (B,);
    k_pos: (B,W) int32, all on one CUDA device. Returns (B,Hq,hd_v)."""
    global launches
    check_common(q, k, v, q_pos, k_pos, window, chunk)
    B, Hq, hd = q.shape
    Hkv, W = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    if k.shape != (B, Hkv, W, hd) or v.shape[:3] != (B, Hkv, W):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % Hkv or Hq // Hkv not in GROUPS:
        raise ValueError(f"GQA group {Hq}/{Hkv} not in {GROUPS}")
    if hd not in HEAD_DIMS or hd_v != hd:
        raise ValueError(f"head dims ({hd}, {hd_v}) not supported; the "
                         f"kernel takes hd == hd_v in {HEAD_DIMS}")
    if q_pos.shape != (B,) or k_pos.shape != (B, W):
        raise ValueError("positions must be (B,) and (B, W)")
    if not (_row_aligned(k) and _row_aligned(v)):
        raise ValueError("k/v rows must be 16-byte aligned with unit d "
                         "stride")
    q = q.contiguous()
    q_pos, k_pos = q_pos.contiguous(), k_pos.contiguous()
    out = torch.empty((B, Hq, hd_v), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    fn = build.library("decode_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             k_pos.data_ptr(), out.data_ptr(), strides, B, Hq, Hkv, W, hd,
             hd_v, window or -1, chunk or -1, DTYPES[q.dtype],
             q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    build.check(err, "decode_attention")
    return out
