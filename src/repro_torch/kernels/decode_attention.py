"""Wrapper of the hand-written CUDA decode kernel ``csrc/decode_attention.cu``
(the port of the Pallas TPU kernel ``repro.kernels.decode_attention``).

A cluster of up to eight blocks per (batch, kv head) splits the cache
(the split-KV core ``csrc/decode_tile.cuh``, one launch a call) and scores
the whole GQA group against each K/V row once. K and V are read through
their strides, so the model passes ``cache["k"].transpose(1, 2)`` — a view
of the (B, W, Hkv, hd) cache — and no per-step copy of the cache is ever
made.

The value head dim may differ from the key's, as in the reference: the
instances with ``hd_v != hd`` are those of ``PAIRS`` (MLA decode over the
latent cache, ``ops.mla_decode_attention``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPES, check_common,
                                                 check_rows, head_dims)

# the groups of the split-KV core's instances (csrc/decode_tile.cuh
# by_group), in both decode kernels: 3, InternLM2-20B (48 query heads on
# 8 kv heads duplicated to 16); 5, Llama-4 Maverick (40 real query heads
# on one copy of each of its 8 kv heads)
GROUPS = (1, 2, 3, 4, 5, 8)
# (hd, hd_v) -> groups of the instances with hd_v != hd: the reference's
# MLA sweep (tests/test_kernels.py), kvr 16 + rope 8 over one latent head
PAIRS = {(24, 16): (4,)}

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


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
    group = Hq // Hkv
    if not ((hd == hd_v and hd in head_dims(q.dtype))
            or group in PAIRS.get((hd, hd_v), ())):
        raise ValueError(f"head dims ({hd}, {hd_v}) at group {group} not "
                         f"supported; the kernel takes hd == hd_v in "
                         f"{head_dims(q.dtype)} ({q.dtype}), or (hd, hd_v) "
                         f"-> groups {PAIRS}")
    if q_pos.shape != (B,) or k_pos.shape != (B, W):
        raise ValueError("positions must be (B,) and (B, W)")
    if W < 1:
        raise ValueError("the cache needs at least one row")
    check_rows("cache", k=k, v=v)
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
