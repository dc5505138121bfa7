"""Wrapper of the hand-written CUDA prefill kernel ``csrc/flash_attention.cu``
(the port of the Pallas TPU kernel ``repro.kernels.flash_attention``).

The kernel reads q/k/v through their strides and writes its output
through strides too: the result is a (B, Hq, Sq, hd) view of a
(B, Sq, Hq, hd) buffer, so the model's head merge after attention is a
free reshape. It masks the ragged Sq/Sk edges itself; nothing is padded.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128)    # 112: Zamba2's shared attention

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def check_common(q, k, v, q_pos, k_pos, window, chunk) -> None:
    """Validation shared by both attention wrappers: raise on what the
    kernels do not take instead of launching them on it."""
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"attention kernels take {list(DTYPES)}, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1 or None, got {chunk}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: Optional[int] = None,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,Sq,hd); k/v: (B,Hkv,Sk,hd); q_pos: (B,Sq); k_pos: (B,Sk)
    int32, all on one CUDA device. Returns (B,Hq,Sq,hd) in q.dtype."""
    global launches
    check_common(q, k, v, q_pos, k_pos, window, chunk)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, hd) or v.shape != (B, Hkv, Sk, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError("kernel requires uniform GQA grouping (Hq % Hkv)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q_pos.shape != (B, Sq) or k_pos.shape != (B, Sk):
        raise ValueError("positions must be (B, Sq) and (B, Sk)")
    q_pos, k_pos = q_pos.contiguous(), k_pos.contiguous()
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride())
    fn = build.library("flash_attention")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             k_pos.data_ptr(), out.data_ptr(), strides, B, Hq, Hkv, Sq, Sk,
             hd, window or -1, chunk or -1, DTYPES[q.dtype],
             q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    build.check(err, "flash_attention")
    return out
