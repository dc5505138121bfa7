"""Wrapper of the hand-written CUDA kernel ``csrc/wkv6.cu`` (the port of
the Pallas TPU kernel ``repro.kernels.wkv6.wkv6``): the RWKV6 recurrence
per (batch, head) with a float32 state.

r, k, v and w are read through their (b, h, t) strides, so the model
passes transposed views of its (B, T, H, hd) projections and nothing is
copied. The output is written into a (B, T, H, hd) buffer and returned as
its (B, H, T, hd) view, so the model's transpose back is free. The final
state may be written over the initial one (``s_out=s0``): decode updates
the cache in place.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # r, k, v
# 32 and 64: the smoke and full configs; 8 and 16: the reference's sweeps
HEAD_DIMS = (8, 16, 32, 64)

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
         s_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: (B,H,T,hd) float32 or bf16 (one dtype); w: (B,H,T,hd) and
    u: (H,hd), each float32 or the dtype of r/k/v (widened to float32 on
    load); s0: (B,H,hd,hd) float32, contiguous; all on one CUDA device,
    unit stride on hd. ``s_out`` (contiguous float32,
    may be ``s0``) receives the final state. Returns (out (B,H,T,hd)
    float32, s_final (B,H,hd,hd) float32)."""
    global launches
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u), ("s0", s0)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if r.dtype not in DTYPES:
        raise TypeError(f"wkv6 takes r/k/v in {list(DTYPES)}, got {r.dtype}")
    if not (k.dtype == v.dtype == r.dtype):
        raise TypeError("r, k and v must share one dtype")
    for name, t in (("w", w), ("u", u)):
        if t.dtype not in (torch.float32, r.dtype):
            raise TypeError(f"{name} must be float32 or {r.dtype}, got "
                            f"{t.dtype}")
    if s0.dtype != torch.float32:
        raise TypeError(f"s0 must be float32, got {s0.dtype}")
    B, H, T, hd = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, hd) or s0.shape != (B, H, hd, hd):
        raise ValueError(f"shapes r {tuple(r.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} w {tuple(w.shape)} u "
                         f"{tuple(u.shape)} s0 {tuple(s0.shape)} do not "
                         "match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if T < 1:
        raise ValueError("wkv6 needs at least one time step")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("r, k, v and w need unit stride on the head dim")
    if s_out is None:
        s_out = torch.empty_like(s0, memory_format=torch.contiguous_format)
    elif s_out.shape != s0.shape or s_out.dtype != torch.float32 or \
            s_out.device != r.device:
        raise ValueError("s_out must be a float32 (B,H,hd,hd) tensor on r's "
                         "device")
    if not (s0.is_contiguous() and s_out.is_contiguous()):
        raise ValueError("s0 and s_out must be contiguous")
    u = u.contiguous()
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_longlong * 12)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3])
    fn = build.library("wkv6")
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s0.data_ptr(), s_out.data_ptr(), out.data_ptr(),
             strides, B, H, T, hd, DTYPES[r.dtype], DTYPES[w.dtype],
             DTYPES[u.dtype], r.device.index or 0,
             torch.cuda.current_stream(r.device).cuda_stream)
    launches += 1
    build.check(err, "wkv6")
    return out.transpose(1, 2), s_out
