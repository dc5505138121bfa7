"""Wrapper of the hand-written CUDA kernel ``csrc/ssd_chunk.cu`` (the port
of the Pallas TPU kernel ``repro.kernels.ssd.ssd_chunk``): the Mamba2 SSD
within-chunk outputs ``y_intra``, ``h_chunk`` and ``decay`` in float32.

x, dt, B and C are read through their (b, h, c, t) strides, so
``ops.ssd_scan`` passes permuted views of the model's (B, T, H, *)
projections, and a B/C group broadcast over the heads (head stride 0) is
never copied. The feature dims must have unit stride.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dim P and state dim N it takes: the models' 16-64, and the
# reference's kernel sweep's P 8, N 4 (N 8 beside it)
HEAD_DIMS = (8, 16, 32, 64)
STATE_DIMS = (4, 8, 16, 32, 64)
MAX_CHUNK = 256

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def _unit_feature(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,H,nc,cl,P); dt: (B,H,nc,cl); A: (H,) float32; Bm/Cm:
    (B,H,nc,cl,N), all on one CUDA device, x/dt/Bm/Cm of one dtype.
    Returns (y_intra (B,H,nc,cl,P), h_chunk (B,H,nc,P,N), decay (B,H,nc)),
    float32."""
    global launches
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_chunk takes {list(DTYPES)}, got {x.dtype}")
    if not (dt.dtype == Bm.dtype == Cm.dtype == x.dtype):
        raise TypeError("x, dt, Bm and Cm must share one dtype")
    if A.dtype != torch.float32:
        raise TypeError("A must be float32")
    B, H, nc, cl, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (B, H, nc, cl) or A.shape != (H,) or \
            Bm.shape != (B, H, nc, cl, N) or Cm.shape != Bm.shape:
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} Bm {tuple(Bm.shape)} Cm "
                         f"{tuple(Cm.shape)} do not match")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"head dim {P} / state dim {N} not in "
                         f"{HEAD_DIMS} / {STATE_DIMS}")
    if not 1 <= cl <= MAX_CHUNK:
        raise ValueError(f"chunk length {cl} not in [1, {MAX_CHUNK}]")
    x, Bm, Cm = _unit_feature(x), _unit_feature(Bm), _unit_feature(Cm)
    A = A.contiguous()
    dev = x.device
    y = torch.empty((B, H, nc, cl, P), dtype=torch.float32, device=dev)
    h = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=dev)
    dec = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 16)(
        *x.stride()[:4], *dt.stride(), *Bm.stride()[:4], *Cm.stride()[:4])
    fn = build.library("ssd_chunk")
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), y.data_ptr(), h.data_ptr(), dec.data_ptr(),
             strides, B, H, nc, cl, P, N, DTYPES[x.dtype], dev.index or 0,
             torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    build.check(err, "ssd_chunk")
    return y, h, dec
