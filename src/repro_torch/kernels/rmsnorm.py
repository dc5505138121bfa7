"""Wrapper of the hand-written CUDA kernel ``csrc/rmsnorm.cu`` (the port of
the Pallas TPU kernel ``repro.kernels.rmsnorm.rmsnorm``): RMSNorm over the
rows of a (R, d) tensor, statistics in float32, output in ``x.dtype``.

Rows are read through their stride (unit stride inside a row); the output
is contiguous. Any d: the kernel takes 16-byte vectors where the row is
aligned and single elements where it is not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # x, and scale on its own

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (R, d) float32 or bf16 with unit stride on d; scale: (d,)
    float32 or bf16; both on one CUDA device. Returns (R, d) in
    ``x.dtype``, contiguous."""
    global launches
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if x.dtype not in DTYPES or scale.dtype not in DTYPES:
        raise TypeError(f"rmsnorm takes {list(DTYPES)}, got x {x.dtype} "
                        f"scale {scale.dtype}")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"x {tuple(x.shape)} must be (R, d) and scale "
                         f"{tuple(scale.shape)} (d,)")
    if x.stride(1) != 1:
        raise ValueError("x needs unit stride on d")
    R, d = x.shape
    y = torch.empty((R, d), dtype=x.dtype, device=x.device)
    if R == 0:
        return y
    scale = scale.contiguous()
    fn = build.library("rmsnorm")
    err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), R, x.stride(0), d,
             float(eps), DTYPES[x.dtype], DTYPES[scale.dtype],
             x.device.index or 0,
             torch.cuda.current_stream(x.device).cuda_stream)
    launches += 1
    build.check(err, "rmsnorm")
    return y
