"""Wrappers of the hand-written CUDA kernel ``csrc/rmsnorm.cu`` (the port
of the Pallas TPU kernel ``repro.kernels.rmsnorm.rmsnorm``): RMSNorm over
the rows of a (R, d) tensor, statistics in float32, output in the row's
type, with the row formed in the same launch from what the model holds:

- ``rmsnorm(x)``: the row is x;
- ``add_rmsnorm(x, delta)``: the row is x + delta, also returned (the
  residual stream);
- ``cat_rmsnorm(x, e[, delta])``: the row is [x (+ delta) | e] (Zamba2's
  shared block), never materialised;
- ``gated_rmsnorm(y, z)``: the row is (y * silu(z)) cast to ``dtype``
  (Mamba2's gate), y and z float32.

Inputs are read through their row stride (unit stride inside a row);
outputs are contiguous. Any d: the kernel takes 16-byte vectors where the
rows are aligned and single elements where they are not. Each call is one
launch and adds 1 to ``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the row, and scale
PLAIN, ADD, CAT, ADD_CAT, GATE = range(5)        # csrc/rmsnorm.cu prologues

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def _rows(name: str, t: torch.Tensor, x: torch.Tensor, d=None,
          dtype=None) -> None:
    """Raise unless ``t`` is (R, d) rows on x's device with x's row count
    (with x's type, or ``dtype``), unit stride on d (any d where ``d`` is
    None)."""
    if t.get_device() != x.get_device():
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    want = dtype or x.dtype
    if want not in DTYPES:
        raise TypeError(f"rmsnorm takes {list(DTYPES)}, got {name} {want}")
    if t.dtype != want:
        raise TypeError(f"rmsnorm takes {name} in {want}, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != x.shape[0] or (
            d is not None and t.shape[1] != d):
        raise ValueError(f"{name} {tuple(t.shape)} must be ({x.shape[0]}, "
                         f"{'d' if d is None else d}) rows")
    if t.stride(1) != 1:
        raise ValueError(f"{name} needs unit stride on d")


def _launch(pro: int, x: torch.Tensor, b, e, scale: torch.Tensor,
            s, y: torch.Tensor, eps: float) -> None:
    """One launch of prologue ``pro``: x and b (delta or z) read through
    their row strides, e the second segment, s and y written. The path is
    host-bound, so this does no more than the checks and the call."""
    global launches
    dev = y.get_device()
    if scale.get_device() != dev:
        raise ValueError(f"scale is on {scale.device}, x on {y.device}")
    if scale.dtype not in DTYPES:
        raise TypeError(f"rmsnorm takes {list(DTYPES)}, got scale "
                        f"{scale.dtype}")
    R, d = y.shape
    if scale.shape != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} must be ({d},)")
    if R == 0:
        return
    scale = scale.contiguous()
    d1 = x.shape[1]
    err = build.library("rmsnorm")(
        pro, x.data_ptr(), 0 if b is None else b.data_ptr(),
        0 if e is None else e.data_ptr(), scale.data_ptr(),
        0 if s is None else s.data_ptr(), y.data_ptr(), R, x.stride(0),
        0 if b is None else b.stride(0), 0 if e is None else e.stride(0),
        d1, d - d1, eps, DTYPES[y.dtype], DTYPES[scale.dtype], dev,
        # the current stream's handle, without building a Stream object
        torch._C._cuda_getCurrentRawStream(dev))
    launches += 1
    build.check(err, "rmsnorm")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (R, d) float32 or bf16 with unit stride on d; scale: (d,)
    float32 or bf16; both on one CUDA device. Returns (R, d) in
    ``x.dtype``, contiguous."""
    _rows("x", x, x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch(PLAIN, x, None, None, scale, None, y, eps)
    return y


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5):
    """x, delta: (R, d) of one type (float32 or bf16), unit stride on d.
    Returns (s, y): s = x + delta rounded once to the type (bit-identical
    to PyTorch's ``x + delta``) and y = rmsnorm(s), both (R, d)
    contiguous."""
    _rows("x", x, x)
    _rows("delta", delta, x, x.shape[1])
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch(ADD, x, delta, None, scale, s, y, eps)
    return s, y


def cat_rmsnorm(x: torch.Tensor, e: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5, delta: torch.Tensor | None = None):
    """x: (R, d1) and e: (R, d2) of one type, unit stride on their last
    dim; scale: (d1 + d2,). Returns y = rmsnorm([x | e]) (R, d1 + d2); with
    ``delta`` (R, d1), (s, y) with s = x + delta and y = rmsnorm([s |
    e])."""
    _rows("x", x, x)
    _rows("e", e, x)
    y = torch.empty((x.shape[0], x.shape[1] + e.shape[1]), dtype=x.dtype,
                    device=x.device)
    if delta is None:
        _launch(CAT, x, None, e, scale, None, y, eps)
        return y
    _rows("delta", delta, x, x.shape[1])
    s = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch(ADD_CAT, x, delta, e, scale, s, y, eps)
    return s, y


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float, dtype: torch.dtype) -> torch.Tensor:
    """y, z: (R, d) float32, unit stride on d. Returns rmsnorm of (y *
    silu(z)) cast to ``dtype`` (float32 or bf16), (R, d) in ``dtype``,
    contiguous."""
    if dtype not in DTYPES:
        raise TypeError(f"rmsnorm takes {list(DTYPES)}, got {dtype}")
    _rows("y", y, y, dtype=torch.float32)
    _rows("z", z, y, y.shape[1], dtype=torch.float32)
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    _launch(GATE, y, z, None, scale, None, out, eps)
    return out
