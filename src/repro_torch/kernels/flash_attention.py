"""Wrapper of the hand-written CUDA prefill kernel ``csrc/flash_attention.cu``
(the port of the Pallas TPU kernel ``repro.kernels.flash_attention``).

The kernel reads q/k/v through their strides and writes its output
through strides too: the result is a (B, Hq, Sq, hd) view of a
(B, Sq, Hq, hd) buffer, so the model's head merge after attention is a
free reshape. It masks the ragged Sq/Sk edges itself; nothing is padded.
The bf16 instance copies pieces of rows with ``cp.async``: 16 bytes, or
8 at hd 100 (a 200-byte row; the rows of a (B, S, H, 100) projection start
on 8-byte boundaries only). So it takes only operands whose rows are
aligned to that piece with unit d stride (the model's (B, S, H, hd)
projections and their head-transposed views are) and raises on any other;
there is no copy and no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# 100: LLaMA-3B; 112: Zamba2's shared attention; 160: StableLM-2-12B; 8
# and 16: the reference's kernel sweeps
HEAD_DIMS = (8, 16, 32, 64, 100, 112, 128, 160)
# float32 also takes hd 20 (examples/serve_e2e_torch.py: d_model 160 over
# 8 heads); the bf16 tensor-core tiles do not
F32_HEAD_DIMS = HEAD_DIMS + (20,)


def head_dims(dtype) -> tuple:
    """The head dims of the flash and contiguous decode kernels' instances
    of ``dtype``."""
    return F32_HEAD_DIMS if dtype == torch.float32 else HEAD_DIMS

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def piece_bytes(t: torch.Tensor) -> int:
    """Bytes of one ``cp.async`` piece of ``t``'s rows: 16, or 8 where a
    row is no whole number of 16-byte pieces (bf16 hd 100: 200 bytes); the
    rule of ``attn::piece_bytes`` in ``csrc/attention_tile.cuh``."""
    return 16 if (t.shape[-1] * t.element_size()) % 16 == 0 else 8


def row_aligned(t: torch.Tensor) -> bool:
    """Every row (all indices but the last) starts on a ``piece_bytes``
    boundary with unit d stride: the kernels read rows in such pieces."""
    e, n = t.element_size(), piece_bytes(t)
    return (t.stride(-1) == 1 and t.data_ptr() % n == 0
            and all((s * e) % n == 0 for s in t.stride()[:-1]))


def check_rows(what: str, **tensors: torch.Tensor) -> None:
    """Raise on an operand whose rows are not aligned to the kernel's
    ``cp.async`` piece (``piece_bytes``) with unit d stride."""
    for name, t in tensors.items():
        if not row_aligned(t):
            raise ValueError(
                f"{what} {name} (strides {t.stride()}) needs unit d stride "
                f"and {piece_bytes(t)}-byte aligned rows: the kernel copies "
                "rows with cp.async")


def check_bf16_rows(**tensors: torch.Tensor) -> None:
    """The bf16 prefill kernels copy rows with ``cp.async`` (the float32
    ones read elements through any strides): raise on a bf16 operand whose
    rows are not aligned to its piece."""
    check_rows("bf16", **{n: t for n, t in tensors.items()
                          if t.dtype == torch.bfloat16})


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
                    chunk: Optional[int] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Hq,Sq,hd); k/v: (B,Hkv,Sk,hd); q_pos: (B,Sq) (-1 = pad
    query, output 0); k_pos: (B,Sk) int32, all on one CUDA device.
    Returns (B,Hq,Sq,hd) in q.dtype. ``lse``, a contiguous float32
    (B,Hq,Sq) buffer, also receives each query row's logsumexp of its
    scaled scores (+inf where the row sees no key: the backward pass
    gives it no gradient); the serving path passes none."""
    global launches
    check_common(q, k, v, q_pos, k_pos, window, chunk)
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, hd) or v.shape != (B, Hkv, Sk, hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError("kernel requires uniform GQA grouping (Hq % Hkv)")
    if hd not in head_dims(q.dtype):
        raise ValueError(f"head dim {hd} not in {head_dims(q.dtype)} "
                         f"({q.dtype})")
    if q_pos.shape != (B, Sq) or k_pos.shape != (B, Sk):
        raise ValueError("positions must be (B, Sq) and (B, Sk)")
    check_bf16_rows(q=q, k=k, v=v)
    q_pos, k_pos = q_pos.contiguous(), k_pos.contiguous()
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride())
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr())
    if lse is None:
        fn = build.library("flash_attention")
    else:
        if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32
                or not lse.is_contiguous() or lse.device != q.device):
            raise ValueError(f"lse must be a contiguous float32 ({B}, {Hq}, "
                             f"{Sq}) tensor on {q.device}")
        fn = build.library("flash_attention_lse")
        ptrs += (lse.data_ptr(),)
    err = fn(*ptrs, strides, B, Hq, Hkv, Sq, Sk, hd, window or -1,
             chunk or -1, DTYPES[q.dtype], q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    build.check(err, "flash_attention")
    return out
