"""Attention ops with device dispatch: a tensor on the CPU goes to the
plain PyTorch version (``kernels/ref.py``), a tensor on a CUDA device to
the hand-written kernel — which launches or raises. There is no fallback
from the kernel to the plain version.

Each kernel module keeps a plain-integer launch count (``launches``),
incremented where the kernel is launched and nowhere else, so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

_KERNELS = {"flash_attention": _fa, "decode_attention": _dec}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"attention ops run on cpu or cuda, not {t.device}")


def flash_attention(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                    chunk: Optional[int] = None):
    """Prefill attention. q: (B,Hq,Sq,hd); k/v: (B,Hkv,Sk,hd);
    q_pos: (B,Sq); k_pos: (B,Sk). -> (B,Hq,Sq,hd)."""
    if _on_cuda(q):
        return _fa.flash_attention(q, k, v, q_pos, k_pos, window, chunk)
    return _ref.flash_attention(q, k, v, q_pos, k_pos, window, chunk)


def decode_attention(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                     chunk: Optional[int] = None):
    """Single-token decode attention over a (B, Hkv, W, *) KV cache view.
    q: (B,Hq,hd); q_pos: (B,); k_pos: (B,W). -> (B,Hq,hd_v)."""
    if _on_cuda(q):
        return _dec.decode_attention(q, k, v, q_pos, k_pos, window, chunk)
    return _ref.decode_attention(q, k, v, q_pos, k_pos, window, chunk)


def reset_launches() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}
