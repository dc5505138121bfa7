"""Wrapper of the hand-written CUDA kernel ``csrc/paged_decode_attention.cu``
(the port of the Pallas TPU kernel ``paged_decode_attention`` in
``repro.kernels.decode_attention``).

A cluster of up to eight blocks per (batch, kv head) splits the slot's
logical pages (the split-KV core ``csrc/decode_tile.cuh``), each block
walking its span through the block table, so the shared page pool is never
gathered into a per-slot copy; one launch a call. The pool's strides reach
the kernel as 64-bit integers; every flat page offset is computed in 64
bits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import GROUPS
from repro_torch.kernels.flash_attention import (DTYPES, HEAD_DIMS,
                                                 check_common, check_rows)

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def check_pool(q, k_pages, v_pages, block_tbl, k_pos,
               head_dims=HEAD_DIMS, groups=GROUPS) -> None:
    """Validation shared by both paged wrappers: pool, table and logical
    positions must agree with each other and with what the kernels take
    (``head_dims`` and ``groups``: the calling kernel's instances)."""
    Hkv, P1, ps, hd = k_pages.shape
    M = block_tbl.shape[-1]
    if v_pages.shape[:3] != (Hkv, P1, ps):
        raise ValueError(f"k_pages {tuple(k_pages.shape)} / v_pages "
                         f"{tuple(v_pages.shape)} do not match")
    if hd not in head_dims or v_pages.shape[-1] != hd or q.shape[-1] != hd:
        raise ValueError(f"head dims (q {q.shape[-1]}, k {hd}, v "
                         f"{v_pages.shape[-1]}) not supported; the kernel "
                         f"takes hd == hd_v in {head_dims}")
    Hq = q.shape[1]
    if Hq % Hkv or Hq // Hkv not in groups:
        raise ValueError(f"GQA group {Hq}/{Hkv} not in {groups}")
    if block_tbl.device != q.device:
        raise ValueError(f"block_tbl is on {block_tbl.device}, q on {q.device}")
    if block_tbl.dtype != torch.int32:
        raise TypeError("block_tbl must be int32")
    if block_tbl.shape != (q.shape[0], M) or k_pos.shape != (q.shape[0],
                                                             M * ps):
        raise ValueError("block_tbl must be (B, M) and k_pos (B, M*ps)")
    check_rows("pool", k_pages=k_pages, v_pages=v_pages)


def pool_strides(k_pages: torch.Tensor, v_pages: torch.Tensor):
    """(head, page, row) element strides of both pools, 64-bit."""
    return (*k_pages.stride()[:3], *v_pages.stride()[:3])


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tbl: torch.Tensor,
                           q_pos: torch.Tensor, k_pos: torch.Tensor,
                           window: Optional[int] = None,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,hd); k_pages/v_pages: (Hkv,P+1,ps,hd); block_tbl: (B,M)
    int32 (-1 = unmapped -> trash page P); q_pos: (B,); k_pos: (B,M*ps)
    int32 logical positions, all on one CUDA device. Returns (B,Hq,hd)."""
    global launches
    check_common(q, k_pages, v_pages, q_pos, k_pos, window, chunk)
    check_pool(q, k_pages, v_pages, block_tbl, k_pos)
    B, Hq, hd = q.shape
    Hkv, P1, ps, _ = k_pages.shape
    M = block_tbl.shape[1]
    if q_pos.shape != (B,):
        raise ValueError("q_pos must be (B,)")
    if M * ps * ps >= 2 ** 32:
        raise ValueError(f"table width {M} x page size {ps}^2 must be < "
                         "2^32 (the kernel's page division by reciprocal)")
    q = q.contiguous()
    tbl = block_tbl.contiguous()
    q_pos, k_pos = q_pos.contiguous(), k_pos.contiguous()
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 6)(*pool_strides(k_pages, v_pages))
    fn = build.library("paged_decode_attention")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             tbl.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
             out.data_ptr(), strides, B, Hq, Hkv, P1, ps, M, hd, hd,
             window or -1, chunk or -1, DTYPES[q.dtype], q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    build.check(err, "paged_decode_attention")
    return out
