"""Wrapper of the hand-written CUDA kernel
``csrc/chunked_prefill_attention.cu`` (the port of the Pallas TPU kernel
``repro.kernels.chunked_prefill``).

A chunk of S prompt queries per slot scores the slot's whole logical
history through the block table. q is read, and the output written,
through strides: the model passes a (B, Hq, S, hd) view of its (B, S, Hq,
hd) projection and gets back a view of a (B, S, Hq, hd) buffer, so the
head merge after attention is a free reshape. A bf16 q must have rows
aligned to the kernel's ``cp.async`` piece (16 bytes; 8 at hd 100) with
unit d stride; the pools always must.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPES, check_bf16_rows,
                                                 check_common)
from repro_torch.kernels.paged_decode_attention import check_pool, pool_strides

# 16: the reference's kernel sweep; 160: StableLM-2-12B
HEAD_DIMS = (16, 32, 64, 100, 128, 160)
# the GQA groups its C entry takes, those of the decode kernels (5:
# Llama-4 Maverick's 40 real q heads over its kv heads ::2)
GROUPS = (1, 2, 3, 4, 5, 8)

# kernel launches since the last reset (kernels/ops.py reset_launches)
launches = 0


def chunked_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, block_tbl: torch.Tensor,
                              q_pos: torch.Tensor, k_pos: torch.Tensor,
                              window: Optional[int] = None,
                              chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,S,hd); k_pages/v_pages: (Hkv,P+1,ps,hd) with the chunk's
    keys already written; block_tbl: (B,M) int32; q_pos: (B,S) int32 (-1 =
    pad query, output 0); k_pos: (B,M*ps) int32 logical, all on one CUDA
    device. Returns (B,Hq,S,hd) in q.dtype."""
    global launches
    check_common(q, k_pages, v_pages, q_pos, k_pos, window, chunk)
    check_pool(q, k_pages, v_pages, block_tbl, k_pos, head_dims=HEAD_DIMS,
               groups=GROUPS)
    B, Hq, S, hd = q.shape
    Hkv, P1, ps, _ = k_pages.shape
    M = block_tbl.shape[1]
    if q_pos.shape != (B, S):
        raise ValueError("q_pos must be (B, S)")
    check_bf16_rows(q=q)           # the pools: check_pool
    tbl = block_tbl.contiguous()
    q_pos, k_pos = q_pos.contiguous(), k_pos.contiguous()
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 14)(
        *q.stride(), *pool_strides(k_pages, v_pages), *out.stride())
    fn = build.library("chunked_prefill_attention")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             tbl.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
             out.data_ptr(), strides, B, Hq, Hkv, S, P1, ps, M, hd, hd,
             window or -1, chunk or -1, DTYPES[q.dtype], q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    build.check(err, "chunked_prefill_attention")
    return out
