"""Dense / GQA self-attention and the contiguous KV cache (the port of the
dense part of ``repro.models.attention``).

* Head padding: configs whose head counts do not divide the sharding pad
  (``cfg.*_padded``) get zero wq columns / wo rows for padded q heads and
  duplicated kv heads, exactly as the reference initialises them; the
  static q-head -> kv-head map keeps GQA exact.
* KV cache per layer: ``{"k","v": (B, W, Hkv, hd), "pos_ids": (B, W)
  int32, "length": (B,) int32}``, W = min(max_len, sliding_window). A
  ring buffer: ``pos_ids`` (-1 = empty) drives every mask. Keys are stored
  rotated. The reference rebuilds the cache functionally each step; here
  every write goes into the cache tensors in place.
* Attention itself goes through ``kernels/ops.py``: the plain PyTorch
  version for a CPU tensor, the hand-written CUDA kernel for a CUDA one.
  Paged and chunk modes come with the paged KV pool (ROADMAP Queue 1,
  Paged engine).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as KOPS
from repro_torch.models import layers as L


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def _kv_index_map(n_q: int, n_kv: int, n_q_pad: int, n_kv_pad: int) -> np.ndarray:
    """Static map q-head -> kv-head honoring the original GQA grouping.

    When only KV heads are padded (consecutive-duplicate layout from
    attn_init), the map is the uniform divide i // (n_q_pad // n_kv_pad).
    """
    group = n_q // n_kv
    dup = n_kv_pad // n_kv if n_kv_pad % n_kv == 0 else 1
    if n_q_pad == n_q and dup > 1 and n_q_pad % n_kv_pad == 0:
        gp = n_q_pad // n_kv_pad
        idx = (np.arange(n_q_pad) // gp).astype(np.int32)
        # correctness: padded kv c is a copy of orig kv c // dup
        if not all((idx[i] // dup) == (i // group) for i in range(n_q)):
            raise AssertionError("kv duplicate layout broke the GQA map")
        return idx
    idx = np.zeros((n_q_pad,), dtype=np.int32)
    for i in range(n_q):
        orig_kv = i // group
        idx[i] = orig_kv * dup + (i % dup if dup > 1 else 0)
    return idx


def uniform_gqa_group(cfg) -> Optional[int]:
    """Group size when the q->kv map is the uniform divide (the kernels'
    GQA layout); None otherwise."""
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    n_qp, n_kvp = cfg.n_heads_padded, cfg.n_kv_heads_padded
    if n_qp % n_kvp:
        return None
    idx = _kv_index_map(n_q, n_kv, n_qp, n_kvp)
    gp = n_qp // n_kvp
    if np.array_equal(idx, np.arange(n_qp) // gp):
        return gp
    return None


def attn_init(gen, cfg, device) -> Dict:
    dt = L.dtype_of(cfg)
    d = cfg.d_model
    hd = cfg.head_dim_
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    n_qp, n_kvp = cfg.n_heads_padded, cfg.n_kv_heads_padded
    wq = L.dense_init(gen, d, n_qp * hd, dt, device)
    wk = L.dense_init(gen, d, n_kv * hd, dt, device)
    wv = L.dense_init(gen, d, n_kv * hd, dt, device)
    wo = L.dense_init(gen, n_qp * hd, cfg.d_model, dt, device)
    # zero the padded q heads (columns of wq, rows of wo)
    if n_qp > n_q:
        wq[:, n_q * hd:] = 0
        wo[n_q * hd:, :] = 0
    if n_kvp > n_kv:
        if n_kvp % n_kv == 0:
            dup = n_kvp // n_kv
            wk = wk.reshape(d, n_kv, hd).repeat_interleave(dup, 1).reshape(d, -1)
            wv = wv.reshape(d, n_kv, hd).repeat_interleave(dup, 1).reshape(d, -1)
        else:
            pad = (n_kvp - n_kv) * hd
            wk = torch.nn.functional.pad(wk, (0, pad))
            wv = torch.nn.functional.pad(wv, (0, pad))
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------


def cache_width(cfg, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_kv_cache(cfg, batch: int, max_len: int, device) -> Dict:
    dt = L.dtype_of(cfg)
    W = cache_width(cfg, max_len)
    H, hd = cfg.n_kv_heads_padded, cfg.head_dim_
    return {
        "k": torch.zeros((batch, W, H, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, W, H, hd), dtype=dt, device=device),
        "pos_ids": torch.full((batch, W), -1, dtype=torch.int32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill_write_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor,
                        pos_ids: torch.Tensor) -> Dict:
    """Write a full prompt (possibly longer than the ring) into a fresh
    cache, in place.

    For token j the ring slot is j % W; when S > W only the last W tokens
    survive — a deterministic gather of the latest token landing in each
    slot, as in the reference.
    """
    S = k.shape[1]
    W = cache["k"].shape[1]
    if S <= W:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["pos_ids"][:, :S] = pos_ids
    else:
        s = torch.arange(W, device=k.device)
        j = s + W * torch.div(S - 1 - s, W, rounding_mode="floor")
        cache["k"].copy_(k[:, j])
        cache["v"].copy_(v[:, j])
        cache["pos_ids"].copy_(pos_ids[:, j])
    cache["length"].copy_(pos_ids.max(dim=1).values + 1)
    return cache


def decode_write_cache(cache: Dict, k1: torch.Tensor, v1: torch.Tensor) -> Dict:
    """Append one token per sequence in place. k1/v1: (B, 1, Hkv, hd)."""
    B = k1.shape[0]
    W = cache["k"].shape[1]
    slot = torch.remainder(cache["length"], W).long()
    bidx = torch.arange(B, device=k1.device)
    cache["k"][bidx, slot] = k1[:, 0]
    cache["v"][bidx, slot] = v1[:, 0]
    cache["pos_ids"][bidx, slot] = cache["length"]
    cache["length"] += 1
    return cache


# --------------------------------------------------------------------------
# GQA self-attention block
# --------------------------------------------------------------------------


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _qkv(p, cfg, x, positions):
    hd = cfg.head_dim_
    n_qp, n_kvp = cfg.n_heads_padded, cfg.n_kv_heads_padded
    q = _split_heads(x @ p["wq"], n_qp, hd)
    k = _split_heads(x @ p["wk"], n_kvp, hd)
    v = _split_heads(x @ p["wv"], n_kvp, hd)
    q = L.apply_rope(q, positions, cfg.rotary_pct, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rotary_pct, cfg.rope_theta)
    return q, k, v


def _expand_kv(cfg, k):
    idx = torch.as_tensor(_kv_index_map(cfg.n_heads, cfg.n_kv_heads,
                                        cfg.n_heads_padded,
                                        cfg.n_kv_heads_padded),
                          dtype=torch.long, device=k.device)
    return k.index_select(2, idx)


def self_attention(p: Dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                   layer_window: Optional[int], layer_chunk: Optional[int],
                   cache: Optional[Dict] = None, mode: str = "prefill",
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """mode: 'prefill' (write a fresh cache; ``cache`` may be None for a
    cache-less forward) | 'decode' (one token against the cache).

    Attention runs in the kernels' (B, H, S, hd) layout through
    ``kernels/ops.py``: transposed views in, no copies. A GQA map that is
    not the uniform divide has no kernel: on CUDA it raises, on the CPU the
    kv heads are expanded and the plain version runs with group 1.
    """
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"attention mode {mode!r}: paged/chunk modes arrive with the "
            "paged KV pool (ROADMAP Queue 1, Paged engine)")
    q, k, v = _qkv(p, cfg, x, positions)
    uniform = uniform_gqa_group(cfg) is not None
    if not uniform and q.device.type == "cuda":
        raise NotImplementedError(
            f"{cfg.name}: non-uniform GQA head map has no CUDA kernel")
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        decode_write_cache(cache, k, v)
        ck, cv = cache["k"], cache["v"]
        if not uniform:
            ck, cv = _expand_kv(cfg, ck), _expand_kv(cfg, cv)
        # (B, Hkv, W, hd) views of the (B, W, Hkv, hd) cache: the decode
        # kernel reads through the strides, the cache is never copied
        out = KOPS.decode_attention(
            q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2),
            positions[:, 0], cache["pos_ids"],
            window=layer_window, chunk=layer_chunk)[:, None]  # (B,1,Hq,hd)
    else:
        if cache is not None:
            prefill_write_cache(cache, k, v, positions)
        kk, vv = (k, v) if uniform else (_expand_kv(cfg, k), _expand_kv(cfg, v))
        out = KOPS.flash_attention(
            q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            positions, positions, window=layer_window,
            chunk=layer_chunk).transpose(1, 2)             # (B,S,Hq,hd)
    flat = out.reshape(out.shape[:-2] + (-1,))
    return flat @ p["wo"], cache
