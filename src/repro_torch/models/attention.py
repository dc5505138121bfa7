"""Dense / GQA self-attention, the contiguous KV cache, DeepSeek's MLA
(multi-head latent attention) with its latent cache, and cross-attention
to a memory (the VLM's image embeddings, the encoder-decoder's encoder
output): the port of ``repro.models.attention``.

* Head padding: configs whose head counts do not divide the sharding pad
  (``cfg.*_padded``) get zero wq columns / wo rows for padded q heads and
  duplicated kv heads, exactly as the reference initialises them; the
  static q-head -> kv-head map keeps GQA exact. Where that map is not the
  uniform divide only because of the padded q heads (MiniCPM: 36 heads
  padded to 48, the padded ones on kv head 0), the card runs the kernels
  with the divide of the padded counts (``kernel_head_group``): a padded
  head's output meets zero rows of wo whichever kv head it reads, so the
  block's output is the same. Where the kv heads are duplicated and the
  real q heads read copies of their original kv head in turn (Llama-4
  Maverick: 40 / 8 heads padded to 48 / 16, map ``[0 1 0 1 0 3 2 3 ...]``),
  the card runs the kernels over the real q heads against one copy of
  each original kv head: the strided view ``k[:, :, ::dup]``, no copy.
  ``model.check_head_padding`` holds a parameter tree to those zero rows
  and equal copies, once, where parameters are made.
* Fully masked query rows (a right-padded prompt's pad queries): the
  plain version gives them the mean of V over the key range (every score
  is the finite ``NEG_INF``), the CUDA kernels 0. Row-local blocks never
  read them; a ``moe`` block routes them and they take expert capacity,
  so on a model with one the card's rows get the plain version's value
  after the kernel (``_fill_dead_rows``) wherever the forward's token
  count can drop a token (``moe.can_drop``; elsewhere no row's value can
  change another's).
* KV cache per layer: ``{"k","v": (B, W, Hkv, hd), "pos_ids": (B, W)
  int32, "length": (B,) int32}``, W = min(max_len, sliding_window). A
  ring buffer: ``pos_ids`` (-1 = empty) drives every mask. Keys are stored
  rotated. The reference rebuilds the cache functionally each step; here
  every write goes into the cache tensors in place.
* Paged KV pool leaf group (the allocator lives in ``serving/paged.py``):
  ``{"k_pages","v_pages": (Hkv, P+1, ps, hd), "pos_ids": (B, W) LOGICAL
  (-1 empty), "length": (B,)}``, head-major so every append and gather is
  one flat-row index. The last page is a TRASH page: writes of slots with
  no mapped page land there and unmapped logical pages read from there,
  always masked because the logical ``pos_ids`` entry is -1. PyTorch has
  no ``mode="drop"`` scatter, so every write the reference drops goes to
  the trash page (pool rows) or to a scratch column (``pos_ids``) here;
  nothing raises and nothing wraps. All layout ops write in place.
* Attention itself goes through ``kernels/ops.py``: the plain PyTorch
  version for a CPU tensor, the hand-written CUDA kernel for a CUDA one.
  MLA's attention and cross-attention are plain PyTorch on every
  device, as the reference computes them outside any Pallas kernel (the
  MLA and cross-attention sections below).
* Under a mesh (the model's DTensor program) the reference's ``shard()``
  sites stand where its own do, the cache writes and the kernels run on
  each rank's rows and heads (``sharding.api.local_op``), and no paged
  pool runs (the comment above ``_kv_group``).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as KOPS
from repro_torch.kernels import ref as KREF
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.sharding import api as SH
from repro_torch.sharding.api import shard


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


def uniform_gqa_group(cfg, real_only: bool = False) -> Optional[int]:
    """Group size when the q->kv map is the uniform divide of the padded
    head counts (the kernels' GQA layout); None otherwise. ``real_only``
    holds only the real q heads to the divide: padded q heads, whose wo
    rows are zero, may read another kv head (MiniCPM-2B: 36 / 36 heads
    padded to 48 / 48, the padded ones on kv head 0, group 1)."""
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    n_qp, n_kvp = cfg.n_heads_padded, cfg.n_kv_heads_padded
    if n_qp % n_kvp:
        return None
    idx = _kv_index_map(n_q, n_kv, n_qp, n_kvp)
    gp = n_qp // n_kvp
    n = n_q if real_only else n_qp
    if np.array_equal(idx[:n], np.arange(n) // gp):
        return gp
    return None


def duplicated_kv_layout(cfg) -> Optional[Tuple[int, int, int]]:
    """(group, dup, n_heads) when the kv heads are duplicated ``dup`` > 1
    times (consecutive copies, as ``attn_init`` makes them) and real q
    head i reads a copy of original kv head ``i // group``: the kernels
    then run the real q heads at that group against copy 0 of each
    original kv head, the view ``k[:, :, ::dup]``. None otherwise."""
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    n_qp, n_kvp = cfg.n_heads_padded, cfg.n_kv_heads_padded
    if n_kvp % n_kv or n_kvp == n_kv or n_q % n_kv:
        return None
    dup, group = n_kvp // n_kv, n_q // n_kv
    idx = _kv_index_map(n_q, n_kv, n_qp, n_kvp)
    if all(idx[i] // dup == i // group for i in range(n_q)):
        return group, dup, n_q
    return None


@functools.lru_cache(maxsize=None)
def kernel_head_group(cfg, device_type: str
                      ) -> Optional[Tuple[int, int, int]]:
    """The kernels' head layout ``(group, kv_step, n_q)`` for ``cfg`` on a
    device of ``device_type``, worked out once a config: the kernels run q
    heads ``:n_q`` at GQA ``group`` against the kv heads ``::kv_step``.

    On the card: the uniform divide of the padded heads, ``(gp, 1,
    n_qp)``; the divide the real heads follow, the padded ones reading
    any kv head (MiniCPM), ``(gp, 1, n_qp)``; or duplicated kv heads
    (``duplicated_kv_layout``, Llama-4 Maverick), ``(group, dup, n_q)``.
    Each is exact given ``model.check_head_padding``; a map none covers
    raises. On the CPU the uniform divide, else None, and the kv heads are
    expanded through the reference's map (its semantics)."""
    n_qp = cfg.n_heads_padded
    if device_type != "cuda":
        group = uniform_gqa_group(cfg)
        return None if group is None else (group, 1, n_qp)
    group = uniform_gqa_group(cfg, real_only=True)
    if group is not None:
        return group, 1, n_qp
    layout = duplicated_kv_layout(cfg)
    if layout is None:
        raise ValueError(f"{cfg.name}: the GQA map of its real heads is "
                         "neither a divide of the padded heads nor a group "
                         "a copy of each kv head; no kernel takes it")
    return layout


def attn_init(gen, cfg, device, d_in: Optional[int] = None,
              qk_norm: bool = False) -> Dict:
    """``d_in`` overrides the input width (the Zamba2 shared block takes
    concat(h, emb), 2 * d_model wide). ``qk_norm`` adds the RMSNorm scales
    ``q_norm`` and ``k_norm`` over the head dim, shared by all heads
    (StableLM-2's ``parallel`` block)."""
    dt = L.dtype_of(cfg)
    d = d_in if d_in is not None else cfg.d_model
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
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, dt, device)
        p["k_norm"] = L.rmsnorm_init(hd, dt, device)
    return p


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
                        pos_ids: torch.Tensor,
                        names: Tuple[str, str] = ("k", "v")) -> Dict:
    """Write a full prompt (possibly longer than the ring) into a fresh
    cache, in place: k and v (B, S, ...) into the leaves ``names`` (MLA's
    ``("ckv", "k_rope")``).

    For token j the ring slot is j % W; when S > W only the last W tokens
    survive — a deterministic gather of the latest token landing in each
    slot, as in the reference.
    """
    S = k.shape[1]
    ck, cv = cache[names[0]], cache[names[1]]
    W = ck.shape[1]
    if S <= W:
        ck[:, :S] = k
        cv[:, :S] = v
        cache["pos_ids"][:, :S] = pos_ids
    else:
        s = torch.arange(W, device=k.device)
        j = s + W * torch.div(S - 1 - s, W, rounding_mode="floor")
        ck.copy_(k[:, j])
        cv.copy_(v[:, j])
        cache["pos_ids"].copy_(pos_ids[:, j])
    cache["length"].copy_(pos_ids.max(dim=1).values + 1)
    return cache


def decode_write_cache(cache: Dict, k1: torch.Tensor, v1: torch.Tensor,
                       names: Tuple[str, str] = ("k", "v")) -> Dict:
    """Append one token per sequence in place. k1/v1: (B, 1, ...) into the
    leaves ``names``, at each sequence's ring slot ``length % W``."""
    B = k1.shape[0]
    W = cache[names[0]].shape[1]
    slot = torch.remainder(cache["length"], W).long()
    bidx = torch.arange(B, device=k1.device)
    cache[names[0]][bidx, slot] = k1[:, 0]
    cache[names[1]][bidx, slot] = v1[:, 0]
    cache["pos_ids"][bidx, slot] = cache["length"]
    cache["length"] += 1
    return cache


# --------------------------------------------------------------------------
# paged KV pool: layout ops
# --------------------------------------------------------------------------


def _flat_rows(pages: torch.Tensor):
    """(Hkv, P+1, ps, hd) -> ((Hkv, (P+1)*ps, hd) view, ps, trash page)."""
    H, P1, ps, hd = pages.shape
    return pages.view(H, P1 * ps, hd), ps, P1 - 1


def _assert_private_rows(rows: torch.Tensor, trash: int, ps: int) -> None:
    """Several writes of one call may land on the trash page (its winner
    is undefined on CUDA, and it is always masked), never on one row of a
    real page. Checked where it costs no device sync: on the CPU."""
    if rows.device.type != "cpu":
        return
    r = rows.reshape(-1)
    real = r[(r < trash * ps) | (r >= (trash + 1) * ps)]
    if real.unique().numel() != real.numel():
        raise AssertionError("two writes of one call hit one pool row "
                             "outside the trash page")


def _last_writes(rows: torch.Tensor, trash: int, ps: int) -> torch.Tensor:
    """(N,) for the N flat pool ``rows`` of one call's writes: the write
    whose value each one stores. A real page's row has one write, its own;
    the writes that share a row of the trash page all store the last
    one's value, as a sequential write (the reference's) leaves that row,
    whatever order the device commits them in (an index write with
    repeated rows keeps an unspecified one, on the CPU too). A ``moe``
    model's dead query rows average the trash page, so its contents must
    not depend on that order."""
    idx = torch.arange(rows.shape[0], device=rows.device)
    local = rows - trash * ps
    hit = (local >= 0) & (local < ps)
    at = torch.where(hit, local, torch.zeros_like(local))
    last = torch.full((ps,), -1, dtype=idx.dtype, device=rows.device)
    last.scatter_reduce_(0, at, torch.where(hit, idx, -1), "amax")
    return torch.where(hit, last[at], idx)


def paged_decode_write(cache: Dict, tbl: torch.Tensor, k1: torch.Tensor,
                       v1: torch.Tensor, ordered: bool = False) -> Dict:
    """Append one token per slot through the (B, max_pages) block table,
    in place. k1/v1: (B, 1, Hkv, hd). A slot whose page is unmapped, or
    whose cursor is past the table, writes into the trash page; with
    ``ordered``, writes sharing a trash row store the last one's value
    (``_last_writes``)."""
    t = cache["length"]
    kf, ps, trash = _flat_rows(cache["k_pages"])
    vf, _, _ = _flat_rows(cache["v_pages"])
    B, M = tbl.shape
    W = cache["pos_ids"].shape[1]
    bidx = torch.arange(B, device=t.device)
    lp = torch.div(t, ps, rounding_mode="floor")
    pg = tbl[bidx, lp.clamp(0, M - 1).long()]
    pg = torch.where((pg < 0) | (lp >= M), torch.full_like(pg, trash), pg)
    rows = (pg * ps + torch.remainder(t, ps)).long()   # physical flat rows
    _assert_private_rows(rows, trash, ps)
    k1, v1 = k1[:, 0].transpose(0, 1), v1[:, 0].transpose(0, 1)
    if ordered:
        sel = _last_writes(rows, trash, ps)
        k1, v1 = k1.index_select(1, sel), v1.index_select(1, sel)
    kf[:, rows] = k1.to(kf.dtype)
    vf[:, rows] = v1.to(vf.dtype)
    cache["pos_ids"][bidx, t.clamp(0, W - 1).long()] = t
    cache["length"] += 1
    return cache


def paged_chunk_write(cache: Dict, tbl: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, positions: torch.Tensor,
                      ordered: bool = False) -> Dict:
    """Append one prompt chunk per slot through the block table, in place.

    k/v: (B, S, Hkv, hd); positions: (B, S) LOGICAL (-1 = pad). The pages
    covering the chunk must already be mapped (``alloc_chunk_pages``). Pad
    tokens and rows past the table land in the trash page, and ``pos_ids``
    is written only at valid positions (the others go to a scratch column
    that is cut off), so pads never unmask. ``ordered``: as
    ``paged_decode_write``'s."""
    t = positions
    kf, ps, trash = _flat_rows(cache["k_pages"])
    vf, _, _ = _flat_rows(cache["v_pages"])
    B, S = t.shape
    M = tbl.shape[1]
    W = cache["pos_ids"].shape[1]
    bidx = torch.arange(B, device=t.device)[:, None]
    valid = t >= 0
    lp = torch.where(valid, torch.div(t, ps, rounding_mode="floor"),
                     torch.full_like(t, M))            # pads -> out of range
    pg = tbl[bidx, lp.clamp(0, M - 1).long()]
    pg = torch.where(valid & (lp < M) & (pg >= 0), pg,
                     torch.full_like(pg, trash))
    rows = (pg * ps + torch.where(valid, torch.remainder(t, ps),
                                  torch.zeros_like(t))).long()   # (B, S)
    _assert_private_rows(rows, trash, ps)
    H = kf.shape[0]
    rows = rows.reshape(-1)
    k = k.permute(2, 0, 1, 3).reshape(H, B * S, -1)
    v = v.permute(2, 0, 1, 3).reshape(H, B * S, -1)
    if ordered:
        sel = _last_writes(rows, trash, ps)
        k, v = k.index_select(1, sel), v.index_select(1, sel)
    kf[:, rows] = k.to(kf.dtype)
    vf[:, rows] = v.to(vf.dtype)
    col = torch.where(valid, t.clamp(0, W - 1), torch.full_like(t, W))
    pos = cache["pos_ids"]
    ext = torch.cat([pos, pos.new_zeros((B, 1))], dim=1)   # column W: scratch
    ext.scatter_(1, col.long(), t)
    pos.copy_(ext[:, :W])
    cache["length"] += valid.sum(dim=1).to(torch.int32)
    return cache


def copy_page_rows(pages: torch.Tensor, src_pg: torch.Tensor,
                   dst_pg: torch.Tensor) -> torch.Tensor:
    """Copy whole pages ``src_pg[i] -> dst_pg[i]`` inside one pool leaf,
    in place — the data half of copy-on-write. pages: (Hkv, P+1, ps, hd);
    src_pg/dst_pg: (n,) physical ids, dst < 0 = skip (the reference drops
    that write; here it goes to the trash page). The sources are gathered
    into a copy before the scatter, so a page copied onto a page that is
    itself a source of this call is read before it is overwritten."""
    P1 = pages.shape[1]
    trash = P1 - 1
    src = pages.index_select(1, src_pg.clamp(0, P1 - 1).long())   # a copy
    dst = torch.where(dst_pg < 0, torch.full_like(dst_pg, trash),
                      dst_pg).long()
    ps = pages.shape[2]
    _assert_private_rows(dst * ps, trash, ps)
    pages[:, dst] = src
    return pages


def gather_pages_hb(pages: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Head-major logical view (Hkv, B, W, hd) of a page pool: one
    page-granular gather (a copy)."""
    return KREF.logical_view(pages, tbl).transpose(0, 1)


def gather_pages(pages: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Logical (B, W, Hkv, hd) cache view of a page pool — the layout of
    the contiguous cache leaf, for reference and equality checks."""
    return KREF.logical_view(pages, tbl).transpose(1, 2)


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
    if "q_norm" in p:
        # qk-norm before RoPE, one norm launch each on the card over the
        # (B*S*H, hd) rows
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rotary_pct, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rotary_pct, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


@functools.lru_cache(maxsize=None)
def _kv_index(cfg, device: str) -> torch.Tensor:
    """The reference's q-head -> kv-head map as a long tensor on
    ``device``, made once a config and device: a copy to the card waits
    for it, so it is never made in a step."""
    return torch.as_tensor(
        _kv_index_map(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads_padded,
                      cfg.n_kv_heads_padded), dtype=torch.long, device=device)


def _expand_kv(cfg, k):
    """k (B, S, Hkv, hd) -> (B, S, Hq, hd) through the reference's map;
    under a mesh on the local rows, the kv heads whole (the result's
    heads replicated, for the site after it to split)."""
    return SH.local_op(
        lambda k: k.index_select(2, _kv_index(cfg, str(k.device))),
        [("batch", "kv_seq", None, None)], ("batch", "kv_seq", None, None))(k)


# -- the attention proper on local shards ------------------------------------
#
# Under a mesh the kernels run through ``sharding.api.local_op`` on each
# rank's heads and rows. The rule for heads that the model axis does not
# divide (``sharding.api.fit_spec``): such heads are replicated over it.
# When the q heads are split and the kv heads are not (Llama-3.2-1B's 2 kv
# heads over a model axis of 4), each rank slices the kv heads its q heads
# read (``_kv_group``), so the kernel's GQA group comes from the local head
# counts and no rank holds zero heads. The sequence is whole inside a
# kernel (flash, decode and the scans are causal or recurrent): a
# sequence split by the rule (``LONG_CONTEXT_RULES``) is all-gathered
# before the kernel, as GSPMD gathers it; a split-KV combine across ranks
# is not ported.


def _kv_group(kk, vv, n_q_local: int, q0: int, group: int):
    """The kv heads (dim 1 of (B, Hkv, S, hd)) that q heads q0 ..
    q0 + n_q_local - 1 read at GQA ``group``, where the kv heads are whole
    and the q heads split; as they are where the counts already agree."""
    if kk.shape[1] * group == n_q_local:
        return kk, vv
    lo, hi = q0 // group, (q0 + n_q_local - 1) // group + 1
    if n_q_local % (hi - lo):
        raise ValueError(f"{n_q_local} local q heads from {q0} do not "
                         f"split evenly over kv heads {lo}..{hi - 1}")
    return kk[:, lo:hi], vv[:, lo:hi]


def _prefill_local(cfg, direct: bool, step: int, group: int, q0: int,
                   fill: bool, window, chunk, q, k, v, positions):
    """Prefill / train attention on one rank's rows and heads: q (B, S,
    Hq, hd), k / v (B, S, Hkv, hd) -> (B, S, Hq, hd_v)."""
    if direct:
        kk, vv = k[:, :, ::step], v[:, :, ::step]
    else:
        kk = k.index_select(2, _kv_index(cfg, str(k.device)))
        vv = v.index_select(2, _kv_index(cfg, str(v.device)))
        kk, vv = kk[:, :, q0:q0 + q.shape[2]], vv[:, :, q0:q0 + q.shape[2]]
    kk, vv = _kv_group(kk.transpose(1, 2), vv.transpose(1, 2), q.shape[2],
                       q0, group if direct else 1)
    out = KOPS.flash_attention(q.transpose(1, 2), kk, vv, positions,
                               positions, window=window,
                               chunk=chunk).transpose(1, 2)   # (B,S,Hq,hd)
    if fill:
        # a real query sees its own key: only pad queries see none
        out = _fill_dead_rows(out, vv, positions < 0)
    return out


def _decode_local(direct: bool, step: int, group: int, q0: int, fill: bool,
                  window, chunk, q, ck, cv, q_pos, k_pos):
    """Contiguous-cache decode on one rank's rows and heads: q (B, Hq,
    hd), ck / cv (B, W, Hkv, hd) views of the cache (or the expanded
    (B, W, Hq, hd)) -> (B, Hq, hd_v)."""
    if direct:
        ck, cv = ck[:, :, ::step], cv[:, :, ::step]
    # (B, Hkv, W, hd) views of the (B, W, Hkv, hd) cache: the decode
    # kernel reads through the strides, the cache is never copied
    ck, cv = _kv_group(ck.transpose(1, 2), cv.transpose(1, 2), q.shape[1],
                       q0, group if direct else 1)
    out = KOPS.decode_attention(q, ck, cv, q_pos, k_pos, window=window,
                                chunk=chunk)                  # (B,Hq,hd)
    if fill:
        dead = ~KREF.attention_mask(q_pos[:, None], k_pos, window,
                                    chunk).any(-1)
        out = _fill_dead_rows(out, cv, dead)
    return out


# a contiguous cache's leaves, the kv heads split where the rule splits
# them and the ring whole (its writes index the whole ring)
_KV_LEAVES = {"k": ("batch", None, "kv_heads", None),
              "v": ("batch", None, "kv_heads", None),
              "pos_ids": ("batch", None), "length": ("batch",)}
_LATENT_LEAVES = {"ckv": ("batch", None, None),
                  "k_rope": ("batch", None, None),
                  "pos_ids": ("batch", None), "length": ("batch",)}


def write_cache(write, cache: Dict, leaves: Dict, kv: Tuple, kv_axes: Tuple,
                *rest) -> Dict:
    """``write(cache, *kv, *rest)`` in place; under a mesh on the local
    shards of the cache leaves named in ``leaves`` (their axes), the new
    keys and values placed by ``kv_axes``, the positions (``rest``) by
    rows (``sharding.api.local_update``)."""
    def run(c, *a):
        write(c, *a)

    SH.local_update(run, cache, leaves,
                    list(kv_axes) + [("batch", None)] * len(rest), None,
                    *kv, *rest)
    return cache


def _fill_dead_rows(out: torch.Tensor, v: torch.Tensor,
                    dead: torch.Tensor) -> torch.Tensor:
    """The plain version's value in the query rows that see no key: the
    mean of V over the key range, in float32 (a uniform softmax over the
    finite ``NEG_INF`` scores). out: (B, S, Hq, hd) with ``dead`` (B, S),
    or (B, Hq, hd) with ``dead`` (B,); v: (B, Hkv, Sk, hd), the kernel's
    operand. One where over the output, no host sync."""
    mean = v.mean(dim=2, dtype=torch.float32)                 # (B, Hkv, hd)
    mean = mean.repeat_interleave(out.shape[-2] // v.shape[1], dim=1)
    mean = mean.reshape((mean.shape[0],) + (1,) * (out.dim() - 3)
                        + mean.shape[1:])
    return torch.where(dead.reshape(dead.shape + (1, 1)),
                       mean.to(out.dtype), out)


def _fill_dead_rows_paged(out: torch.Tensor, v_pages: torch.Tensor,
                          page_tbl: torch.Tensor,
                          dead: torch.Tensor) -> torch.Tensor:
    """``_fill_dead_rows`` over a paged pool: the mean of V over each
    slot's logical view, the (Hkv, P+1, ps, hd) pool ``v_pages`` (the
    kernels' operand, kv heads ``::kv_step`` included) gathered through
    its (B, M) table, -1 read as the trash page, as the plain versions
    score it. A gather and a where on the device, no host sync (a decode
    graph captures it)."""
    return _fill_dead_rows(out, KREF.logical_view(v_pages, page_tbl), dead)


def self_attention(p: Dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                   layer_window: Optional[int], layer_chunk: Optional[int],
                   cache: Optional[Dict] = None, mode: str = "prefill",
                   page_tbl: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """mode: 'prefill' (write a fresh cache; ``cache`` may be None for a
    cache-less forward) | 'train' (the cache-less prefill: every position,
    no cache read or written) | 'decode' (one token against the cache) |
    'chunk' (an S-token prompt chunk appended to a paged cache).

    A decode cache is either the contiguous per-slot layout or a paged
    leaf group (``k_pages`` present), read through ``page_tbl``. Chunk
    mode is paged decode widened to S queries: the chunk's keys are
    written first, then its queries score the slot's whole logical
    history, and ``k_pos <= q_pos`` gives causality inside the chunk.

    Attention runs in the kernels' (B, H, S, hd) layout through
    ``kernels/ops.py``: transposed views in, no copies. The heads are read
    through ``kernel_head_group``'s layout: q heads ``:n_q`` against kv
    heads ``::kv_step`` (strided views), the output's heads meeting wo's
    first ``n_q`` head rows (the rest are zero); where it is None (the
    CPU, a map that is not the uniform divide; in 'train' mode on any
    device) the kv heads are expanded (a paged pool gathered first) and
    the kernel or the plain version runs with group 1.
    A paged pool keeps the reference's (Hkv_padded, P+1, ps, hd) shape;
    the paged kernels read its kv heads ``::kv_step`` through the head
    stride, as the contiguous kernels read the cache's.
    On the card, a model with a ``moe`` block gets the plain version's
    value in every fully masked query row (``_fill_dead_rows``, over a
    paged slot's gathered logical view ``_fill_dead_rows_paged``) where
    the forward can drop a token: where ``moe.can_drop`` holds for its
    tokens, and on a paged pool always (a fleet, whose shards each route
    against their own expert capacity, is always paged). A ``moe`` model's paged writes are ``ordered`` on every
    device, so the trash page such a row averages is the reference's.
    """
    if mode not in ("train", "prefill", "decode", "chunk"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if mode == "train":
        cache = None
    q, k, v = _qkv(p, cfg, x, positions)
    # direct: the kernels read the heads through the layout. Training takes
    # the reference's map on every device: the card's layout for padded
    # heads (a padded q head over another kv head, or not run) changes no
    # output, their wo rows being zero, but it changes those rows' gradient
    layout = kernel_head_group(cfg, "cpu" if mode == "train"
                               else q.device.type)
    direct = layout is not None
    step = layout[1] if direct else 1
    if direct and layout[2] < q.shape[2]:
        q = q[:, :, :layout[2]]
    moe_on_card = cfg.moe is not None and q.device.type == "cuda"
    paged = cache is not None and "k_pages" in cache
    # a dead row matters where it can take a real token's expert slot (B*S
    # tokens in this forward's moe calls), and on a paged pool always: its
    # keys and values at the next layer land in the trash page, which
    # later dead rows average
    fill = moe_on_card and (paged or MOE.can_drop(
        cfg, x.shape[0] * x.shape[1]))
    # a moe model's writes sharing a trash row store the last one's value
    # on every device (an index write with repeated rows keeps an
    # unspecified one, on the CPU too): the trash page its dead rows
    # average is then the reference's
    ordered = cfg.moe is not None
    if mode in ("decode", "chunk"):
        if cache is None:
            raise ValueError(f"{mode} needs a cache")
        if paged and page_tbl is None:
            raise ValueError("a paged cache needs page_tbl")
        if mode == "chunk" and not paged:
            raise ValueError("chunked prefill needs a paged cache")
    mesh = isinstance(q, SH.DTensor)       # the model's DTensor program
    if mesh and paged:
        raise NotImplementedError(
            "no paged pool runs under a mesh: the reference's fleet runs "
            "its shards without a sharding context")
    group = layout[0] if direct else 1
    q0 = SH.shard_offset("heads", q.shape[2]) if mesh else 0
    if paged and direct:
        # the kernels' kv heads: the pool's ::kv_step, a strided view
        kp, vp = cache["k_pages"][::step], cache["v_pages"][::step]
    if mode == "chunk":
        paged_chunk_write(cache, page_tbl, k, v, positions, ordered)
        if direct:
            out = KOPS.chunked_prefill_attention(
                q.transpose(1, 2), kp, vp, page_tbl, positions,
                cache["pos_ids"], window=layer_window,
                chunk=layer_chunk).transpose(1, 2)       # (B,S,Hq,hd)
            if fill:
                # a real query sees its own key, written first: only pad
                # queries see none
                out = _fill_dead_rows_paged(out, vp, page_tbl, positions < 0)
        else:
            kk = _expand_kv(cfg, gather_pages(cache["k_pages"], page_tbl))
            vv = _expand_kv(cfg, gather_pages(cache["v_pages"], page_tbl))
            out = KOPS.flash_attention(
                q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
                positions, cache["pos_ids"], window=layer_window,
                chunk=layer_chunk).transpose(1, 2)
    elif mode == "decode" and paged:
        paged_decode_write(cache, page_tbl, k, v, ordered)
        if direct:
            out = KOPS.paged_decode_attention(
                q[:, 0], kp, vp, page_tbl, positions[:, 0],
                cache["pos_ids"], window=layer_window,
                chunk=layer_chunk)                        # (B,Hq,hd)
            if fill:
                dead = ~KREF.attention_mask(
                    positions[:, :1], cache["pos_ids"], layer_window,
                    layer_chunk).any(-1)
                out = _fill_dead_rows_paged(out, vp, page_tbl, dead)
            out = out[:, None]                            # (B,1,Hq,hd)
        else:
            kk = _expand_kv(cfg, gather_pages(cache["k_pages"], page_tbl))
            vv = _expand_kv(cfg, gather_pages(cache["v_pages"], page_tbl))
            out = KOPS.decode_attention(
                q[:, 0], kk.transpose(1, 2), vv.transpose(1, 2),
                positions[:, 0], cache["pos_ids"], window=layer_window,
                chunk=layer_chunk)[:, None]
    elif mode == "decode":
        write_cache(decode_write_cache, cache, _KV_LEAVES, (k, v),
                    (("batch", None, "kv_heads", None),) * 2)
        if direct:
            ck = shard(cache["k"], "batch", "kv_seq", "kv_heads", None)
            cv = shard(cache["v"], "batch", "kv_seq", "kv_heads", None)
            kv_ax = ("batch", None, "kv_heads", None)
        else:
            ck = shard(_expand_kv(cfg, cache["k"]), "batch", "kv_seq",
                       "heads", None)
            cv = shard(_expand_kv(cfg, cache["v"]), "batch", "kv_seq",
                       "heads", None)
            kv_ax = ("batch", None, "heads", None)
        out = SH.local_op(
            functools.partial(_decode_local, direct, step, group, q0, fill,
                              layer_window, layer_chunk),
            [("batch", "heads", None), kv_ax, kv_ax, ("batch",),
             ("batch", None)], ("batch", "heads", None))(
                q[:, 0], ck, cv, positions[:, 0], cache["pos_ids"])
        out = out[:, None]                                   # (B,1,Hq,hd)
    else:
        if cache is not None:
            write_cache(prefill_write_cache, cache, _KV_LEAVES, (k, v),
                        (("batch", None, "kv_heads", None),) * 2, positions)
        kv_ax = (("batch", None, "kv_heads", None) if direct
                 else ("batch", None, None, None))
        out = SH.local_op(
            functools.partial(_prefill_local, cfg, direct, step, group, q0,
                              fill, layer_window, layer_chunk),
            [("batch", None, "heads", None), kv_ax, kv_ax, ("batch", None)],
            ("batch", None, "heads", None))(q, k, v, positions)
    out = shard(out, "batch", "seq", "heads", None)
    flat = out.reshape(out.shape[:-2] + (-1,))
    wo = p["wo"]
    if flat.shape[-1] < wo.shape[0]:
        wo = wo[:flat.shape[-1]]
    return flat @ wo, cache


# --------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# --------------------------------------------------------------------------
#
# The reference computes MLA outside any Pallas kernel: the prefill's
# attention is its jnp ``attention_core`` (direct below
# ``DIRECT_ATTN_MAX_SEQ`` keys, the two-level running-softmax scan above,
# or the scan with the latent expansion fused into each kv chunk under
# ``cfg.mla_fused_prefill``), the decode the absorbed einsums over the
# latent cache. So here all of it is plain PyTorch on every device, with
# the reference's masking: an additive ``NEG_INF`` bias, pad keys at
# position -1, the scan's denominator clamped at 1e-30. Its norms
# (``q_norm``, and ``kv_norm`` over ``dkv[..., :kv_lora_rank]`` read at
# the row stride kv_lora_rank + rope, no copy) go through the RMSNorm
# kernel on the card.

NEG_INF = KREF.NEG_INF
DIRECT_ATTN_MAX_SEQ = 2048     # above this many keys, the two-level scan
Q_CHUNK = 512
KV_CHUNK = 1024


def mla_init(gen, cfg, device) -> Dict:
    """The reference's MLA parameters; padded heads (``n_heads`` ..
    ``n_heads_padded``) get zero columns of w_uq, w_uk and w_uv and zero
    rows of wo, so the padded model's output is the unpadded one's."""
    m = cfg.mla
    dt = L.dtype_of(cfg)
    d = cfg.d_model
    H, nH = cfg.n_heads_padded, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    p = {
        "w_dq": L.dense_init(gen, d, m.q_lora_rank, dt, device),
        "q_norm": L.rmsnorm_init(m.q_lora_rank, dt, device),
        "w_uq": L.dense_init(gen, m.q_lora_rank, H * qk_head, dt, device),
        "w_dkv": L.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                              dt, device),
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, dt, device),
        "w_uk": L.dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                             dt, device),
        "w_uv": L.dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, dt,
                             device),
        "wo": L.dense_init(gen, H * m.v_head_dim, d, dt, device),
    }
    if H > nH:
        p["w_uq"][:, nH * qk_head:] = 0
        p["w_uk"][:, nH * m.qk_nope_head_dim:] = 0
        p["w_uv"][:, nH * m.v_head_dim:] = 0
        p["wo"][nH * m.v_head_dim:, :] = 0
    return p


def init_mla_cache(cfg, batch: int, max_len: int, device) -> Dict:
    """The latent cache: ``ckv`` (B, W, kv_lora_rank) and the shared rope
    key ``k_rope`` (B, W, rope), with the ring's ``pos_ids`` and
    ``length``; W = ``cache_width``."""
    dt = L.dtype_of(cfg)
    m = cfg.mla
    W = cache_width(cfg, max_len)
    return {
        "ckv": torch.zeros((batch, W, m.kv_lora_rank), dtype=dt,
                           device=device),
        "k_rope": torch.zeros((batch, W, m.qk_rope_head_dim), dtype=dt,
                              device=device),
        "pos_ids": torch.full((batch, W), -1, dtype=torch.int32,
                              device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
          chunk: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) float32 additive bias: 0 where the key is seen,
    ``NEG_INF`` elsewhere (k_pos -1: an empty or pad key)."""
    ok = KREF.attention_mask(q_pos[..., :, None], k_pos[..., None, :],
                             window, chunk)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _direct_attention(q, k, v, bias):
    """q: (B,Sq,H,hd), k: (B,Sk,H,hd), v: (B,Sk,H,hd_v), bias:
    (B,1|H,Sq,Sk) -> (B,Sq,H,hd_v). Scores in the input type, then scaled
    and masked in float32; the softmax's weights in the input type. Under
    a mesh on each rank's rows and heads (``sharding.api.local_op``), as
    the kernels run."""
    heads = ("batch", None, "heads", None)
    return SH.local_op(_direct_local, [heads] * 3 + [(
        "batch", "heads" if bias.shape[1] > 1 else None, None, None)],
        heads)(q, k, v, bias)


def _direct_local(q, k, v, bias):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale + bias
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _pad_seq(x: torch.Tensor, n: int, value=0) -> torch.Tensor:
    """x padded along dim 1 to length n with ``value``."""
    if x.shape[1] == n:
        return x
    pad = x.new_full((x.shape[0], n - x.shape[1]) + x.shape[2:], value)
    return torch.cat([x, pad], dim=1)


def _blkshard(t: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """The reference's ``blkshard`` site on (B, n*c, H, hd) as its
    (n, B, c, H, hd) blocks; back in (B, n*c, H, hd)."""
    blocks = t.reshape((t.shape[0], n, c) + t.shape[2:]).movedim(1, 0)
    blocks = shard(blocks, None, "batch", None, "heads", None)
    return blocks.movedim(0, 1).reshape(t.shape)


def _scan(qs, ks, q_pos, k_pos, window, chunk, scores, values, hd_v,
          dtype, pinned: bool = False):
    """The reference's two-level running-softmax scan: queries in blocks
    of ``Q_CHUNK``, keys in blocks of ``KV_CHUNK`` (pad queries at
    position 0 are cut off, pad keys at -1 are masked). ``qs`` are (B,Sq,
    ...) query tensors and ``ks`` (B,Sk,...) key-side tensors; a block's
    float32 scores (B,H,Qc,Kc), already scaled, are ``scores(q blocks, k
    blocks)`` and its values (B,Kc,H,hd_v) ``values(k blocks)``. Returns
    (B,Sq,H,hd_v) in ``dtype``. ``pinned``: the reference's sites of its
    ``_flash_attention`` (the blocks, the carries, each block's scores and
    accumulator, the output)."""
    B, Sq = qs[0].shape[:2]
    Sk = ks[0].shape[1]
    H = qs[0].shape[2]
    nq, nk = -(-Sq // Q_CHUNK), -(-Sk // KV_CHUNK)
    qs = [_pad_seq(t, nq * Q_CHUNK) for t in qs]
    ks = [_pad_seq(t, nk * KV_CHUNK) for t in ks]
    if pinned:
        qs = [_blkshard(t, nq, Q_CHUNK) for t in qs]
        ks = [_blkshard(t, nk, KV_CHUNK) for t in ks]
    qpos = _pad_seq(q_pos, nq * Q_CHUNK, 0)
    kpos = _pad_seq(k_pos, nk * KV_CHUNK, -1)
    dev = qs[0].device
    pin = shard if pinned else (lambda t, *axes: t)

    def built(t):                  # a carry or a mask every rank builds
        return SH.replicated_like(t, qs[0])
    out = []
    for i in range(nq):
        qsl = slice(i * Q_CHUNK, (i + 1) * Q_CHUNK)
        qb = [t[:, qsl] for t in qs]
        m = pin(built(torch.full((B, H, Q_CHUNK), -math.inf, device=dev)),
                "batch", "heads", None)
        den = pin(built(torch.zeros((B, H, Q_CHUNK), device=dev)),
                  "batch", "heads", None)
        acc = pin(built(torch.zeros((B, H, Q_CHUNK, hd_v), device=dev)),
                  "batch", "heads", None, None)
        for j in range(nk):
            ksl = slice(j * KV_CHUNK, (j + 1) * KV_CHUNK)
            kb = [t[:, ksl] for t in ks]
            s = pin(scores(qb, kb), "batch", "heads", None, None)
            s = s + built(_bias(qpos[:, qsl], kpos[:, ksl], window,
                                chunk)[:, None])
            m_new = torch.maximum(m, s.amax(dim=-1))
            pw = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + pw.sum(dim=-1)
            vb = values(kb)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pw.to(vb.dtype), vb).float()
            acc = pin(acc, "batch", "heads", None, None)
            m = m_new
        o = acc / torch.clamp(den, min=1e-30)[..., None]
        out.append(o.transpose(1, 2).to(dtype))            # (B,Qc,H,hd_v)
    return pin(torch.cat(out, dim=1)[:, :Sq], "batch", "seq", "heads", None)


def _flash_attention(q, k, v, q_pos, k_pos, window, chunk):
    """The scan over materialised q, k (B,S,H,hd) and v (B,Sk,H,hd_v);
    hd may differ from hd_v (MLA: 192 against 128)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _scan(
        [q], [k, v], q_pos, k_pos, window, chunk,
        lambda qb, kb: torch.einsum("bqhd,bkhd->bhqk", qb[0],
                                    kb[0]).float() * scale,
        lambda kb: kb[1], v.shape[-1], q.dtype, pinned=True)


def attention_core(q, k, v, q_pos, k_pos, window=None, chunk=None):
    """Direct attention up to ``DIRECT_ATTN_MAX_SEQ`` keys, the scan above
    (the same math), as the reference dispatches."""
    if k.shape[1] <= DIRECT_ATTN_MAX_SEQ:
        bias = _bias(q_pos, k_pos, window, chunk)[:, None]
        return _direct_attention(q, k, v, bias)
    return _flash_attention(q, k, v, q_pos, k_pos, window, chunk)


def _mla_qkv_latent(p, cfg, x, positions):
    """Per-head q (nope, rope) and the latent key parts: ``q_norm`` on the
    low-rank q, ``kv_norm`` on the latent ``dkv[..., :kv_lora_rank]``
    (a strided view), and one rope key a token shared by every head."""
    m = cfg.mla
    H = cfg.n_heads_padded
    cq = L.rmsnorm(p["q_norm"], x @ p["w_dq"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(
        x.shape[:-1] + (H, m.qk_nope_head_dim + m.qk_rope_head_dim))
    q = shard(q, "batch", "seq", "heads", None)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = L.apply_rope(q_rope, positions, 1.0, cfg.rope_theta)
    dkv = x @ p["w_dkv"]
    ckv = L.rmsnorm(p["kv_norm"], dkv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = L.apply_rope(dkv[..., None, m.kv_lora_rank:], positions, 1.0,
                          cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_flash_fused(q_nope, q_rope, ckv, k_rope, w_uk, w_uv, q_pos, k_pos,
                     window, scale):
    """The scan with the latent -> per-head expansion done in each kv
    block, never forming (B, Sk, H, nope + rope) keys. q_nope: (B,Sq,H,n);
    q_rope: (B,Sq,H,r); ckv: (B,Sk,kvr); k_rope: (B,Sk,r); w_uk: (kvr,H,n);
    w_uv: (kvr,H,v)."""
    def scores(qb, kb):
        k_nope = shard(torch.einsum("bkr,rhn->bkhn", kb[0], w_uk),
                       "batch", "seq", "heads", None)
        return (torch.einsum("bqhn,bkhn->bhqk", qb[0], k_nope)
                + torch.einsum("bqhr,bkr->bhqk", qb[1], kb[1])
                ).float() * scale

    return _scan([q_nope, q_rope], [ckv, k_rope], q_pos, k_pos, window,
                 None, scores,
                 lambda kb: shard(torch.einsum("bkr,rhv->bkhv", kb[0], w_uv),
                                  "batch", "seq", "heads", None),
                 w_uv.shape[-1], q_nope.dtype)


def mla_attention(p: Dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                  layer_window: Optional[int], cache: Optional[Dict] = None,
                  mode: str = "prefill") -> Tuple[torch.Tensor, Optional[Dict]]:
    """mode 'prefill' (the expanded path; writes a fresh latent cache in
    place, ``cache`` None: a cache-less forward) | 'train' (that path with
    no cache) | 'decode' (one token,
    absorbed: ``q_lat = q_nope . w_uk^T`` scored against ``ckv`` plus the
    rope term, ``o_lat . w_uv``). MLA's latent cache is contiguous only
    (the reference's ``supports_paged_decode`` excludes it), so there is
    no chunk mode."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"MLA attention has no mode {mode!r} (its latent "
                         "cache is contiguous, never paged)")
    if mode == "train":
        cache = None
    m = cfg.mla
    H = cfg.n_heads_padded
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, cfg, x, positions)
    w_uk = p["w_uk"].view(m.kv_lora_rank, H, m.qk_nope_head_dim)
    w_uv = p["w_uv"].view(m.kv_lora_rank, H, m.v_head_dim)
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        write_cache(functools.partial(decode_write_cache,
                                      names=("ckv", "k_rope")),
                    cache, _LATENT_LEAVES, (ckv, k_rope),
                    (("batch", None, None),) * 2)
        ckv_all = shard(cache["ckv"], "batch", "kv_seq", None)
        krope_all = shard(cache["k_rope"], "batch", "kv_seq", None)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
        s = (torch.einsum("bqhr,bkr->bhqk", q_lat, ckv_all)
             + torch.einsum("bqhn,bkn->bhqk", q_rope, krope_all)
             ).float() * scale
        s = s + SH.replicated_like(_bias(positions, cache["pos_ids"],
                                         layer_window, None)[:, None], s)
        w = torch.softmax(s, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhqk,bkr->bqhr", w, ckv_all)
        out = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
    else:
        if cache is not None:
            write_cache(functools.partial(prefill_write_cache,
                                          names=("ckv", "k_rope")),
                        cache, _LATENT_LEAVES, (ckv, k_rope),
                        (("batch", None, None),) * 2, positions)
        if cfg.mla_fused_prefill and x.shape[1] > DIRECT_ATTN_MAX_SEQ:
            out = _mla_flash_fused(q_nope, q_rope, ckv, k_rope, w_uk, w_uv,
                                   positions, positions, layer_window, scale)
        else:
            k_nope = shard(torch.einsum("bkr,rhn->bkhn", ckv, w_uk),
                           "batch", "seq", "heads", None)
            vv = shard(torch.einsum("bkr,rhv->bkhv", ckv, w_uv),
                       "batch", "seq", "heads", None)
            kk = shard(torch.cat([k_nope, k_rope[:, :, None, :].expand(
                k_nope.shape[:3] + (m.qk_rope_head_dim,))], dim=-1),
                "batch", "seq", "heads", None)
            qq = shard(torch.cat([q_nope, q_rope], dim=-1),
                       "batch", "seq", "heads", None)
            out = attention_core(qq, kk, vv, positions, positions,
                                 layer_window, None)
    flat = out.reshape(out.shape[:-2] + (-1,))
    return flat @ p["wo"], cache


# --------------------------------------------------------------------------
# Cross-attention (VLM image layers; the encoder-decoder's decoder)
# --------------------------------------------------------------------------
#
# The reference computes it with its jnp ``_direct_attention`` and no
# kernel: every query sees every memory row (no mask, no rope), the kv
# heads expanded through the reference's map. So here too it is plain
# PyTorch on every device.


def encoder_attention(p: Dict, cfg, x: torch.Tensor, positions: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The encoder's bidirectional self-attention (the reference's ``enc``
    block): rope at ``positions``, every query over every key, ``mask``
    (B, S) > 0 marking the keys seen (the frames' mask; None: all), the kv
    heads expanded through the reference's map, then ``wo``."""
    q, k, v = _qkv(p, cfg, x, positions)
    kk, vv = _expand_kv(cfg, k), _expand_kv(cfg, v)
    if mask is None:
        bias = torch.zeros((x.shape[0], 1, 1, kk.shape[1]),
                           dtype=torch.float32, device=x.device)
    else:
        bias = torch.where(mask[:, None, None, :] > 0, 0.0,
                           NEG_INF).to(torch.float32)
    out = _direct_attention(q, kk, vv, bias)
    return out.reshape(out.shape[:-2] + (-1,)) @ p["wo"]


def cross_attn_init(gen, cfg, device, gated: bool = False) -> Dict:
    """``attn_init``'s projections, plus a scalar ``gate`` when gated
    (Llama-3.2-Vision), zero as the reference initialises it: tanh(0)
    multiplies the layer's cross-attention away until the gate is set."""
    p = attn_init(gen, cfg, device)
    if gated:
        p["gate"] = torch.zeros((), dtype=L.dtype_of(cfg), device=device)
    return p


def build_cross_cache(p: Dict, cfg, memory: torch.Tensor) -> Dict:
    """The memory's keys and values, (B, M, n_kv_heads_padded, hd) each,
    with no rope: static for the rest of the sequence."""
    hd, n_kvp = cfg.head_dim_, cfg.n_kv_heads_padded
    return {"k": _split_heads(memory @ p["wk"], n_kvp, hd),
            "v": _split_heads(memory @ p["wv"], n_kvp, hd)}


def cross_attention(p: Dict, cfg, x: torch.Tensor,
                    cross_cache: Dict) -> torch.Tensor:
    """x (B, S, d) attends to every row of ``cross_cache`` (``k``/``v``
    (B, M, Hkv, hd)); the output times tanh(``gate``), computed in
    float32 and cast, where the layer is gated."""
    q = _split_heads(x @ p["wq"], cfg.n_heads_padded, cfg.head_dim_)
    kk = _expand_kv(cfg, cross_cache["k"])
    vv = _expand_kv(cfg, cross_cache["v"])
    # no mask: a zero bias, broadcast over the queries
    bias = torch.zeros((x.shape[0], 1, 1, kk.shape[1]), dtype=torch.float32,
                       device=x.device)
    out = _direct_attention(q, kk, vv, bias)
    y = out.reshape(out.shape[:-2] + (-1,)) @ p["wo"]
    if "gate" in p:
        y = y * torch.tanh(p["gate"].float()).to(y.dtype)
    return y
