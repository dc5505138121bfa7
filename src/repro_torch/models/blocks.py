"""Per-layer blocks (the port of ``repro.models.blocks``), every kind of
the reference's ``BLOCK_KINDS``: ``dense`` (pre-norm self-attention +
SwiGLU MLP on a sequential residual), ``parallel`` (StableLM-2: attention
with qk-norm and the MLP side by side on one pre-norm, added together),
``moe`` (the ``dense`` block with the mixture-of-experts FFN of
``models/moe.py`` in place of the SwiGLU; serving launches no aux loss,
training returns it; under a sharding context whose expert axes span
more than one rank, ``models/moe_sharded.py``'s expert-parallel layer),
``mla`` and ``mla_moe`` (DeepSeek-V3: the ``dense`` and ``moe`` blocks
with MLA's latent attention in place of self-attention), ``mamba2`` (the
Mamba2 SSD block), ``shared`` (Zamba2's weight-shared attention + MLP
block on concat(h, embedding)), ``rwkv6`` (RWKV6 time-mix +
channel-mix, attention-free), and the memory-conditioned kinds:
``cross`` (Llama-3.2-Vision: gated cross-attention to the image
embeddings and a gated SwiGLU), ``enc`` (the encoder-decoder's
bidirectional encoder layer) and ``dec`` (its decoder layer:
self-attention, cross-attention to the encoder output, SwiGLU).

Under a sharding context each block first all-gathers its FSDP-sharded
weights (``sharding.api.gather_fsdp``; the expert-parallel MoE weights
excepted), and the reference's ``shard()`` sites of this module pin the
residual stream: its ``_res`` site on each residual delta, here where the
pending delta is consumed (the norm that performs the add, ``_norm3``),
and its ``_norm3`` site on each block norm's output."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import moe_sharded as MOES
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM
from repro_torch.models.config import BLOCK_KINDS
from repro_torch.sharding import api as SH
from repro_torch.sharding.api import shard


@dataclasses.dataclass
class LayerCtx:
    cfg: Any
    mode: str                           # train | prefill | decode | chunk
    positions: torch.Tensor             # (B, S) int32 absolute positions
    mask: Optional[torch.Tensor] = None      # (B, S) 1 = real token
    memory: Optional[torch.Tensor] = None    # image / encoder output (B,M,d)
    emb_orig: Optional[torch.Tensor] = None  # Zamba2 concat input
    layer_idx: int = 0                  # absolute depth (chunk alternation)
    page_tbl: Optional[torch.Tensor] = None  # (B, max_pages) paged-KV table
    moe_groups: int = 1                 # MoE capacity groups (moe.moe_apply)


def _layer_window_chunk(cfg, layer_idx: int):
    window = cfg.sliding_window
    chunk = cfg.attn_chunk if cfg.layer_uses_chunked_attn(layer_idx) else None
    return window, chunk


def _check_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def block_init(gen, cfg, kind: str, device) -> Dict:
    _check_kind(kind)
    dt = L.dtype_of(cfg)
    d = cfg.d_model
    if kind == "cross":
        return {"ln1": L.rmsnorm_init(d, dt, device),
                "attn": A.cross_attn_init(gen, cfg, device, gated=True),
                "ln2": L.rmsnorm_init(d, dt, device),
                "mlp": L.swiglu_init(gen, d, cfg.d_ff, dt, device),
                "gate_mlp": torch.zeros((), dtype=dt, device=device)}
    if kind == "dec":
        return {"ln1": L.rmsnorm_init(d, dt, device),
                "attn": A.attn_init(gen, cfg, device),
                "ln_x": L.rmsnorm_init(d, dt, device),
                "xattn": A.cross_attn_init(gen, cfg, device, gated=False),
                "ln2": L.rmsnorm_init(d, dt, device),
                "mlp": L.swiglu_init(gen, d, cfg.d_ff, dt, device)}
    if kind == "mamba2":
        return {"ln1": L.rmsnorm_init(d, dt, device),
                "ssm": SSM.ssm_init(gen, cfg, device)}
    if kind == "rwkv6":
        return RWKV.rwkv_layer_init(gen, cfg, device)
    if kind == "shared":
        # Zamba2 weight-shared block on concat(h, emb): width 2d
        return {"ln1": L.rmsnorm_init(2 * d, dt, device),
                "attn": A.attn_init(gen, cfg, device, d_in=2 * d),
                "ln2": L.rmsnorm_init(2 * d, dt, device),
                "mlp": {"w_gate": L.dense_init(gen, 2 * d, cfg.d_ff, dt,
                                               device),
                        "w_up": L.dense_init(gen, 2 * d, cfg.d_ff, dt, device),
                        "w_down": L.dense_init(gen, cfg.d_ff, d, dt, device)}}
    attn = (A.mla_init(gen, cfg, device) if kind in ("mla", "mla_moe")
            else A.attn_init(gen, cfg, device, qk_norm=(kind == "parallel")))
    p = {"ln1": L.rmsnorm_init(d, dt, device), "attn": attn,
         "ln2": L.rmsnorm_init(d, dt, device)}
    if kind in ("moe", "mla_moe"):
        p["moe"] = MOE.moe_init(gen, cfg, device)
    else:
        p["mlp"] = L.swiglu_init(gen, d, cfg.d_ff, dt, device)
    return p


def _memory_kv(cfg, batch: int, M: int, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Zero cross-attention keys and values, (B, M, Hkv, hd) each."""
    shape = (batch, M, cfg.n_kv_heads_padded, cfg.head_dim_)
    return (torch.zeros(shape, dtype=L.dtype_of(cfg), device=device),
            torch.zeros(shape, dtype=L.dtype_of(cfg), device=device))


def block_cache_init(cfg, kind: str, batch: int, max_len: int, device,
                     layer_idx: int = 0) -> Optional[Dict]:
    """A layer's decode state. The memory-conditioned kinds: ``cross``
    keeps the memory's ``{"k", "v"}``, a ``dec`` layer its self-attention
    KV cache plus the memory's ``xk`` and ``xv``, zero here, over the
    reference's M (``n_image_tokens``, else ``encoder_seq``); an ``enc``
    layer keeps nothing (``None``): it runs once a prefill, over the
    memory."""
    _check_kind(kind)
    if kind == "enc":
        return None
    if kind == "cross":
        k, v = _memory_kv(cfg, batch, cfg.n_image_tokens or cfg.encoder_seq,
                          device)
        return {"k": k, "v": v}
    if kind == "mamba2":
        return SSM.init_ssm_state(cfg, batch, device)
    if kind == "rwkv6":
        return RWKV.init_rwkv_state(cfg, batch, device)
    if cfg.layer_uses_chunked_attn(layer_idx):
        # chunked local attention only ever attends within the current
        # chunk: a ring of `attn_chunk` slots suffices
        max_len = min(max_len, cfg.attn_chunk)
    if kind in ("mla", "mla_moe"):
        return A.init_mla_cache(cfg, batch, max_len, device)
    cache = A.init_kv_cache(cfg, batch, max_len, device)
    if kind == "dec":
        cache["xk"], cache["xv"] = _memory_kv(cfg, batch, cfg.encoder_seq,
                                              device)
    return cache


def _res(cfg, delta):
    """The block's residual delta, scaled where the config says so."""
    if cfg.residual_scale != 1.0:
        # a fill, not ``torch.tensor``: a copy from the host cannot be
        # captured in the decode step's CUDA graph
        delta = delta * torch.full((), cfg.residual_scale, dtype=delta.dtype,
                                   device=delta.device)
    return delta


def res_site(delta: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The reference's ``_res`` site on a (B, S, d) residual delta."""
    if delta is not None and delta.ndim == 3:
        delta = shard(delta, "batch", "seq", "embed")
    return delta


def _norm3(p: Dict, x: torch.Tensor, delta: Optional[torch.Tensor],
           eps: float, cat: Optional[torch.Tensor] = None):
    """``L.residual_rmsnorm`` between the reference's sites: ``_res`` on
    the pending delta it adds, ``_norm3`` on the normalised rows."""
    x, h = L.residual_rmsnorm(p, x, res_site(delta), eps, cat)
    if h.ndim == 3:
        h = shard(h, "batch", "seq", "embed")
    return x, h


def block_apply(p: Dict, cfg, kind: str, ctx: LayerCtx, x: torch.Tensor,
                cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One whole block: returns (x, cache) with its residual add done; the
    cache is updated in place."""
    x, delta, _ = block_apply_pending(p, cfg, kind, ctx, x, None, cache)
    return (x if delta is None else x + res_site(delta)), cache


def block_apply_pending(p: Dict, cfg, kind: str, ctx: LayerCtx,
                        x: torch.Tensor, delta: Optional[torch.Tensor],
                        cache: Optional[Dict]
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """One block on the residual stream x + delta, the add still pending
    (``delta`` None: none): the block's first norm performs it, and the
    block returns (x, delta, aux) with its own last add pending, for the
    next norm to perform. On the card each norm and the add before it are
    one kernel launch. The cache is updated in place. ``aux`` is the MoE
    FFN's aux-loss dict (``moe.moe_aux``) of a ``moe`` / ``mla_moe`` block
    in train mode, else empty."""
    _check_kind(kind)
    p = SH.gather_fsdp(p, skip=("moe",))
    if kind in ("cross", "enc", "dec"):
        return (*_memory_block(p, cfg, kind, ctx, x, delta, cache), {})
    if kind == "mamba2":
        x, h = _norm3(p["ln1"], x, delta, cfg.norm_eps)
        y = SSM.mamba2_block(p["ssm"], cfg, h, cache, ctx.mode, ctx.mask)
        return x, _res(cfg, y), {}
    if kind == "rwkv6":
        if delta is not None:
            x = x + delta
        return RWKV.rwkv_block(p, cfg, x, cache, ctx.mode), None, {}
    window, chunk = _layer_window_chunk(cfg, ctx.layer_idx)
    cat = None
    if kind == "shared":
        # the residual stream and the embedding output side by side; the
        # block's attention takes no chunked-local variant
        cat, chunk = ctx.emb_orig, None
    x, h = _norm3(p["ln1"], x, delta, cfg.norm_eps, cat)
    if kind in ("mla", "mla_moe"):
        a, cache = A.mla_attention(p["attn"], cfg, h, ctx.positions, window,
                                   cache, ctx.mode)
    else:
        a, cache = A.self_attention(p["attn"], cfg, h, ctx.positions, window,
                                    chunk, cache, ctx.mode,
                                    page_tbl=ctx.page_tbl)
    if kind == "parallel":
        # the MLP reads the same x; the reference adds x + (a + f), a + f
        # first, so the next norm's pending add forms the same value
        h2 = shard(L.rmsnorm(p["ln2"], x, cfg.norm_eps), "batch", "seq",
                   "embed")
        return x, _res(cfg, a + L.swiglu(p["mlp"], h2)), {}
    x, h2 = _norm3(p["ln2"], x, _res(cfg, a), cfg.norm_eps, cat)
    if kind in ("moe", "mla_moe"):
        if MOES.use_sharded_moe(cfg):
            # expert-parallel over the context's mesh (the reference's
            # ``_moe_dispatch``)
            f, aux = MOES.moe_ffn_sharded(p["moe"], cfg, h2)
            return x, _res(cfg, f), (aux if ctx.mode == "train" else {})
        pm = SH.gather_fsdp(p["moe"])
        if ctx.mode == "train":
            f, aux = MOE.moe_ffn(pm, cfg, h2)
            return x, _res(cfg, f), aux
        f, _ = MOE.moe_apply(pm, cfg, h2, ctx.moe_groups)   # no aux
        return x, _res(cfg, f), {}
    return x, _res(cfg, L.swiglu(p["mlp"], h2, sites=kind != "shared")), {}


def _memory_kv_of(p: Dict, cfg, ctx: LayerCtx, cache: Optional[Dict],
                  names: Tuple[str, str]) -> Dict:
    """The cross-attention keys and values a layer reads: built from the
    memory in prefill (and train) when one is given, and then stored in
    ``cache`` under ``names``; else the cache's (decode, or a prefill without
    memory: the zeros of ``block_cache_init``, as in the reference).

    Form of these leaves: where the port writes every other cache in
    place, the memory's keys and values REPLACE the leaves of the layer's
    cache dict whole, as the reference replaces its cross cache: the dict
    is the one the caller holds, its ``k``/``v`` (``xk``/``xv``) tensors
    are new, and their M is the memory's, which may differ from the M
    ``block_cache_init`` allocated."""
    if ctx.mode in ("train", "prefill") and ctx.memory is not None:
        built = A.build_cross_cache(p, cfg, ctx.memory)
        if cache is not None:
            cache[names[0]], cache[names[1]] = built["k"], built["v"]
        return built
    if cache is None:
        raise ValueError("cross-attention needs the memory (extras) or a "
                         "cache holding its keys and values")
    return {"k": cache[names[0]], "v": cache[names[1]]}


def _memory_block(p: Dict, cfg, kind: str, ctx: LayerCtx, x: torch.Tensor,
                  delta: Optional[torch.Tensor], cache: Optional[Dict]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``cross``, ``enc`` and ``dec`` blocks, each norm performing the
    add pending before it, as ``block_apply_pending``.

    * ``cross``: ln1, gated cross-attention to the memory, ln2, SwiGLU
      times tanh(``gate_mlp``) (float32, cast);
    * ``enc``: ln1, bidirectional self-attention (rope at the positions,
      ``ctx.mask`` the frames' mask: ``NEG_INF`` on masked keys), ln2,
      SwiGLU; no cache;
    * ``dec``: ln1, causal self-attention through ``self_attention`` (the
      kernels on the card), ``ln_x``, unmasked cross-attention to the
      encoder output (``xk``/``xv``), ln2, SwiGLU."""
    eps = cfg.norm_eps
    x, h = _norm3(p["ln1"], x, delta, eps)
    if kind == "cross":
        mem = _memory_kv_of(p["attn"], cfg, ctx, cache, ("k", "v"))
        a = A.cross_attention(p["attn"], cfg, h, mem)
        x, h2 = _norm3(p["ln2"], x, _res(cfg, a), eps)
        f = L.swiglu(p["mlp"], h2)
        f = f * torch.tanh(p["gate_mlp"].float()).to(f.dtype)
        return x, _res(cfg, f)
    if kind == "enc":
        a = A.encoder_attention(p["attn"], cfg, h, ctx.positions, ctx.mask)
    else:
        window, _ = _layer_window_chunk(cfg, ctx.layer_idx)
        # the self-attention reads and writes k, v, pos_ids and length of
        # the layer's cache, in place; xk and xv ride beside them
        a, _ = A.self_attention(p["attn"], cfg, h, ctx.positions, window,
                                None, cache, ctx.mode, page_tbl=ctx.page_tbl)
        x, hx = _norm3(p["ln_x"], x, _res(cfg, a), eps)
        mem = _memory_kv_of(p["xattn"], cfg, ctx, cache, ("xk", "xv"))
        a = A.cross_attention(p["xattn"], cfg, hx, mem)
    x, h2 = _norm3(p["ln2"], x, _res(cfg, a), eps)
    return x, _res(cfg, L.swiglu(p["mlp"], h2))
