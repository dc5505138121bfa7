"""Per-layer blocks (the port of ``repro.models.blocks``) for the kinds the
port serves: ``dense`` (pre-norm self-attention + SwiGLU MLP on a
sequential residual), ``parallel`` (StableLM-2: attention with qk-norm and
the MLP side by side on one pre-norm, added together), ``moe`` (the
``dense`` block with the mixture-of-experts FFN of ``models/moe.py`` in
place of the SwiGLU; serving launches no aux loss), ``mla`` and
``mla_moe`` (DeepSeek-V3: the ``dense`` and ``moe`` blocks with MLA's
latent attention in place of self-attention), ``mamba2`` (the
Mamba2 SSD block), ``shared`` (Zamba2's weight-shared attention + MLP
block on concat(h, embedding)) and ``rwkv6`` (RWKV6 time-mix +
channel-mix, attention-free)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM

PORTED_KINDS = ("dense", "parallel", "moe", "mla", "mla_moe", "mamba2",
                "shared", "rwkv6")


@dataclasses.dataclass
class LayerCtx:
    cfg: Any
    mode: str                           # prefill | decode | chunk
    positions: torch.Tensor             # (B, S) int32 absolute positions
    mask: Optional[torch.Tensor] = None      # (B, S) 1 = real token
    emb_orig: Optional[torch.Tensor] = None  # Zamba2 concat input
    layer_idx: int = 0                  # absolute depth (chunk alternation)
    page_tbl: Optional[torch.Tensor] = None  # (B, max_pages) paged-KV table


def _require_ported(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP Queue 1, "
            "Other model families)")


def _layer_window_chunk(cfg, layer_idx: int):
    window = cfg.sliding_window
    chunk = cfg.attn_chunk if cfg.layer_uses_chunked_attn(layer_idx) else None
    return window, chunk


def block_init(gen, cfg, kind: str, device) -> Dict:
    _require_ported(kind)
    dt = L.dtype_of(cfg)
    d = cfg.d_model
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


def block_cache_init(cfg, kind: str, batch: int, max_len: int, device,
                     layer_idx: int = 0) -> Dict:
    _require_ported(kind)
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
    return A.init_kv_cache(cfg, batch, max_len, device)


def _res(cfg, delta):
    """The block's residual delta, scaled where the config says so."""
    if cfg.residual_scale != 1.0:
        delta = delta * torch.tensor(cfg.residual_scale, dtype=delta.dtype,
                                     device=delta.device)
    return delta


def block_apply(p: Dict, cfg, kind: str, ctx: LayerCtx, x: torch.Tensor,
                cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One whole block: returns (x, cache) with its residual add done; the
    cache is updated in place."""
    x, delta = block_apply_pending(p, cfg, kind, ctx, x, None, cache)
    return (x if delta is None else x + delta), cache


def block_apply_pending(p: Dict, cfg, kind: str, ctx: LayerCtx,
                        x: torch.Tensor, delta: Optional[torch.Tensor],
                        cache: Optional[Dict]
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block on the residual stream x + delta, the add still pending
    (``delta`` None: none): the block's first norm performs it, and the
    block returns (x, delta) with its own last add pending, for the next
    norm to perform. On the card each norm and the add before it are one
    kernel launch. The cache is updated in place."""
    _require_ported(kind)
    if kind == "mamba2":
        x, h = L.residual_rmsnorm(p["ln1"], x, delta, cfg.norm_eps)
        y = SSM.mamba2_block(p["ssm"], cfg, h, cache, ctx.mode, ctx.mask)
        return x, _res(cfg, y)
    if kind == "rwkv6":
        if delta is not None:
            x = x + delta
        return RWKV.rwkv_block(p, cfg, x, cache, ctx.mode), None
    window, chunk = _layer_window_chunk(cfg, ctx.layer_idx)
    cat = None
    if kind == "shared":
        # the residual stream and the embedding output side by side; the
        # block's attention takes no chunked-local variant
        cat, chunk = ctx.emb_orig, None
    x, h = L.residual_rmsnorm(p["ln1"], x, delta, cfg.norm_eps, cat)
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
        h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x, _res(cfg, a + L.swiglu(p["mlp"], h2))
    x, h2 = L.residual_rmsnorm(p["ln2"], x, _res(cfg, a), cfg.norm_eps, cat)
    if kind in ("moe", "mla_moe"):
        f, _ = MOE.moe_apply(p["moe"], cfg, h2)    # no aux when serving
        return x, _res(cfg, f)
    return x, _res(cfg, L.swiglu(p["mlp"], h2))
