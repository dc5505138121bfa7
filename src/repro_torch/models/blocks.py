"""Per-layer blocks (the port of ``repro.models.blocks``, ``dense`` kind):
pre-norm self-attention + SwiGLU MLP on a sequential residual."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L

PORTED_KINDS = ("dense",)


@dataclasses.dataclass
class LayerCtx:
    cfg: Any
    mode: str                           # prefill | decode
    positions: torch.Tensor             # (B, S) int32 absolute positions
    layer_idx: int = 0                  # absolute depth (chunk alternation)


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
    return {"ln1": L.rmsnorm_init(d, dt, device),
            "attn": A.attn_init(gen, cfg, device),
            "ln2": L.rmsnorm_init(d, dt, device),
            "mlp": L.swiglu_init(gen, d, cfg.d_ff, dt, device)}


def block_cache_init(cfg, kind: str, batch: int, max_len: int, device,
                     layer_idx: int = 0) -> Dict:
    _require_ported(kind)
    if cfg.layer_uses_chunked_attn(layer_idx):
        # chunked local attention only ever attends within the current
        # chunk: a ring of `attn_chunk` slots suffices
        max_len = min(max_len, cfg.attn_chunk)
    return A.init_kv_cache(cfg, batch, max_len, device)


def _res(cfg, x, delta):
    if cfg.residual_scale != 1.0:
        delta = delta * torch.tensor(cfg.residual_scale, dtype=delta.dtype,
                                     device=delta.device)
    return x + delta


def block_apply(p: Dict, cfg, kind: str, ctx: LayerCtx, x: torch.Tensor,
                cache: Optional[Dict]) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (x, cache); the cache is updated in place."""
    _require_ported(kind)
    window, chunk = _layer_window_chunk(cfg, ctx.layer_idx)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, cache = A.self_attention(p["attn"], cfg, h, ctx.positions, window,
                                chunk, cache, ctx.mode)
    x = _res(cfg, x, a)
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return _res(cfg, x, L.swiglu(p["mlp"], h2)), cache
