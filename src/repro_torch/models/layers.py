"""Basic layers: norms, RoPE, SwiGLU, embeddings, logits (the port of
``repro.models.layers``).

Params are plain dicts of tensors with the JAX package's key names.
Weights keep the JAX (d_in, d_out) orientation, so every projection is
``x @ w``. Mixed precision follows the reference: activations in
``cfg.dtype``, norm statistics, RoPE angles and the SiLU in float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def normal(gen: Optional[torch.Generator], shape, scale: float, dtype,
           device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), s, dtype, device)


# --- norms -----------------------------------------------------------------


def rmsnorm_init(dim: int, dtype, device) -> Dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# --- rotary embeddings -----------------------------------------------------


def rope_frequencies(head_dim: int, rotary_pct: float, theta: float,
                     device) -> Tuple[int, torch.Tensor]:
    """(rotary_dim, inv_freq[rotary_dim/2])."""
    rot = int(head_dim * rotary_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return rot, 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rotary_pct: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S) int32."""
    hd = x.shape[-1]
    rot, inv = rope_frequencies(hd, rotary_pct, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv          # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]                # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    roped = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([roped, xp], dim=-1) if rot < hd else roped


# --- MLP -------------------------------------------------------------------


def swiglu_init(gen, d_model: int, d_ff: int, dtype, device) -> Dict:
    return {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
            "w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device)}


def swiglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


# --- embeddings / logits ---------------------------------------------------


def embedding_init(gen, cfg, device) -> Dict:
    return {"tok": normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                          dtype_of(cfg), device)}


def embed(p: Dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    x = p["tok"][tokens]
    if cfg.scale_emb != 1.0:
        x = x * torch.tensor(cfg.scale_emb, dtype=x.dtype, device=x.device)
    return x


def lm_head_init(gen, cfg, device) -> Dict:
    if cfg.tie_embeddings:
        return {}
    return {"out": dense_init(gen, cfg.d_model, cfg.padded_vocab,
                              dtype_of(cfg), device, scale=0.02)}


def logits(head_p: Dict, embed_p: Dict, cfg, x: torch.Tensor) -> torch.Tensor:
    w = embed_p["tok"].T if cfg.tie_embeddings else head_p["out"]
    out = (x @ w).float()
    if cfg.logit_scale != 1.0:
        out = out * cfg.logit_scale
    return out
