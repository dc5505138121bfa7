"""Basic layers: norms, RoPE, SwiGLU, embeddings, logits (the port of
``repro.models.layers``).

Params are plain dicts of tensors with the JAX package's key names.
Weights keep the JAX (d_in, d_out) orientation, so every projection is
``x @ w``. Mixed precision follows the reference: activations in
``cfg.dtype``, norm statistics, RoPE angles and the SiLU in float32.

RMSNorm goes through ``kernels.ops``: the plain version on the CPU, the
hand-written kernel on the card, which also forms the row it normalises
(the residual add, Zamba2's concat, Mamba2's gate) in the same launch.
LayerNorm (RWKV6's only) has no kernel in the reference and stays plain
PyTorch.

Under a sharding context the reference's ``shard()`` sites of this module
place the FFN's hidden ``d_ff``, the flattened ``tokens`` tables, the
embedding output and the logits' ``vocab`` (``sharding.api.shard``), and
each RMSNorm form runs on the local rows of its DTensor operands
(``sharding.api.local_op``: the rows as they are placed, the last dim
whole, the scale replicated).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS
from repro_torch.sharding import api as SH
from repro_torch.sharding.api import DTensor, shard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# a draw is made in slices of at most this many elements along its
# leading axis
SLICE_ELEMS = 1 << 26


def normal(gen: Optional[torch.Generator], shape, scale: float, dtype,
           device) -> torch.Tensor:
    """N(0, scale^2) in ``dtype``, drawn in float32 from ``gen`` slice by
    slice along the leading axis into the preallocated result, so the
    draw's peak is the result plus one float32 slice, not twice the tensor
    in float32 (Llama-4 Maverick's (128, 5120, 8192) expert tensors). The
    slices follow each other in one generator, so the draw is
    deterministic; a tensor of one slice gets the numbers of a whole
    draw. On the ``meta`` device (shapes only) nothing is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    step = max(1, SLICE_ELEMS // max(1, math.prod(shape[1:])))
    buf = torch.empty((min(step, shape[0]),) + tuple(shape[1:]),
                      dtype=torch.float32, device=device)
    for i in range(0, shape[0], step):
        part = buf[:min(step, shape[0] - i)]
        torch.randn(part.shape, generator=gen, out=part)
        out[i:i + part.shape[0]].copy_(part.mul_(scale))
    return out


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), s, dtype, device)


# --- norms -----------------------------------------------------------------


def rmsnorm_init(dim: int, dtype, device) -> Dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def on_rows(fn, rows, scale: torch.Tensor, n_out: int = 1, extra=()):
    """``fn(*rows, scale, *extra)``, a norm over the last dim: under a
    mesh on the local rows of the DTensors ``rows`` (each placed as the
    first one's rows, ``sharding.api.row_placements``) with ``scale`` and
    ``extra`` replicated; as it is otherwise."""
    ref = next((t for t in rows if isinstance(t, DTensor)), None)
    if ref is None:
        return fn(*rows, scale, *extra)
    pl = SH.row_placements(ref)
    rep = SH.replicate_all(ref.device_mesh)
    return SH.local_op(fn, [pl] * len(rows) + [rep] * (1 + len(extra)),
                       pl if n_out == 1 else (pl,) * n_out)(
                           *rows, scale, *extra)


def rmsnorm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return on_rows(lambda x, s: KOPS.rmsnorm(x, s, eps), (x,), p["scale"])


def residual_rmsnorm(p: Dict, x: torch.Tensor, delta: Optional[torch.Tensor],
                     eps: float, cat: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pending residual add and the norm that reads it, in one kernel
    launch on the card: returns (x + delta, rmsnorm(x + delta)), or with
    ``cat`` (Zamba2's shared block) (x + delta, rmsnorm(concat([x + delta,
    cat], -1))). ``delta`` None: no add, x returned as it is."""
    scale = p["scale"]
    if cat is not None:
        if delta is None:
            return x, on_rows(lambda x, e, s: KOPS.cat_rmsnorm(x, e, s, eps),
                              (x, cat), scale)
        return on_rows(lambda x, e, d, s: KOPS.cat_rmsnorm(x, e, s, eps, d),
                       (x, cat, delta), scale, 2)
    if delta is None:
        return x, rmsnorm(p, x, eps)
    return on_rows(lambda x, d, s: KOPS.add_rmsnorm(x, d, s, eps),
                   (x, delta), scale, 2)


def gated_rmsnorm(p: Dict, y: torch.Tensor, z: torch.Tensor, eps: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """Mamba2's gated norm, rmsnorm((y * silu(z)).to(dtype)), in one kernel
    launch on the card."""
    return on_rows(lambda y, z, s: KOPS.gated_rmsnorm(y, z, s, eps, dtype),
                   (y, z), p["scale"])


def layernorm_init(dim: int, dtype, device) -> Dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    if isinstance(x, DTensor):          # on the local rows (``on_rows``)
        return on_rows(lambda x, s, b: layernorm({"scale": s, "bias": b},
                                                 x, eps),
                       (x,), p["scale"], extra=(p["bias"],))
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


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
    """x: (..., S, H, hd); positions: broadcastable to (..., S) int32.
    Under a mesh on the local shards of a DTensor x (B, S, H, hd): x as
    it is placed, its head dim whole (a partial sum stays one: the
    rotation is linear), the positions by x's batch and sequence."""
    if isinstance(x, DTensor):
        return _local_rope(x, positions, rotary_pct, theta)
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


def _local_rope(x, positions, rotary_pct: float, theta: float):
    last = x.ndim - 1
    pl = [SH.Replicate() if isinstance(p, SH.Shard) and p.dim in (last, -1)
          else p for p in x.placements]
    pos = [p if isinstance(p, SH.Shard) and p.dim < positions.ndim
           else SH.Replicate() for p in pl]
    return SH.local_op(
        lambda x, q: apply_rope(x, q, rotary_pct, theta), [pl, pos], pl)(
            x, positions)


# --- MLP -------------------------------------------------------------------


def swiglu_init(gen, d_model: int, d_ff: int, dtype, device) -> Dict:
    return {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
            "w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device)}


def swiglu(p: Dict, x: torch.Tensor, sites: bool = True) -> torch.Tensor:
    """The SwiGLU MLP; ``sites`` False: without the reference's sites
    (Zamba2's shared block computes it inline, unpinned)."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    if not sites:
        return h @ p["w_down"]
    if h.ndim == 3:
        h = shard(h, "batch", "seq", "d_ff")
    elif h.ndim == 2:
        h = shard(h, "tokens", "d_ff")
    out = h @ p["w_down"]
    if out.ndim == 2:
        out = shard(out, "tokens", None)
    return out


# --- embeddings / logits ---------------------------------------------------


def embedding_init(gen, cfg, device) -> Dict:
    return {"tok": normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                          dtype_of(cfg), device)}


def embed(p: Dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    # the gather as ``F.embedding``: the same rows, and DTensor's strategy
    # for a vocab-split table (a masked lookup, summed at the site below);
    # under a mesh the tokens are placed by the site's own ("batch", "seq")
    # first, so the masked lookup is summed over the rows that hold it
    # (DTensor cannot reduce it onto a split it was not made on); a plain
    # table (a rank-local program) keeps them as they are
    if isinstance(p["tok"], DTensor):
        tokens = SH.place(SH.replicated(tokens, p["tok"].device_mesh),
                          ("batch", "seq"))
    x = F.embedding(tokens, p["tok"])
    if cfg.scale_emb != 1.0:
        x = x * torch.full((), cfg.scale_emb, dtype=x.dtype, device=x.device)
    return shard(x, "batch", "seq", "embed")


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
    if out.ndim == 3:
        out = shard(out, "batch", "seq", "vocab")
    return out
