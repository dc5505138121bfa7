"""Mamba2 (state-space dual) block (the port of ``repro.models.ssm``):
chunked SSD for prefill, the O(1)-state recurrence for decode.

Prefill runs the SSD through ``kernels.ops.ssd_scan``: the plain version
for a CPU tensor, the hand-written CUDA kernel for the within-chunk part
on a CUDA one. The reference's model calls its jnp ``ssd_chunked`` (fixed
chunk, padded); ``ssd_scan`` takes ``min(chunk, T)`` and pads to that.
Padded steps have dt = 0, so the two compute the same function.

State per layer: ``{"conv": (B, d_conv-1, conv_dim) f32, "state":
(B, H, P, N) f32, "length": (B,) int32}``, written in place.

The prefill conv state is each row's own last ``d_conv-1`` REAL tokens
(zeros before the first), gathered at ``length-1-i``. The reference keeps
the padded tail ``xp[:, -(d_conv-1):]`` (``repro/models/ssm.py``
``_causal_conv``), which for a right-padded row holds pad tokens'
projections, so its decode after a padded prefill starts from a wrong
conv state; here padded prefill equals exact-length prefill.

Under a sharding context the reference's one site (the heads of ``xh``
before the SSD) splits the SSD scan over the model axis
(``sharding.api.local_op``: the kernel on each rank's rows and heads, the
sequence whole). The causal conv, which mixes the channels of x, B and C,
runs on each rank's rows with the channels whole; the decode recurrence
then takes the rank's heads of its inputs (``sharding.api.shard_offset``)
and advances the SSM state on the shard that the cache rule gives it
(``sharding.api.local_update``), so the state never moves.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS
from repro_torch.models import layers as L
from repro_torch.sharding import api as SH
from repro_torch.sharding.api import shard

_STATE = {"conv": ("batch", None, None),
          "state": ("batch", "heads", None, None), "length": ("batch",)}
_ROWS3 = ("batch", None, None)
_REP1 = (None,)


def ssm_init(gen, cfg, device) -> Dict:
    s = cfg.ssm
    dt = L.dtype_of(cfg)
    d = cfg.d_model
    di, H, cd = s.d_inner(d), s.n_heads(d), s.conv_dim(d)
    f32 = dict(dtype=torch.float32, device=device)
    # in_proj -> [z (di), xBC (cd), dt (H)]
    return {
        "in_proj": L.dense_init(gen, d, 2 * di + 2 * s.n_groups * s.state_dim
                                + H, dt, device),
        "conv_w": L.normal(gen, (s.d_conv, cd), 1.0 / math.sqrt(s.d_conv),
                           torch.float32, device),
        "conv_b": torch.zeros((cd,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01, **f32))),
        "gate_norm": L.rmsnorm_init(di, dt, device),
        "out_proj": L.dense_init(gen, di, d, dt, device),
    }


def init_ssm_state(cfg, batch: int, device) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    H, P, N = s.n_heads(d), s.head_dim, s.state_dim
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, s.conv_dim(d)),
                            dtype=torch.float32, device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _causal_conv(s, xbc: torch.Tensor, conv_w, conv_b,
                 conv_state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. xbc: (B, T, cd) f32. Returns
    (silu(conv), xp) with xp the (B, d_conv-1+T, cd) input behind it (the
    conv state, or zeros, then xbc)."""
    dc = s.d_conv
    if conv_state is None:
        conv_state = xbc.new_zeros((xbc.shape[0], dc - 1, xbc.shape[2]))
    xp = torch.cat([conv_state, xbc], dim=1)
    T = xbc.shape[1]
    out = sum(xp[:, i:i + T] * conv_w[i] for i in range(dc)) + conv_b
    return F.silu(out), xp


def _split_proj(s, cfg, zxbcdt):
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.state_dim
    return (zxbcdt[..., :di], zxbcdt[..., di:di + di + 2 * gn],
            zxbcdt[..., di + di + 2 * gn:])


def _split_xbc(s, cfg, xbc):
    di = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.state_dim
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def _heads(s, m: torch.Tensor, H: int) -> torch.Tensor:
    """(B, T, G*N) -> (B, T, H, N): each group broadcast over its H // G
    heads. One group (every configuration here) is a stride-0 view."""
    Bsz, T = m.shape[:2]
    g = m.reshape(Bsz, T, s.n_groups, s.state_dim)
    if s.n_groups == 1:
        return g.expand(Bsz, T, H, s.state_dim)
    return g.repeat_interleave(H // s.n_groups, dim=2)


def _decode(s, cfg, h0: int, state: Dict, zxbcdt, conv_w, conv_b, dt_bias,
            D, A):
    """One decode step of the recurrence on ``state`` (in place), whose
    SSM state holds the heads h0 .. h0 + Hl - 1 (all of them, or a rank's
    share under a mesh): returns (y (B, 1, Hl * P) of those heads, z)."""
    d = cfg.d_model
    H, P = s.n_heads(d), s.head_dim
    Hl = state["state"].shape[1]
    hs = slice(h0, h0 + Hl)
    z, xbc, dt_raw = _split_proj(s, cfg, zxbcdt)
    xbc_a, xp = _causal_conv(s, xbc, conv_w, conv_b, state["conv"])
    xx, Bm, Cm = _split_xbc(s, cfg, xbc_a)
    dt0 = F.softplus(dt_raw + dt_bias)[:, 0, hs]              # (B,Hl)
    xh = xx[:, 0].reshape(-1, H, P)[:, hs]
    Bh = _heads(s, Bm, H)[:, 0, hs]
    Ch = _heads(s, Cm, H)[:, 0, hs]
    decay = torch.exp(dt0 * A[hs])
    h = state["state"] * decay[..., None, None] + \
        xh[..., None] * Bh[:, :, None, :] * dt0[..., None, None]
    y = torch.einsum("bhn,bhpn->bhp", Ch, h) + D[hs, None] * xh
    state["conv"].copy_(xp[:, 1:])
    state["state"].copy_(h)
    state["length"] += 1
    return y.reshape(-1, 1, Hl * P), z


def _scan_inputs(s, cfg, zxbcdt, conv_w, conv_b, dt_bias, mask):
    """The prefill's conv and splits over whole rows: (z, xh (B, T, H, P),
    dt, Bh, Ch (B, T, H, N), xp (the conv's input))."""
    d = cfg.d_model
    H, P = s.n_heads(d), s.head_dim
    z, xbc, dt_raw = _split_proj(s, cfg, zxbcdt)
    if mask is not None:                                   # softplus -> 0
        dt_raw = torch.where(mask[..., None] > 0, dt_raw,
                             torch.full_like(dt_raw, -1e9))
    xbc_a, xp = _causal_conv(s, xbc, conv_w, conv_b, None)
    xx, Bm, Cm = _split_xbc(s, cfg, xbc_a)
    dt = F.softplus(dt_raw + dt_bias)
    Bsz, T = zxbcdt.shape[:2]
    return (z, xx.reshape(Bsz, T, H, P), dt, _heads(s, Bm, H),
            _heads(s, Cm, H), xp)


def _write_prefill(s, state: Dict, xp, h_final, mask):
    """The prefill's state, in place: each row's conv tail of real tokens,
    the SSD state and the length."""
    Bsz, T = xp.shape[0], xp.shape[1] - (s.d_conv - 1)
    length = (mask.sum(dim=1).to(torch.int32) if mask is not None
              else torch.full((Bsz,), T, dtype=torch.int32,
                              device=xp.device))
    # each row's last d_conv-1 real tokens: xp row length + i holds
    # token length - (d_conv-1) + i (the leading zeros before 0)
    idx = length[:, None].long() + torch.arange(
        s.d_conv - 1, device=xp.device)[None]
    state["conv"].copy_(torch.gather(
        xp, 1, idx[..., None].expand(-1, -1, xp.shape[-1])))
    state["state"].copy_(h_final)
    state["length"].copy_(length)


def mamba2_block(p: Dict, cfg, x: torch.Tensor, state: Optional[Dict] = None,
                 mode: str = "prefill",
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, T, d_model); mask: (B, T) 1 = real token (pad steps get dt =
    0, so they leave the SSM state alone). ``state`` is updated in place:
    prefill writes it (when given), decode advances it by one token;
    'train' is the prefill with no state. On the card under grad the SSD
    chunk kernel and the gated norm run as ``autograd.Function``s (the
    kernel forward, a PyTorch backward: ``kernels/autograd.py``)."""
    s = cfg.ssm
    d = cfg.d_model
    di, H, P = s.d_inner(d), s.n_heads(d), s.head_dim
    zxbcdt = (x @ p["in_proj"]).float()
    A = -torch.exp(p["A_log"])
    small = (p["conv_w"], p["conv_b"], p["dt_bias"])

    if mode == "decode":
        if state is None:
            raise ValueError("decode needs a state")
        y, z = SH.local_update(
            functools.partial(_decode, s, cfg, SH.shard_offset("heads", H)),
            state, _STATE, [_ROWS3, (None, None), _REP1, _REP1, _REP1, _REP1],
            (("batch", None, "heads"), _ROWS3), zxbcdt, *small, p["D"], A)
    elif mode in ("train", "prefill"):
        if mode == "train":
            state = None
        z, xh, dt, Bh, Ch, xp = SH.local_op(
            functools.partial(_scan_inputs, s, cfg),
            [_ROWS3, (None, None), _REP1, _REP1, ("batch", None)],
            (_ROWS3, ("batch", None, None, None), _ROWS3,
             ("batch", None, None, None), ("batch", None, None, None),
             _ROWS3))(zxbcdt, *small, mask)
        Bsz, T = x.shape[:2]
        xh = shard(xh, "batch", "seq", "heads", None)
        heads = ("batch", None, "heads", None)
        y, h_final = SH.local_op(
            lambda *a: KOPS.ssd_scan(*a, chunk=s.chunk),
            [heads, ("batch", None, "heads"), ("heads",), heads, heads],
            (heads, ("batch", "heads", None, None)))(xh, dt, A, Bh, Ch)
        y = (y + p["D"][:, None] * xh).reshape(Bsz, T, di)
        if state is not None:
            SH.local_update(functools.partial(_write_prefill, s), state,
                            _STATE, [_ROWS3, ("batch", "heads", None, None),
                                     ("batch", None)], None,
                            xp, h_final, mask)
    else:
        raise ValueError(f"mamba2 runs in train, prefill or decode mode, not "
                         f"{mode!r} (recurrent blocks do not chunk)")

    # gated RMSNorm then out-projection
    y = L.gated_rmsnorm(p["gate_norm"], y, z, cfg.norm_eps, x.dtype)
    return y @ p["out_proj"]
