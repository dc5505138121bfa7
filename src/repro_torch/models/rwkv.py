"""RWKV6 ("Finch") block (the port of ``repro.models.rwkv``): time-mix with
data-dependent decay, then channel-mix.

The WKV6 recurrence runs through ``kernels.ops.wkv6``: the plain version
(a loop over T) for a CPU tensor, the hand-written CUDA kernel on a CUDA
one, in every prefill and decode step. The decay ``w = exp(-exp(wlog))``
is computed and passed in float32 (about 0.9975 at the initial ``w0 =
-6``, which bf16 would round to 0.996 or 1.0); r, k and v stay in
``cfg.dtype``. The float32 parameters (the ``mix_*`` and LoRA leaves,
``w0``, ``u``, ``cmix_*``) stay float32, and the mixing math runs in
float32 where the reference's does.

State per layer: ``{"att_shift": (B, d), "ffn_shift": (B, d)`` in
``cfg.dtype``, ``"wkv": (B, H, hd, hd)`` float32, ``"length": (B,)``
int32}``, written in place. The shifts are the last row of the block's
normalized input (``ln1(x)``, ``ln2(x)``), as in the reference.

Copied from the reference as it is, though the published RWKV6 differs:
``ln_x`` is one LayerNorm over the whole d (not a per-head group norm),
``channel_mix`` reads its weights from the layer's ``tmix`` dict, and
there is no ``ln0`` after the embedding (the model's ``final_norm`` is
an RMSNorm).

Under a sharding context the reference's four sites stand where its own
do (r's heads, the channel mix's hidden d_ff, both residual deltas), the
WKV6 kernel runs on each rank's rows and heads (``sharding.api.local_op``;
the state leaf advanced on its shards), and the LayerNorms on local rows.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KOPS
from repro_torch.models import layers as L
from repro_torch.sharding import api as SH
from repro_torch.sharding.api import shard


def rwkv_init(gen, cfg, device) -> Dict:
    r = cfg.rwkv
    dt = L.dtype_of(cfg)
    d = cfg.d_model
    H = d // r.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # time-mix
        "mix_x": torch.full((d,), 0.5, **f32),
        "mix_base": torch.full((5, d), 0.5, **f32),
        "mix_lora_A": L.normal(gen, (d, 5 * r.mix_lora), 0.01,
                               torch.float32, device),
        "mix_lora_B": L.normal(gen, (5, r.mix_lora, d), 0.01, torch.float32,
                               device),
        "w0": torch.full((d,), -6.0, **f32),        # slow decay default
        "w_lora_A": L.normal(gen, (d, r.decay_lora), 0.01, torch.float32,
                             device),
        "w_lora_B": L.normal(gen, (r.decay_lora, d), 0.01, torch.float32,
                             device),
        "wr": L.dense_init(gen, d, d, dt, device),
        "wk": L.dense_init(gen, d, d, dt, device),
        "wv": L.dense_init(gen, d, d, dt, device),
        "wg": L.dense_init(gen, d, d, dt, device),
        "u": L.normal(gen, (H, r.head_dim), 0.5, torch.float32, device),
        "ln_x": L.layernorm_init(d, dt, device),   # over the whole d
        "wo": L.dense_init(gen, d, d, dt, device),
        # channel-mix
        "cmix_k": torch.full((d,), 0.5, **f32),
        "cmix_r": torch.full((d,), 0.5, **f32),
        "cwk": L.dense_init(gen, d, cfg.d_ff, dt, device),
        "cwv": L.dense_init(gen, cfg.d_ff, d, dt, device),
        "cwr": L.dense_init(gen, d, d, dt, device),
    }


def init_rwkv_state(cfg, batch: int, device) -> Dict:
    r = cfg.rwkv
    d = cfg.d_model
    H = d // r.head_dim
    dt = L.dtype_of(cfg)
    return {
        "att_shift": torch.zeros((batch, d), dtype=dt, device=device),
        "ffn_shift": torch.zeros((batch, d), dtype=dt, device=device),
        "wkv": torch.zeros((batch, H, r.head_dim, r.head_dim),
                           dtype=torch.float32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """xprev[t] = x[t-1]; the first step takes the carried ``prev``."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p: Dict, x: torch.Tensor, xprev: torch.Tensor):
    """Data-dependent token-shift interpolation (5 targets r, k, v, w, g),
    in float32, each target returned in ``x.dtype``."""
    dxp = (xprev - x).float()
    xf = x.float()
    base = xf + dxp * p["mix_x"]
    # the five targets' LoRA rows whole before the split into them (under
    # a mesh the product's columns may be split, 5 * r over the model axis)
    lo = SH.place(torch.tanh(base @ p["mix_lora_A"]), ("batch", "seq", None))
    lo = lo.reshape(*lo.shape[:2], 5, -1)
    delta = torch.einsum("btim,imd->btid", lo, p["mix_lora_B"])
    mixed = xf[:, :, None, :] + dxp[:, :, None, :] * (p["mix_base"] + delta)
    return [mixed[:, :, i].to(x.dtype) for i in range(5)]


def wkv6_scan(r, k, v, w, u, state0: torch.Tensor,
              s_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence on the model's layout. r, k, v: (B,T,H,hd); w:
    (B,T,H,hd) decay in (0, 1), float32; u: (H,hd); state0: (B,H,hd,hd)
    float32. ``ops.wkv6`` reads transposed (B,H,T,hd) views, nothing is
    copied; ``s_out`` receives the final state (it may be ``state0``).
    Returns out (B,T,H,hd) float32 and the final state."""
    out, S = KOPS.wkv6(r.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), w.transpose(1, 2), u, state0,
                       s_out)
    return out.transpose(1, 2), S


def time_mix(p: Dict, cfg, x: torch.Tensor, state: Optional[Dict]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, new att_shift). With a ``state`` its ``wkv`` leaf is
    advanced in place."""
    r_cfg = cfg.rwkv
    d = cfg.d_model
    H, hd = d // r_cfg.head_dim, r_cfg.head_dim
    B, T, _ = x.shape
    prev = state["att_shift"] if state is not None else None
    xprev = _token_shift(x, prev)
    xr, xk, xv, xw, xg = _ddlerp(p, x, xprev)

    r = (xr @ p["wr"]).reshape(B, T, H, hd)
    k = (xk @ p["wk"]).reshape(B, T, H, hd)
    v = (xv @ p["wv"]).reshape(B, T, H, hd)
    g = xg @ p["wg"]
    # data-dependent decay (the Finch contribution), float32 throughout
    wlog = p["w0"] + torch.tanh(xw.float() @ p["w_lora_A"]) @ p["w_lora_B"]
    w = torch.exp(-torch.exp(wlog)).reshape(B, T, H, hd)

    r = shard(r, "batch", "seq", "heads", None)
    heads = ("batch", None, "heads", None)
    if state is not None:
        # the state advanced in place (on its shards under a mesh)
        out = SH.local_update(
            lambda st, *a: wkv6_scan(*a, st["wkv"], st["wkv"])[0], state,
            {"wkv": ("batch", "heads", None, None)},
            [heads] * 4 + [("heads", None)], heads, r, k, v, w, p["u"])
    else:
        S = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                        device=x.device)
        out = SH.local_op(lambda *a: wkv6_scan(*a)[0],
                          [heads] * 4 + [("heads", None),
                                         ("batch", "heads", None, None)],
                          heads)(r, k, v, w, p["u"], S)

    out = L.layernorm(p["ln_x"], SH.place(out.reshape(B, T, d).to(x.dtype),
                                          ("batch", "seq", None)),
                      cfg.norm_eps)
    out = out * F.silu(g.float()).to(x.dtype)
    return out @ p["wo"], x[:, -1]


def channel_mix(p: Dict, cfg, x: torch.Tensor, state: Optional[Dict]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, new ffn_shift)."""
    prev = state["ffn_shift"] if state is not None else None
    xprev = _token_shift(x, prev)
    xf, xpf = x.float(), xprev.float()
    xk = (xf + (xpf - xf) * p["cmix_k"]).to(x.dtype)
    xr = (xf + (xpf - xf) * p["cmix_r"]).to(x.dtype)
    kk = xk @ p["cwk"]
    kk = torch.square(F.relu(kk.float())).to(x.dtype)
    kk = shard(kk, "batch", "seq", "d_ff")
    vv = kk @ p["cwv"]
    rr = torch.sigmoid((xr @ p["cwr"]).float())
    return (rr * vv.float()).to(x.dtype), x[:, -1]


def rwkv_block(p: Dict, cfg, x: torch.Tensor, state: Optional[Dict] = None,
               mode: str = "prefill") -> torch.Tensor:
    """Full RWKV6 layer: x + time_mix(ln1(x)); x + channel_mix(ln2(x)).
    ``state`` (when given) is advanced in place by the T tokens of ``x``:
    prefill starts from the state it is given (zeros in a fresh cache),
    decode from the carried one; 'train' is the prefill with no state
    (on the card under grad the WKV6 kernel runs as an
    ``autograd.Function``: ``kernels/autograd.py``).
    Prompts have exact length: there is no mask, as in the reference."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"rwkv6 runs in train, prefill or decode mode, not "
                         f"{mode!r} (recurrent blocks do not chunk)")
    if mode == "train":
        state = None
    h = L.layernorm(p["ln1"], x, cfg.norm_eps)
    att, att_shift = time_mix(p["tmix"], cfg, h, state)
    x = x + shard(att, "batch", "seq", "embed")
    h2 = L.layernorm(p["ln2"], x, cfg.norm_eps)
    ffn, ffn_shift = channel_mix(p["tmix"], cfg, h2, state)
    x = x + shard(ffn, "batch", "seq", "embed")
    if state is not None:
        _store(state, "att_shift", att_shift)
        _store(state, "ffn_shift", ffn_shift)
        state["length"] += x.shape[1]
    return x


def _store(state: Dict, name: str, value: torch.Tensor) -> None:
    """``state[name] = value`` in place; under a mesh the leaf is replaced
    by ``value`` placed by its cache rule."""
    if isinstance(state[name], SH.DTensor):
        from repro_torch.sharding.rules import cache_axes
        state[name] = SH.place(value.to(state[name].dtype),
                               cache_axes(name, value.ndim))
    else:
        state[name].copy_(value)


def rwkv_layer_init(gen, cfg, device) -> Dict:
    dt = L.dtype_of(cfg)
    return {"ln1": L.layernorm_init(cfg.d_model, dt, device),
            "ln2": L.layernorm_init(cfg.d_model, dt, device),
            "tmix": rwkv_init(gen, cfg, device)}
