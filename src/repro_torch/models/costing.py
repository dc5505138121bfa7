"""Analytic parameter accounting (the port of ``repro.models.costing``):
the carbon model's ``LLMWorkload`` view of a config, counted from the
port's own parameter shapes (built on the ``meta`` device, no storage).
The meter's modeled J depends on every field, so each must equal the
reference's."""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.energy import LLMWorkload
from repro_torch.models.model import Model


def named_leaves(tree, path: Tuple[str, ...] = ()):
    """(path of keys, leaf) over a tree of dicts, lists and tuples, in
    order; a sequence index is its str, as the reference's key paths."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, path + (str(i),))
    else:
        yield path, tree


def param_counts(cfg) -> Tuple[float, float]:
    """(total, active-per-token) parameter counts from the real init shapes.
    A weight-shared block is one set of tensors referenced at several
    layers and counts once, as the reference's tree holds it once. The
    routed experts' leaves (``experts_*``) are active at the reference's
    fraction ``top_k / n_experts``; every other parameter is active, an
    encoder-decoder's encoder and a ``cross`` layer's scalar gates
    included."""
    total = 0.0
    expert_total = 0.0
    seen = set()
    for path, leaf in named_leaves(Model(cfg, "meta").param_shapes()):
        if id(leaf) in seen:
            continue
        seen.add(id(leaf))
        n = float(leaf.numel())
        total += n
        if any(k.startswith("experts_") for k in path):
            expert_total += n
    active = total
    if cfg.moe is not None and expert_total:
        frac = min(1.0, cfg.moe.top_k / cfg.moe.n_experts)
        active = total - expert_total * (1.0 - frac)
    return total, active


def model_flops(cfg, tokens: float, training: bool) -> float:
    """6*N_active*D (train) / 2*N_active*D (inference), the reference's
    count."""
    _, active = param_counts(cfg)
    mult = 6.0 if training else 2.0
    return mult * active * tokens


def workload_of(cfg, dtype_bytes: int = 2) -> LLMWorkload:
    """LLMWorkload view of a ModelConfig for the energy/carbon model."""
    total, active = param_counts(cfg)
    hd = cfg.head_dim_
    kv_per_tok = 0.0
    state_bytes = 0.0
    for i, kind in enumerate(cfg.block_pattern):
        if kind in ("dense", "parallel", "moe", "enc", "dec", "shared"):
            if cfg.layer_uses_chunked_attn(i):
                continue               # ring cache, O(1) amortized growth
            kv_per_tok += 2 * cfg.n_kv_heads_padded * hd * dtype_bytes
        elif kind in ("mla", "mla_moe"):
            m = cfg.mla        # the latent and the shared rope key
            kv_per_tok += (m.kv_lora_rank + m.qk_rope_head_dim) * dtype_bytes
        elif kind == "mamba2":
            s = cfg.ssm
            state_bytes += (s.n_heads(cfg.d_model) * s.head_dim * s.state_dim
                            * 4 + (s.d_conv - 1) * s.conv_dim(cfg.d_model) * 4)
        elif kind == "rwkv6":
            H = cfg.d_model // cfg.rwkv.head_dim
            state_bytes += (H * cfg.rwkv.head_dim ** 2 * 4
                            + 2 * cfg.d_model * dtype_bytes)
        elif kind != "cross":
            # the reference's reckoning adds nothing for a ``cross`` layer
            # (its memory's keys and values are not per token)
            raise NotImplementedError(f"costing of block kind {kind!r}")
    return LLMWorkload(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads_padded, n_kv_heads=cfg.n_kv_heads_padded,
        head_dim=hd, d_ff=cfg.d_ff, vocab=cfg.padded_vocab,
        params_total=total, params_active=active, dtype_bytes=dtype_bytes,
        kv_bytes_per_token=kv_per_tok, state_bytes=state_bytes,
        sliding_window=cfg.sliding_window)
