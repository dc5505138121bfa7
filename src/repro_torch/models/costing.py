"""Analytic parameter accounting (the port of ``repro.models.costing``):
the carbon model's ``LLMWorkload`` view of a config, counted from the
port's own parameter shapes (built on the ``meta`` device, no storage).
The meter's modeled J depends on every field, so each must equal the
reference's."""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.energy import LLMWorkload
from repro_torch.models.model import Model


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_counts(cfg) -> Tuple[float, float]:
    """(total, active-per-token) parameter counts from the real init shapes
    (dense kinds only: every parameter is active)."""
    total = 0.0
    for leaf in _leaves(Model(cfg, "meta").param_shapes()):
        total += float(leaf.numel())
    return total, total


def workload_of(cfg, dtype_bytes: int = 2) -> LLMWorkload:
    """LLMWorkload view of a ModelConfig for the energy/carbon model."""
    total, active = param_counts(cfg)
    hd = cfg.head_dim_
    kv_per_tok = 0.0
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "dense":
            if cfg.layer_uses_chunked_attn(i):
                continue               # ring cache, O(1) amortized growth
            kv_per_tok += 2 * cfg.n_kv_heads_padded * hd * dtype_bytes
        else:
            raise NotImplementedError(f"costing of block kind {kind!r}")
    return LLMWorkload(
        name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_heads=cfg.n_heads_padded, n_kv_heads=cfg.n_kv_heads_padded,
        head_dim=hd, d_ff=cfg.d_ff, vocab=cfg.padded_vocab,
        params_total=total, params_active=active, dtype_bytes=dtype_bytes,
        kv_bytes_per_token=kv_per_tok, state_bytes=0.0,
        sliding_window=cfg.sliding_window)
