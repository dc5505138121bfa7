"""Optimizer and LR schedules (the port of ``repro.training.optim``).

AdamW with decoupled weight decay and global-norm clipping, optional
bf16 moments; the WSD (warmup-stable-decay) schedule of MiniCPM
[arXiv:2404.06395] and a cosine one. Parameters are the port's nested
dict / list of tensors (``Model.init``); a tensor referenced at several
sites (Zamba2's weight-shared block) is one parameter, with one pair of
moments, updated once. The arithmetic is float32, as the reference's;
the update writes the parameters and moments in place under
``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.costing import named_leaves
from repro_torch.models.layers import DTYPES

# leaf-path names whose parameters take no weight decay (the reference's
# ``_decay_mask``: norms, scales, biases)
NO_DECAY = {"scale", "bias", "ln1", "ln2", "ln_x", "q_norm", "k_norm",
            "kv_norm", "gate_norm"}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak LR (schedules scale it)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"    # "bfloat16" for the giant configs


def unique_leaves(tree) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``named_leaves`` with each object once, at its first path."""
    seen = set()
    for path, leaf in named_leaves(tree):
        if id(leaf) not in seen:
            seen.add(id(leaf))
            yield path, leaf


def tree_map(fn: Callable, tree, memo: Optional[Dict[int, Any]] = None):
    """``fn`` over the leaves, the structure kept; a leaf object met at
    several sites maps to one result object."""
    memo = {} if memo is None else memo
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, memo) for v in tree)
    if id(tree) not in memo:
        memo[id(tree)] = fn(tree)
    return memo[id(tree)]


def adamw_init(params, cfg: AdamWConfig) -> Dict:
    dt = DTYPES[cfg.moment_dtype]
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "step": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (each object once) in
    float32; a None leaf (no gradient) counts as zeros."""
    return torch.sqrt(torch.stack([
        torch.sum(torch.square(g.float())) for _, g in unique_leaves(tree)
        if g is not None]).sum())


def _decay_mask(path: Tuple[str, ...]) -> bool:
    """No weight decay on norms / scales / biases (by leaf-path name)."""
    return not set(path) & NO_DECAY


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's f32 scalars."""
    return float(np.float32(x))


def adamw_update(params, grads, state: Dict, cfg: AdamWConfig,
                 lr_scale: float) -> Tuple[Any, Dict, Dict]:
    """One AdamW step, in place. ``grads`` has the structure of
    ``params`` (None leaves: zero gradient). Returns (params, state,
    metrics) with metrics ``grad_norm`` and ``clip`` (0-d float32
    tensors) and ``lr``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    step = state["step"] + 1
    lr = _f32(np.float32(cfg.lr) * np.float32(lr_scale))
    b1c = _f32(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    b2c = _f32(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))
    mdt = DTYPES[cfg.moment_dtype]
    g_of = {id(p): g for (_, p), (_, g) in zip(named_leaves(params),
                                               named_leaves(grads))}
    m_of = {id(p): m for (_, p), (_, m) in zip(named_leaves(params),
                                               named_leaves(state["m"]))}
    v_of = {id(p): v for (_, p), (_, v) in zip(named_leaves(params),
                                               named_leaves(state["v"]))}
    with torch.no_grad():
        for path, p in unique_leaves(params):
            g, m, v = g_of[id(p)], m_of[id(p)], v_of[id(p)]
            gf = (torch.zeros_like(p, dtype=torch.float32) if g is None
                  else g.float() * clip.to(p.device))
            m_new = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            v_new = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
            if cfg.weight_decay and _decay_mask(path):
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            m.copy_(m_new.to(mdt))
            v.copy_(v_new.to(mdt))
    state = {"m": state["m"], "v": state["v"], "step": step}
    return params, state, {"grad_norm": gnorm, "lr": lr, "clip": clip}


# --- schedules --------------------------------------------------------------
# float32 arithmetic, as the reference's


def wsd_schedule(warmup: int, stable: int, decay: int,
                 final_frac: float = 0.1) -> Callable[[int], float]:
    """MiniCPM warmup-stable-decay: linear warmup -> flat -> exp decay."""
    f32 = np.float32

    def f(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(s / f32(max(warmup, 1)))
        if s < warmup + stable:
            return 1.0
        t = np.clip((s - f32(warmup) - f32(stable)) / f32(max(decay, 1)),
                    f32(0.0), f32(1.0))
        return float(np.exp(f32(math.log(final_frac)) * t, dtype=f32))
    return f


def cosine_schedule(warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable[[int], float]:
    f32 = np.float32

    def f(step: int) -> float:
        s = f32(step)
        if s < warmup:
            return float(s / f32(max(warmup, 1)))
        t = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                    f32(0.0), f32(1.0))
        return float(f32(final_frac) + f32(1 - final_frac) * f32(0.5)
                     * (f32(1.0) + np.cos(f32(np.pi) * t, dtype=f32)))
    return f
