"""Checkpoints (the port of ``repro.training.checkpoint``): one file per
step holding ``{"step", "leaves": {path: tensor}}``, the paths the
reference's ``_flatten`` makes ("/"-joined dict keys and sequence
indices). The card's installation has no ``msgpack``, so the file is one
``torch.save`` payload, written to a temporary file and moved into place
with ``os.replace``, and read back with ``torch.load(weights_only=True)``.
A Python int leaf (the optimizer's step) is stored as a 0-d tensor.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.costing import named_leaves

SUFFIX = ".pt"


def _flatten(tree) -> Dict[str, torch.Tensor]:
    out = {}
    for path, leaf in named_leaves(tree):
        key = "/".join(path)
        out[key] = (leaf.detach() if isinstance(leaf, torch.Tensor)
                    else torch.tensor(leaf))
    return out


def save(path: str, tree, step: Optional[int] = None) -> None:
    tmp = path + ".tmp"
    torch.save({"step": step, "leaves": _flatten(tree)}, tmp)
    os.replace(tmp, path)


def restore(path: str, like) -> Tuple[Any, Optional[int]]:
    """Restore into the structure of ``like`` (tensors, on their devices,
    or ints). A leaf object met at several sites of ``like`` (a shared
    block) is restored once and referenced at each."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    leaves = payload["leaves"]
    memo: Dict[int, Any] = {}

    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, path + (str(i),))
                              for i, v in enumerate(tree))
        if id(tree) in memo:
            return memo[id(tree)]
        key = "/".join(path)
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = leaves[key]
        if isinstance(tree, torch.Tensor):
            if tuple(arr.shape) != tuple(tree.shape):
                raise ValueError(f"shape mismatch for {key!r}: "
                                 f"{tuple(arr.shape)} vs {tuple(tree.shape)}")
            out = arr.to(tree.device)
        else:
            out = type(tree)(arr.item())
        memo[id(tree)] = out
        return out

    return build(like, ()), payload.get("step")


def latest(ckpt_dir: str, prefix: str = "ckpt_") -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for f in os.listdir(ckpt_dir):
        if f.startswith(prefix) and f.endswith(SUFFIX):
            try:
                steps.append((int(f[len(prefix):-len(SUFFIX)]), f))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])
