"""Carry the JAX reference's parameters into the port."""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def params_from_jax(np_tree: Dict, cfg, device: Union[str, torch.device] = "cuda"
                    ) -> Dict:
    """The port's parameters from the JAX ``Model.init`` pytree, converted
    leaf by leaf to numpy (``jax.tree_util.tree_map(np.asarray, params)``).

    The reference scans a stacked ``unit`` of layers: every unit leaf has a
    leading axis of length ``repeats`` (``repro/models/model.py``), and
    position ``i`` of the unit is keyed ``str(i)``. Layer ``r * len(unit)
    + i`` of the port is ``unit[str(i)]`` at index ``r``, after the
    unrolled ``prefix`` layers. Weights keep the reference's (d_in, d_out)
    orientation; nothing is transposed. Values pass through float32 (numpy
    has no bfloat16) and land in ``cfg.dtype`` exactly.
    """
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return _t(x, dt, dev)

    prefix, unit, repeats = cfg.grouping()
    layers = [tree(p) for p in np_tree["prefix"]]
    for r in range(repeats):
        for i in range(len(unit)):
            layers.append(tree(_index(np_tree["unit"][str(i)], r)))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: rebuilt {len(layers)} layers, "
                         f"config has {cfg.n_layers}")
    return {"embed": tree(np_tree["embed"]), "layers": layers,
            "final_norm": tree(np_tree["final_norm"]),
            "lm_head": tree(np_tree.get("lm_head", {}))}


def _index(x, r: int):
    if isinstance(x, dict):
        return {k: _index(v, r) for k, v in x.items()}
    return np.asarray(x)[r]
