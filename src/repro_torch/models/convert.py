"""Carry the JAX reference's parameters into the port."""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.model import check_head_padding


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
    unrolled ``prefix`` layers. A ``shared`` position of the unit has no
    ``unit`` entry: it is the reference's one ``shared_block``, converted
    once and referenced by every such layer (a ``shared`` layer of the
    prefix keeps its own parameters there). Weights keep the reference's
    (d_in, d_out) orientation; nothing is transposed. Values pass through
    float32 (numpy has no bfloat16) and land in ``cfg.dtype`` exactly;
    the float32 leaves (the SSM's, the MoE router) stay float32, and a
    ``moe`` block's ``experts_gate``/``_up``/``_down`` (E, d_in, d_out) and
    ``shared`` SwiGLU come across as they are, as do an ``mla`` block's
    latent projections and norms, the ``mtp`` head, a ``cross`` layer's
    scalar gates (``attn.gate``, ``gate_mlp``) and a ``dec`` layer's
    ``xattn``. An encoder-decoder's stacked ``encoder`` (a leading axis of
    ``n_encoder_layers``) becomes the per-layer list ``encoder``, beside
    ``enc_norm``. Raises if a padded
    q head's wo rows are not zero or duplicated kv heads differ
    (``model.check_head_padding``).
    """
    params = tree_from_jax(np_tree, cfg, device)
    check_head_padding(params, cfg)
    return params


def tree_from_jax(np_tree: Dict, cfg, device: Union[str, torch.device] = "cuda"
                  ) -> Dict:
    """``params_from_jax`` without the padding check: any tree of the
    parameters' structure, such as the reference's gradients (``jax.grad``
    of ``train_loss``), in the port's layout."""
    dev = resolve_device(device)
    dt = L.dtype_of(cfg)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        a = np.asarray(x)
        return _t(a, torch.float32 if a.dtype == np.float32 else dt, dev)

    prefix, unit, repeats = cfg.grouping()
    layers = [tree(p) for p in np_tree["prefix"]]
    shared = tree(np_tree["shared_block"]) if "shared" in unit else None
    for r in range(repeats):
        for i, kind in enumerate(unit):
            layers.append(shared if kind == "shared"
                          else tree(_index(np_tree["unit"][str(i)], r)))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: rebuilt {len(layers)} layers, "
                         f"config has {cfg.n_layers}")
    params = {"embed": tree(np_tree["embed"]), "layers": layers,
              "final_norm": tree(np_tree["final_norm"]),
              "lm_head": tree(np_tree.get("lm_head", {}))}
    if "encoder" in np_tree:
        params["encoder"] = [tree(_index(np_tree["encoder"], i))
                             for i in range(cfg.n_encoder_layers)]
        params["enc_norm"] = tree(np_tree["enc_norm"])
    if "mtp" in np_tree:
        params["mtp"] = tree(np_tree["mtp"])
    return params


def _index(x, r: int):
    if isinstance(x, dict):
        return {k: _index(v, r) for k, v in x.items()}
    return np.asarray(x)[r]
