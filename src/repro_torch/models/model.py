"""Model assembly (the port of ``repro.models.model``): embeddings ->
blocks -> final norm -> logits, with prefill and decode entry points.

The reference scans a stacked ``unit`` of layers to keep XLA compile time
flat in depth; PyTorch runs eagerly, so here the layers are a Python loop
over a per-layer parameter list (``params["layers"]``) and a per-layer
cache list (``caches["layers"]``). Caches are written in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

class Model:
    """A ModelConfig bound to a device. Parameters live outside the object
    (``init`` returns them), as in the reference."""

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda"):
        for kind in set(cfg.block_pattern):
            B._require_ported(kind)
        if cfg.is_encdec or cfg.n_image_tokens:
            raise NotImplementedError(
                f"{cfg.name}: memory-conditioned models are not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator]) -> Dict:
        """Random parameters from ``generator`` (on ``self.device``). The
        draws differ from the reference's ``jax.random`` ones; to run the
        reference's weights use ``models.convert.params_from_jax``."""
        cfg, dev = self.cfg, self.device
        dt = L.dtype_of(cfg)
        return {
            "embed": L.embedding_init(generator, cfg, dev),
            "layers": [B.block_init(generator, cfg, kind, dev)
                       for kind in cfg.block_pattern],
            "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev),
            "lm_head": L.lm_head_init(generator, cfg, dev),
        }

    def param_shapes(self) -> Dict:
        """The parameter tree on the ``meta`` device: shapes, no storage."""
        return Model(self.cfg, "meta").init(None)

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> Dict:
        cfg = self.cfg
        return {
            "t": torch.zeros((batch,), dtype=torch.int32, device=self.device),
            "layers": [B.block_cache_init(cfg, kind, batch, max_len,
                                          self.device, layer_idx=i)
                       for i, kind in enumerate(cfg.block_pattern)],
        }

    # --------------------------------------------------------------- forward
    def forward(self, params, tokens: torch.Tensor, mask=None,
                mode: str = "prefill", caches: Optional[Dict] = None,
                last_index: Optional[torch.Tensor] = None):
        """Returns (logits, caches). ``last_index`` (B,) keeps only that
        token's hidden state before the final norm and the vocab product:
        rows are independent there, so the result equals the full logits
        at those rows without computing the others."""
        cfg = self.cfg
        Bsz, S = tokens.shape
        if mode == "decode":
            positions = caches["t"][:, None]
        elif mode == "prefill":
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device)[None].expand(Bsz, S)
            if mask is not None:
                # right-padded batched prefill: pad slots get position -1,
                # so their cache entries are masked and never attended
                positions = torch.where(mask > 0, positions,
                                        torch.full_like(positions, -1))
        else:
            raise NotImplementedError(
                f"forward mode {mode!r} is not ported yet (ROADMAP Queue 1)")

        x = L.embed(params["embed"], cfg, tokens)
        layer_caches = caches["layers"] if caches is not None else None
        for i, kind in enumerate(cfg.block_pattern):
            ctx = B.LayerCtx(cfg=cfg, mode=mode, positions=positions,
                             layer_idx=i)
            c = layer_caches[i] if layer_caches is not None else None
            x, _ = B.block_apply(params["layers"][i], cfg, kind, ctx, x, c)
        if last_index is not None:
            x = x[torch.arange(Bsz, device=x.device), last_index][:, None]
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.logits(params["lm_head"], params["embed"], cfg, x)
        if caches is not None:
            if mode == "decode":
                caches["t"] += 1
            else:
                lengths = (mask.sum(dim=1).to(torch.int32) if mask is not None
                           else torch.full((Bsz,), S, dtype=torch.int32,
                                           device=tokens.device))
                caches["t"].copy_(lengths)
        return logits, caches

    # ---------------------------------------------------------------- serve
    def prefill(self, params, tokens: torch.Tensor, mask=None,
                max_len: Optional[int] = None,
                caches: Optional[Dict] = None):
        """Process prompts; returns (last-token logits (B, vocab), caches)."""
        Bsz, S = tokens.shape
        if caches is None:
            caches = self.init_cache(Bsz, max_len or S)
        lengths = (mask.sum(dim=1) if mask is not None
                   else torch.full((Bsz,), S, device=tokens.device))
        last = torch.clamp(lengths - 1, min=0).long()
        logits, caches = self.forward(params, tokens, mask, mode="prefill",
                                      caches=caches, last_index=last)
        return logits[:, 0], caches

    def decode_step(self, params, caches, tokens: torch.Tensor):
        """tokens: (B, 1) -> (logits (B, vocab), caches)."""
        logits, caches = self.forward(params, tokens, None, mode="decode",
                                      caches=caches)
        return logits[:, 0], caches
