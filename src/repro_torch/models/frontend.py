"""STUB modality frontends (the port of ``repro.models.frontend``, the one
allowed stub).

The VLM and audio architectures specify the transformer backbone only;
the vision encoder (ViT/SigLIP + projector) and the speech frontend
(mel-spectrogram + conv feature extractor) are stubbed: these functions
emit frame / patch *embeddings* of the right shape, N(0, 0.02^2) drawn
from a ``torch.Generator`` on ``device``. The draws differ from the
reference's ``jax.random`` ones, so a test that compares the two packages
feeds both the same numpy arrays.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def _normal(gen: Optional[torch.Generator], shape, dtype,
            device: Device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * 0.02).to(dtype)


def vision_embeddings(gen: Optional[torch.Generator], batch: int,
                      n_tokens: int, d_model: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: Device = "cuda") -> torch.Tensor:
    """Stub ViT output: (batch, n_tokens, d_model) patch embeddings."""
    return _normal(gen, (batch, n_tokens, d_model), dtype, device)


def audio_frames(gen: Optional[torch.Generator], batch: int, n_frames: int,
                 d_model: int, dtype: torch.dtype = torch.bfloat16,
                 device: Device = "cuda") -> torch.Tensor:
    """Stub speech-encoder frontend output: (batch, frames, d_model)."""
    return _normal(gen, (batch, n_frames, d_model), dtype, device)


def image_positions(batch: int, n_tokens: int, seq_len: int,
                    device: Device = "cuda") -> torch.Tensor:
    """Early-fusion slots (Llama-4): the first ``min(n_tokens, seq_len)``
    positions of the sequence, (batch, n) int32."""
    pos = torch.arange(min(n_tokens, seq_len), dtype=torch.int32,
                       device=device)
    return pos[None].expand(batch, pos.shape[0])
