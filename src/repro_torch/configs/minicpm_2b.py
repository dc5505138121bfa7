"""MiniCPM-2B [arXiv:2404.06395] — llama-like dense with muP-style scaling
and the WSD (warmup-stable-decay) schedule (implemented in repro.training).

40 layers, d_model 2304, 36 MHA heads (padded to 48 for the 16-way model
axis — documented overhead), d_ff 5760, vocab 122753, tied embeddings,
scale_emb=12, residual scale 1.4/sqrt(40), logit scale 1/(d_model/256).
"""
import math

from repro_torch.models.config import ModelConfig, repeat_pattern


def make(variant: str = "full", arch: str = "minicpm-2b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="dense", n_layers=2, d_model=144,
            n_heads=6, n_kv_heads=6, d_ff=256, vocab=512, dtype="float32",
            block_pattern=repeat_pattern(("dense",), 2), tie_embeddings=True,
            scale_emb=12.0, residual_scale=1.4 / math.sqrt(2),
            logit_scale=256.0 / 144.0, pad_heads_to_multiple=4,
            vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="dense", n_layers=40, d_model=2304,
        n_heads=36, n_kv_heads=36, d_ff=5760, vocab=122753,
        block_pattern=repeat_pattern(("dense",), 40),
        tie_embeddings=True, scale_emb=12.0,
        residual_scale=1.4 / math.sqrt(40), logit_scale=256.0 / 2304.0,
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
