"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] — small llama3.

16 layers, d_model 2048, 32 q heads / 8 kv heads (duplicated to 16),
head_dim 64, d_ff 8192, vocab 128256, tied embeddings, rope theta 500000.
"""
from repro_torch.models.config import ModelConfig, repeat_pattern


def make(variant: str = "full", arch: str = "llama3.2-1b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="dense", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, dtype="float32",
            block_pattern=repeat_pattern(("dense",), 2), tie_embeddings=True,
            rope_theta=500000.0, vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="dense", n_layers=16, d_model=2048,
        n_heads=32, n_kv_heads=8, d_ff=8192, vocab=128256,
        block_pattern=repeat_pattern(("dense",), 16), tie_embeddings=True,
        rope_theta=500000.0,
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
