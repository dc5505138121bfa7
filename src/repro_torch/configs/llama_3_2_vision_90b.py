"""Llama-3.2-Vision 90B [hf:meta-llama/Llama-3.2-11B-Vision, scaled].

100 layers = 80 self-attention + 20 gated cross-attention (every 5th layer
attends to vision-encoder patch embeddings — the ViT frontend is the
allowed stub). d_model 8192, 64 q heads / 8 kv heads (duplicated to 16 for
the 16-way model axis), d_ff 28672, vocab 128256.
"""
from repro_torch.models.config import ModelConfig, repeat_pattern


def make(variant: str = "full", arch: str = "llama-3.2-vision-90b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="vlm", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, dtype="float32",
            block_pattern=("dense", "cross"), n_image_tokens=16,
            rope_theta=500000.0, vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="vlm", n_layers=100, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
        block_pattern=repeat_pattern(("dense",) * 4 + ("cross",), 20),
        n_image_tokens=1600, rope_theta=500000.0,
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
