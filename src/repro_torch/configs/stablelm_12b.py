"""StableLM-2-12B [hf:stabilityai/stablelm-2-1_6b family, 12B member].

40 layers with parallel attention/FFN residual, qk-layernorm, partial
rotary (25%). d_model 5120, 32 q heads / 8 kv heads (duplicated to 16),
d_ff 13824, vocab 100352.
"""
from repro_torch.models.config import ModelConfig, repeat_pattern


def make(variant: str = "full", arch: str = "stablelm-12b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="dense", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, dtype="float32",
            rotary_pct=0.25,
            block_pattern=repeat_pattern(("parallel",), 2),
            vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352,
        rotary_pct=0.25,
        block_pattern=repeat_pattern(("parallel",), 40),
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
