"""InternLM2-20B [arXiv:2403.17297] — llama-like dense with GQA.

48 layers, d_model 6144, 48 q heads / 8 kv heads (duplicated to 16),
d_ff 16384, vocab 92544, rope theta 1e6.
"""
from repro_torch.models.config import ModelConfig, repeat_pattern


def make(variant: str = "full", arch: str = "internlm2-20b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="dense", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, dtype="float32",
            block_pattern=repeat_pattern(("dense",), 2), rope_theta=1e6,
            vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="dense", n_layers=48, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544,
        block_pattern=repeat_pattern(("dense",), 48), rope_theta=1e6,
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
