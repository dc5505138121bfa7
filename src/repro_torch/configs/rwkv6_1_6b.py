"""RWKV6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay. 24 layers, d_model 2048 (32 WKV heads of 64), d_ff 7168, vocab
65536. O(1) state: the ``long`` variant is the full one.
"""
from repro_torch.models.config import ModelConfig, RWKVConfig, repeat_pattern


def make(variant: str = "full", arch: str = "rwkv6-1.6b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="ssm", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, dtype="float32",
            block_pattern=repeat_pattern(("rwkv6",), 2),
            rwkv=RWKVConfig(head_dim=32, decay_lora=16, mix_lora=8),
            vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="ssm", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536,
        block_pattern=repeat_pattern(("rwkv6",), 24),
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
        pad_heads_to_multiple=16)
