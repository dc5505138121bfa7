"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + weight-shared attention.

81 layers: every 6th is the *weight-shared* full-attention block applied to
concat(h, embedding) (one parameter set, 13 application sites with separate
KV caches), the rest are Mamba2 SSD blocks (d_inner 7168, 112 SSM heads,
state 64). d_model 3584, shared-attn 32 heads of 112, d_ff 14336, vocab
32000. Zamba2's per-site LoRA adapters on the shared block are omitted, as
in the reference configuration. The ``long`` variant gives the shared
attention an 8192 sliding window.
"""
from repro_torch.models.config import ModelConfig, SSMConfig, repeat_pattern


def make(variant: str = "full", arch: str = "zamba2-7b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="hybrid", n_layers=3, d_model=128,
            n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, dtype="float32",
            block_pattern=("mamba2", "mamba2", "shared"),
            ssm=SSMConfig(state_dim=16, head_dim=32, chunk=8),
            vocab_pad_multiple=8)
    # 81 = 13 * (5 mamba + 1 shared) + 3 trailing mamba
    pattern = repeat_pattern(("mamba2",) * 5 + ("shared",), 13,
                             suffix=("mamba2",) * 3)
    return ModelConfig(
        name=arch, family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
        block_pattern=pattern,
        ssm=SSMConfig(state_dim=64, head_dim=64, n_groups=1, d_conv=4,
                      expand=2, chunk=256),
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
