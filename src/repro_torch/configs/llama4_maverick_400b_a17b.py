"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

48 layers alternating dense / MoE (128 routed experts top-1 + 1 shared,
d_ff 8192), d_model 5120, 40 q heads (padded to 48 for the 16-way model
axis) / 8 kv heads (duplicated to 16), vocab 202048. iRoPE-style chunked
local attention (8192) with full attention every 4th layer — this is what
makes long_500k tractable without a sliding-window override. Early-fusion
vision: stub patch embeddings are scattered into token slots.
"""
from repro_torch.models.config import MoEConfig, ModelConfig, repeat_pattern


def make(variant: str = "full", arch: str = "llama4-maverick-400b-a17b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="moe", n_layers=4, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, dtype="float32",
            block_pattern=repeat_pattern(("dense", "moe"), 2),
            attn_chunk=8, global_attn_every=4,
            moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128,
                          n_shared_experts=1, capacity_factor=2.0),
            vocab_pad_multiple=8)
    # "long" == "full": chunked attention is already sub-quadratic.
    return ModelConfig(
        name=arch, family="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
        head_dim=128,
        block_pattern=repeat_pattern(("dense", "moe"), 24),
        attn_chunk=8192, global_attn_every=4,
        moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                      n_shared_experts=1, capacity_factor=1.25),
        rope_theta=500000.0,
        pad_heads_to_multiple=16)
