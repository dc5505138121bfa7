"""DeepSeek-V3 671B [arXiv:2412.19437] — MoE 256e top-8, MLA, MTP.

61 layers, d_model 7168, 128 heads (MLA latent attention: kv cache is the
512-dim latent + 64-dim rope key, ~1.1 KB/token in bf16), first 3 layers
dense (d_ff 18432), remaining 58 MoE with 1 shared + 256 routed experts of
d_ff 2048, top-8 routing; multi-token-prediction head. Vocab 129280.

Simplifications vs the paper (noted in DESIGN.md): softmax-over-top-k
router instead of sigmoid+bias-correction; node-limited routing modeled by
the capacity factor; depth-1 MTP.
"""
from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig


def make(variant: str = "full", arch: str = "deepseek-v3-671b") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="moe", n_layers=3, d_model=256,
            n_heads=8, n_kv_heads=8, d_ff=512, vocab=512, dtype="float32",
            block_pattern=("mla",) + ("mla_moe",) * 2,
            mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                          qk_nope_head_dim=16, qk_rope_head_dim=8,
                          v_head_dim=16),
            moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128,
                          n_shared_experts=1, capacity_factor=2.0),
            mtp=True, vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=18432, vocab=129280,
        block_pattern=("mla",) * 3 + ("mla_moe",) * 58,
        head_dim=128,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                      n_shared_experts=1, capacity_factor=1.25),
        mtp=True, rope_theta=10000.0,
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
