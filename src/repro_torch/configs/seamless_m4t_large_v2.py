"""SeamlessM4T-Large v2 [arXiv:2308.11596] — enc-dec speech/text model.

24 encoder + 24 decoder layers (the assigned "24L" is per stack; see
DESIGN.md), d_model 1024, 16 heads, d_ff 8192, vocab 256206 (padded to
256256 for the 16-way model axis). The speech frontend (mel + conformer
feature extractor) is the allowed stub: the encoder consumes precomputed
frame embeddings (default 4096 frames).
"""
from repro_torch.models.config import ModelConfig, repeat_pattern


def make(variant: str = "full", arch: str = "seamless-m4t-large-v2") -> ModelConfig:
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="audio", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, dtype="float32",
            block_pattern=("dec", "dec"), n_encoder_layers=2,
            encoder_seq=24, vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="audio", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206,
        block_pattern=repeat_pattern(("dec",), 24),
        n_encoder_layers=24, encoder_seq=4096,
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
