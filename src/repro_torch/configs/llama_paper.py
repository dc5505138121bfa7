"""The paper's own LLaMA 1B/3B/7B serving workloads (§2.1).

1B/3B are non-standard sizes (DESIGN.md assumption #4): dims chosen to hit
the parameter counts (1.26B / 3.43B / 6.74B) with llama-1 style MHA,
matching repro_torch.core.energy.LLAMA_{1,3,7}B exactly.
"""
from repro_torch.models.config import ModelConfig, repeat_pattern

_DIMS = {
    "llama-paper-1b": dict(n_layers=22, d_model=2048, n_heads=32, d_ff=5632),
    "llama-paper-3b": dict(n_layers=26, d_model=3200, n_heads=32, d_ff=8640),
    "llama-paper-7b": dict(n_layers=32, d_model=4096, n_heads=32, d_ff=11008),
}


def make(variant: str = "full", arch: str = "llama-paper-1b") -> ModelConfig:
    d = _DIMS[arch]
    if variant == "smoke":
        return ModelConfig(
            name=arch + "-smoke", family="dense", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, dtype="float32",
            block_pattern=repeat_pattern(("dense",), 2), vocab_pad_multiple=8)
    return ModelConfig(
        name=arch, family="dense", n_layers=d["n_layers"],
        d_model=d["d_model"], n_heads=d["n_heads"], n_kv_heads=d["n_heads"],
        d_ff=d["d_ff"], vocab=32000,
        block_pattern=repeat_pattern(("dense",), d["n_layers"]),
        sliding_window=8192 if variant == "long" else None,
        pad_heads_to_multiple=16)
