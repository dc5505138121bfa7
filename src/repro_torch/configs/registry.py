"""Architecture registry of the port: ``get_config(arch_id, variant)``.

Covers the configurations the port serves so far: the paper's own dense
``llama-paper-{1b,3b,7b}`` (MHA; 3b at head dim 100), ``llama3.2-1b``
(GQA), ``internlm2-20b`` (GQA group 3 after its kv heads are duplicated
to 16), ``minicpm-2b`` (36 MHA heads padded to 48, muP-style scaling,
tied embeddings), ``stablelm-12b`` (the parallel block with qk-norm, 25%
partial rotary, head dim 160, GQA group 2 after its kv heads are
duplicated to 16), the MoE ``llama4-maverick-400b-a17b`` (dense and
``moe`` blocks alternating, 128 experts top-1 plus a shared one,
chunk-local iRoPE attention with a global layer every 4th, 40 q heads
padded to 48 on 8 kv heads duplicated to 16), ``deepseek-v3-671b``
(MLA's latent attention in 3 dense ``mla`` and 58 ``mla_moe`` layers,
256 experts top-8 plus a shared one, a depth-1 MTP head), the hybrid
``zamba2-7b`` (Mamba2 + one weight-shared attention block), the
attention-free ``rwkv6-1.6b``, and the two memory-conditioned families:
the VLM ``llama-3.2-vision-90b`` (every 5th of its 100 layers a gated
``cross`` layer attending to 1,600 stub image embeddings; 64 / 8 heads,
the kv heads duplicated to 16) and the encoder-decoder
``seamless-m4t-large-v2`` (24 bidirectional ``enc`` layers over 4,096
stub audio frames, 24 ``dec`` layers of self- and cross-attention). That
is every architecture of the JAX registry, and the paper's own three.
Variants are the JAX registry's:
``full``, ``smoke`` (a few layers, narrow widths, float32; for CPU
tests) and ``long`` (full with a sliding window; full itself for
``rwkv6-1.6b``).
"""
from __future__ import annotations

import importlib
from typing import Dict

ARCH_IDS = ["llama-paper-1b", "llama-paper-3b", "llama-paper-7b",
            "llama3.2-1b", "internlm2-20b", "minicpm-2b", "stablelm-12b",
            "llama4-maverick-400b-a17b", "deepseek-v3-671b", "zamba2-7b",
            "rwkv6-1.6b", "llama-3.2-vision-90b", "seamless-m4t-large-v2"]

_MODULES = {
    "llama-paper-1b": "repro_torch.configs.llama_paper",
    "llama-paper-3b": "repro_torch.configs.llama_paper",
    "llama-paper-7b": "repro_torch.configs.llama_paper",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "llama4-maverick-400b-a17b":
        "repro_torch.configs.llama4_maverick_400b_a17b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

VARIANTS = ("full", "smoke", "long")


def get_config(arch: str, variant: str = "full"):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; use one of {VARIANTS}")
    mod_name = _MODULES.get(arch)
    if mod_name is None:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(mod_name).make(variant=variant, arch=arch)


def all_configs(variant: str = "full") -> Dict[str, object]:
    return {a: get_config(a, variant) for a in ARCH_IDS}
