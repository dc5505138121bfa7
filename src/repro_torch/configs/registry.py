"""Architecture registry of the port: ``get_config(arch_id, variant)``.

Covers the dense LLaMA configurations the port serves so far: the paper's
own ``llama-paper-{1b,3b,7b}`` (MHA) and ``llama3.2-1b`` (GQA). Variants
are the JAX registry's: ``full``, ``smoke`` (a few layers, narrow widths,
float32; for CPU tests) and ``long`` (full with a sliding window).
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["llama-paper-1b", "llama-paper-3b", "llama-paper-7b",
            "llama3.2-1b"]

_MODULES = {
    "llama-paper-1b": "repro_torch.configs.llama_paper",
    "llama-paper-3b": "repro_torch.configs.llama_paper",
    "llama-paper-7b": "repro_torch.configs.llama_paper",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
}

VARIANTS = ("full", "smoke", "long")


def get_config(arch: str, variant: str = "full"):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; use one of {VARIANTS}")
    mod_name = _MODULES.get(arch)
    if mod_name is None:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(mod_name).make(variant=variant, arch=arch)
