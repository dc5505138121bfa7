"""DeepSeek-V3 (MLA's latent cache and absorbed decode, ``mla_moe``
experts top-k) served by the port's contiguous ``ServingEngine`` against
the JAX engine on the CPU in float32, on parameters carried across by
``params_from_jax``: ragged prompts of 3-30 tokens in padded prefill
batches of mixed lengths, most of them decoding past the 8-token bucket,
token for token, with each request's modeled J, every non-wall-clock
``stats()`` key (modeled J and gCO2 included) to 1e-12 and the carbon
report equal (``tests/test_torch_moe.py:_engines_agree``).

* ``deepseek-v3-671b`` smoke (3 layers: one ``mla``, two ``mla_moe``;
  E4 top-2 and a shared expert; the MTP head held);
* a small config with DeepSeek's top-8 (of 16 experts), 6 heads padded to
  8 and a capacity factor of 0.5, so prefill launches drop real tokens
  beside the routed pad tokens (a 32-token bucket of two rows: 512 pairs
  on 16 experts of 16 slots);
* the smoke model with ``DIRECT_ATTN_MAX_SEQ`` set to 16 on both
  packages, so the 32-token prefill buckets take the two-level scan.
"""
import dataclasses

import pytest

from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro_torch.models import attention as TA

from test_torch_mla import DEEPSEEK, port_config
from test_torch_moe import _engines_agree


def _top8(cf):
    """DeepSeek smoke with top-8 of 16 experts, 6 heads padded to 8 and
    capacity factor ``cf``. Returns (JAX config, port config)."""
    j = jax_get_config(DEEPSEEK, "smoke")
    jcfg = dataclasses.replace(
        j, name=f"deepseek-top8-cf{cf}", n_heads=6, n_kv_heads=6,
        pad_heads_to_multiple=4,
        moe=dataclasses.replace(j.moe, n_experts=16, top_k=8,
                                capacity_factor=cf))
    return jcfg, port_config(jcfg)


def test_deepseek_smoke_engine_matches_jax_engine():
    jcfg = jax_get_config(DEEPSEEK, "smoke")
    _engines_agree(jcfg, port_config(jcfg))


def test_deepseek_top8_padded_heads_tight_capacity_engine():
    jcfg, cfg = _top8(0.5)
    assert cfg.n_heads_padded == 8 and cfg.moe.top_k == 8
    _engines_agree(jcfg, cfg)


def test_deepseek_scan_prefill_engine(monkeypatch):
    for mod in (JA, TA):
        monkeypatch.setattr(mod, "DIRECT_ATTN_MAX_SEQ", 16)
    jcfg = jax_get_config(DEEPSEEK, "smoke")
    _engines_agree(jcfg, port_config(jcfg))
