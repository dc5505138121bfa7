"""Unified model configuration covering all assigned architecture families.

One ``ModelConfig`` describes dense / MoE / MLA / SSM / RWKV / hybrid /
enc-dec / VLM models through a per-layer ``block_pattern``. The pattern is
factored into ``prefix + unit * repeats`` so the model can scan over layer
groups (compile time O(1) in depth — required for the 100-layer dry-runs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

# Block kinds appearing in block_pattern:
#   "dense"     self-attention + SwiGLU MLP (sequential residual)
#   "parallel"  self-attention + MLP computed in parallel (StableLM-2)
#   "moe"       self-attention + mixture-of-experts FFN
#   "mla"       MLA attention + SwiGLU MLP (DeepSeek dense layers)
#   "mla_moe"   MLA attention + MoE FFN (DeepSeek MoE layers)
#   "mamba2"    Mamba2 SSD block
#   "shared"    Zamba2 weight-shared full-attention block (concat input)
#   "cross"     cross-attention + MLP (VLM layers attending to image embeds)
#   "rwkv6"     RWKV6 time-mix + channel-mix block (attention-free)
#   "enc"       bidirectional encoder block (enc-dec models)
#   "dec"       decoder block: self-attn + cross-attn + MLP (enc-dec models)
BLOCK_KINDS = ("dense", "parallel", "moe", "mla", "mla_moe", "mamba2",
               "rwkv6", "shared", "cross", "enc", "dec")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 2048
    n_shared_experts: int = 0          # shared experts always active
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01    # load-balance loss weight
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (state-space dual) block."""
    state_dim: int = 64
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256                   # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.state_dim


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64               # LoRA rank of the data-dependent decay
    mix_lora: int = 32                 # LoRA rank of the ddlerp token mix


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block_pattern: Tuple[str, ...]
    head_dim: Optional[int] = None     # default d_model // n_heads
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0            # partial rotary (StableLM-2)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # attention locality
    sliding_window: Optional[int] = None     # ring-buffer window (all layers)
    attn_chunk: Optional[int] = None         # llama4 chunked local attention
    global_attn_every: int = 0               # every Nth layer full attn (iRoPE)
    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # enc-dec (audio) / cross-attn (vlm)
    n_encoder_layers: int = 0
    encoder_seq: int = 4096            # stub frontend frames / image tokens
    n_image_tokens: int = 0            # vlm cross-attention kv length
    # MiniCPM muP-ish scaling
    scale_emb: float = 1.0
    residual_scale: float = 1.0        # scales residual branch (depth scaling)
    logit_scale: float = 1.0
    # DeepSeek multi-token prediction
    mtp: bool = False
    mtp_weight: float = 0.3
    # perf lever (EXPERIMENTS.md SSPerf H1): expand the MLA latent to
    # per-head K/V per kv-chunk inside the flash scan instead of
    # materializing the full (B,S,H,192) expansion
    mla_fused_prefill: bool = False
    # attention execution path: "ref" (pure jnp, default — used by the
    # dry-run so the roofline reflects XLA lowering), "pallas" (TPU
    # kernels), "pallas_interpret" (kernel bodies on CPU; tests)
    attn_impl: str = "ref"
    # sharding pads (see repro.sharding.rules)
    pad_heads_to_multiple: int = 1     # pad q/kv heads for the model axis
    vocab_pad_multiple: int = 256

    # ------------------------------------------------------------------
    def __post_init__(self):
        if len(self.block_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: block_pattern has {len(self.block_pattern)} "
                f"entries but n_layers={self.n_layers}")
        for b in self.block_pattern:
            if b not in BLOCK_KINDS:
                raise ValueError(f"{self.name}: unknown block kind {b!r}")
        if any(b in ("mla", "mla_moe") for b in self.block_pattern) and self.mla is None:
            raise ValueError(f"{self.name}: MLA blocks need cfg.mla")
        if any(b in ("moe", "mla_moe") for b in self.block_pattern) and self.moe is None:
            raise ValueError(f"{self.name}: MoE blocks need cfg.moe")
        if "mamba2" in self.block_pattern and self.ssm is None:
            raise ValueError(f"{self.name}: mamba2 blocks need cfg.ssm")
        if "rwkv6" in self.block_pattern and self.rwkv is None:
            raise ValueError(f"{self.name}: rwkv6 blocks need cfg.rwkv")

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    def padded_heads(self, n: int) -> int:
        m = self.pad_heads_to_multiple
        return ((n + m - 1) // m) * m

    @property
    def n_heads_padded(self) -> int:
        return self.padded_heads(self.n_heads)

    @property
    def n_kv_heads_padded(self) -> int:
        return self.padded_heads(self.n_kv_heads)

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(b in ("mamba2", "rwkv6") for b in self.block_pattern)

    def layer_uses_chunked_attn(self, layer_idx: int) -> bool:
        """llama4 iRoPE: chunked local attention except every Nth layer."""
        if self.attn_chunk is None:
            return False
        if self.global_attn_every and (layer_idx + 1) % self.global_attn_every == 0:
            return False
        return True

    # ------------------------------------------------------------------
    def grouping(self) -> Tuple[Tuple[str, ...], Tuple[str, ...], int]:
        """Factor block_pattern into (prefix, unit, repeats).

        The model unrolls the prefix and scans the unit ``repeats`` times.
        Chooses the factorization minimizing prefix+unit length; a layer
        whose behaviour depends on absolute depth (chunked/global attention
        alternation) is handled by folding the alternation period into the
        unit.
        """
        pat = self.block_pattern
        n = len(pat)
        # the unit must also respect the global-attention period, so two
        # layers at the same position-in-unit behave identically.
        forced_period = self.global_attn_every if self.attn_chunk else 1
        best = (pat, (), 0)            # fallback: all prefix, no scan
        best_cost = n
        for unit_len in range(1, n + 1):
            if forced_period and unit_len % forced_period and unit_len != n:
                continue
            for prefix_len in range(0, n - unit_len + 1):
                rem = n - prefix_len
                if rem % unit_len:
                    continue
                repeats = rem // unit_len
                unit = pat[prefix_len:prefix_len + unit_len]
                if pat[prefix_len:] != unit * repeats:
                    continue
                cost = prefix_len + unit_len
                if repeats > 1 and cost < best_cost:
                    best_cost = cost
                    best = (pat[:prefix_len], unit, repeats)
        return best

    def validate(self) -> None:
        """Extra invariants checked by tests."""
        assert self.d_model % max(self.n_heads, 1) == 0 or self.head_dim, \
            f"{self.name}: d_model not divisible by n_heads and no head_dim"
        prefix, unit, repeats = self.grouping()
        assert tuple(prefix) + tuple(unit) * repeats == tuple(self.block_pattern)


def repeat_pattern(unit, repeats, prefix=(), suffix=()):
    return tuple(prefix) + tuple(unit) * repeats + tuple(suffix)
