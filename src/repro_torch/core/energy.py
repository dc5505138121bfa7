"""Analytical performance + power + energy model (paper §2, Eq. 1).

The paper *measures* latency (wall clock) and power (NVML @ 100 ms) and
derives ``E_prompt = P_prompt * t_prompt``. This container has neither a GPU
nor a power meter, so the measured quantities are replaced by a calibrated
analytical model:

  time   t = t_overhead + max(FLOPs/(peak*eff_c(tokens)), bytes/(bw*eff_m))
             * thrash(working_set) + collective_bytes/link_bw
  power  P = P_idle + (TDP - P_idle) * util**alpha,  util = t_compute/t
  energy E = P * t                                           (paper Eq. 1)

The model reproduces the paper's qualitative structure exactly:

* decode is memory-bound (t_mem dominates), prefill compute-bound (§2.3);
* batch-1 decode has tiny util -> a 70 W T4 can beat a 300 W Ada on J/token
  despite being slower (Takeaway 1);
* prefill throughput peaks at a finite batch size because (a) small batches
  under-utilize the compute units (``sm_saturation_tokens`` ramp) and (b)
  larger batches pad every prompt to the batch max under an Alpaca-like
  length distribution (§2.1: prompts from Alpaca), so useful tokens/s falls
  (Takeaway 2);
* near-capacity working sets thrash and then OOM (Figure 1 "OOM" cells).

FLOP/byte counts are analytic for the GPU profiles (matching the paper's
LLaMA workloads) and can alternatively be taken from the XLA-compiled
artifact for the TPU profiles (``launch/dryrun.py`` -> cost_analysis).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.hardware import HardwareProfile

# ---------------------------------------------------------------------------
# Workload description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LLMWorkload:
    """Analytic description of a decoder-only LLM serving workload.

    ``params_active`` differs from ``params_total`` only for MoE models
    (MODEL_FLOPS = 6*N_active*D per the roofline spec).
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    params_total: float
    params_active: float
    dtype_bytes: int = 2
    # bytes of KV cache appended per token across all layers
    kv_bytes_per_token: float = 0.0
    # O(1)-in-seq recurrent state bytes (SSM/RWKV); 0 for pure attention
    state_bytes: float = 0.0
    sliding_window: Optional[int] = None

    @staticmethod
    def llama_like(name: str, n_layers: int, d_model: int, n_heads: int,
                   n_kv_heads: int, d_ff: int, vocab: int,
                   dtype_bytes: int = 2,
                   sliding_window: Optional[int] = None) -> "LLMWorkload":
        head_dim = d_model // n_heads
        emb = vocab * d_model
        per_layer = (
            d_model * head_dim * (n_heads + 2 * n_kv_heads)  # q,k,v proj
            + n_heads * head_dim * d_model                   # o proj
            + 3 * d_model * d_ff                             # swiglu
            + 2 * d_model                                    # norms
        )
        params = emb * 2 + n_layers * per_layer + d_model
        kv_per_tok = 2 * n_layers * n_kv_heads * head_dim * dtype_bytes
        return LLMWorkload(
            name=name, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv_heads, head_dim=head_dim, d_ff=d_ff, vocab=vocab,
            params_total=float(params), params_active=float(params),
            dtype_bytes=dtype_bytes, kv_bytes_per_token=float(kv_per_tok),
            sliding_window=sliding_window,
        )

    @property
    def params_bytes(self) -> float:
        return self.params_total * self.dtype_bytes

    def effective_context(self, context: float) -> float:
        """Context length actually attended to (sliding window caps it)."""
        if self.sliding_window is not None:
            return min(context, float(self.sliding_window))
        return float(context)


# Paper's LLaMA sizes (§2.1). 1B/3B are non-standard; dims chosen to hit the
# parameter counts (see DESIGN.md assumption log #4).
LLAMA_1B = LLMWorkload.llama_like("llama-1b", 22, 2048, 32, 32, 5632, 32000)
LLAMA_3B = LLMWorkload.llama_like("llama-3b", 26, 3200, 32, 32, 8640, 32000)
LLAMA_7B = LLMWorkload.llama_like("llama-7b", 32, 4096, 32, 32, 11008, 32000)


# ---------------------------------------------------------------------------
# Per-phase FLOP / byte counts (§2.3 prefill vs decode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepCounts:
    """Compute/memory/communication demand of one serving or training step."""

    flops: float
    hbm_bytes: float
    working_set_bytes: float
    tokens: float                     # tokens produced/processed this step
    collective_bytes: float = 0.0
    compute_tokens: float = 0.0       # tokens incl. padding (utilization ramp)
    kv_bytes: float = 0.0             # KV-cache portion of hbm_bytes (old GPUs
                                      # re-read it: profile.kv_read_inefficiency)

    def scaled(self, k: float) -> "StepCounts":
        return dataclasses.replace(
            self, flops=self.flops * k, hbm_bytes=self.hbm_bytes * k,
            tokens=self.tokens * k, collective_bytes=self.collective_bytes * k,
            compute_tokens=self.compute_tokens * k)


def prefill_counts(w: LLMWorkload, batch: int, seq: float,
                   useful_seq: Optional[float] = None) -> StepCounts:
    """One prefill of ``batch`` prompts padded to ``seq`` tokens each."""
    useful = useful_seq if useful_seq is not None else seq
    tokens = batch * seq
    ctx = w.effective_context(seq)
    # matmul flops: 2 FLOP per param per token; attention: QK^T + PV, causal.
    mm = 2.0 * w.params_active * tokens
    attn = 2.0 * 2.0 * batch * seq * ctx * 0.5 * w.n_heads * w.head_dim * w.n_layers
    # memory: stream weights once + write KV + activation traffic
    act_traffic = 12.0 * tokens * w.d_model * w.n_layers * w.dtype_bytes
    kv_write = tokens * w.kv_bytes_per_token
    hbm = w.params_bytes + kv_write + act_traffic
    ws = w.params_bytes + kv_write + 4.0 * tokens * w.d_model * w.dtype_bytes
    return StepCounts(flops=mm + attn, hbm_bytes=hbm, working_set_bytes=ws,
                      tokens=batch * useful, compute_tokens=tokens,
                      kv_bytes=kv_write)


def decode_counts(w: LLMWorkload, batch: int, context: float) -> StepCounts:
    """One decode step: ``batch`` sequences each emit 1 token at ``context``."""
    ctx = w.effective_context(context)
    mm = 2.0 * w.params_active * batch
    attn = 2.0 * 2.0 * batch * ctx * w.n_heads * w.head_dim * w.n_layers
    kv_read = batch * (ctx * w.kv_bytes_per_token + w.state_bytes)
    act_traffic = 12.0 * batch * w.d_model * w.n_layers * w.dtype_bytes
    hbm = w.params_bytes + kv_read + act_traffic
    ws = w.params_bytes + batch * (context if w.sliding_window is None
                                   else min(context, w.sliding_window)) \
        * w.kv_bytes_per_token + batch * w.state_bytes
    return StepCounts(flops=mm + attn, hbm_bytes=hbm, working_set_bytes=ws,
                      tokens=float(batch), compute_tokens=float(batch),
                      kv_bytes=kv_read)


def migrate_counts(w: LLMWorkload, kv_tokens: float) -> StepCounts:
    """One KV-page migration hop: ``kv_tokens`` tokens of cache leave one
    pool and land in another. Pure data movement — zero FLOPs (so
    ``step_power`` prices it at idle draw), the KV bytes crossing HBM on
    each side, and the same bytes on the interconnect (``collective_bytes``
    routes through the slice's ``ici_bw`` when set). ``tokens`` carries the
    migrated token count for per-token accounting in the ``migrate`` phase;
    ``compute_tokens`` stays 0 so utilization-ramp heuristics ignore it."""
    b = max(kv_tokens, 0.0) * w.kv_bytes_per_token
    return StepCounts(flops=0.0, hbm_bytes=b, working_set_bytes=b,
                      tokens=float(max(kv_tokens, 0.0)),
                      collective_bytes=b, compute_tokens=0.0, kv_bytes=b)


# ---------------------------------------------------------------------------
# Time / power / energy model
# ---------------------------------------------------------------------------

# Utilization ramp: with few tokens in flight the compute units are
# under-occupied. sqrt softens the ramp (a single GEMV still reaches a
# meaningful fraction of peak); the floor keeps degenerate single-token
# steps from becoming spuriously compute-bound (they are latency/memory
# bound in reality). Old small GPUs saturate with fewer tokens
# (profile.sm_saturation_tokens) — this is what makes prefill throughput
# peak at batch 8 on T4 vs 32 on Ada (paper Fig. 2a).
RAMP_FLOOR = 0.05


def compute_efficiency(profile: HardwareProfile, compute_tokens: float) -> float:
    """Fraction of peak FLOP/s achievable at this level of parallelism."""
    k = profile.sm_saturation_tokens
    ramp = math.sqrt(compute_tokens / (compute_tokens + k))
    return profile.eff_compute * max(ramp, RAMP_FLOOR)


@dataclasses.dataclass(frozen=True)
class TimeBreakdown:
    t_compute: float
    t_memory: float
    t_collective: float
    t_overhead: float
    thrash: float
    oom: bool

    @property
    def t_total(self) -> float:
        if self.oom:
            return math.inf
        return (self.t_overhead
                + max(self.t_compute, self.t_memory) * self.thrash
                + self.t_collective)

    @property
    def bound(self) -> str:
        if self.oom:
            return "oom"
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective, "overhead": self.t_overhead}
        return max(terms, key=terms.get)

    @property
    def utilization(self) -> float:
        """FLOP-utilization proxy used by the power model."""
        if self.oom or self.t_total <= 0:
            return 0.0
        return min(1.0, self.t_compute / self.t_total)


def step_time(profile: HardwareProfile, counts: StepCounts) -> TimeBreakdown:
    oom = not profile.fits(counts.working_set_bytes)
    eff_c = compute_efficiency(profile, counts.compute_tokens or counts.tokens)
    t_c = counts.flops / (profile.peak_flops * max(eff_c, 1e-9))
    extra_kv = counts.kv_bytes * (profile.kv_read_inefficiency - 1.0)
    t_m = (counts.hbm_bytes + extra_kv) / (profile.hbm_bw * profile.eff_memory)
    link = profile.ici_bw if profile.ici_bw > 0 else profile.hbm_bw
    t_x = counts.collective_bytes / link if counts.collective_bytes else 0.0
    return TimeBreakdown(
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        t_overhead=profile.step_overhead_s,
        thrash=profile.thrash_multiplier(counts.working_set_bytes),
        oom=oom,
    )


def step_power(profile: HardwareProfile, tb: TimeBreakdown) -> float:
    """Average device power over the step (paper: NVML average)."""
    u = tb.utilization
    return profile.idle_w + (profile.tdp_w - profile.idle_w) * u ** profile.power_alpha


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    time: TimeBreakdown
    power_w: float
    energy_j: float
    tokens: float

    @property
    def t_total(self) -> float:
        return self.time.t_total

    @property
    def j_per_token(self) -> float:
        return self.energy_j / max(self.tokens, 1e-12)

    @property
    def energy_wh(self) -> float:
        """Wh — the unit measured power traces integrate to
        (repro_torch.core.power_trace); 1 Wh = 3600 J."""
        return self.energy_j / 3600.0

    @property
    def tokens_per_s(self) -> float:
        if math.isinf(self.time.t_total):
            return 0.0
        return self.tokens / self.time.t_total


def step_energy(profile: HardwareProfile, counts: StepCounts) -> EnergyReport:
    tb = step_time(profile, counts)
    p = step_power(profile, tb)
    e = math.inf if tb.oom else p * tb.t_total
    return EnergyReport(time=tb, power_w=p, energy_j=e, tokens=counts.tokens)


# ---------------------------------------------------------------------------
# Prompt-length model (Alpaca-like) for batch padding waste
# ---------------------------------------------------------------------------

ALPACA_MEDIAN_PROMPT = 45.0
ALPACA_SIGMA = 0.75


def _norm_ppf(p: float) -> float:
    """Acklam's rational approximation of the standard normal inverse CDF."""
    if not 0.0 < p < 1.0:
        raise ValueError("p must be in (0,1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) / \
               ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1)
    if p > phigh:
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) / \
               ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1)
    q = p - 0.5
    r = q * q
    return (((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*q / \
           (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1)


def expected_prompt_len(median: float = ALPACA_MEDIAN_PROMPT,
                        sigma: float = ALPACA_SIGMA) -> float:
    return median * math.exp(sigma ** 2 / 2.0)


def expected_batch_max_len(batch: int, median: float = ALPACA_MEDIAN_PROMPT,
                           sigma: float = ALPACA_SIGMA) -> float:
    """E[max of `batch` lognormal prompt lengths] (quantile approximation)."""
    if batch <= 1:
        return expected_prompt_len(median, sigma)
    q = batch / (batch + 1.0)
    return median * math.exp(sigma * _norm_ppf(q) + sigma ** 2 / (2.0 * batch))


def prefill_report(profile: HardwareProfile, w: LLMWorkload,
                   batch: int) -> EnergyReport:
    """Prefill of one Alpaca-like batch: padded to the batch max length."""
    pad_len = expected_batch_max_len(batch)
    useful = expected_prompt_len()
    counts = prefill_counts(w, batch, pad_len, useful_seq=useful)
    return step_energy(profile, counts)


def decode_report(profile: HardwareProfile, w: LLMWorkload, batch: int,
                  context: Optional[float] = None) -> EnergyReport:
    """One decode step at an Alpaca-like context (prompt + ~75 generated)."""
    ctx = context if context is not None else expected_prompt_len() + 75.0
    return step_energy(profile, decode_counts(w, batch, ctx))


def prompt_report(profile: HardwareProfile, w: LLMWorkload, batch: int,
                  decode_tokens: int = 150) -> EnergyReport:
    """End-to-end prompt: prefill + ``decode_tokens`` decode steps (§2.1:
    the paper times 150 generated tokens per prompt).

    The decode sum is approximated by the midpoint context (KV grows
    linearly over the 150 steps, and time/energy are affine in context, so
    the midpoint is exact up to the thrash/OOM boundary, which we check at
    the final — largest — context).
    """
    pf = prefill_report(profile, w, batch)
    if math.isinf(pf.energy_j):
        return pf
    prompt_len = expected_batch_max_len(batch)
    mid = step_energy(profile, decode_counts(w, batch,
                                             prompt_len + decode_tokens / 2.0))
    last = step_energy(profile, decode_counts(w, batch,
                                              prompt_len + decode_tokens))
    if math.isinf(mid.energy_j) or math.isinf(last.energy_j):
        return EnergyReport(time=last.time, power_w=last.power_w,
                            energy_j=math.inf, tokens=0.0)
    t = pf.t_total + decode_tokens * mid.t_total
    e = pf.energy_j + decode_tokens * mid.energy_j
    tokens = float(batch * decode_tokens)
    # report per-prompt medians like the paper: time & energy of the batch
    tb = TimeBreakdown(t_compute=t, t_memory=0.0, t_collective=0.0,
                       t_overhead=0.0, thrash=1.0, oom=False)
    return EnergyReport(time=tb, power_w=e / t, energy_j=e, tokens=tokens)
