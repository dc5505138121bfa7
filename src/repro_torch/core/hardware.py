"""Hardware profiles for the energy/carbon models.

The paper characterizes two NVIDIA GPUs (RTX6000 Ada, T4 — Table 1). We keep
those as first-class profiles (their perf/power constants are *calibrated*
against the paper's measurements, see ``benchmarks/calibration.py``) and add
the TPU profiles the paper's §4 calls for ("Characterization of diverse LLM
hardware platforms"). TPU v5e is the compile target of the whole framework:
its roofline terms come from real XLA lowering (``launch/dryrun.py``).

Units: FLOP/s, bytes/s, bytes, watts, seconds, mm², nm, GB.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

GB = 1024**3
TFLOPS = 1e12
GBPS = 1e9


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """One accelerator type.

    Performance-model fields (``eff_*``, ``step_overhead_s``, ``idle_w``,
    ``power_alpha``, ``thrash_knee``/``thrash_slope``) are calibration
    parameters of the analytical model in :mod:`repro_torch.core.energy`; the
    physical fields (peak flops, bandwidth, TDP, die area, node, memory)
    are from public spec sheets (paper Table 1 and vendor documentation).
    """

    name: str
    vendor: str
    year: int
    family: str                      # "gpu" | "tpu"
    # --- physical specs ---
    peak_flops_bf16: float           # dense tensor/matrix FLOP/s
    hbm_bw: float                    # bytes/s
    mem_bytes: float
    tdp_w: float
    die_mm2: float
    tech_node_nm: float
    mem_gb: float
    mem_type: str                    # "GDDR6" | "HBM2" | "HBM2e" | "HBM3"
    # interconnect (TPU): per-chip aggregate ICI bandwidth, bytes/s
    ici_bw: float = 0.0              # intra-pod, per link
    dci_bw: float = 0.0              # inter-pod (data-center network), per chip
    # --- calibrated performance-model parameters ---
    eff_compute: float = 0.55        # achievable fraction of peak FLOP/s
    eff_memory: float = 0.75         # achievable fraction of peak HBM bw
    step_overhead_s: float = 2e-3    # fixed per-step launch/runtime overhead
    idle_w: float = 20.0             # power at util ~ 0 (but clocks up)
    power_alpha: float = 0.8         # P = idle + (tdp-idle) * util**alpha
    # memory-oversubscription ("thrash") model: latency multiplier once the
    # working set approaches capacity; hard OOM above ``oom_frac``.
    thrash_knee: float = 0.92        # fraction of capacity where slowdown starts
    thrash_slope: float = 80.0       # multiplier growth per fraction beyond knee
    oom_frac: float = 1.0            # working set / capacity that hard-OOMs
    # tokens at which the compute units reach ~50% of their peak-efficiency
    # ramp (older, smaller chips saturate with fewer tokens in flight).
    sm_saturation_tokens: float = 500.0
    # extra KV-cache read traffic factor for devices without fused
    # (flash-style) attention kernels — old GPUs re-materialize attention
    # intermediates (paper Fig. 3: T4 decode scales poorly with batch).
    kv_read_inefficiency: float = 1.0

    @property
    def peak_flops(self) -> float:
        return self.peak_flops_bf16

    def fits(self, working_set_bytes: float) -> bool:
        return working_set_bytes <= self.oom_frac * self.mem_bytes

    def thrash_multiplier(self, working_set_bytes: float) -> float:
        """Latency multiplier when the working set nears capacity.

        Reproduces the paper's observation that T4 running LLaMA-7B at batch
        size 4 (working set ~15.7/16 GB) is 11.4x slower than Ada rather than
        the ~3x the bandwidth ratio alone predicts.
        """
        frac = working_set_bytes / self.mem_bytes
        if frac <= self.thrash_knee:
            return 1.0
        return 1.0 + self.thrash_slope * (frac - self.thrash_knee)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# Paper Table 1 devices. eff/overhead/idle/alpha/kv-inefficiency calibrated
# against the paper's Figures 1-3 via repro_torch.core.calibrate (the fitted
# constants are frozen here; tests/test_paper_claims.py validates the
# held-out claims).
# Fitted 2026-07 via repro_torch.core.calibrate (score 0.145; worst residual 22%
# on the 7B batch-1 latency ratio; all four batch-position anchors exact).
# These are *effective* parameters of a 2-resource roofline — e.g. T4's
# kv_read_inefficiency ~ 11 folds in everything the paper's HF/eager T4
# runs lost on attention at large batch (no fused flash-decode on Turing).
RTX6000ADA = HardwareProfile(
    name="rtx6000ada", vendor="nvidia", year=2023, family="gpu",
    peak_flops_bf16=364e12,          # Ada Lovelace FP16/BF16 tensor, dense
    hbm_bw=960 * GBPS,
    mem_bytes=48 * GB, mem_gb=48, mem_type="GDDR6",
    tdp_w=300.0, die_mm2=608.4, tech_node_nm=5,
    eff_compute=0.7400, eff_memory=0.5712,
    step_overhead_s=5.744e-3, idle_w=54.18, power_alpha=0.7034,
    sm_saturation_tokens=1463.3, kv_read_inefficiency=1.209,
)

T4 = HardwareProfile(
    name="t4", vendor="nvidia", year=2018, family="gpu",
    peak_flops_bf16=65e12,           # Turing FP16 tensor, dense
    hbm_bw=320 * GBPS,
    mem_bytes=16 * GB, mem_gb=16, mem_type="GDDR6",
    tdp_w=70.0, die_mm2=545.0, tech_node_nm=12,
    eff_compute=0.1668, eff_memory=0.9101,
    step_overhead_s=2.296e-3, idle_w=31.90, power_alpha=1.8802,
    sm_saturation_tokens=1536.1, kv_read_inefficiency=11.285,
    thrash_knee=0.80, thrash_slope=545.9, oom_frac=0.92,
)

# TPU profiles — the paper's §4 extension. v5e numbers are the hardware
# constants mandated for the roofline analysis: 197 TFLOP/s bf16, 819 GB/s
# HBM, ~50 GB/s per ICI link.
TPU_V5E = HardwareProfile(
    name="tpu_v5e", vendor="google", year=2023, family="tpu",
    peak_flops_bf16=197e12,
    hbm_bw=819 * GBPS,
    mem_bytes=16 * GB, mem_gb=16, mem_type="HBM2e",
    tdp_w=220.0, die_mm2=325.0, tech_node_nm=5,
    ici_bw=50 * GBPS,                 # per link
    dci_bw=25 * GBPS,                 # inter-pod per chip (DCN), conservative
    eff_compute=0.55, eff_memory=0.80,
    step_overhead_s=0.3e-3, idle_w=55.0, power_alpha=0.75,
)

TPU_V5P = HardwareProfile(
    name="tpu_v5p", vendor="google", year=2023, family="tpu",
    peak_flops_bf16=459e12,
    hbm_bw=2765 * GBPS,
    mem_bytes=95 * GB, mem_gb=95, mem_type="HBM2e",
    tdp_w=350.0, die_mm2=600.0, tech_node_nm=5,
    ici_bw=100 * GBPS, dci_bw=25 * GBPS,
    eff_compute=0.55, eff_memory=0.80,
    step_overhead_s=0.3e-3, idle_w=85.0, power_alpha=0.75,
)

# An older-generation TPU, used for the paper's old-vs-new study transplanted
# onto the TPU fleet (Takeaways 1/3/5).
TPU_V3 = HardwareProfile(
    name="tpu_v3", vendor="google", year=2018, family="tpu",
    peak_flops_bf16=123e12,
    hbm_bw=900 * GBPS,
    mem_bytes=32 * GB, mem_gb=32, mem_type="HBM2",
    tdp_w=220.0, die_mm2=648.0, tech_node_nm=16,
    ici_bw=70 * GBPS, dci_bw=12 * GBPS,
    eff_compute=0.45, eff_memory=0.72,
    step_overhead_s=0.5e-3, idle_w=60.0, power_alpha=0.75,
)

A100_40G = HardwareProfile(
    name="a100_40g", vendor="nvidia", year=2020, family="gpu",
    peak_flops_bf16=312e12,
    hbm_bw=1555 * GBPS,
    mem_bytes=40 * GB, mem_gb=40, mem_type="HBM2",
    tdp_w=400.0, die_mm2=826.0, tech_node_nm=7,
    eff_compute=0.50, eff_memory=0.80,
    step_overhead_s=4.0e-3, idle_w=55.0, power_alpha=0.65,
)

H100_SXM = HardwareProfile(
    name="h100_sxm", vendor="nvidia", year=2023, family="gpu",
    peak_flops_bf16=989e12,
    hbm_bw=3350 * GBPS,
    mem_bytes=80 * GB, mem_gb=80, mem_type="HBM3",
    tdp_w=700.0, die_mm2=814.0, tech_node_nm=5,
    eff_compute=0.50, eff_memory=0.82,
    step_overhead_s=3.5e-3, idle_w=90.0, power_alpha=0.60,
)

REGISTRY: Dict[str, HardwareProfile] = {
    p.name: p
    for p in [RTX6000ADA, T4, TPU_V5E, TPU_V5P, TPU_V3, A100_40G, H100_SXM]
}


def get_profile(name: str) -> HardwareProfile:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware profile {name!r}; known: {sorted(REGISTRY)}"
        ) from None


def register_profile(profile: HardwareProfile, overwrite: bool = False) -> None:
    if profile.name in REGISTRY and not overwrite:
        raise ValueError(f"profile {profile.name!r} already registered")
    REGISTRY[profile.name] = profile
