"""Copies of the JAX package's metering core (``repro.core``) with only the
import paths changed: the paper's Eq. 2-4 carbon model, the calibrated
energy model, hardware profiles, grid intensities and the per-phase
``CarbonMeter``. They must price a step bit-identically to the reference."""
from repro_torch.core.energy import (LLMWorkload, StepCounts, decode_counts,
                                     prefill_counts, step_energy)
from repro_torch.core.hardware import HardwareProfile, get_profile
from repro_torch.core.meter import CarbonMeter

__all__ = ["LLMWorkload", "StepCounts", "decode_counts", "prefill_counts",
           "step_energy", "HardwareProfile", "get_profile", "CarbonMeter"]
