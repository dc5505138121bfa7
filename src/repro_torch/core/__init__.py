"""Copies of the JAX package's metering core (``repro.core``) with only the
import paths changed: the paper's Eq. 2-4 carbon model, the calibrated
energy model, hardware profiles, grid intensities, the per-phase
``CarbonMeter``, and the measured-power side: ``PowerTrace`` integrates a
sampled power log over a request window, ``calibrate`` fits a profile's
free parameters to such traces. They must price a step bit-identically to
the reference."""
from repro_torch.core.energy import (LLMWorkload, StepCounts, decode_counts,
                                     prefill_counts, step_energy)
from repro_torch.core.hardware import HardwareProfile, get_profile
from repro_torch.core.meter import CarbonMeter
from repro_torch.core.power_trace import (ActiveWindow, LabeledSegment,
                                          PowerTrace, SegmentPlan,
                                          normalized, synthesize_trace)

__all__ = ["LLMWorkload", "StepCounts", "decode_counts", "prefill_counts",
           "step_energy", "HardwareProfile", "get_profile", "CarbonMeter",
           "ActiveWindow", "LabeledSegment", "PowerTrace", "SegmentPlan",
           "normalized", "synthesize_trace"]
