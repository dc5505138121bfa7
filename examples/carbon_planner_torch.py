"""CI-directed fleet planning with the PyTorch port's metering core
(``repro_torch.core``), the same plan as ``examples/carbon_planner.py``
and its output line for line (paper §4 "CI-directed LLM serving"):

1. per-request-class placement across a heterogeneous (device, region)
   fleet under a latency SLO;
2. SplitWise-style phase disaggregation, carbon-directed;
3. a 24-hour routing simulation against diurnal CI traces, showing the
   carbon saved vs pinning to any single fleet slice.

It prices modeled steps on the host and runs no model, so it takes no
device.

    PYTHONPATH=src python examples/carbon_planner_torch.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.energy import LLAMA_1B, LLAMA_7B  # noqa: E402
from repro_torch.core.hardware import get_profile  # noqa: E402
from repro_torch.core.intensity import get_region  # noqa: E402
from repro_torch.core.scheduler import (CIDirectedScheduler,  # noqa: E402
                                        FleetSlice, place_request_class,
                                        plan_disaggregated)


def fleet():
    return [
        FleetSlice(get_profile("t4"), get_region("QC")),
        FleetSlice(get_profile("t4"), get_region("CISO")),
        FleetSlice(get_profile("rtx6000ada"), get_region("QC")),
        FleetSlice(get_profile("rtx6000ada"), get_region("CISO")),
        FleetSlice(get_profile("rtx6000ada"), get_region("PACE")),
        FleetSlice(get_profile("tpu_v5e"), get_region("CISO")),
    ]


def main():
    fl = fleet()

    print("=== 1. request-class placement (LLaMA-7B prompts) ===")
    for slo in (None, 8.0, 2.0):
        win, table = place_request_class(fl, LLAMA_7B, "prompt", slo_s=slo)
        label = "no SLO" if slo is None else f"SLO {slo:.0f}s"
        if win is None:
            print(f"  {label:<10} -> infeasible")
            continue
        print(f"  {label:<10} -> {win.slice_key:<18} batch {win.batch:<3} "
              f"{win.g_per_token:.3e} g/token, {win.latency_s:.2f}s")
    print("  (tighter SLOs force newer/faster hardware at higher carbon — "
          "Takeaway 3)")

    print("\n=== 2. carbon-directed phase disaggregation (LLaMA-1B) ===")
    plan = plan_disaggregated(fl, LLAMA_1B)
    for phase, p in plan.items():
        print(f"  {phase:<8} -> {p.slice_key:<18} batch {p.batch:<3} "
              f"{p.g_per_token:.3e} g/token")
    print("  (prefill is compute-bound, decode memory-bound — the paper's "
          "SS2.3 split exposes independent placement choices)")

    print("\n=== 3. 24h CI-directed routing (diurnal CI traces) ===")
    sched = CIDirectedScheduler(fl, LLAMA_1B, phase="prompt", batch=8)
    day = sched.simulate_day(requests_per_hour=3600)
    print(f"  routed total:  {day['total_g']:.1f} g CO2eq")
    for key, g in sorted(day["pinned_g"].items(), key=lambda kv: kv[1]):
        save = (g - day["total_g"]) / g
        print(f"  pinned {key:<18} {g:>9.1f} g  (routing saves {save:.1%})")
    hours_by_slice = {}
    for c in day["choices"]:
        hours_by_slice[c] = hours_by_slice.get(c, 0) + 1
    print(f"  hourly choices: {hours_by_slice}")


if __name__ == "__main__":
    main()
