#!/usr/bin/env python3
"""Where a served trace's time goes on the card.

    python3 chip_profile.py

Serves ``chip_smoke.py``'s engine trace (``llama-paper-1b`` at full width,
bf16, 16 requests of 16-1024 prompt tokens, 64 new tokens each) three
times on one model: cold (first use of every shape), warm, and warm under
``torch.profiler``. Prints the three wall times, the device's busy time
and idle share in the profiled run, the warm wall per decode micro-step,
and the kernels and host ops that take the most time. Needs one NVIDIA
card.
"""
import sys
import time

import torch

import chip_smoke


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, ServingEngine
    card = chip_smoke.card_line()
    cfg = get_config("llama-paper-1b")
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    ecfg = EngineConfig(max_batch=8, max_len=2048, profile="h100_sxm",
                        region="QC")

    def serve():
        engine = ServingEngine(model, params, ecfg)
        for r in chip_smoke.engine_requests(cfg.vocab):
            engine.submit(r)
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        return engine, time.perf_counter() - t0

    _, cold_wall = serve()
    _, warm_wall = serve()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine, wall = serve()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        raise RuntimeError("the profiler recorded no device events")
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in rows)
    st = engine.stats()
    print(f"[profile] {card}")
    print(f"  wall: cold {cold_wall:.3f} s, warm {warm_wall:.3f} s, warm "
          f"under the profiler {wall:.3f} s")
    print(f"  device busy {busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall:.1%}"
          f" of the profiled wall; idle share {1 - busy_us / 1e6 / wall:.1%}")
    print(f"  prefill batches {engine.prefill_batches}, decode micro-steps "
          f"{st['steps']}, warm wall per micro-step (prefill included) "
          f"{warm_wall / max(st['steps'], 1) * 1e3:.2f} ms")
    print("  top kernels by device time (self, total over the run):")
    top = sorted(rows, key=lambda e: -getattr(e, "self_device_time_total", 0))
    for e in top[:15]:
        print(f"    {getattr(e, 'self_device_time_total', 0) / 1e3:10.2f} ms"
              f"  x{e.count:6d}  {e.key[:90]}")
    print("  top host ops by CPU time (self):")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:10]:
        print(f"    {e.self_cpu_time_total / 1e3:10.2f} ms  x{e.count:6d}  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
