"""End-to-end serving example with the PyTorch + CUDA port, the same run as
``examples/serve_e2e.py``: a ~25M-param llama-style model served with
batched requests under three deployment scenarios — new GPU in a dirty
grid, old GPU in a clean grid, and a TPU v5e — reproducing the paper's
central comparison live on the engine. Each scenario serves the same
requests and meters them at its profile and region; the model runs on
this machine's card (the default) or its CPU.

    PYTHONPATH=src python examples/serve_e2e_torch.py [--requests 24]
    PYTHONPATH=src python examples/serve_e2e_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.models import Model, ModelConfig, repeat_pattern  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.training.data import alpaca_like_prompts  # noqa: E402

SCENARIOS = [
    ("rtx6000ada", "PACE", "new GPU, coal/gas grid"),
    ("rtx6000ada", "QC", "new GPU, hydro grid"),
    ("t4", "QC", "old GPU, hydro grid (paper's winner at small batch)"),
    ("tpu_v5e", "CISO", "TPU pod slice, gas/solar grid (paper SS4 extension)"),
]


def build_model(device):
    """The JAX example's model on ``device``, weights from a seeded
    generator. Returns (model, params)."""
    cfg = ModelConfig(
        name="serve-25m", family="dense", n_layers=6, d_model=160,
        n_heads=8, n_kv_heads=4, d_ff=640, vocab=4096, dtype="float32",
        block_pattern=repeat_pattern(("dense",), 6), vocab_pad_multiple=8)
    model = Model(cfg, device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    return model, model.init(gen)


def run(model, params, requests, max_new_tokens):
    """Serve the JAX example's prompts once per scenario, printing each
    scenario's carbon report. Returns [(profile, region, desc, engine)]."""
    prompts = alpaca_like_prompts(seed=7, n=requests,
                                  vocab=model.cfg.vocab, max_len=96)
    results = []
    for profile, region, desc in SCENARIOS:
        engine = ServingEngine(model, params, EngineConfig(
            max_batch=8, max_len=256, profile=profile, region=region),
            device=model.device)
        for i, p in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=list(p),
                                  max_new_tokens=max_new_tokens))
        resps = engine.run()
        assert all(r.finished for r in resps)
        results.append((profile, region, desc, engine))
        print(f"\n--- {profile} @ {region} ({desc}) ---")
        print(engine.carbon_report())
    return results


def compare(results):
    print("\n=== scenario comparison (same workload) ===")
    print(f"{'scenario':<24} {'energy J':>10} {'carbon g':>12} "
          f"{'g/token':>12} {'embodied %':>10}")
    stats = [(profile, region, desc, engine.stats())
             for profile, region, desc, engine in results]
    for profile, region, desc, st in stats:
        print(f"{profile + '@' + region:<24} {st['total_energy_j']:>10.1f} "
              f"{st['total_carbon_g']:>12.3e} "
              f"{st['total_carbon_g'] / max(st['decode_tokens'] + st['prefill_tokens'], 1):>12.3e} "
              f"{st['embodied_fraction']:>10.1%}")
    best = min(stats, key=lambda r: r[3]["total_carbon_g"])
    print(f"\nlowest-carbon deployment: {best[0]}@{best[1]} — {best[2]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model, params = build_model(args.device)
    compare(run(model, params, args.requests, args.max_new_tokens))


if __name__ == "__main__":
    main()
