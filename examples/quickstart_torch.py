"""Quickstart with the PyTorch + CUDA port: serve a tiny LLaMA-style model
with carbon metering, the same run as ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds a small model, submits a handful of Alpaca-like prompts through the
continuous-batching engine, and prints the per-phase carbon report — the
paper's measurement harness as three lines of user code. On the card
(the default) its attention and RMSNorm run the hand-written kernels.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.models import Model, ModelConfig, repeat_pattern  # noqa: E402
from repro_torch.serving import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.training.data import alpaca_like_prompts  # noqa: E402


def build_model(device):
    """The JAX example's model on ``device``, weights from a seeded
    generator. Returns (model, params)."""
    cfg = ModelConfig(
        name="quickstart-20m", family="dense", n_layers=4, d_model=128,
        n_heads=8, n_kv_heads=4, d_ff=512, vocab=2048, dtype="float32",
        block_pattern=repeat_pattern(("dense",), 4), vocab_pad_multiple=8)
    model = Model(cfg, device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    return model, model.init(gen)


def serve(model, params):
    """The JAX example's engine and requests. Returns (engine, responses)."""
    engine = ServingEngine(model, params, EngineConfig(
        max_batch=4, max_len=256, profile="t4", region="QC"),
        device=model.device)
    prompts = alpaca_like_prompts(seed=1, n=8, vocab=model.cfg.vocab,
                                  max_len=64)
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=list(p), max_new_tokens=24))
    return engine, engine.run()


def report(engine, responses):
    print(f"served {len(responses)} requests, "
          f"{sum(r.n_tokens for r in responses)} tokens generated\n")
    print(engine.carbon_report())
    st = engine.stats()
    print(f"\nper-token: prefill {st['prefill_j_per_token']:.3e} J, "
          f"decode {st['decode_j_per_token']:.3e} J "
          f"(decode is the expensive phase at small batch — paper §2.3)")
    print(f"embodied share of total carbon: {st['embodied_fraction']:.1%} "
          f"(QC grid — low CI makes embodied carbon prominent, Takeaway 3)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model, params = build_model(args.device)
    report(*serve(model, params))


if __name__ == "__main__":
    main()
