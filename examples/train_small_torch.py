"""Train a small model with the PyTorch + CUDA port: the WSD schedule and
training-carbon metering (paper §4 "Sustainable LLM training"), the same
run as ``examples/train_small.py``. On the card its attention and
RMSNorm run the hand-written kernels under autograd.

Presets: --preset tiny (default, ~1M params) or --preset 100m (the
~100M-parameter configuration, sized for a real accelerator).

    PYTHONPATH=src python examples/train_small_torch.py --steps 200
    PYTHONPATH=src python examples/train_small_torch.py --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.models import Model, ModelConfig, repeat_pattern  # noqa: E402
from repro_torch.training import AdamWConfig, TrainConfig, Trainer  # noqa: E402
from repro_torch.training.data import lm_batches  # noqa: E402
from repro_torch.training.optim import unique_leaves  # noqa: E402

PRESETS = {
    "tiny": dict(n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
                 d_ff=256, vocab=512, batch=8, seq=64),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
                 d_ff=2048, vocab=32000, batch=32, seq=1024),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    p = PRESETS[args.preset]

    cfg = ModelConfig(
        name=f"train-{args.preset}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"], vocab=p["vocab"],
        dtype="float32" if args.device == "cpu" else "bfloat16",
        block_pattern=repeat_pattern(("dense",), p["n_layers"]),
        vocab_pad_multiple=8)
    model = Model(cfg, args.device)
    n_params = sum(t.numel() for _, t in unique_leaves(model.param_shapes()))
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params, WSD schedule, "
          f"{args.steps} steps on {args.device}")

    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    trainer = Trainer(model, TrainConfig(
        steps=args.steps, log_every=max(args.steps // 10, 1), warmup=10,
        schedule="wsd", optim=AdamWConfig(lr=args.lr),
        profile="h100_sxm", region="CISO"), generator=gen,
        device=args.device)
    hist = trainer.fit(lm_batches(0, cfg.vocab, batch=p["batch"],
                                  seq=p["seq"], branching=4))

    print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    print("\ntraining-run carbon (attributed to h100_sxm @ CISO):")
    print(trainer.meter.report())
    print("\npaper §4: training has no latency SLO — shifting this run to a "
          "low-CI window/region scales the operational term directly.")


if __name__ == "__main__":
    main()
