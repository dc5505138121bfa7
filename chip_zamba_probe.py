#!/usr/bin/env python3
"""The Zamba2 gradient probe of ``chip_smoke.py`` over several batches on
one NVIDIA card, to see how the ratio it holds to ``REFEREE`` is spread
and what sets its worst leaf.

    python3 chip_zamba_probe.py [--batches 8]

``zamba2-7b`` at full width cut to ``ZAMBA_PROBE_DEPTH`` layers (one
unit), random weights from seed 0, as ``phase_train_recurrent`` probes
it; batches ``RECURRENT_STEPS + 1`` onward of its ``lm_batches`` stream
(the first is the one ``chip_smoke.py`` probes). For each batch: every
gradient leaf of the bf16 kernel path, the plain bf16 path and the
float32 referee (``train_grads``), each leaf's ratio of the kernel path's
relative error from the referee to the plain bf16 path's. Prints every
batch's worst ratio and leaf, the ``A_log`` leaves' ratios, and their
spread.
"""
import argparse
import dataclasses
import gc
import statistics
import sys

import numpy as np
import torch

import chip_smoke as CS


def up(t):
    if isinstance(t, dict):
        return {k: up(v) for k, v in t.items()}
    if isinstance(t, list):
        return [up(v) for v in t]
    return t.float()


def ratios(kern, plain, truth):
    """{leaf: kernel path's relative error / the plain bf16 path's}."""
    out = {}
    for (path, gk), (_, gp), (_, gt) in zip(kern, plain, truth):
        norm = max(float(gt.norm()), 1e-30)
        rk = float((gk - gt).norm()) / norm
        rp = float((gp - gt).norm()) / norm
        out[path] = rk / max(rp, 1e-30)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_zamba_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.training.data import lm_batches
    torch.backends.cuda.matmul.allow_tf32 = False
    card = CS.card_line()
    print(card)
    build.build()
    cfg = CS.zamba_train_cut()
    depth = CS.ZAMBA_PROBE_DEPTH
    cut = dataclasses.replace(cfg, n_layers=depth,
                              block_pattern=cfg.block_pattern[:depth])
    model, params, _, _ = CS.load_model(cut, CS.ZAMBA_PROBE_PARAMS,
                                        "zamba2 probe", card)
    ref = Model(dataclasses.replace(cut, dtype="float32"), "cuda")
    ref_params = up(params)
    stream = lm_batches(0, cut.vocab, CS.TRAIN_BATCH, CS.TRAIN_SEQ,
                        CS.TRAIN_BRANCHING)
    data = [next(stream) for _ in range(CS.RECURRENT_STEPS + 1
                                        + args.batches)]
    worst, a_log = [], []
    for i in range(args.batches):
        n = CS.RECURRENT_STEPS + 1 + i
        batch = {k: torch.as_tensor(v).cuda() for k, v in data[n].items()}
        with CS.plain_ops():
            _, plain = CS.train_grads(model, params, batch)
            _, truth = CS.train_grads(ref, ref_params, batch)
        _, kern = CS.train_grads(model, params, batch)
        r = ratios(kern, plain, truth)
        leaf = max(r, key=r.get)
        worst.append(r[leaf])
        logs = {p: v for p, v in r.items() if p.endswith("A_log")}
        a_log += list(logs.values())
        print(f"batch {n}: worst ratio {r[leaf]:.4f} at {leaf}; A_log "
              + ", ".join(f"{p} {v:.4f}" for p, v in logs.items()))
        kern = plain = truth = None
        gc.collect()
        torch.cuda.empty_cache()
    print(f"worst ratio over {len(worst)} batches min {min(worst):.4f} "
          f"median {statistics.median(worst):.4f} max {max(worst):.4f}; "
          f"A_log leaves min {min(a_log):.4f} median "
          f"{statistics.median(a_log):.4f} max {max(a_log):.4f}; batches "
          f"past REFEREE {CS.REFEREE}: "
          f"{sum(x > CS.REFEREE for x in worst)} ({card})")
    print(np.round(np.array(worst), 4).tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
