#!/usr/bin/env python3
"""Host time of the port's eager model steps, one tree against another,
on one card.

    git archive <commit> | tar -x -C build/parent
    python3 chip_host_ab.py build/parent . . build/parent

Each ROOT (a checkout of the repo) runs in a process of its own, in the
order given: ``llama-paper-1b`` at full size (bf16, random weights from
seed 0), its kernels built from ROOT's sources, a prefill of 8 x 256
tokens and then 32 eager decode steps on the contiguous cache, timed
with the host's clock around a ``torch.cuda.synchronize()``; three
rounds, the first dropped. Prints the card's name and power limit, then
one line a root: its prefill ms and its mean decode ms a step, a round.
Needs the CUDA toolkit and one card.
"""
import os
import subprocess
import sys

STEPS = 32


def one(root: str) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    import time
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import Model
    build.build()
    cfg = get_config("llama-paper-1b")
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    tok = torch.randint(0, cfg.vocab, (8, 256), generator=gen,
                        device="cuda", dtype=torch.int32)
    rounds = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = model.prefill(params, tok, max_len=256 + STEPS)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            nxt = torch.argmax(logits[:, :cfg.vocab], -1)[:, None].int()
            for _ in range(STEPS):
                logits, caches = model.decode_step(params, caches, nxt)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rounds.append(((t1 - t0) * 1e3, (t2 - t1) / STEPS * 1e3))
    print(f"{root}: prefill ms, eager decode ms a step: "
          + ", ".join(f"{a:.2f} {b:.3f}" for a, b in rounds[1:]),
          flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
