#!/usr/bin/env python3
"""Run the PyTorch + CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card: device name and count, ``nvidia-smi`` name and power limit;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` (one process per source, in parallel), printing ptxas'
   registers / shared memory / spills per kernel;
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main path's shapes, bf16 (atol 2e-2, rtol 2e-2) and float32
   (1e-4), on valid query rows; kernel, plain-version and library
   (``scaled_dot_product_attention``) times from CUDA events;
4. engine: ``llama-paper-1b`` at full width in bf16, random weights from a
   seed, serving 16 requests through ``ServingEngine``; the kernels' launch
   counts show every layer of every prefill and decode step went through
   them. A small float32 config is also served on the card and on the CPU
   (the plain path) and must agree token for token;
5. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It needs the card: with ``torch.cuda.is_available()`` false it exits 2
and prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12          # H100 SXM float32 outside the tensor cores
HBM_BPS = 3.35e12         # H100 SXM device memory bytes/s
TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
N_LAYERS = 22             # llama-paper-1b
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
DECODE_SRC = "src/repro_torch/kernels/csrc/decode_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention.py:77"
DECODE_TPU = "src/repro/kernels/decode_attention.py:130"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_ops, t_bytes = flops / peak, nbytes / HBM_BPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_close(name, got, want, rows, dtype) -> float:
    """Max abs error over valid rows; raise past atol + rtol * |want|."""
    atol, rtol = TOL[dtype]
    g, w = got.float()[rows], want.float()[rows]
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements past atol {atol} rtol {rtol}"
            f" (max abs err {err.max().item():.3e})")
    return err.max().item()


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def flash_case(FA, REF, B, Hq, Hkv, S, dtype, gen):
    dev = "cuda"
    hd = 64
    q = torch.randn(B, S, Hq, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype)
    # right-padded prompts: row b holds lens[b] real tokens
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device=dev)
    lens[0] = S
    ar = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    pos = torch.where(ar < lens[:, None], ar, torch.full_like(ar, -1))
    pos = pos.contiguous()
    # the model's layout: (B,S,H,hd) projections seen as (B,H,S,hd) views
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = FA.flash_attention(qt, kt, vt, pos, pos)
    want = REF.flash_attention(qt, kt, vt, pos, pos)
    rows = (pos >= 0)[:, None, :, None].expand_as(want)
    err = check_close(f"flash B{B} H{Hq}/{Hkv} S{S} {dtype}", got, want,
                      rows, dtype)
    mask = (pos[:, None, :, None] >= 0) & (pos[:, None, None, :] >= 0) & \
        (pos[:, None, None, :] <= pos[:, None, :, None])
    pairs = float(mask.sum().item()) * Hq
    flops = 4.0 * hd * pairs
    nbytes = float((q.numel() + k.numel() + v.numel() + q.numel())
                   * q.element_size() + 2 * pos.numel() * 4)
    bms, by = bound_ms(flops, nbytes, dtype)
    ms = time_ms(lambda: FA.flash_attention(qt, kt, vt, pos, pos))
    plain = time_ms(lambda: REF.flash_attention(qt, kt, vt, pos, pos))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by)


def decode_case(DA, REF, B, Hq, Hkv, W, dtype, gen):
    dev = "cuda"
    hd = 64
    q = torch.randn(B, Hq, hd, generator=gen, device=dev).to(dtype)
    cache_k = torch.randn(B, W, Hkv, hd, generator=gen, device=dev).to(dtype)
    cache_v = torch.randn(B, W, Hkv, hd, generator=gen, device=dev).to(dtype)
    # mixed fills: tokens written so far per slot, one slot wrapped around
    # the ring (k_pos unsorted), pad rows of a right-padded prompt at -1
    n_tok = torch.randint(16, W, (B,), generator=gen, device=dev).tolist()
    n_tok[-1] = W + W // 3
    k_pos = torch.full((B, W), -1, dtype=torch.int32)
    for b, n in enumerate(n_tok):
        t = torch.arange(max(0, n - W), n, dtype=torch.int32)
        k_pos[b, (t % W).long()] = t
        if n > 9:
            k_pos[b, 5:9] = -1
    q_pos = torch.tensor([n - 1 for n in n_tok], dtype=torch.int32)
    k_pos, q_pos = k_pos.to(dev), q_pos.to(dev)
    kt, vt = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    got = DA.decode_attention(q, kt, vt, q_pos, k_pos)
    want = REF.decode_attention(q, kt, vt, q_pos, k_pos)
    rows = torch.ones_like(want, dtype=torch.bool)
    err = check_close(f"decode B{B} H{Hq}/{Hkv} W{W} {dtype}", got, want,
                      rows, dtype)
    valid = float(((k_pos >= 0) & (k_pos <= q_pos[:, None])).sum().item())
    e = q.element_size()
    flops = valid * Hq * 4.0 * hd
    nbytes = (valid * Hkv * 2 * hd * e + 2 * q.numel() * e
              + k_pos.numel() * 4 + q_pos.numel() * 4)
    bms, by = bound_ms(flops, nbytes, dtype)
    ms = time_ms(lambda: DA.decode_attention(q, kt, vt, q_pos, k_pos))
    plain = time_ms(lambda: REF.decode_attention(q, kt, vt, q_pos, k_pos))
    mask = ((k_pos >= 0) & (k_pos <= q_pos[:, None]))[:, None, None, :]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by)


def phase_kernels(card):
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as REF
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    flash = {}
    for label, args in [
            ("flash B8 H32/32 S128 bf16", (8, 32, 32, 128, bf)),
            ("flash B8 H32/32 S512 bf16", (8, 32, 32, 512, bf)),
            ("flash B8 H32/16 S512 bf16", (8, 32, 16, 512, bf)),
            ("flash B2 H32/32 S128 f32", (2, 32, 32, 128, f32))]:
        flash[label] = flash_case(FA, REF, *args[:4], args[4], gen)
    decode = {}
    for label, args in [
            ("decode B8 H32/32 W2048 bf16", (8, 32, 32, 2048, bf)),
            ("decode B8 H32/16 W2048 bf16", (8, 32, 16, 2048, bf)),
            ("decode B8 H32/32 W2048 f32", (8, 32, 32, 2048, f32))]:
        decode[label] = decode_case(DA, REF, *args[:4], args[4], gen)
    print(f"\n[kernels] vs plain version on valid rows ({card})")
    print(f"{'case':34s} {'max_abs_err':>11s} {'ms':>9s} {'plain_ms':>9s} "
          f"{'sdpa_ms':>9s} {'bound_ms':>9s} bound_by")
    for label, r in list(flash.items()) + list(decode.items()):
        print(f"{label:34s} {r['max_abs_err']:11.3e} {r['ms']:9.4f} "
              f"{r['plain_ms']:9.4f} {r['library_ms']:9.4f} "
              f"{r['bound_ms']:9.5f} {r['bound_by']}")
    return (flash["flash B8 H32/32 S512 bf16"],
            decode["decode B8 H32/32 W2048 bf16"])


# --------------------------------------------------------------------------
# phase 4: the engine
# --------------------------------------------------------------------------


def smoke_agreement():
    """A small float32 config served on the card (kernels) and on the CPU
    (plain versions) from the same weights: identical tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("llama3.2-1b", "smoke")
    gen = torch.Generator().manual_seed(1)
    cpu_params = Model(cfg, "cpu").init(gen)
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(2, cfg.vocab, int(n)).tolist())
            for i, n in enumerate([5, 40, 70, 17, 90, 33])]
    toks = {}
    for dev in ("cpu", "cuda"):
        params = _to(cpu_params, dev)
        eng = ServingEngine(Model(cfg, dev), params,
                            EngineConfig(max_batch=4, max_len=64),
                            device=dev)
        for rid, prompt in reqs:
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=12))
        toks[dev] = {r.rid: r.tokens for r in eng.run()}
    if toks["cpu"] != toks["cuda"]:
        raise AssertionError(f"smoke tokens differ: cpu {toks['cpu']} "
                             f"cuda {toks['cuda']}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def engine_requests(vocab):
    from repro_torch.serving import Request
    from repro_torch.training.data import alpaca_like_prompts
    prompts = alpaca_like_prompts(seed=0, n=16, vocab=vocab, max_len=1024)
    # prompts of 16-1024 tokens: short ones repeat to 16, and the first is
    # stretched to 1024 so the largest prefill bucket runs too
    prompts = [np.resize(p, max(len(p), 16)) for p in prompts]
    prompts[0] = np.resize(prompts[0], 1024)
    return [Request(rid=i, prompt=p.tolist(), max_new_tokens=64)
            for i, p in enumerate(prompts)]


def phase_engine(card):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("llama-paper-1b")
    assert cfg.n_layers == N_LAYERS and cfg.dtype == "bfloat16"
    model = Model(cfg, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    ecfg = EngineConfig(max_batch=8, max_len=2048, profile="h100_sxm",
                        region="QC")
    # warm-up engine (library handles, allocator) — not counted
    warm = ServingEngine(model, params, ecfg)
    warm.submit(Request(rid=0, prompt=list(range(2, 40)), max_new_tokens=4))
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    engine = ServingEngine(model, params, ecfg)
    reqs = engine_requests(cfg.vocab)
    for r in reqs:
        engine.submit(r)
    ops.reset_launches()
    t0 = time.perf_counter()
    responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    st = engine.stats()
    for r in responses:
        if not (r.finished and r.finish_reason == "length"
                and r.n_tokens == 64):
            raise AssertionError(f"request {r.rid}: finished={r.finished} "
                                 f"reason={r.finish_reason} n={r.n_tokens}")
        if not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"request {r.rid}: token out of vocab")
    if counts["flash_attention"] < N_LAYERS * engine.prefill_batches:
        raise AssertionError(f"flash launches {counts['flash_attention']} < "
                             f"{N_LAYERS} x {engine.prefill_batches} batches")
    if counts["decode_attention"] < N_LAYERS * st["steps"] or \
            counts["decode_attention"] % N_LAYERS:
        raise AssertionError(f"decode launches {counts['decode_attention']} "
                             f"vs {N_LAYERS} x {st['steps']} micro-steps")
    gen_tokens = sum(r.n_tokens for r in responses)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    print(f"\n[engine] llama-paper-1b full width bf16, 16 requests, "
          f"{prompt_tokens} prompt tokens, {gen_tokens} generated ({card})")
    print(f"  wall {wall:.3f} s, {gen_tokens / wall:.1f} generated tokens/s "
          f"({card})")
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB ({card})")
    print(f"  prefill batches {engine.prefill_batches}, decode chunks "
          f"{engine.decode_chunks}, micro-steps with work {st['steps']}, "
          f"host syncs {engine.host_syncs}")
    print(f"  launches: {counts}")
    print(f"  modeled (h100_sxm profile, QC): prefill "
          f"{st['prefill_j_per_token']:.4e} J/token "
          f"{st['prefill_g_per_token']:.4e} g/token; decode "
          f"{st['decode_j_per_token']:.4e} J/token "
          f"{st['decode_g_per_token']:.4e} g/token")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[card] {kind}, device_count {count}")
    print(card)

    t0 = time.perf_counter()
    libs = build.build()
    print(f"\n[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s"
          f" (nvcc, sm_90a)")
    for name in libs:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}")

    flash, decode = phase_kernels(card)
    smoke_agreement()
    print("\n[smoke] llama3.2-1b smoke f32: cuda tokens == cpu tokens")
    counts = phase_engine(card)

    kernels = [
        dict(name="flash_attention", route="cuda", source=FLASH_SRC,
             replaces=FLASH_TPU, launches=counts["flash_attention"],
             **flash),
        dict(name="decode_attention", route="cuda", source=DECODE_SRC,
             replaces=DECODE_TPU, launches=counts["decode_attention"],
             **decode),
    ]
    for k in kernels:
        for key in ("max_abs_err", "ms", "plain_ms", "library_ms",
                    "bound_ms"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} not finite")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
