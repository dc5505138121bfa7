#!/usr/bin/env python3
"""Where a served trace's time goes on the card.

    python3 chip_profile.py [contiguous] [paged] [zamba2] [rwkv]
                            [llama3b] [llama3b-paged] [llama7b]
                            [internlm2] [minicpm] [stablelm] [fleet]
                            [maverick] [maverick-paged] [maverick-fleet]
                            [deepseek] [vlm] [seamless] [train]
                            [train-rwkv6] [train-zamba2] [graph-floor]

Serves ``chip_smoke.py``'s engine traces (16 requests of 64 new tokens
each, bf16, full width and depth) four times per path: cold (first use
of every shape), warm, warm under ``torch.profiler``, and warm with
CUDA's sync debug mode on, which counts every point where the host
waits for the device. On ``llama-paper-1b``, the contiguous path serves
16-1024-token prompts on the default engine and the paged path serves
the shared-system-prompt trace with the paged pool, chunked prefill
(256, pack 2) and prefix sharing; the zamba2 path serves the contiguous
path's prompts on ``zamba2-7b`` with the paged pool, and the rwkv path
on ``rwkv6-1.6b`` with the contiguous engine (exact-length prefill
groups). The dense paths serve ``chip_smoke.py``'s dense trace (12
requests of the shared-system-prompt trace, 32 new tokens each):
``llama-paper-3b`` (head dim 100) on the contiguous engine
(``llama3b``) and on the paged main path (``llama3b-paged``), and
``llama-paper-7b``, ``internlm2-20b`` (GQA group 3), ``minicpm-2b``
(padded heads, the identity map) and ``stablelm-12b`` (the parallel block
with qk-norm, head dim 160) on the paged main path. The fleet path serves
``chip_smoke.py``'s fleet trace (48 requests of 32 new tokens in two
waves, 16 of them deferred) on ``llama-paper-1b`` through
``ShardedServingEngine``: 4 shards of 8 slots on the card, carbon routing
over three grid regions. The maverick path serves ``chip_smoke.py``'s
Maverick trace (8 prompts of 64-512 tokens, then one of 8,176 alone, 32
new tokens each) on ``llama4-maverick-400b-a17b`` cut to depth 4 at full
width (chunk-local dense, moe, dense, the global moe layer; 70.2 GB) on
the contiguous engine. The maverick-paged path serves the same weights
with full attention (``chip_smoke.maverick_full_attention``) on the paged
main path (page 16, chunk 256 packed 2, prefix sharing) over the paged
trace (16 requests, 32 new tokens each), and the maverick-fleet path
``chip_smoke.py``'s fleet trace on it through ``ShardedServingEngine``
(4 shards of 8 slots, each shard's own expert capacity). The deepseek
path serves ``chip_smoke.py``'s
DeepSeek trace (8 prompts of 64-512 tokens, then one of 3,000 alone on
the scan path, 32 new tokens each) on ``deepseek-v3-671b`` cut to depth 5
at full width (3 ``mla`` and 2 ``mla_moe`` blocks, 256 experts top-8;
55.2 GB) on the contiguous engine. The vlm path serves ``chip_smoke.py``'s
VLM trace (8 text-only prompts of 64-512 tokens, 32 new tokens each) on
``llama-3.2-vision-90b`` cut to depth 10 at full width (two units of
(dense x 4, cross), the gates set non-zero; 21.65 GB) on the contiguous
engine. The seamless path runs ``chip_smoke.py``'s model-level
SeamlessM4T path (neither engine serves an encoder-decoder):
``seamless-m4t-large-v2`` in full, one prefill of 4 x 4,096 frames under
4 x 64 decoder tokens, then 32 greedy decode steps; its "engine" is
``ModelLevel``, whose host_syncs are 0 (the loop fetches nothing).
The train path runs one ``Trainer.train_step`` of ``chip_smoke.py``'s
``phase_train`` (``llama-paper-1b`` full, bf16, 4 x 1,024 tokens, the
flash and RMSNorm kernels under autograd, AdamW in place) a "micro-step"
(``ModelLevel``; host_syncs 0: the step fetches nothing); the
train-rwkv6 and train-zamba2 paths the same on ``phase_train_recurrent``'s
models: ``rwkv6-1.6b`` full and ``zamba2-7b`` at full width cut to depth
24 (``chip_smoke.zamba_train_cut``), the SSD chunk, WKV6 and the concat
and gate norms under autograd as well.
``graph-floor`` times a chain of small kernels eagerly and as one CUDA
graph (``graph_floor``). With no argument it profiles the first four.
Prints the three timed
walls, the device's busy time and idle share in the profiled run, the
host's waits (by source line) beside the engine's ``host_syncs``, the
warm wall per decode micro-step, the kernel launches per micro-step by
launch call (``cudaLaunchKernel``; the cluster launches of the decode,
``wkv6`` and ``ssd_chunk`` kernels are ``cudaLaunchKernelExC``, cuBLAS's
``cuLaunchKernelEx``; a served path's decode chunks are replays of CUDA
graphs, ``cudaGraphLaunch``, counted apart), the kernels and host ops
that take the most time, and the device time of each of the port's
kernels. Needs one NVIDIA card.
"""
import collections
import gc
import re
import sys
import time
import traceback
import warnings

import torch

import chip_smoke

# the __global__ functions of src/repro_torch/kernels/csrc/*.cu (both
# decode kernels run the split-KV core of decode_tile.cuh)
KERNELS = ("flash_tc_kernel", "flash_fwd_kernel", "chunk_tc_kernel",
           "chunk_fwd_kernel", "decode_kernel", "paged_decode_kernel",
           "ssd_chunk_kernel", "wkv6_kernel", "rmsnorm_kernel")
# the host calls that launch a kernel: the port's kernels and PyTorch's own
# use cudaLaunchKernel, the cluster launches of the decode, wkv6 and SSD
# kernels (and some library kernels) cudaLaunchKernelExC, cuBLAS's matmuls
# cuLaunchKernelEx
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def profile(card, label, model, params, ecfg, requests, engine_cls=None,
            drive=None) -> None:
    """``engine_cls`` (default ``ServingEngine``) serves ``requests()``;
    ``drive(engine, reqs)``, if given, submits and runs them (its submits
    are timed with the run)."""
    from repro_torch.serving import ServingEngine
    engine_cls = engine_cls or ServingEngine

    def serve():
        engine = engine_cls(model, params, ecfg)
        reqs = requests()
        if drive is None:
            for r in reqs:
                engine.submit(r)
        t0 = time.perf_counter()
        if drive is None:
            engine.run()
        else:
            drive(engine, reqs)
        torch.cuda.synchronize()
        return engine, time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    _, cold_wall = serve()
    _, warm_wall = serve()
    waits, waiter_syncs = host_waits(serve)
    # one engine (its pools and graphs) alive at a time: Maverick's fleet
    # fills the card with two
    gc.collect()
    torch.cuda.empty_cache()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine, wall = serve()
    # the trace's summary, built once: over a served trace's ~10^6 events
    # it takes minutes
    t0 = time.perf_counter()
    avgs = prof.key_averages()
    summary_s = time.perf_counter() - t0
    rows = [e for e in avgs
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        raise RuntimeError("the profiler recorded no device events")
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in rows)
    st = engine.stats()
    print(f"\n[profile] {label} ({card})")
    print(f"  wall: cold {cold_wall:.3f} s, warm {warm_wall:.3f} s, warm "
          f"under the profiler {wall:.3f} s (its summary took "
          f"{summary_s:.1f} s)")
    print(f"  device busy {busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall:.1%}"
          f" of the profiled wall; idle share {1 - busy_us / 1e6 / wall:.1%}")
    print(f"  host waits for the device (sync debug mode) {len(waits)}; "
          f"engine host_syncs {waiter_syncs}")
    for line, n in collections.Counter(waits).most_common(8):
        print(f"    {n:6d}  {line}")
    print(f"  prefill batches {engine.prefill_batches}, prefill chunks "
          f"{engine.prefill_chunks}, decode micro-steps {st['steps']}, warm "
          f"wall per micro-step (prefill included) "
          f"{warm_wall / max(st['steps'], 1) * 1e3:.2f} ms")
    calls = {e.key: e.count for e in avgs if e.key in LAUNCH_CALLS}
    n_launch = sum(calls.values())
    print(f"  kernel launches {n_launch} ({calls}), "
          f"{n_launch / max(st['steps'], 1):.1f} per micro-step (prefill "
          f"included)")
    graphs = getattr(engine, "graphs", None)
    if graphs is not None:
        replays = sum(e.count for e in avgs if e.key == "cudaGraphLaunch")
        print(f"  the fused decode step's CUDA graphs: {graphs.captured} "
              f"captured in {graphs.capture_s:.3f} s, {replays} graph "
              f"launches ({graphs.replays} replays; the launches above are "
              "prefill's, the captures' and the host's own)")
    print("  top kernels by device time (self, total over the run):")
    top = sorted(rows, key=lambda e: -getattr(e, "self_device_time_total", 0))
    for e in top[:15]:
        print(f"    {getattr(e, 'self_device_time_total', 0) / 1e3:10.2f} ms"
              f"  x{e.count:6d}  {e.key[:90]}")
    gap_report(prof)
    print("  the port's kernels by device time (total over the run):")
    for stem in KERNELS:
        hits = [e for e in rows
                if re.search(rf"(?<![A-Za-z_]){stem}(?:<|I)", e.key)]
        if hits:
            t = sum(getattr(e, "self_device_time_total", 0) for e in hits)
            print(f"    {t / 1e3:10.2f} ms  x{sum(e.count for e in hits):6d}"
                  f"  {stem}")
    print("  top host ops by CPU time (self):")
    host = sorted(avgs, key=lambda e: -e.self_cpu_time_total)
    for e in host[:10]:
        print(f"    {e.self_cpu_time_total / 1e3:10.2f} ms  x{e.count:6d}  "
              f"{e.key[:90]}")


def host_waits(serve):
    """One more ``serve()`` under CUDA's sync debug mode: (the host's
    waits for the device, each keyed by the innermost frame outside torch
    and by the frame inside torch that waited, if any; the engine's
    ``host_syncs``). The engine is not kept."""
    waits = []

    def record(message, *_):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack if "/torch/" not in f.filename]
        key = f"{ours[-1].filename}:{ours[-1].lineno}"
        if stack[-1] is not ours[-1]:
            key += (f" <- {stack[-1].filename}:{stack[-1].lineno} "
                    f"{stack[-1].name}")
        waits.append(key)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            waiter, _ = serve()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return waits, waiter.host_syncs


GAP_MAX_US = 1000.0        # a longer gap is the host's, not the chain's


def gap_report(prof, top: int = 10) -> None:
    """The device's gaps between consecutive kernels of the profiled run
    shorter than ``GAP_MAX_US`` (inside a chain of launches or a graph's
    replay; a longer one waits for the host), summed by the kernel that
    follows each gap, the largest first."""
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    total = collections.Counter()
    count = collections.Counter()
    end = None
    for e in kernels:
        if end is not None and 0 < e.time_range.start - end < GAP_MAX_US:
            total[e.name] += e.time_range.start - end
            count[e.name] += 1
        end = e.time_range.end if end is None else max(end,
                                                       e.time_range.end)
    print(f"  device gaps under {GAP_MAX_US:.0f} us between kernels: "
          f"{sum(total.values()) / 1e3:.2f} ms over {sum(count.values())} "
          f"gaps ({sum(total.values()) / max(sum(count.values()), 1):.2f} us "
          "a gap); by the kernel after the gap:")
    for name, us in total.most_common(top):
        print(f"    {us / 1e3:10.2f} ms  x{count[name]:6d}  "
              f"{us / count[name]:7.2f} us  {name[:80]}")


class ModelLevel:
    """An engine's face (``profile``'s reads) over a model-level path:
    ``drive_model`` runs one prefill and greedy decode steps."""
    host_syncs = 0
    prefill_chunks = 0

    def __init__(self, model, params, ecfg):
        self.model, self.params = model, params
        self.prefill_batches = 0
        self.steps = 0

    def stats(self):
        return {"steps": self.steps}


def drive_train(engine, reqs):
    """One ``Trainer.train_step`` through ``ModelLevel``'s face: its
    ``model`` is the trainer, its ``params`` the device batch."""
    engine.model.train_step(engine.params)
    engine.steps += 1


def drive_model(engine, reqs):
    """reqs: (tokens, extras, decode steps)."""
    tokens, extras, steps = reqs
    logits, caches = engine.model.prefill(
        engine.params, tokens, max_len=tokens.shape[1] + steps,
        extras=extras)
    engine.prefill_batches += 1
    chip_smoke.greedy_decode(engine.model, engine.params, caches, logits,
                             steps)
    engine.steps += steps


GRAPH_FLOOR_NODES = 2000


def graph_floor(card) -> None:
    """The card's floor for a chain of small kernels, which the graphed
    decode step is (1,300-3,400 kernel nodes a micro-step): a chain of
    ``GRAPH_FLOOR_NODES`` in-place adds on one bf16 element and on an (8,
    2,048) bf16 activation, launched eagerly and replayed as one CUDA
    graph; us a kernel from CUDA events, and the host's us to launch the
    graph."""
    for shape in ((1,), (8, 2048)):
        x = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")

        def chain():
            for _ in range(GRAPH_FLOOR_NODES):
                x.add_(1)

        def timed(run, reps=5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            run()
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                run()
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) * 1e3 / reps / GRAPH_FLOOR_NODES

        eager = timed(chain)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, stream=stream):
            chain()
        replay = timed(graph.replay)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        host = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        print(f"\n[graph floor] {GRAPH_FLOOR_NODES} in-place adds on a bf16 "
              f"tensor of {shape} ({card}): eager {eager:.2f} us a kernel, "
              f"graph replay {replay:.2f} us a kernel; the host {host:.1f} "
              "us to launch the graph")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig
    known = ["contiguous", "paged", "zamba2", "rwkv", "fleet", "maverick",
             "maverick-paged", "maverick-fleet", "deepseek", "vlm",
             "seamless"]
    # train path -> its config
    trains = {"train": lambda: get_config(chip_smoke.TRAIN),
              "train-rwkv6": lambda: get_config(chip_smoke.RWKV),
              "train-zamba2": chip_smoke.zamba_train_cut}
    # path -> (config, paged main path)
    dense = {"llama3b": ("llama-paper-3b", False),
             "llama3b-paged": ("llama-paper-3b", True),
             "llama7b": ("llama-paper-7b", True),
             "internlm2": ("internlm2-20b", True),
             "minicpm": ("minicpm-2b", True),
             "stablelm": ("stablelm-12b", True)}
    paths = sys.argv[1:] or known[:4]
    unknown = (set(paths) - set(known) - set(dense) - set(trains)
               - {"graph-floor"})
    if unknown:
        print(f"chip_profile: unknown paths {sorted(unknown)}", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    if "graph-floor" in paths:
        graph_floor(card)
    base = dict(max_batch=8, max_len=2048, profile="h100_sxm", region="QC")

    def gen_of(seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return gen

    def load(arch):
        cfg = get_config(arch)
        model = Model(cfg, "cuda")
        return cfg, model, model.init(gen_of(0))

    if {"contiguous", "paged", "fleet"} & set(paths):
        cfg, model, params = load("llama-paper-1b")
        if "contiguous" in paths:
            profile(card, "contiguous", model, params, EngineConfig(**base),
                    lambda: chip_smoke.engine_requests(cfg.vocab))
        if "paged" in paths:
            profile(card, "paged", model, params,
                    EngineConfig(**base, paged=True, page_size=16,
                                 prefill_chunk=256, prefill_pack=2,
                                 prefix_sharing=True),
                    lambda: chip_smoke.paged_requests(cfg.vocab))
        if "fleet" in paths:
            from repro_torch.serving import ShardedServingEngine
            profile(card, "fleet (4 shards x 8 slots, carbon routing, "
                    "deferral)", model, params, chip_smoke.fleet_config(),
                    lambda: chip_smoke.fleet_requests(cfg.vocab),
                    engine_cls=ShardedServingEngine,
                    drive=chip_smoke.drive_fleet)
        del model, params
        torch.cuda.empty_cache()
    if "zamba2" in paths:
        cfg, model, params = load("zamba2-7b")
        profile(card, "zamba2 paged", model, params,
                EngineConfig(**base, paged=True, page_size=16),
                lambda: chip_smoke.engine_requests(cfg.vocab))
        del model, params
        torch.cuda.empty_cache()
    if "rwkv" in paths:
        cfg, model, params = load("rwkv6-1.6b")
        profile(card, "rwkv6 contiguous", model, params, EngineConfig(**base),
                lambda: chip_smoke.engine_requests(cfg.vocab))
        del model, params
        torch.cuda.empty_cache()
    if "maverick" in paths:
        cfg = chip_smoke.maverick_cut()
        model = Model(cfg, "cuda")
        params = model.init(gen_of(0))
        profile(card, f"{cfg.name} depth {cfg.n_layers} contiguous", model,
                params, EngineConfig(**dict(
                    base, max_len=chip_smoke.MAVERICK_MAX_LEN)),
                lambda: chip_smoke.maverick_requests(cfg.vocab))
        del model, params
        torch.cuda.empty_cache()
    if {"maverick-paged", "maverick-fleet"} & set(paths):
        cfg = chip_smoke.maverick_full_attention()
        model = Model(cfg, "cuda")
        params = model.init(gen_of(0))
        if "maverick-paged" in paths:
            profile(card, f"{cfg.name} depth {cfg.n_layers} full attention "
                    "paged", model, params,
                    EngineConfig(**base, paged=True, page_size=16,
                                 prefill_chunk=256, prefill_pack=2,
                                 prefix_sharing=True),
                    lambda: chip_smoke.paged_requests(
                        cfg.vocab, chip_smoke.MAVERICK_NEW))
        if "maverick-fleet" in paths:
            from repro_torch.serving import ShardedServingEngine
            profile(card, f"{cfg.name} depth {cfg.n_layers} full attention "
                    "fleet (4 shards x 8 slots, carbon routing, deferral)",
                    model, params, chip_smoke.fleet_config(),
                    lambda: chip_smoke.fleet_requests(cfg.vocab),
                    engine_cls=ShardedServingEngine,
                    drive=chip_smoke.drive_fleet)
        del model, params
        torch.cuda.empty_cache()
    if "deepseek" in paths:
        cfg = chip_smoke.deepseek_cut()
        model = Model(cfg, "cuda")
        params = model.init(gen_of(0))
        profile(card, f"{cfg.name} depth {cfg.n_layers} contiguous", model,
                params, EngineConfig(**dict(
                    base, max_len=chip_smoke.DEEPSEEK_MAX_LEN)),
                lambda: chip_smoke.deepseek_requests(cfg.vocab))
        del model, params
        torch.cuda.empty_cache()
    if "vlm" in paths:
        cfg = chip_smoke.vlm_cut()
        model = Model(cfg, "cuda")
        params = model.init(gen_of(0))
        chip_smoke.set_gates(params)
        profile(card, f"{cfg.name} depth {cfg.n_layers} contiguous "
                "(text-only)", model, params, EngineConfig(**dict(
                    base, max_len=chip_smoke.VLM_MAX_LEN)),
                lambda: chip_smoke.vlm_requests(cfg.vocab))
        del model, params
        torch.cuda.empty_cache()
    if "seamless" in paths:
        cfg, model, params = load(chip_smoke.SEAMLESS)
        profile(card, f"{cfg.name} model level (prefill over 4 x "
                f"{cfg.encoder_seq} frames, {chip_smoke.SEAMLESS_STEPS} "
                "decode steps)", model, params, None,
                lambda: (*chip_smoke.seamless_inputs(cfg, gen_of(0)),
                         chip_smoke.SEAMLESS_STEPS),
                engine_cls=ModelLevel, drive=drive_model)
        del model, params
        torch.cuda.empty_cache()
    for path in [p for p in paths if p in trains]:
        from repro_torch.training import AdamWConfig, TrainConfig, Trainer
        from repro_torch.training.data import lm_batches
        cfg = trains[path]()
        model = Model(cfg, "cuda")
        params = model.init(gen_of(0))
        trainer = Trainer(model, TrainConfig(
            steps=chip_smoke.TRAIN_STEPS, warmup=chip_smoke.TRAIN_WARMUP,
            optim=AdamWConfig(lr=chip_smoke.TRAIN_LR), profile="h100_sxm",
            region="CISO"), device="cuda", params=params)
        batch = trainer.device_batch(next(lm_batches(
            0, cfg.vocab, chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ,
            chip_smoke.TRAIN_BRANCHING)))
        profile(card, f"{cfg.name} depth {cfg.n_layers} train step "
                f"({chip_smoke.TRAIN_BATCH} x {chip_smoke.TRAIN_SEQ} tokens, "
                "AdamW)", trainer, batch,
                None, lambda: None, engine_cls=ModelLevel,
                drive=drive_train)
        del model, params, trainer
        torch.cuda.empty_cache()
    for path in [p for p in paths if p in dense]:
        arch, paged = dense[path]
        cfg, model, params = load(arch)
        ecfg = (EngineConfig(**base, paged=True, page_size=16,
                             prefill_chunk=256, prefill_pack=2,
                             prefix_sharing=True) if paged
                else EngineConfig(**base))
        profile(card, f"{arch} {'paged' if paged else 'contiguous'}", model,
                params, ecfg, lambda: chip_smoke.dense_requests(cfg.vocab))
        del model, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
