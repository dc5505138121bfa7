#!/usr/bin/env python3
"""Time the port's kernels against the same kernels built from other
sources, on one card, in one process.

    mkdir -p build/ab
    for f in wkv6 ssd_chunk; do
      git show <commit>:src/repro_torch/kernels/csrc/$f.cu > build/ab/$f.cu
    done
    python3 chip_kernel_ab.py build/ab

DIR holds any of ``flash_attention.cu``, ``chunked_prefill_attention.cu``,
``decode_attention.cu``, ``paged_decode_attention.cu``, ``wkv6.cu``,
``ssd_chunk.cu`` and ``rmsnorm.cu`` and the ``*.cuh`` headers they
include (an earlier tree's, or a variant of this tree's); the kernels
whose source is there are compared. Each is built with this tree's ``nvcc`` flags into
``build/kernels/`` beside this tree's own (``build.build(..., csrc=DIR)``)
and called through this tree's wrappers. At ``chip_smoke.py``'s main-path
shapes, in bf16 (chunked prefill B1 H32/32 S256 after 768 history tokens
at hd 64; flash B8 H32/32 S512, right-padded, at hd 64 and 112; decode B8
H32/32 W2048, mixed fills, and paged decode B8 H32/32 ps16 M128, fills
16-2048, at hd 64 and 112, and both again at a serving step's fills: the
engine trace's first 8 prompts, 32 tokens into their decode; each of
these attention cases also at StableLM-2-12B's hd 160 over 16 kv heads,
H32/16, GQA group 2; WKV6 at B1
H32 T1024 and B8 H32 T1 hd 64 and at the rwkv6 engine's prefills, B1 T16,
B2 T17, B1 T48 and B1 T119; the SSD chunk at B2 H112 T1024 cl256 P64 N64
in float32 and bf16 and at the zamba2 engine's prefill buckets in bf16,
B8 T128 cl128, B4 T64 cl64, B1 T32 cl32 and B1 T1024 cl256; RMSNorm's
plain row at (8, 2048), (8, 3584), (1024, 2048) and (1024, 7168), its
residual add at (8, 2048) and (1024, 2048), Zamba2's add and concat at
(8, 3584 + 3584) and Mamba2's gate at (8, 7168) and (1024, 7168); an
``rmsnorm.cu`` from before the prologues runs behind its own wrapper,
after the add, concat or gate in PyTorch, as the engines ran it), it
holds both builds to the plain version (attention: ``chip_smoke.TOL`` on valid rows;
WKV6: ``chip_smoke.WKV_REL`` of the largest output; SSD: 1e-4; RMSNorm:
``chip_smoke.TOL``; or it fails), counts each attention build's elements past
``chip_smoke.TOL_WIDE`` against the plain version run in float32
(reported, not held: a variant may be there to show that it breaks it),
and times each around the replay of a CUDA graph of 20 calls, in turns
(DIR, this tree, this tree, DIR), beside ``scaled_dot_product_attention``
with the same mask (attention only) and the least time the card could
take; RMSNorm's calls also launched eagerly (the host's cost per call,
where it exceeds the kernel's). Before the times it prints ptxas'
registers and spill bytes of every instance whose counts differ between
the two builds. A case that DIR's build refuses (a head dim or group
from after that tree) is named and left out. Needs one NVIDIA card.
"""
import functools
import json
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke

NAMES = ("flash_attention", "chunked_prefill_attention", "decode_attention",
         "paged_decode_attention", "wkv6", "ssd_chunk", "rmsnorm")


def through(csrc, call):
    """``call`` with the wrappers' kernels built from ``csrc`` (None: this
    tree's sources)."""
    from repro_torch.kernels import build

    def run():
        if csrc is None:
            return call()
        with mock.patch.object(build, "library",
                               functools.partial(build.library, csrc=csrc)):
            return call()
    return run


def plain_only_rmsnorm(csrc):
    """The wrapper of an ``rmsnorm.cu`` from before the prologues (entry
    ``rmsnorm_fwd(x, scale, y, rows, row_stride, d, eps, dtype,
    scale_dtype, device, stream)``), its checks and its call as that
    tree's ``kernels/rmsnorm.py`` made them."""
    import ctypes

    from repro_torch.kernels import build
    fn = getattr(ctypes.CDLL(str(build.build(["rmsnorm"], csrc)["rmsnorm"])),
                 "rmsnorm_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dtypes = {torch.float32: 0, torch.bfloat16: 1}

    def rmsnorm(x, scale, eps=1e-5):
        if scale.device != x.device:
            raise ValueError("scale and x on different devices")
        if x.dtype not in dtypes or scale.dtype not in dtypes:
            raise TypeError(f"rmsnorm takes {list(dtypes)}")
        if x.dim() != 2 or scale.shape != (x.shape[1],):
            raise ValueError("x must be (R, d) and scale (d,)")
        if x.stride(1) != 1:
            raise ValueError("x needs unit stride on d")
        R, d = x.shape
        y = torch.empty((R, d), dtype=x.dtype, device=x.device)
        scale = scale.contiguous()
        err = fn(x.data_ptr(), scale.data_ptr(), y.data_ptr(), R,
                 x.stride(0), d, float(eps), dtypes[x.dtype],
                 dtypes[scale.dtype], x.device.index or 0,
                 torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "rmsnorm")
        return y
    return rmsnorm


# the attention cases' (head dim, kv heads) over 32 q heads
ATTN = ((64, 32), (112, 32), (160, 16))


def ptxas_counts(name, csrc=None):
    """{instance: (registers, spill bytes)} of one build of ``name``, the
    anonymous namespace's per-file hash taken out of the mangled names so
    two trees' instances line up."""
    import re
    return {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", k): (e["regs"], e["spill"])
            for k, e in chip_smoke._ptxas_instances(name, "", csrc).items()}


def rms_check(label, got, want):
    """y of an RMSNorm call (the second of (s, y)) against the plain
    version, at ``chip_smoke.TOL`` for bf16."""
    if isinstance(got, tuple):
        got = got[1]
    rows = torch.ones_like(want, dtype=torch.bool)
    return chip_smoke.check_close(label, got, want, rows, torch.bfloat16)


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage (one NVIDIA card): python3 chip_kernel_ab.py DIR",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import chunked_prefill as CP
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode_attention as PD
    from repro_torch.kernels import ref as REF
    from repro_torch.kernels import rmsnorm as RMS
    from repro_torch.kernels import ssd as SSD
    from repro_torch.kernels import wkv6 as WKV
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card)
    base = Path(sys.argv[1]).resolve()
    names = [n for n in NAMES if (base / f"{n}.cu").exists()]
    if not names:
        print(f"chip_kernel_ab: no kernel source of {NAMES} in {base}",
              file=sys.stderr)
        return 2
    build.build(names, csrc=base)
    build.build(names)
    print(f"\n[ab] ptxas (registers, spill bytes), base -> new, of the "
          f"instances that differ ({card})")
    for n in names:
        b, w = ptxas_counts(n, base), ptxas_counts(n)
        diff = sorted(k for k in set(b) | set(w) if b.get(k) != w.get(k))
        same = sum(1 for k in set(b) & set(w) if b[k] == w[k])
        print(f"  {n}: {same} instances the same, {len(diff)} differ")
        for k in diff:
            print(f"    {k}: {b.get(k)} -> {w.get(k)}")
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = []
    for hd, hkv in ((64, 32), (160, 16)) if (
            "chunked_prefill_attention" in names) else ():
        args = chip_smoke.chunk_inputs(32, hkv, [1024], 256, bf, gen, hd=hd)
        flops, nbytes = chip_smoke.paged_traffic(
            args[3], args[4], args[5], 16, 32, hkv, hd, 2, S=256)
        cases.append(dict(label=f"chunk B1 H32/{hkv} S256 hist768 hd{hd}",
                          kernel=CP.chunked_prefill_attention,
                          plain=REF.chunked_prefill_attention, args=args,
                          sdpa=chip_smoke.chunk_sdpa(*args), qpos=args[4],
                          flops=flops, nbytes=nbytes))
    for hd, hkv in ATTN if "flash_attention" in names else ():
        q, k, v, pos = chip_smoke.flash_inputs(8, 32, hkv, 512, bf, gen, hd)
        flops, nbytes, mask = chip_smoke.flash_work(q, k, v, pos)
        cases.append(dict(
            label=f"flash B8 H32/{hkv} S512 hd{hd}",
            kernel=FA.flash_attention,
            plain=REF.flash_attention, args=(q, k, v, pos, pos),
            sdpa=lambda a=(q, k, v), m=mask, g=hkv != 32: torch.nn.
            functional.scaled_dot_product_attention(*a, attn_mask=m,
                                                    enable_gqa=g),
            qpos=pos, flops=flops, nbytes=nbytes))
    # the decode kernels also at a serving step's fills: the first 8 prompts
    # of chip_smoke.py's engine trace (one of 1,024 tokens, the rest 16-119)
    # 32 tokens into their decode, in a 2,048-key cache or table
    serving = [len(r.prompt) + 32
               for r in chip_smoke.engine_requests(32000)[:8]]
    for fills, tag in ((None, ""), (serving, " serving")):
        for hd, hkv in ATTN if "decode_attention" in names else ():
            args = chip_smoke.decode_inputs(8, 32, hkv, 2048, bf, gen, hd,
                                            fills)
            flops, nbytes = chip_smoke.decode_work(*args[:2], *args[3:])
            cases.append(dict(
                label=f"decode B8 H32/{hkv} W2048 hd{hd}{tag}",
                kernel=DA.decode_attention, plain=REF.decode_attention,
                args=args, sdpa=chip_smoke.decode_sdpa(*args), qpos=None,
                flops=flops, nbytes=nbytes))
        for hd, hkv in ATTN if "paged_decode_attention" in names else ():
            args = chip_smoke.paged_inputs(
                8, 32, hkv, fills or chip_smoke.paged_fills(), bf, gen,
                hd=hd)
            flops, nbytes = chip_smoke.paged_traffic(
                args[3], args[4], args[5], 16, 32, hkv, hd, 2)
            cases.append(dict(
                label=f"paged B8 H32/{hkv} ps16 M128 hd{hd}{tag}",
                kernel=PD.paged_decode_attention,
                plain=REF.paged_decode_attention, args=args,
                sdpa=chip_smoke.paged_sdpa(*args), qpos=None, flops=flops,
                nbytes=nbytes))
    # the scan kernels: phase 3's shapes and the engines' prefills (rwkv6:
    # exact-length groups; zamba2: power-of-two buckets), and WKV6's decode
    for B, T in ((1, 1024), (8, 1), (1, 16), (2, 17), (1, 48), (1, 119)):
        if "wkv6" not in names:
            break
        args = chip_smoke.wkv6_inputs(B, 32, T, 64, bf, gen)
        flops, nbytes = chip_smoke.wkv6_work(*args)
        cases.append(dict(label=f"wkv6 B{B} H32 T{T} hd64", kernel=WKV.wkv6,
                          plain=REF.wkv6, args=args,
                          check=chip_smoke.wkv6_check, flops=flops,
                          nbytes=nbytes, dtype=torch.float32))
    for B, T, cl, dt in ((2, 1024, 256, torch.float32), (2, 1024, 256, bf),
                         (8, 128, 128, bf), (4, 64, 64, bf), (1, 32, 32, bf),
                         (1, 1024, 256, bf)):
        if "ssd_chunk" not in names:
            break
        args = chip_smoke.ssd_inputs(B, 112, T, cl, 64, 64, dt, gen)
        flops, nbytes, peak = chip_smoke.ssd_work(*args)
        cases.append(dict(
            label=f"ssd B{B} H112 T{T} cl{cl} P64 N64 "
            f"{'bf16' if dt == bf else 'f32'}", kernel=SSD.ssd_chunk,
            plain=REF.ssd_chunk, args=args, check=chip_smoke.ssd_check,
            flops=flops, nbytes=nbytes, dtype=dt, peak=peak))
    # RMSNorm: the plain row at the llama and zamba2 paths' decode and
    # prefill rows, and the prologues at theirs; a DIR source from before
    # the prologues runs behind its own wrapper, after the add, concat or
    # gate in PyTorch, as the engines ran it
    old_abi = ("rmsnorm" in names and "int prologue"
               not in (base / "rmsnorm.cu").read_text())
    old_rms = plain_only_rmsnorm(base) if old_abi else None
    for variant, R, d in (("plain", 8, 2048), ("plain", 8, 3584),
                          ("plain", 1024, 2048), ("plain", 1024, 7168),
                          ("add", 8, 2048), ("add", 1024, 2048),
                          ("add+cat", 8, 3584), ("gate", 8, 7168),
                          ("gate", 1024, 7168)):
        if "rmsnorm" not in names:
            break
        kern, plain, _, unfused, args, nbytes = chip_smoke.rmsnorm_inputs(
            RMS, REF, variant, R, d, bf, gen)
        cases.append(dict(
            label=f"rmsnorm {variant} R{R} d{d}",
            kernel=kern, plain=plain, args=args, check=rms_check,
            flops=chip_smoke.RMS_FLOPS[variant] * R * d
            * (2 if "cat" in variant else 1),
            nbytes=nbytes, dtype=torch.float32, eager=True,
            base_call=(lambda u=unfused, a=args: u(old_rms, *a))
            if old_abi else None))
    rows_out = []
    print(f"\n[ab] ms per call from CUDA-graph replays; max abs err "
          f"against the plain version, elements past TOL_WIDE against it in "
          f"float32 (attention; bf16 unless named) ({card})")
    print(f"{'case':42s} {'base':>8s} {'new':>8s} {'new':>8s} {'base':>8s} "
          f"{'sdpa':>8s} {'bound':>8s} by      base_err  new_err  "
          f"base_wide new_wide")
    for c in cases:
        call = lambda c=c: c["kernel"](*c["args"])  # noqa: E731
        runs = {"base": c.get("base_call") or through(base, call),
                "new": through(None, call)}
        try:
            runs["base"]()
        except RuntimeError as e:   # an earlier tree without this shape
            print(f"{c['label']:42s} not taken by DIR's build: {e}")
            continue
        want = c["plain"](*c["args"])
        errs, wide = [], []
        for who in ("base", "new"):
            got = runs[who]()
            label = f"{c['label']} {who}"
            if "check" in c:           # the scan kernels
                errs.append(c["check"](label, got, want))
                wide.append(0)
                continue
            rows = (torch.ones_like(want, dtype=torch.bool)
                    if c["qpos"] is None
                    else (c["qpos"] >= 0)[:, None, :, None].expand_as(want))
            errs.append(chip_smoke.check_close(label, got, want, rows, bf))
            wide.append(chip_smoke.check_wide(got, c["plain"], c["args"],
                                              rows, bf)[1])
        times = [chip_smoke.time_ms(runs[who], graph=True)
                 for who in ("base", "new", "new", "base")]
        lib = (chip_smoke.time_ms(c["sdpa"], graph=True) if "sdpa" in c
               else None)
        bms, by = chip_smoke.bound_ms(c["flops"], c["nbytes"],
                                      c.get("dtype", bf), c.get("peak"))
        print(f"{c['label']:42s} " + " ".join(f"{t:8.4f}" for t in times)
              + (f" {lib:8.4f}" if lib is not None else f" {'-':>8s}")
              + f" {bms:8.5f} {by:7s} {errs[0]:.2e} {errs[1]:.2e}"
              f" {wide[0]:9d} {wide[1]:8d}")
        eager = ([chip_smoke.time_ms(runs[who], iters=200)
                  for who in ("base", "new", "new", "base")]
                 if c.get("eager") else None)
        if eager:
            print(f"{'':42s} eager " + " ".join(f"{t:8.4f}" for t in eager))
        rows_out.append(dict(case=c["label"], base_ms=[times[0], times[3]],
                             new_ms=[times[1], times[2]], sdpa_ms=lib,
                             bound_ms=bms, bound_by=by,
                             base_max_abs_err=errs[0],
                             new_max_abs_err=errs[1],
                             base_past_tol_wide=wide[0],
                             new_past_tol_wide=wide[1],
                             eager_ms=eager))
    print(card)
    print(json.dumps({"ab": rows_out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
