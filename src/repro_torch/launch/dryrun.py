"""Dry-run of every (architecture x input shape) on the production meshes
(the port of ``repro.launch.dryrun``): no device and no allocation.

The reference lowers and compiles each step on placeholder devices and
reads XLA's memory and cost analyses. Here the model is built on the
``meta`` device (shapes, no storage) and, for each record:

  * ``memory``: one device's argument bytes from the placements
    (``sharding.rules``): the parameters, plus AdamW's two moments for
    ``train`` (bfloat16 moments over 2e10 parameters, as the reference),
    plus the caches for ``decode`` (``Model.init_cache`` placed by
    ``_CACHE_AXES``), plus the inputs; the reference's
    ``argument_size_in_bytes``. Temporaries are not counted (no compiler
    plans them), and the record says so.
  * ``roofline``: one chip's FLOPs, bytes and collectives, counted by
    ``launch.op_cost`` over the whole step run as the model's DTensor
    program on meta tensors (``train``: the forward and backward of
    ``train_loss`` and the AdamW update; ``prefill``; ``decode``: one
    decode step on the contiguous cache and its argmax): the parameters
    placed by ``sharding.rules.distribute_params``, the caches by their
    rules, the step under ``use_sharding(mesh, rules)`` as the
    reference's (``rules``: ``LONG_CONTEXT_RULES`` for ``long_500k``).
    What one rank runs is counted: its local ops, and every collective
    that the model's ``shard()`` sites, its kernels' ``local_op``s, the
    FSDP weight gathers, DTensor's own propagation and the
    expert-parallel MoE issue, by op, with per-chip ring wire bytes split
    into ICI (within a pod) and DCN (across pods). Beside them
    ``model_flops`` (``models.costing``). ``t_collective`` prices the
    wire bytes with ``analysis.H100_LINKS`` (the record states the
    assumption). A CPU mesh (this dry-run's ``fake`` group, and gloo)
    moves a shard from one dim to another with an all-gather where NCCL
    would take an all-to-all (DTensor's CPU path); the counts are of that
    path.

The mesh is ``init_device_mesh`` over a ``fake`` process group of the
mesh's size, set up here in code (``launch.mesh.fake_group``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k [--test-mesh] [--multi-pod] --out results.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out r.jsonl
"""
import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import analysis
from repro_torch.launch.mesh import (fake_group, make_production_mesh,
                                     make_test_mesh)
from repro_torch.launch.op_cost import OpCounter, tensor_bytes
from repro_torch.models import Model
from repro_torch.models.costing import model_flops
from repro_torch.sharding.api import (ShardingContext, axis_sizes, local_op,
                                      local_shape, use_sharding)
from repro_torch.sharding.rules import CACHE_AXES as _CACHE_AXES  # noqa
from repro_torch.sharding.rules import (DEFAULT_RULES, LONG_CONTEXT_RULES,
                                        cache_axes, distribute_params,
                                        param_spec, tree_map_with_path)
from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update

# The assigned input shapes.
INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

I32 = torch.int32
META = torch.device("meta")
TEMPORARIES = "not counted: no compiler plans the temporaries"


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def variant_for(shape_name: str) -> str:
    return "long" if shape_name == "long_500k" else "full"


def extras_specs(cfg, batch: int, seq: int, kind: str) -> Dict:
    """Meta tensors of the stub-frontend inputs."""
    dt = getattr(torch, cfg.dtype)
    ex: Dict = {}
    if kind == "decode":
        return ex
    if cfg.family == "vlm":
        ex["image_embeds"] = meta((batch, cfg.n_image_tokens, cfg.d_model),
                                  dt)
    elif cfg.family == "audio":
        ex["frames"] = meta((batch, cfg.encoder_seq, cfg.d_model), dt)
    elif cfg.family == "moe" and cfg.attn_chunk is not None:
        n_img = 256
        ex["image_embeds"] = meta((batch, n_img, cfg.d_model), dt)
        ex["image_positions"] = meta((batch, n_img), I32)
    return ex


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _local_bytes(t: torch.Tensor, spec, mesh, dtype=None) -> int:
    n = math.prod(local_shape(tuple(t.shape), spec, mesh))
    return n * tensor_bytes(meta((1,), dtype or t.dtype))


def argument_bytes(model: Model, kind: str, batch: int, seq: int, mesh,
                   fsdp: bool, rules) -> Dict[str, float]:
    """One device's argument bytes by part (``param_bytes``,
    ``optimizer_bytes``, ``cache_bytes``, ``input_bytes``) and their sum
    (``argument_size_in_bytes``). ``mesh``: a ``DeviceMesh`` or a
    shape-only one (``{"data": 1, "model": 1}``-shaped)."""
    cfg = model.cfg
    ctx = ShardingContext(mesh=mesh, rules=rules)
    pshapes = model.param_shapes()
    seen, pbytes, n_params, opt = set(), 0, 0, 0
    spec_of = {path: param_spec(cfg, path, tuple(x.shape), mesh, fsdp)
               for path, x in _leaves(pshapes)}
    for path, x in _leaves(pshapes):
        if id(x) in seen:                   # a shared block counts once
            continue
        seen.add(id(x))
        pbytes += _local_bytes(x, spec_of[path], mesh)
        n_params += x.numel()
    out = {"param_bytes": float(pbytes)}
    if kind == "train":
        mdt = torch.bfloat16 if n_params > 2e10 else torch.float32
        seen.clear()
        for path, x in _leaves(pshapes):
            if id(x) not in seen:
                seen.add(id(x))
                opt += 2 * _local_bytes(x, spec_of[path], mesh, mdt)
        out["optimizer_bytes"] = float(opt)
        out["moment_dtype"] = str(mdt).replace("torch.", "")
    cbytes = 0
    if kind == "decode":
        caches = Model(cfg, META).init_cache(batch, seq)
        for path, x in _leaves(caches):
            cbytes += _local_bytes(x, ctx.spec(cache_axes(path[-1], x.ndim)),
                                   mesh)
        out["cache_bytes"] = float(cbytes)
    inputs = {"tokens": meta((batch, 1 if kind == "decode" else seq), I32)}
    if kind == "train":
        inputs["labels"] = meta((batch, seq), I32)
    inputs.update(extras_specs(cfg, batch, seq, kind))
    ibytes = sum(_local_bytes(x, ctx.spec(["batch"] + [None] * (x.ndim - 1)),
                              mesh) for x in inputs.values())
    out["input_bytes"] = float(ibytes)
    out["argument_size_in_bytes"] = float(pbytes + opt + cbytes + ibytes)
    return out


# --------------------------------------------------------------------------
# the counted steps
# --------------------------------------------------------------------------


def run_step(model: Model, kind: str, params, tokens, *, labels=None,
             extras=None, caches=None, max_len: int = 0,
             opt_cfg: AdamWConfig = None, remat: bool = True):
    """One step of ``kind`` as the dry-run counts it: ``train`` (the
    forward and backward of ``train_loss``, then the AdamW update, the
    parameters' ``.grad`` left in place), ``prefill`` (``max_len`` wide
    caches made inside) or ``decode`` (one step on ``caches``, or on fresh
    ``max_len`` wide ones, and the argmax). Returns (loss, metrics) or
    (logits, caches)."""
    cfg = model.cfg
    if kind == "train":
        for _, x in _leaves(params):
            x.requires_grad_(True)
        loss, metrics = model.train_loss(params, {"tokens": tokens,
                                            "labels": labels,
                                            **(extras or {})}, remat=remat)
        loss.backward()
        grads = tree_map_with_path(lambda p, x: x.grad, params)
        adamw_update(params, grads, adamw_init(params, opt_cfg), opt_cfg,
                     1.0)
        return loss, metrics
    with torch.no_grad():
        if kind == "prefill":
            return model.prefill(params, tokens, max_len=max_len,
                                 extras=extras or None)
        if caches is None:
            caches = model.placed_cache(params, tokens.shape[0], max_len)
        logits, caches = model.decode_step(params, caches, tokens)
        # the greedy token, over the whole vocab of each rank's rows
        local_op(lambda t: torch.argmax(t[..., :cfg.vocab], dim=-1),
                 [("batch", None)], ("batch",))(logits)
        return logits, caches


def count_step(model: Model, kind: str, batch: int, seq: int,
               opt_cfg: AdamWConfig, pod_size: int = 0, remat: bool = True,
               mesh=None, rules=None, fsdp: bool = True):
    """op_cost of one step on meta tensors (``remat``: ``train_loss``'s,
    on in the dry-run as in the reference). Without ``mesh``: the whole
    step on one device; with one (over a ``fake`` group): rank 0's share
    of the model's DTensor program under ``use_sharding(mesh, rules)``,
    the parameters placed with ``fsdp``."""
    ex = extras_specs(model.cfg, batch, seq, kind)
    tokens = meta((batch, 1 if kind == "decode" else seq), I32)
    labels = meta((batch, seq), I32)
    params = model.param_shapes()
    if mesh is None:
        with OpCounter(pod_size) as oc:
            run_step(model, kind, params, tokens, labels=labels, extras=ex,
                     max_len=seq, opt_cfg=opt_cfg, remat=remat)
        return oc.cost
    params = distribute_params(model.cfg, params, mesh, fsdp)
    with use_sharding(mesh, rules):
        with OpCounter(pod_size) as oc:
            run_step(model, kind, params, tokens, labels=labels, extras=ex,
                     max_len=seq, opt_cfg=opt_cfg, remat=remat)
    return oc.cost


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            test_mesh: bool = False, fsdp: bool = True,
            verbose: bool = True, serve_fsdp: str = "on",
            mla_fused: bool = False, tag: str = "") -> Dict:
    spec = INPUT_SHAPES[shape_name]
    cfg = get_config(arch, variant_for(shape_name))
    if cfg.dtype != "bfloat16":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    if mla_fused and cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla_fused_prefill=True)
    model = Model(cfg, META)
    chips = (8 if test_mesh else 256) * (2 if multi_pod and not test_mesh
                                         else 1)
    rules = LONG_CONTEXT_RULES if shape_name == "long_500k" else DEFAULT_RULES
    B, S = spec["batch"], spec["seq"]
    kind = spec["kind"]
    with fake_group(chips):
        mesh = (make_test_mesh(multi_pod=multi_pod) if test_mesh
                else make_production_mesh(multi_pod=multi_pod))
        sizes = axis_sizes(mesh)
        pod_size = sizes["data"] * sizes["model"] if multi_pod else 0
        if kind != "train" and serve_fsdp != "on":
            # serving-mode sharding: FSDP weight gathers every decode step
            # are pure overhead when model-axis-sharded weights fit
            if serve_fsdp == "off":
                fsdp = False
            else:                                      # "auto"
                pbytes = sum(tensor_bytes(x) for _, x in
                             _leaves(model.param_shapes()))
                fsdp = (pbytes / sizes.get("model", 1)) > 0.6 * 16 * 2**30
        rec: Dict = {"arch": arch, "shape": shape_name, "kind": kind,
                     "mesh": ("2x16x16" if multi_pod else "16x16")
                     if not test_mesh else str(tuple(sizes.values())),
                     "chips": chips, "fsdp": fsdp,
                     "torch": torch.__version__}
        if tag:
            rec["tag"] = tag
        t0 = time.time()
        mem = argument_bytes(model, kind, B, S, mesh, fsdp, rules)
        mem["temporaries"] = TEMPORARIES
        rec["memory"] = mem
        n_params = sum(x.numel() for _, x in
                       _leaves(model.param_shapes()))
        opt_cfg = AdamWConfig(moment_dtype="bfloat16" if n_params > 2e10
                              else "float32")
        rec["memory_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        step = count_step(model, kind, B, S, opt_cfg, pod_size, mesh=mesh,
                          rules=rules, fsdp=fsdp)
        rec["count_s"] = round(time.time() - t1, 2)
        tokens = B * S if kind != "decode" else B
        mf = model_flops(cfg, tokens / chips, training=kind == "train")
        coll = analysis.CollectiveStats(
            dict(step.collective_wire), dict(step.collective_counts),
            step.ici_bytes, step.dcn_bytes)
        rl = analysis.roofline(step.flops, step.bytes, coll, chips,
                               model_flops=mf, links=analysis.H100_LINKS)
        rec["roofline"] = dict(
            rl.row(), collectives_counted="rank 0 of the step's DTensor "
            "program: the shard() sites, the kernels' local_op "
            "redistributions, the FSDP weight gathers and their gradients' "
            "reduce-scatters, DTensor's propagation and the expert-parallel "
            "MoE; ring wire bytes a chip")
        rec["ok"] = True

    if verbose:
        r = rec["roofline"]
        tx = ("none" if r["t_collective_s"] is None
              else f"{r['t_collective_s']:.3e}")
        print(f"[OK] {arch} x {shape_name} ({rec['mesh']}): count "
              f"{rec['count_s']}s | args "
              f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB/dev | "
              f"t_c {r['t_compute_s']:.3e} t_m {r['t_memory_s']:.3e} "
              f"t_x {tx} -> {r['dominant']}-bound | "
              f"useful {r['useful_flops_frac']:.2f}")
        sys.stdout.flush()
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default="all")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--all", action="store_true",
                    help="every arch x every shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--test-mesh", action="store_true",
                    help="small 8-rank mesh (CPU tests)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--serve-fsdp", choices=["on", "off", "auto"],
                    default="on", help="FSDP for serving shapes")
    ap.add_argument("--mla-fused", action="store_true",
                    help="fused MLA latent expansion in prefill")
    ap.add_argument("--tag", default="", help="experiment tag in records")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    archs = ARCH_IDS if args.all or args.arch == "all" else [args.arch]
    shapes = (list(INPUT_SHAPES) if args.all or args.shape == "all"
              else [args.shape])
    done = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    failures = []
    for arch in archs:
        for shape in shapes:
            mesh_name = "2x16x16" if args.multi_pod else "16x16"
            if (arch, shape, mesh_name) in done:
                print(f"[skip] {arch} x {shape} ({mesh_name})")
                continue
            try:
                rec = run_one(arch, shape, multi_pod=args.multi_pod,
                              test_mesh=args.test_mesh,
                              fsdp=not args.no_fsdp,
                              serve_fsdp=args.serve_fsdp,
                              mla_fused=args.mla_fused, tag=args.tag)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "ok": False,
                       "mesh": mesh_name, "error": f"{type(e).__name__}: {e}"}
                failures.append((arch, shape))
                print(f"[FAIL] {arch} x {shape}: {e}")
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    print(f"\n{len(failures)} failures" + (f": {failures}" if failures else ""))
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
