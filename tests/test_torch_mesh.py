"""The port's model as one SPMD program on a ``DeviceMesh``: 8 gloo ranks
of the (2, 4) test mesh (and the (2, 2, 2) multi-pod one) against the
single-device port on the same parameters, and against the meta-device
dry-run's collective counts.

The ranks run in ONE subprocess: this file run as a script (``python
tests/test_torch_mesh.py OUT_DIR [CASE ...]``) starts 8 processes
(``spawn``). Each first runs its share of the cases on one device
(``<case>.plain.npz``, whose greedy tokens every rank's decode is fed);
then they meet through a ``FileStore`` in ``OUT_DIR`` and run every case
on the mesh, rank 0 writing ``<case>.npz`` and ``<case>.json``. Beside
them a second subprocess (``python tests/test_torch_mesh.py --meta
OUT_DIR [CASE ...]``) counts every case's steps with the meta dry-run on
one ``fake`` group of 8 (``<case>.meta.json``). Nothing run there
imports jax.

Cases (smoke configs, float32, parameters from ``Model.init`` on a
seeded generator, the same on every rank, placed by
``distribute_params``): every family on the (2, 4) mesh with
``DEFAULT_RULES`` and FSDP on: llama-paper-1b (MHA), llama3.2-1b (GQA:
2 kv heads over a model axis of 4, replicated there and sliced a rank's
group), Llama-4 Maverick (MoE, expert-parallel), DeepSeek-V3 (MLA),
Zamba2, RWKV6; llama-paper-1b also with FSDP off and on the (2, 2, 2)
mesh; llama-paper-1b, Zamba2 and RWKV6 also under
``LONG_CONTEXT_RULES`` (the sequence split over the data axes, gathered
before each kernel) at batch 1, the regime those rules serve (the
dry-run's ``long_500k``: a batch that cannot be split).

For each case: the prefill's logits (4 x 16 tokens, 1 x 16 under the
long-context rules; caches 20 wide), four
decode steps' logits (the single-device run's greedy tokens fed to both),
``train_loss`` and every parameter's gradient (then one AdamW update; the
``llama`` case through ``torch.utils.checkpoint``) equal the single-device
port's at rtol = atol = ``TOL`` (float32; the shards sum in another
order: the row-parallel products' partial sums, the vocab split of the
embedding). The MoE families run the expert-parallel layer on the mesh,
which, as the reference's, keeps a capacity per (sender, expert) and
takes the load-balancing loss as each rank's statistic averaged over the
ranks: there the capacity factor is 8 (no token drops on either path,
asserted) and the load-balancing loss is weighed 0 (the z-loss, a mean
over equal shares of the tokens, stays). Every ``shard()`` site's
DTensor output has the rule's placements (``ShardingContext.fitted``). Rank 0's collectives of the
prefill, the first decode step and the train step, by op (count and
wire bytes), equal the meta dry-run's (``launch.dryrun.run_step``) for
the same config, mesh, rules and shapes.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

WORLD = 8
B, S, STEPS = 4, 16, 4
MAX_LEN = S + STEPS
TOL = 2e-5
CASES = {
    "llama": ("llama-paper-1b", False, "default", True),
    "llama-nofsdp": ("llama-paper-1b", False, "default", False),
    "llama-multipod": ("llama-paper-1b", True, "default", True),
    "llama-long": ("llama-paper-1b", False, "long", True),
    "llama32": ("llama3.2-1b", False, "default", True),
    "maverick": ("llama4-maverick-400b-a17b", False, "default", True),
    "deepseek": ("deepseek-v3-671b", False, "default", True),
    "zamba2": ("zamba2-7b", False, "default", True),
    "zamba2-long": ("zamba2-7b", False, "long", True),
    "rwkv6": ("rwkv6-1.6b", False, "default", True),
    "rwkv6-long": ("rwkv6-1.6b", False, "long", True),
}
KINDS = ("prefill", "decode", "train")
# each layer recomputed in the backward (``torch.utils.checkpoint``), as
# the dry-run's train step does; the other cases keep the activations, to
# keep the file cheap
REMAT = ("llama",)
SITE_MODULES = ("attention", "blocks", "layers", "model", "moe",
                "moe_sharded", "rwkv", "ssm")


def config(arch):
    """The smoke config; a MoE one with capacity to spare and its
    load-balancing loss weighed 0 (module docstring)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch, "smoke")
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, router_aux_weight=0.0))


def _rules(name):
    from repro_torch.sharding.rules import DEFAULT_RULES, LONG_CONTEXT_RULES
    return LONG_CONTEXT_RULES if name == "long" else DEFAULT_RULES


def _opt():
    from repro_torch.training.optim import AdamWConfig
    return AdamWConfig(lr=1e-3)


def _batch(name):
    return 1 if CASES[name][2] == "long" else B


def _tokens(name, cfg):
    import torch
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, cfg.vocab,
                                         (_batch(name), S))).int()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _counts(cost):
    return {op: [cost.collective_counts[op], cost.collective_wire[op]]
            for op in cost.collective_counts}


def _site_checker(orig, seen):
    """``shard`` that checks each DTensor output's placements."""
    from repro_torch.sharding.api import (DTensor, current_context,
                                          placements_of)

    def shard(x, *axes):
        y = orig(x, *axes)
        if isinstance(y, DTensor):
            ctx = current_context()
            want = placements_of(ctx.fitted(axes, y.shape), ctx.mesh)
            seen["dtensor"] += 1
            if tuple(y.placements) != tuple(want):
                seen["wrong"].append(f"{axes} {tuple(y.shape)}: "
                                     f"{y.placements} != {want}")
        else:
            seen["plain"] += 1
        return y
    return shard


def _case(name, meshes, out):
    import importlib
    import torch
    import torch.distributed as dist
    from repro_torch.launch.dryrun import run_step
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models import Model
    from repro_torch.sharding import distribute_params, use_sharding
    from repro_torch.sharding.api import DTensor, axis_sizes

    arch, multipod, rules, fsdp = CASES[name]
    cfg = config(arch)
    mesh = meshes[multipod]
    sizes = axis_sizes(mesh)
    pod = sizes["data"] * sizes["model"] if multipod else 0
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = _tokens(name, cfg)
    labels = torch.roll(tokens, -1, 1)
    feed = torch.from_numpy(np.load(os.path.join(
        out, f"{name}.plain.npz"))["feed"])
    res = {}

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t
                ).detach().numpy()

    # the mesh
    seen = {"dtensor": 0, "plain": 0, "wrong": []}
    mods = [importlib.import_module(f"repro_torch.models.{m}")
            for m in SITE_MODULES]
    saved = [m.shard for m in mods]
    for m, s in zip(mods, saved):
        m.shard = _site_checker(s, seen)
    counts = {}

    def counted(kind, step):
        """``step()``, its collectives counted on rank 0 (which reports)."""
        if dist.get_rank():
            return step()
        with OpCounter(pod) as oc:
            out = step()
        counts[kind] = _counts(oc.cost)
        return out

    try:
        with use_sharding(mesh, _rules(rules)):
            dp = distribute_params(cfg, params, mesh, fsdp, None)
            logits, caches = counted("prefill", lambda: run_step(
                model, "prefill", dp, tokens, max_len=MAX_LEN))
            res["mesh/prefill"] = full(logits)
            for i in range(STEPS):
                # the first step's collectives counted
                step = functools.partial(run_step, model, "decode", dp,
                                         feed[:, i:i + 1], caches=caches)
                logits, caches = (counted("decode", step) if i == 0
                                  else step())
                res[f"mesh/decode{i}"] = full(logits)
            dp = distribute_params(cfg, params, mesh, fsdp, None)
            loss, metrics = counted("train", lambda: run_step(
                model, "train", dp, tokens, labels=labels, opt_cfg=_opt(),
                remat=name in REMAT))
            res["mesh/loss"] = full(loss)
            drop = metrics.get("moe_drop_frac", 0.0)
            res["mesh/drop"] = np.array(float(
                full(drop) if torch.is_tensor(drop) else drop))
            for k, v in _leaves(dp):
                if v.grad is not None:
                    res[f"mesh/grad{k}"] = full(v.grad)
    finally:
        for m, s in zip(mods, saved):
            m.shard = s
    res["sites/dtensor"] = np.array(seen["dtensor"])
    res["sites/plain"] = np.array(seen["plain"])
    res["sites/wrong"] = np.array(len(seen["wrong"]))
    return res, counts, seen["wrong"][:5]


def _plain(name):
    """The single-device port's results of a case, and the greedy tokens
    its decode fed."""
    import torch
    from repro_torch.models import Model
    cfg = config(CASES[name][0])
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = _tokens(name, cfg)
    labels = torch.roll(tokens, -1, 1)
    res = {}
    with torch.no_grad():
        logits, caches = model.prefill(params, tokens, max_len=MAX_LEN)
        res["plain/prefill"] = logits.numpy()
        feed = []
        for i in range(STEPS):
            feed.append(torch.argmax(logits[:, :cfg.vocab], -1)[:, None]
                        .int())
            logits, caches = model.decode_step(params, caches, feed[-1])
            res[f"plain/decode{i}"] = logits.numpy()
    res["feed"] = torch.cat(feed, 1).numpy()
    clones = {}                  # a leaf shared by layers stays one leaf
    plain = {k: clones.setdefault(id(v), v.clone().requires_grad_(True))
             for k, v in _leaves(params)}
    loss, metrics = model.train_loss(_rebuild(params, plain),
                                     {"tokens": tokens, "labels": labels})
    loss.backward()
    res["plain/loss"] = loss.detach().numpy()
    res["plain/drop"] = np.array(float(metrics.get("moe_drop_frac", 0.0)))
    for k, v in plain.items():
        if v.grad is not None:
            res[f"plain/grad{k}"] = v.grad.numpy()
    return res


def _rebuild(tree, flat, path=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, flat, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return tree if tree is None else flat[path]


def _rank(rank, out_dir, names):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    # this rank's share of the single-device runs, before the group is up
    for name in names[rank::WORLD]:
        np.savez(os.path.join(out_dir, f"{name}.plain.npz"), **_plain(name))
    store = dist.FileStore(os.path.join(out_dir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        dist.barrier()
        meshes = {False: make_test_mesh(), True: make_test_mesh(
            multi_pod=True)}
        for name in names:
            res, counts, wrong = _case(name, meshes, out_dir)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"), **res)
                with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
                    json.dump({"counts": counts, "wrong": wrong}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _meta_counts(names):
    """The dry-run's rank-0 collectives of each case's three steps:
    ``launch.dryrun.run_step`` on meta tensors, as ``count_step`` runs it,
    with the caches as wide as the mesh run's, on one ``fake`` group of 8
    for all the cases (DTensor's caches stay warm between them)."""
    from repro_torch.launch.dryrun import I32, meta, run_step
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models import Model
    from repro_torch.sharding import distribute_params, use_sharding
    from repro_torch.sharding.api import axis_sizes
    out = {}
    with fake_group(WORLD):
        meshes = {False: make_test_mesh(), True: make_test_mesh(
            multi_pod=True)}
        for name in names:
            arch, multipod, rules, fsdp = CASES[name]
            mesh = meshes[multipod]
            sizes = axis_sizes(mesh)
            pod = sizes["data"] * sizes["model"] if multipod else 0
            model = Model(config(arch), "meta")
            out[name] = {}
            for kind in KINDS:
                params = distribute_params(model.cfg, model.param_shapes(),
                                           mesh, fsdp)
                tokens = meta((_batch(name), 1 if kind == "decode"
                               else S), I32)
                with use_sharding(mesh, _rules(rules)), \
                        OpCounter(pod) as oc:
                    run_step(model, kind, params, tokens,
                             labels=meta((_batch(name), S), I32),
                             max_len=MAX_LEN,
                             opt_cfg=_opt(), remat=name in REMAT)
                out[name][kind] = _counts(oc.cost)
    return out


def _main(out_dir, names=tuple(CASES)):
    import torch.multiprocessing as mp
    mp.start_processes(_rank, args=(out_dir, names), nprocs=WORLD,
                       join=True, start_method="spawn")


def _meta_main(out_dir, names=tuple(CASES)):
    import torch
    torch.set_num_threads(1)
    for name, counts in _meta_counts(names).items():
        with open(os.path.join(out_dir, f"{name}.meta.json"), "w") as f:
            json.dump(counts, f)


# --------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    # the ranks and the dry-run's counts side by side
    procs = [subprocess.Popen([sys.executable, __file__] + flag + [str(out)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for flag in ([], ["--meta"])]
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-6000:]
    res = {}
    for name in CASES:
        with open(out / f"{name}.json") as f:
            info = json.load(f)
        with open(out / f"{name}.meta.json") as f:
            meta = json.load(f)
        res[name] = (dict(np.load(out / f"{name}.npz"),
                          **np.load(out / f"{name}.plain.npz")),
                     info, meta)
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_equals_single_device(ranks, name):
    res, _, _ = ranks[name]
    assert float(res["plain/drop"]) == float(res["mesh/drop"]) == 0.0
    np.testing.assert_allclose(res["mesh/prefill"], res["plain/prefill"],
                               rtol=TOL, atol=TOL, err_msg="prefill")
    for i in range(STEPS):
        np.testing.assert_allclose(res[f"mesh/decode{i}"],
                                   res[f"plain/decode{i}"], rtol=TOL,
                                   atol=TOL, err_msg=f"decode step {i}")
    np.testing.assert_allclose(res["mesh/loss"], res["plain/loss"],
                               rtol=TOL, atol=TOL, err_msg="loss")
    grads = sorted(k[len("plain/grad"):] for k in res
                   if k.startswith("plain/grad"))
    assert grads == sorted(k[len("mesh/grad"):] for k in res
                           if k.startswith("mesh/grad"))
    for k in grads:
        np.testing.assert_allclose(res[f"mesh/grad{k}"], res[f"plain/grad{k}"],
                                   rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_sites_have_the_rules_placements(ranks, name):
    res, info, _ = ranks[name]
    assert int(res["sites/dtensor"]) > 0
    assert int(res["sites/wrong"]) == 0, info["wrong"]


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_equal_the_dry_run(ranks, name):
    _, info, meta = ranks[name]
    for kind in KINDS:
        assert info["counts"][kind] == meta[kind], kind
    assert info["counts"]["prefill"], "the prefill issued no collective"


if __name__ == "__main__":
    meta_only = sys.argv[1] == "--meta"
    argv = sys.argv[1 + meta_only:]
    (_meta_main if meta_only else _main)(
        argv[0], tuple(a for a in argv[1:] if a in CASES) or tuple(CASES))
