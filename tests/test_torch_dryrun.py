"""The port's dry-run (``launch/dryrun.py``), op counter
(``launch/op_cost.py``) and roofline (``launch/analysis.py``,
``launch/reanalyze.py``) against the JAX package.

The reference's own dry-run tests are red here (jax 0.9 against its pin),
so the records are held to what runs: the JAX placement rules over the
JAX ``Model.param_shapes()`` (per-device parameter bytes) and
``costing.model_flops``. The four dry-run cases are the reference's
(``tests/test_sharding.py``), run through the CLI on the 8-rank test
meshes (a ``fake`` process group of 8 in the subprocess), all four
subprocesses started together. The op counter mirrors
``tests/test_hlo_cost.py`` in eager form.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.launch import hlo_cost as JHC
from repro.models import Model as JModel
from repro.models.costing import model_flops as j_model_flops
from repro.sharding import rules as JR

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = [("llama3.2-1b", "train_4k", False),
         ("zamba2-7b", "decode_32k", False),
         ("deepseek-v3-671b", "long_500k", False),
         ("llama3.2-1b", "decode_32k", True)]
TEST_MESH = {False: {"data": 2, "model": 4},
             True: {"pod": 2, "data": 2, "model": 2}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = {}
    for arch, shape, pods in CASES:
        path = out / f"{arch}_{shape}_{pods}.jsonl"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--test-mesh", "--out", str(path)]
        procs[arch, shape, pods] = (path, subprocess.Popen(
            cmd + (["--multi-pod"] if pods else []), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    recs = {}
    for key, (path, p) in procs.items():
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-3000:]
        recs[key] = json.loads(path.read_text().splitlines()[-1])
    return recs


def test_mamba2_decode_keeps_the_state_on_its_heads(records):
    """Zamba2's decode step on (data 2, model 4): each rank advances its
    heads' share of every Mamba2 layer's float32 state, as the cache rule
    splits it, so the step's all-gathers move less than one gather of
    those states over the model axis would (n_mamba x B / 2 x H x P x N x
    4 bytes x 3 / 4), FSDP's weight gathers included."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import INPUT_SHAPES
    rec = records["zamba2-7b", "decode_32k", False]
    assert rec["ok"] and rec["torch"]
    cfg = get_config("zamba2-7b")
    s, d = cfg.ssm, cfg.d_model
    n_mamba = sum(k == "mamba2" for k in cfg.block_pattern)
    state = (INPUT_SHAPES["decode_32k"]["batch"] // 2 * s.n_heads(d)
             * s.head_dim * s.state_dim * 4)
    gathered = n_mamba * state * 3 / 4
    assert rec["roofline"]["coll_bytes_by_op"]["all-gather"] < gathered


def _jax_param_bytes(arch, shape, mesh):
    """One device's parameter bytes under the JAX rules on the JAX
    stacked tree, with any mesh axis on a scan axis dropped (the port's
    per-layer leaves cannot take it); and how many leaves that touched."""
    spec = {"train_4k": "full", "decode_32k": "full", "long_500k": "long"}
    cfg = j_get_config(arch, spec[shape])
    if cfg.dtype != "bfloat16":
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    fsdp = True
    total, scan_placed = 0, 0
    for kp, x in jax.tree_util.tree_flatten_with_path(
            JModel(cfg).param_shapes())[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        s = list(JR.spec_for_param(path, tuple(x.shape), mesh, fsdp))
        s += [None] * (len(x.shape) - len(s))
        if path.split("/")[0] in ("unit", "encoder") and s[0] is not None:
            s[0] = None
            scan_placed += 1
        n = 1
        for dim, entry in zip(x.shape, s):
            axes = () if entry is None else ((entry,) if isinstance(
                entry, str) else tuple(entry))
            k = math.prod(mesh.shape[a] for a in axes)
            n *= -(-dim // k)
        total += n * np.dtype(x.dtype).itemsize
    return total, scan_placed, cfg


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}"
                         + ("-multipod" if c[2] else ""))
def test_dryrun_small_mesh(records, case):
    arch, shape, pods = case
    rec = records[case]
    assert rec["ok"]
    assert rec["chips"] == 8 and rec["fsdp"]
    r = rec["roofline"]
    assert r["flops"] > 0 and r["bytes"] > 0
    # the collectives are priced with the H100's links (launch.analysis)
    assert r["t_collective_s"] > 0 and r["profile"] == "h100_sxm"
    assert "NVLink" in r["link_assumption"]
    mesh = FakeMesh(TEST_MESH[pods])
    want, scan_placed, jcfg = _jax_param_bytes(arch, shape, mesh)
    assert rec["memory"]["param_bytes"] == want
    if arch == "llama3.2-1b" and shape == "train_4k":
        assert scan_placed == 2    # ln1, ln2 scales: (16, 2048) on (2, 4)
    from repro_torch.launch.dryrun import INPUT_SHAPES
    sp = INPUT_SHAPES[shape]
    tokens = sp["batch"] * (sp["seq"] if sp["kind"] != "decode" else 1)
    mf = j_model_flops(jcfg, tokens / 8, training=sp["kind"] == "train")
    assert r["model_flops"] == pytest.approx(mf, rel=1e-12)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(
        mem.get(k, 0.0) for k in ("param_bytes", "optimizer_bytes",
                                  "cache_bytes", "input_bytes"))
    if sp["kind"] == "train":
        # float32 moments (1.2 B parameters < 2e10) of bf16 parameters
        assert mem["moment_dtype"] == "float32"
        assert mem["optimizer_bytes"] == 2 * 2 * mem["param_bytes"]
    if arch == "deepseek-v3-671b":
        # 58 MoE layers of moe_ffn_sharded: two all-to-alls over (data,
        # model) each way
        assert r["coll_counts"]["all-to-all"] == 58 * 4
        assert r["coll_counts"]["all-reduce"] >= 58
        assert r["coll_ici_bytes"] > 0
    else:
        # the model's shard() sites on DTensors: FSDP's weight gathers and
        # the row-parallel products' reductions at least
        assert r["coll_counts"]["all-gather"] > 0
        assert r["coll_counts"].get("all-reduce", 0) + r["coll_counts"].get(
            "reduce-scatter", 0) > 0
        assert r["coll_ici_bytes"] > 0
    assert (r["coll_dcn_bytes"] > 0) == pods


def test_argument_bytes_equal_the_allocation():
    """On a one-device mesh the dry-run's argument bytes are the bytes of
    the tensors ``Model.init`` and ``init_cache`` allocate (the chip
    phase's anchor, here on the CPU)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _leaves, argument_bytes
    from repro_torch.models import Model
    from repro_torch.sharding.rules import DEFAULT_RULES
    from repro_torch.training.optim import AdamWConfig, adamw_init
    cfg = get_config("llama3.2-1b", "smoke")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_cache(2, 32)
    one = FakeMesh({"data": 1, "model": 1})

    def nbytes(tree):
        seen = {}
        for _, x in _leaves(tree):
            seen[id(x)] = x.numel() * x.element_size()
        return sum(seen.values())

    got = argument_bytes(model, "decode", 2, 32, one, True, DEFAULT_RULES)
    assert got["param_bytes"] == nbytes(params)
    assert got["cache_bytes"] == nbytes(caches)
    assert got["input_bytes"] == 2 * 1 * 4
    got = argument_bytes(model, "train", 2, 32, one, True, DEFAULT_RULES)
    opt = adamw_init(params, AdamWConfig())
    assert got["optimizer_bytes"] == nbytes(opt["m"]) + nbytes(opt["v"])
    assert got["input_bytes"] == 2 * 2 * 32 * 4


# --- op_cost: tests/test_hlo_cost.py in eager form --------------------------


def _meta(*shape, dtype=None):
    import torch
    return torch.empty(shape, dtype=dtype or torch.float32, device="meta")


def test_dot_flops_exact():
    from repro_torch.launch.op_cost import OpCounter
    with OpCounter() as oc:
        (_meta(128, 256) @ _meta(256, 64)).sum()
    assert oc.cost.flops == 2 * 128 * 256 * 64


def test_loop_counts_each_body():
    import torch
    from repro_torch.launch.op_cost import OpCounter
    h, w = _meta(32, 64), _meta(64, 64)
    with OpCounter() as oc:
        for _ in range(7):
            h = torch.tanh(h @ w)
    assert oc.cost.flops == 7 * 2 * 32 * 64 * 64


def test_nested_loops_multiply():
    from repro_torch.launch.op_cost import OpCounter
    h, w = _meta(16, 32), _meta(32, 32)
    with OpCounter() as oc:
        for _ in range(5):
            for _ in range(3):
                h = h @ w
    assert oc.cost.flops == 15 * 2 * 16 * 32 * 32


def test_bytes_proxy_matches_xla_for_a_dot():
    """A product's bytes are its operands' and output's, as XLA's "bytes
    accessed" of the same dot; views add nothing."""
    from repro_torch.launch.op_cost import OpCounter
    c = jax.jit(lambda a, b: a @ b).lower(
        jax.ShapeDtypeStruct((512, 512), jnp.float32),
        jax.ShapeDtypeStruct((512, 512), jnp.float32)).compile()
    ca = c.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    a, b = _meta(512, 512), _meta(512, 512)
    with OpCounter() as oc:
        a @ b.t().t()
        a.view(256, 1024)
    assert oc.cost.bytes == 3 * 512 * 512 * 4
    assert oc.cost.bytes == pytest.approx(float(ca["bytes accessed"]),
                                          rel=1e-6)


def test_dtype_table():
    import torch
    from repro_torch.launch import op_cost
    assert op_cost.DTYPE_BYTES == JHC.DTYPE_BYTES
    assert op_cost.WIRE_FACTOR == JHC.WIRE_FACTOR
    for dt, name in op_cost.DTYPE_NAMES.items():
        assert op_cost.DTYPE_BYTES[name] == torch.empty(
            (), dtype=dt).element_size(), dt
    assert op_cost.tensor_bytes(_meta(2, 3, dtype=torch.bfloat16)) == 12


def test_collectives_counted_and_split_by_pod():
    """On a fake group of 8 as 2 pods of 4: ring wire bytes by op (a
    rank sends (n - 1) / n of the buffer, an all-reduce twice that), and a
    group spanning both pods counted as DCN."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    from repro_torch.launch.op_cost import OpCounter
    with fake_group(8):
        mesh = make_test_mesh(multi_pod=True)      # (pod 2, data 2, model 2)
        x = _meta(16, 8)
        with OpCounter(pod_size=4) as oc:
            dist.all_to_all_single(_meta(16, 8), x,
                                   group=mesh.get_group("model"))
            dist.all_reduce(x, group=mesh.get_group("pod"))
    c = oc.cost
    assert c.collective_counts == {"all-to-all": 1, "all-reduce": 1}
    # groups of 2: an all-to-all sends half its 512 bytes, an all-reduce
    # 2 x 512 x 1/2
    assert c.collective_wire == {"all-to-all": 256.0, "all-reduce": 512.0}
    assert (c.ici_bytes, c.dcn_bytes) == (256.0, 512.0)


def test_op_counters_nest():
    """A counter inside another: each counts one rank's local product
    (DTensor's global-shape shape inference left out of both), the outer
    also what ran outside the inner, and both leave DTensor's propagator
    as they found it."""
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    from repro_torch.launch.op_cost import _INFER, OpCounter
    from repro_torch.sharding.api import DTensor, Replicate, Shard
    prop = DTensor._op_dispatcher.sharding_propagator
    with fake_group(8):
        mesh = make_test_mesh()                    # (data 2, model 4)
        a = DTensor.from_local(_meta(8, 16), mesh, [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(_meta(16, 8), mesh,
                               [Replicate(), Replicate()], run_check=False)
        with OpCounter() as outer:
            with OpCounter() as inner:
                a @ b
            assert _INFER in vars(prop)            # the outer's, put back
            a @ b
    assert _INFER not in vars(prop)
    local = 2 * 8 * 16 * 8                         # one rank's (8, 16) x (16, 8)
    assert inner.cost.flops == local
    assert outer.cost.flops == 2 * local


def test_roofline_collective_time_needs_a_link_bandwidth():
    from repro_torch.core.hardware import H100_SXM, TPU_V5E
    from repro_torch.launch import analysis, reanalyze
    coll = analysis.CollectiveStats({"all-to-all": 1e9}, {"all-to-all": 4},
                                    1e9, 0.0)
    h = analysis.roofline(1e12, 1e9, coll, 8, H100_SXM, model_flops=5e11)
    assert h.t_collective is None and h.dominant == "compute"
    assert h.row()["coll_ici_bytes"] == 1e9
    assert h.t_compute == 1e12 / H100_SXM.peak_flops
    t = analysis.roofline(1e12, 1e9, coll, 8, TPU_V5E)
    assert t.t_collective == pytest.approx(1e9 / TPU_V5E.ici_bw)
    rec = {"ok": True, "chips": 8, "roofline": h.row()}
    recs, n = reanalyze.reprice([rec, {"ok": False}], TPU_V5E)
    assert n == 1
    assert recs[0]["roofline"]["t_collective_s"] == pytest.approx(
        t.t_collective)
    assert recs[0]["roofline"]["profile"] == "tpu_v5e"


def test_fsdp_weight_gathers_of_a_forward_in_closed_form():
    """llama-paper-1b smoke (untied) on the (2, 4) fake mesh under FSDP:
    the all-gather wire bytes a chip of one train-mode forward are, in
    closed form, sum over the FSDP-split leaves of B_p (n - 1) / n, B_p a
    leaf's bytes once gathered over the n = 2 data ranks (its model-axis
    split kept), plus sum over the norm scales split on the model axis of
    B_s (m - 1) / m, m = 4 (each norm gathers its scale whole); each used
    leaf is gathered once a forward. Nothing else all-gathers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    from repro_torch.launch.op_cost import OpCounter, tensor_bytes
    from repro_torch.models import Model
    from repro_torch.sharding import distribute_params, use_sharding
    from repro_torch.sharding.api import Shard, axis_sizes
    from repro_torch.sharding.rules import DEFAULT_RULES
    cfg = get_config("llama-paper-1b", "smoke")
    assert not cfg.tie_embeddings
    model = Model(cfg, "meta")
    with fake_group(8):
        mesh = make_test_mesh()
        params = distribute_params(cfg, model.param_shapes(), mesh,
                                   fsdp=True)
        sizes, names = axis_sizes(mesh), list(mesh.mesh_dim_names)
        n, m = sizes["data"], sizes["model"]
        want, fsdp_leaves = 0.0, 0
        for x in _dtensor_leaves(params):
            on = {names[i] for i, p in enumerate(x.placements)
                  if isinstance(p, Shard)}
            local = tensor_bytes(x._local_tensor)
            if "data" in on:
                want += local * n * (n - 1) / n
                fsdp_leaves += 1
            elif x.ndim == 1 and "model" in on:
                want += local * m * (m - 1) / m
        tokens = torch.empty((4, 16), dtype=torch.int32, device="meta")
        with use_sharding(mesh, DEFAULT_RULES), torch.no_grad(), \
                OpCounter() as oc:
            model.forward(params, tokens, mode="train")
    assert fsdp_leaves == 1 + 7 * cfg.n_layers + 1   # embed, layers, head
    assert oc.cost.collective_wire["all-gather"] == want


def _dtensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _dtensor_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _dtensor_leaves(v)
    else:
        yield tree


def test_t_collective_is_priced_for_the_h100():
    """``roofline`` with the H100's links kept in ``launch.analysis``:
    NVLink 4 within a pod, InfiniBand NDR across pods; ``reanalyze``
    re-prices an H100 record the same way, and a TPU profile keeps its
    own link bandwidths."""
    from repro_torch.core.hardware import H100_SXM, TPU_V5E
    from repro_torch.launch import analysis, reanalyze
    assert analysis.H100_LINKS.ici_bw == 450e9
    assert analysis.H100_LINKS.dci_bw == 50e9
    assert analysis.links_for(H100_SXM) is analysis.H100_LINKS
    assert analysis.links_for(TPU_V5E) is None
    coll = analysis.CollectiveStats({"all-gather": 9e8}, {"all-gather": 4},
                                    9e8, 1e8)
    h = analysis.roofline(1e12, 1e9, coll, 8, H100_SXM, model_flops=5e11,
                          links=analysis.H100_LINKS)
    assert h.t_collective == pytest.approx(9e8 / 450e9 + 1e8 / 50e9)
    assert "lower bound" in h.row()["link_assumption"]
    bare = analysis.roofline(1e12, 1e9, coll, 8, H100_SXM)
    rec = {"ok": True, "chips": 8, "roofline": bare.row()}
    assert rec["roofline"]["t_collective_s"] is None
    recs, n = reanalyze.reprice([rec], H100_SXM)
    assert n == 1
    assert recs[0]["roofline"]["t_collective_s"] == pytest.approx(
        h.t_collective)
