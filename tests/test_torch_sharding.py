"""The port's placement rules (``sharding/``) against the JAX package's.

``spec_for_param`` and ``expert_axes`` are copies: the port's equal the
JAX ones leaf for leaf, for every ``ARCH_IDS`` config, ``full`` and
``long``, on the production meshes (16x16, 2x16x16) and the test meshes
((2, 4), (2, 2, 2)), with and without FSDP (shape-only meshes, the
reference's own ``FakeMesh`` form; the JAX shapes are built once for the
module).

The port's tree holds a tensor a layer where the reference stacks its
repeated unit (and an encoder) on a leading scan axis, so each port leaf
is held to the JAX spec of the stacked leaf it is a slice of, minus the
scan axis. The leaves where the JAX spec puts a mesh axis on the scan
axis itself are the only placements the port cannot follow; on the
production meshes they are exactly the 8 (L, d) norm scales of
``llama3.2-1b`` and ``internlm2-20b`` under FSDP on 16x16.

Also: the reference's three unit cases (``tests/test_sharding.py``),
DTensor placements on a ``DeviceMesh`` over a ``fake`` process group, the
``shard`` contract, and ``serving_shardings`` over the fleet's
shard-stacked state.
"""
import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.sharding import rules as JR
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.sharding import api as A
from repro_torch.sharding import rules as R

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "(2,4)": {"data": 2, "model": 4},
          "(2,2,2)": {"pod": 2, "data": 2, "model": 2}}
PRODUCTION = ("16x16", "2x16x16")
SCAN_PLACED = {  # (arch, variant, JAX leaf, fsdp) per production mesh
    "16x16": {(a, v, f"unit/0/{n}/scale", True)
              for a in ("internlm2-20b", "llama3.2-1b")
              for v in ("full", "long") for n in ("ln1", "ln2")},
    "2x16x16": set()}
# scan-placed leaves on the test meshes, over every config, variant and
# FSDP setting (counted from the JAX rules)
SCAN_PLACED_TEST = {"(2,4)": 90, "(2,2,2)": 82}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _jax_path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (str(i),))
    else:
        yield path, tree


def _jax_name(cfg, path):
    """The JAX leaf path of a port leaf, and its index on the scan axis
    (None: unstacked)."""
    if path[0] == "layers":
        prefix, unit, repeats = cfg.grouping()
        i = int(path[1]) - len(prefix)
        if i < 0:
            return "/".join(("prefix", path[1]) + path[2:]), None
        if unit[i % len(unit)] == "shared":
            return "/".join(("shared_block",) + path[2:]), None
        return ("/".join(("unit", str(i % len(unit))) + path[2:]),
                i // len(unit))
    if path[0] == "encoder":
        return "/".join(("encoder",) + path[2:]), int(path[1])
    return "/".join(path), None


@pytest.fixture(scope="module")
def leaves():
    """(arch, variant) -> (port config, [(port path, port shape, JAX path,
    JAX shape, stacked)] for every port leaf, every JAX leaf path)."""
    out = {}
    for arch in ARCH_IDS:
        for var in ("full", "long"):
            jshapes = {_jax_path(kp): tuple(x.shape) for kp, x in
                       jax.tree_util.tree_flatten_with_path(
                           JModel(j_get_config(arch, var)).param_shapes())[0]}
            cfg = get_config(arch, var)
            rows = []
            for path, x in _port_leaves(Model(cfg, "meta").param_shapes()):
                jpath, r = _jax_name(cfg, path)
                rows.append((path, tuple(x.shape), jpath, jshapes[jpath],
                             r is not None))
            out[arch, var] = (cfg, rows, set(jshapes))
    return out


def test_port_tree_is_the_stacked_tree(leaves):
    """Every port leaf is its JAX leaf, or one layer of it along the scan
    axis of ``rules.scan_length``; every JAX leaf is reached."""
    for (arch, var), (cfg, rows, jall) in leaves.items():
        seen = set()
        for path, shape, jpath, jshape, stacked in rows:
            seen.add(jpath)
            if stacked:
                assert jshape == (R.scan_length(cfg, path),) + shape, path
            else:
                assert R.scan_length(cfg, path) == 0 and jshape == shape
        assert seen == jall, (arch, var)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_jax_rules(leaves, mesh):
    m = FakeMesh(MESHES[mesh])
    scan_placed = set()
    n = 0
    for (arch, var), (cfg, rows, jall) in leaves.items():
        for fsdp in (False, True):
            for path, shape, jpath, jshape, stacked in rows:
                want = R.full_spec(tuple(JR.spec_for_param(
                    jpath, jshape, m, fsdp)), len(jshape))
                # the copied rule itself, on the reference's own leaf
                assert R.full_spec(R.spec_for_param(jpath, jshape, m, fsdp),
                                   len(jshape)) == want
                got = R.param_spec(cfg, path, shape, m, fsdp)
                n += 1
                if stacked:
                    assert got == want[1:], (arch, var, path, fsdp)
                    if want[0] is not None and path[1] == str(
                            len(R._grouping(cfg)[0])):  # first unit layer
                        scan_placed.add((arch, var, jpath, fsdp))
                else:
                    assert got == want, (arch, var, path, fsdp)
    assert n > 1000
    if mesh in PRODUCTION:
        assert scan_placed == SCAN_PLACED[mesh]
    else:
        assert len(scan_placed) > 0
        assert _count_scan_placed(leaves, m) == SCAN_PLACED_TEST[mesh]


def _count_scan_placed(leaves, m):
    n = 0
    for (arch, var), (cfg, rows, jall) in leaves.items():
        jleaves = {(jpath, jshape) for _, _, jpath, jshape, st in rows if st}
        for fsdp in (False, True):
            for jpath, jshape in jleaves:
                s = JR.spec_for_param(jpath, jshape, m, fsdp)
                n += bool(len(s) and s[0] is not None)
    return n


@pytest.mark.parametrize("mesh", list(MESHES))
def test_context_spec_matches_jax(mesh):
    """``ShardingContext.spec`` of the logical names the model and the
    dry-run use, under both rule tables: the JAX context's entries."""
    from repro.sharding.api import ShardingContext as JContext
    from repro_torch.launch.dryrun import _CACHE_AXES
    m = FakeMesh(MESHES[mesh])
    axes = [("batch", "seq", "heads", None), ("batch", None),
            ("tokens", None), ("experts", "expert_flat", "batch"),
            ("batch", "kv_seq", "kv_heads", None), ("vocab", "embed"),
            ("d_ff", "heads", "kv_heads"), ()] + list(_CACHE_AXES.values())
    for rules in (R.DEFAULT_RULES, R.LONG_CONTEXT_RULES, R.SERVING_RULES):
        ctx, jctx = A.ShardingContext(m, rules), JContext(m, rules)
        for ax in axes:
            assert ctx.spec(ax) == tuple(jctx.spec(ax)), (rules, ax)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_axes_match_jax(mesh):
    m = FakeMesh(MESHES[mesh])
    for E in (1, 2, 4, 8, 16, 32, 64, 128, 256, 6, 12):
        assert R.expert_axes(E, m) == JR.expert_axes(E, m)


def test_placements_on_a_device_mesh():
    """``placements_of`` on a ``DeviceMesh`` over a fake group of 256:
    the experts over (data, model) in mesh order, the FSDP'd embedding."""
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.sharding.api import Replicate, Shard
    with fake_group(256):
        mesh = make_production_mesh()
        assert A.axis_sizes(mesh) == {"data": 16, "model": 16}
        cfg = get_config("deepseek-v3-671b")
        pl = R.param_shardings(cfg, Model(cfg, "meta").param_shapes(), mesh,
                               fsdp=True)
        moe = next(layer["moe"] for layer in pl["layers"] if "moe" in layer)
        assert moe["experts_gate"] == [Shard(0), Shard(0)]
        assert moe["router"] == [Replicate(), Replicate()]
        # (vocab, d): vocab over model, d over data (FSDP)
        assert pl["embed"]["tok"] == [Shard(1), Shard(0)]
    with pytest.raises(ValueError):
        A.placements_of((("model", "data"),), FakeMesh(MESHES["16x16"]))


# --- the reference's unit cases --------------------------------------------


def test_spec_rules_single_device():
    m = FakeMesh({"data": 16, "model": 16})
    s = R.spec_for_param("prefix/0/attn/wq", (2048, 4096), m, fsdp=True)
    assert s in (("data", "model"), (None, "model")) or "model" in str(s)
    s = R.spec_for_param("unit/0/moe/experts_gate", (58, 256, 7168, 2048), m)
    assert str(s).count("data") == 1 and str(s).count("model") == 1
    assert R.spec_for_param("unit/0/moe/router", (7168, 256), m) == \
        (None, None)
    assert R.spec_for_param("final_norm/scale", (7168,), m) == ()
    assert tuple(P()) == ()


def test_expert_axes():
    ea, fa = R.expert_axes(256, FakeMesh({"data": 16, "model": 16}))
    assert set(ea) == {"data", "model"} and fa == ()
    ea, fa = R.expert_axes(128, FakeMesh({"data": 16, "model": 16}))
    assert len(ea) == 1 and len(fa) == 1
    ea, fa = R.expert_axes(4, FakeMesh({"data": 2, "model": 4}))
    assert ea == ("model",) and fa == ("data",)


def test_shard_noop_without_context():
    import torch
    x = torch.ones((2, 3))
    assert A.shard(x, "batch", None) is x


def test_shard_under_a_context():
    """A plain tensor comes back as it is; a DTensor is redistributed to
    the rule's placements; a rank mismatch raises."""
    import torch
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    from repro_torch.sharding.api import DTensor, Replicate, Shard
    try:
        from torch.distributed.tensor import distribute_tensor
    except ImportError:
        from torch.distributed._tensor import distribute_tensor
    with fake_group(8):
        mesh = make_test_mesh()
        x = torch.ones((8, 4))
        with A.use_sharding(mesh, R.DEFAULT_RULES) as ctx:
            assert A.current_context() is ctx
            assert A.shard(x, "batch", None) is x
            with pytest.raises(ValueError):
                A.shard(x, "batch")
            d = distribute_tensor(torch.empty((8, 4), device="meta"), mesh,
                                  [Replicate(), Replicate()])
            y = A.shard(d, "batch", "heads")
            assert isinstance(y, DTensor)
            assert list(y.placements) == [Shard(0), Shard(1)]
            assert tuple(y.to_local().shape) == (4, 1)
        assert A.current_context() is None


def test_serving_shardings_cover_the_fleet_state():
    """Every leaf of the fleet's shard-stacked state is ``Shard(0)`` over
    the serving mesh's data axis, and shard s of each stacked leaf is
    shard s's part of the one-card layout."""
    import torch
    from repro_torch.launch.mesh import fake_group, make_serving_mesh
    from repro_torch.models.config import ModelConfig, repeat_pattern
    from repro_torch.serving import EngineConfig, ShardedServingEngine
    from repro_torch.sharding.api import Shard
    S, B, ps = 2, 2, 8
    cfg = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                      dtype="float32", vocab_pad_multiple=8,
                      block_pattern=repeat_pattern(("dense",), 2))
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = ShardedServingEngine(model, params, EngineConfig(
        max_batch=B, shards=S, paged=True, page_size=ps, prefill_chunk=8,
        max_len=32), device="cpu")
    for layer in eng.caches["layers"]:
        layer["k_pages"].normal_()
    stacked = eng.stacked_state()
    with pytest.raises(ValueError):
        make_serving_mesh(S)                 # no process group is up
    with fake_group(S):
        mesh = make_serving_mesh(S)
        pl = R.serving_shardings(mesh, stacked)
    stacked_leaves = dict(_port_leaves(stacked))
    assert len(stacked_leaves) >= 10
    for path, x in stacked_leaves.items():
        at = pl
        for k in path:
            at = at[int(k)] if isinstance(at, list) and k.isdigit() else at[k]
        assert at == [Shard(0)], path
        assert x.shape[0] == S, path
    P_ = eng.num_pages
    k = eng.caches["layers"][0]["k_pages"]
    for s in range(S):
        assert torch.equal(stacked["caches"]["layers"][0]["k_pages"][s],
                           k[:, s * P_:(s + 1) * P_])
        assert torch.equal(stacked["caches"]["t"][s],
                           eng.caches["t"][s * B:(s + 1) * B])
