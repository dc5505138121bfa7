"""The port's expert-parallel MoE (``models/moe_sharded.py``) on 8 gloo
ranks of the (2, 4) test mesh, against the JAX package's dense
``moe_ffn`` and the port's own.

The ranks run in ONE subprocess: this file run as a script (``python
tests/test_torch_moe_sharded.py OUT_DIR``), which starts 8 processes
(``spawn``) that meet through a ``FileStore`` in ``OUT_DIR`` (never a
fixed port: test files run side by side) and write rank 0's results as
``.npz``. Nothing run there imports jax or ``conftest``: jax is imported
inside the tests only.

Cases (inputs drawn with numpy from a seed, float32):
  * ``e8``: the reference helper's (``tests/helpers/moe_sharded_check.py``)
    config, E 8, top-2, capacity factor 4.0, one shared expert, d 32,
    x (4, 16, 32): pure 8-way expert parallelism (ea = (data, model));
  * ``e4``: E 4 on the same mesh: ea = (model,), fa = (data,), which
    runs the all-gather / reduce-scatter over the FFN dim that the
    reference helper never reaches.
Neither drops a token on either path (the dense capacity rounds to 8,
the sharded one per (sender, expert) to 4). y equals the JAX dense
``moe_ffn`` at rtol = atol = 2e-4 (the reference helper's bound), the
aux loss within rtol 0.5 (per-rank statistics averaged), and every
gradient of sum(y^2) (x, router, each expert tensor, the shared expert)
equals the single-process port ``moe_ffn``'s at 2e-4. A 2-layer ``moe``
model's prefill and train forward under ``use_sharding`` (expert weights
placed by ``distribute_params``) equal the same model without a context,
at 2e-4.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

WORLD = 8
D, F = 32, 16
X_SHAPE = (4, 16, D)
CASES = {"e8": 8, "e4": 4}
TOL = 2e-4


def moe_config(E):
    from repro_torch.models.config import ModelConfig, MoEConfig, \
        repeat_pattern
    return ModelConfig(
        name="t", family="moe", n_layers=2, d_model=D, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=64, dtype="float32",
        block_pattern=repeat_pattern(("moe",), 2),
        moe=MoEConfig(n_experts=E, top_k=2, d_ff_expert=F,
                      n_shared_experts=1, capacity_factor=4.0),
        vocab_pad_multiple=8)


def layer_inputs(E, seed=0):
    """numpy params of one MoE layer (the reference's names) and x."""
    rng = np.random.default_rng(seed + E)
    f32 = np.float32
    p = {"router": (rng.standard_normal((D, E)) / D ** 0.5).astype(f32),
         "experts_gate": (rng.standard_normal((E, D, F)) / D ** 0.5
                          ).astype(f32),
         "experts_up": (rng.standard_normal((E, D, F)) / D ** 0.5
                        ).astype(f32),
         "experts_down": (rng.standard_normal((E, F, D)) / F ** 0.5
                          ).astype(f32),
         "shared": {
             "w_gate": (rng.standard_normal((D, F)) / D ** 0.5).astype(f32),
             "w_up": (rng.standard_normal((D, F)) / D ** 0.5).astype(f32),
             "w_down": (rng.standard_normal((F, D)) / F ** 0.5
                        ).astype(f32)}}
    x = rng.standard_normal(X_SHAPE).astype(f32)
    return p, x


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _tensors(p):
    import torch
    return {k: (_tensors(v) if isinstance(v, dict) else torch.tensor(v))
            for k, v in p.items()}


# --------------------------------------------------------------- the ranks


def _rank(rank, out_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import Model
    from repro_torch.models import moe_sharded as MOES
    from repro_torch.sharding import distribute_params, use_sharding
    from repro_torch.sharding.api import DTensor
    from repro_torch.sharding.rules import DEFAULT_RULES
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_test_mesh()
        for name, E in CASES.items():
            cfg = moe_config(E)
            p_np, x_np = layer_inputs(E)
            p = distribute_params(cfg, {"layers": [_tensors(p_np)]}, mesh
                                  )["layers"][0]
            leaves = _flat(p)
            for w in leaves.values():
                w.requires_grad_(True)
            x = torch.tensor(x_np, requires_grad=True)
            with use_sharding(mesh, DEFAULT_RULES):
                used = MOES.use_sharded_moe(cfg)
                y, aux = MOES.moe_ffn_sharded(p, cfg, x)
            (y * y).sum().backward()
            res = {"y": y.detach().numpy(), "used": np.array(used),
                   "grad/x": x.grad.numpy()}
            res.update({f"aux/{k}": v.detach().numpy()
                        for k, v in aux.items()})
            for k, w in leaves.items():
                g = w.grad
                g = g.full_tensor() if isinstance(g, DTensor) else g
                res[f"grad/{k}"] = g.numpy()
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"), **res)

        # a 2-layer moe model, with and without a context
        cfg = moe_config(8)
        gen = torch.Generator().manual_seed(0)
        model = Model(cfg, "cpu")
        params = model.init(gen)
        sharded = dict(params, layers=[
            dict(layer, moe=distribute_params(
                cfg, {"layers": [layer["moe"]]}, mesh)["layers"][0])
            for layer in params["layers"]])
        tokens = torch.from_numpy(
            np.random.default_rng(1).integers(0, 64, (4, 16))).int()
        res = {}
        with torch.no_grad():
            for tag, pr in (("dense", params), ("sharded", sharded)):
                ctx = (use_sharding(mesh, DEFAULT_RULES) if tag == "sharded"
                       else _null())
                with ctx:
                    logits, _ = model.forward(pr, tokens, mode="prefill",
                                              caches=model.init_cache(4, 16))
                    tl, taux = model.forward(pr, tokens, mode="train")
                res[f"{tag}/prefill"] = logits.numpy()
                res[f"{tag}/train"] = tl.numpy()
                res[f"{tag}/moe_drop_frac"] = taux["moe_drop_frac"].numpy()
        if rank == 0:
            np.savez(os.path.join(out_dir, "model.npz"), **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _main(out_dir):
    import torch.multiprocessing as mp
    mp.start_processes(_rank, args=(out_dir,), nprocs=WORLD, join=True,
                       start_method="spawn")


# --------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_sharded")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, __file__, str(out)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return {name: dict(np.load(out / f"{name}.npz"))
            for name in list(CASES) + ["model"]}


def _dense_grads(E):
    """The single-process port moe_ffn's y, aux and gradients of
    sum(y^2)."""
    import torch
    from repro_torch.models import moe as MOE
    cfg = moe_config(E)
    p_np, x_np = layer_inputs(E)
    p = _tensors(p_np)
    leaves = _flat(p)
    for w in leaves.values():
        w.requires_grad_(True)
    x = torch.tensor(x_np, requires_grad=True)
    y, aux = MOE.moe_ffn(p, cfg, x)
    (y * y).sum().backward()
    grads = {f"grad/{k}": w.grad.numpy() for k, w in leaves.items()}
    grads["grad/x"] = x.grad.numpy()
    return y.detach().numpy(), aux, grads


def _jax_dense(E):
    import jax
    import jax.numpy as jnp
    from repro.models import ModelConfig, MoEConfig
    from repro.models import moe as JMOE
    from repro.models.config import repeat_pattern
    cfg = ModelConfig(
        name="t", family="moe", n_layers=2, d_model=D, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=64, dtype="float32",
        block_pattern=repeat_pattern(("moe",), 2),
        moe=MoEConfig(n_experts=E, top_k=2, d_ff_expert=F,
                      n_shared_experts=1, capacity_factor=4.0),
        vocab_pad_multiple=8)
    p_np, x_np = layer_inputs(E)
    p = jax.tree_util.tree_map(jnp.asarray, p_np)
    y, aux = JMOE.moe_ffn(p, cfg, jnp.asarray(x_np))
    return np.asarray(y), {k: float(v) for k, v in aux.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_moe_matches_jax_dense(ranks, case):
    from repro_torch.sharding.rules import expert_axes
    res = ranks[case]
    E = CASES[case]
    assert bool(res["used"])
    assert expert_axes(E, _Shape()) == (
        (("data", "model"), ()) if E == 8 else (("model",), ("data",)))
    y_jax, aux_jax = _jax_dense(E)
    np.testing.assert_allclose(res["y"], y_jax, rtol=TOL, atol=TOL)
    assert float(res["aux/moe_drop_frac"]) == 0.0
    assert aux_jax["moe_drop_frac"] == 0.0
    np.testing.assert_allclose(float(res["aux/moe_aux"]),
                               aux_jax["moe_aux"], rtol=0.5)


class _Shape:
    shape = {"data": 2, "model": 4}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_moe_grads_match_port_dense(ranks, case):
    res = ranks[case]
    y, aux, grads = _dense_grads(CASES[case])
    np.testing.assert_allclose(res["y"], y, rtol=TOL, atol=TOL)
    assert float(aux["moe_drop_frac"]) == 0.0
    assert set(grads) == {k for k in res if k.startswith("grad/")}
    for k, g in grads.items():
        assert res[k].shape == g.shape, k
        np.testing.assert_allclose(res[k], g, rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_moe_model_forward_under_sharding(ranks, mode):
    res = ranks["model"]
    assert float(res["sharded/moe_drop_frac"]) == 0.0
    assert float(res["dense/moe_drop_frac"]) == 0.0
    np.testing.assert_allclose(res[f"sharded/{mode}"], res[f"dense/{mode}"],
                               rtol=TOL, atol=TOL)


if __name__ == "__main__":
    _main(sys.argv[1])
