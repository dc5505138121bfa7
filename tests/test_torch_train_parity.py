"""The port's ``Model.train_loss`` and its gradients against the JAX
package's, on the CPU in float32, for every architecture: the reference's
10 ``ARCH_IDS`` smoke configs and ``llama-paper-1b`` smoke, with
``tests/conftest.py``'s ``make_extras`` for the VLM (its cross layers'
gates set non-zero: the reference inits them 0), SeamlessM4T and
Llama-4's early fusion. Parameters are the reference's, carried across
by ``convert.params_from_jax``; the reference's gradients are
``jax.value_and_grad`` of its ``train_loss`` (``remat=False``), carried
into the port's layout the same way.

Tolerances: the loss and every metric (``ce``, ``tokens``, ``moe_aux``,
``moe_drop_frac``, ``mtp_ce``, ``loss``) to 1e-5 relative; every
gradient leaf to rtol 1e-3 / atol 1e-5 (float32 sums in another order,
through the backward of each layer). This also mirrors
``tests/test_arch_smoke.py::test_train_step_shapes_and_finite``: every
position's logits of the train forward, finite, and a finite non-zero
gradient norm.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_extras
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import Model as JModel
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax, tree_from_jax
from repro_torch.models.costing import named_leaves
from repro_torch.training.optim import global_norm

ARCHS = list(JAX_ARCH_IDS) + ["llama-paper-1b"]
BATCH, SEQ = 2, 16
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
GATE = 0.5


def set_gates(tree):
    """The numpy tree with every ``cross`` layer's gates at ``GATE``."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATE) if k in ("gate", "gate_mlp")
                    else set_gates(v)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(set_gates(v) for v in tree)
    return tree


def case(arch):
    """(port cfg, JAX model, numpy params, JAX batch, port batch)."""
    jcfg = jax_get_config(arch, "smoke")
    cfg = get_config(arch, "smoke")
    jm = JModel(jcfg)
    np_params = set_gates(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (BATCH, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    extras = {k: np.asarray(v) for k, v in
              make_extras(jcfg, BATCH, SEQ).items()}
    jbatch = {"tokens": tokens, "labels": labels, **extras}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return cfg, jm, np_params, jbatch, tbatch


def grad_tree(params):
    """The ``.grad`` of every leaf (zeros where a leaf took none)."""
    if isinstance(params, dict):
        return {k: grad_tree(v) for k, v in params.items()}
    if isinstance(params, list):
        return [grad_tree(v) for v in params]
    return (params.grad if params.grad is not None
            else torch.zeros_like(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    cfg, jm, np_params, jbatch, tbatch = case(arch)

    def loss_fn(p):
        return jm.train_loss(p, {k: jnp.asarray(v) for k, v in
                                 jbatch.items()}, remat=False)

    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                       np_params))

    model = Model(cfg, "cpu")
    params = params_from_jax(np_params, cfg, "cpu")
    seen = set()
    for _, p in named_leaves(params):
        if id(p) not in seen:
            seen.add(id(p))
            p.requires_grad_(True)
    loss, met = model.train_loss(params, tbatch, remat=False)
    loss.backward()

    assert set(met) == set(jmet), (sorted(met), sorted(jmet))
    for k in jmet:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert np.isfinite(float(loss.detach()))

    want = tree_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg,
                         "cpu")
    got = grad_tree(params)
    paths = 0
    for (path, g), (wpath, w) in zip(named_leaves(got), named_leaves(want)):
        assert path == wpath
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="/".join(path))
        paths += 1
    assert paths == sum(1 for _ in named_leaves(params))
    gnorm = float(global_norm(got))
    assert np.isfinite(gnorm) and gnorm > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_shapes_and_finite(arch):
    cfg, _, np_params, _, tbatch = case(arch)
    model = Model(cfg, "cpu")
    params = params_from_jax(np_params, cfg, "cpu")
    extras = {k: v for k, v in tbatch.items()
              if k not in ("tokens", "labels")}
    with torch.no_grad():
        logits, aux = model.forward(params, tbatch["tokens"], mode="train",
                                    extras=extras)
    assert logits.shape == (BATCH, SEQ, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    assert ("_hidden" in aux) == bool(cfg.mtp)
    if cfg.moe is not None:
        assert {"moe_aux", "moe_z", "moe_drop_frac"} <= set(aux)
