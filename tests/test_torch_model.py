"""The port's model against the JAX ``Model`` on the JAX package's own
seeded parameters (carried over by ``params_from_jax``): prefill logits of
a right-padded batch and 8 decode-step logits, with the reference running
``attn_impl="ref"`` and ``"pallas_interpret"``. float32 smoke configs;
atol 1e-4 covers f32 matmuls summed in another order over a few layers.
Also: config and ``workload_of`` equal to the reference field for field
(the meter's modeled J depends on every workload field)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import Model as JModel
from repro.models.costing import workload_of as jax_workload_of
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.costing import workload_of

ATOL = 1e-4
SMOKE = ["llama-paper-1b", "llama3.2-1b"]


@pytest.mark.parametrize("variant", ["full", "smoke", "long"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_reference(arch, variant):
    assert dataclasses.asdict(get_config(arch, variant)) == \
        dataclasses.asdict(jax_get_config(arch, variant))


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_workload_matches_reference(arch, variant):
    cfg = get_config(arch, variant)
    assert dataclasses.asdict(workload_of(cfg)) == \
        dataclasses.asdict(jax_workload_of(jax_get_config(arch, variant)))


def _jax_model(arch, impl):
    cfg = dataclasses.replace(jax_get_config(arch, "smoke"), attn_impl=impl)
    model = JModel(cfg)
    return model, model.init(jax.random.PRNGKey(0))


def _port(arch, jparams):
    cfg = get_config(arch, "smoke")
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return Model(cfg, "cpu"), params_from_jax(np_tree, cfg, "cpu")


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_and_decode_logits(arch, impl):
    """Right-padded batch; max_len 24 < prompt + 8 decode steps, so the
    ring wraps during decode (pos_ids stop being sorted)."""
    jmodel, jparams = _jax_model(arch, impl)
    model, params = _port(arch, jparams)
    rng = np.random.default_rng(7)
    B, S, max_len = 3, 20, 24
    tokens = rng.integers(2, 500, (B, S)).astype(np.int32)
    lengths = np.array([20, 13, 17])
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)

    prefill = jax.jit(functools.partial(jmodel.prefill, max_len=max_len))
    want, jcache = prefill(jparams, jnp.asarray(tokens),
                           {"mask": jnp.asarray(mask)})
    got, cache = model.prefill(params, torch.from_numpy(tokens),
                               torch.from_numpy(mask), max_len=max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)

    step = jax.jit(jmodel.decode_step)
    for i in range(8):
        tok = rng.integers(2, 500, (B, 1)).astype(np.int32)
        want, jcache = step(jparams, jcache, jnp.asarray(tok))
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {i}")
    # the caches agree too (positions exactly, keys to tolerance)
    jl = jcache["unit"]["0"]
    for layer in range(2):
        np.testing.assert_array_equal(
            cache["layers"][layer]["pos_ids"].numpy(),
            np.asarray(jl["pos_ids"][layer]))
        np.testing.assert_allclose(cache["layers"][layer]["k"].numpy(),
                                   np.asarray(jl["k"][layer]), atol=ATOL)


@pytest.mark.parametrize("arch", SMOKE)
def test_prefill_longer_than_ring(arch):
    """S > W: only the last W tokens survive, by the reference's gather."""
    jmodel, jparams = _jax_model(arch, "ref")
    model, params = _port(arch, jparams)
    rng = np.random.default_rng(3)
    tokens = rng.integers(2, 500, (2, 21)).astype(np.int32)
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=8)
    got, cache = model.prefill(params, torch.from_numpy(tokens), max_len=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    jl = jcache["unit"]["0"]
    np.testing.assert_array_equal(cache["layers"][1]["pos_ids"].numpy(),
                                  np.asarray(jl["pos_ids"][1]))
    np.testing.assert_array_equal(cache["layers"][1]["length"].numpy(),
                                  np.asarray(jl["length"][1]))


def test_params_from_jax_unstacks_every_layer():
    jmodel, jparams = _jax_model("llama3.2-1b", "ref")
    _, params = _port("llama3.2-1b", jparams)
    wq = np.asarray(jparams["unit"]["0"]["attn"]["wq"])   # (repeats, d, h)
    for r in range(wq.shape[0]):
        np.testing.assert_array_equal(
            params["layers"][r]["attn"]["wq"].numpy(), wq[r])
    assert params["lm_head"] == {}                          # tied embeddings


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(get_config("llama-paper-1b", "smoke"))
