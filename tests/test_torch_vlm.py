"""The port's Llama-3.2-Vision family (gated ``cross`` layers attending to
stub image embeddings) and the shared cross-attention against the JAX
package, on the CPU in float32.

The reference initialises both gates of a ``cross`` layer to zero, and
tanh(0) multiplies its cross-attention and its MLP away; every case here
sets them non-zero in the numpy tree before both packages read it.

* ``build_cross_cache`` and ``cross_attention``, gated and ungated, at
  the VLM smoke's 4 / 2 heads, at 8 / 2 heads with the kv heads
  duplicated to 4, and at 6 / 6 heads padded to 8 (rtol = atol = 1e-5);
* the ``cross`` block leaf by leaf: a prefill over the memory (the block's
  output and its ``k``/``v`` cache) and a decode step reading the cache;
* ``Model.prefill(extras)`` and 6 ``decode_step``s against the JAX model
  (1e-4) for the VLM smoke config and ``tests/test_decode_parity.py::
  test_vlm_cross_attention``'s; the image logits differ from the
  text-only ones; ``params_from_jax`` carries every leaf;
* Llama-4's early fusion (image embeddings over token slots) on the
  Maverick smoke config with ``tests/conftest.py``'s extras, computed here;
* config, ``all_configs``, ``param_counts`` (full and smoke, meta device)
  equal to the reference's; each memory kind's parameter and cache
  trees the reference's;
* the contiguous engine on the VLM smoke config against the JAX engine
  (tokens, modeled J and gCO2 to 1e-12, text-only, as the reference's
  engine serves it), and ``paged=True`` / ``prefill_chunk`` refused.

The encoder-decoder family is in ``tests/test_torch_encdec.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models.config import repeat_pattern as jax_repeat_pattern
from repro.models.costing import param_counts as jax_param_counts
from repro_torch.configs import all_configs, get_config
from repro_torch.models import Model
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import frontend as FE
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.costing import param_counts
from repro_torch.serving import EngineConfig, ServingEngine

VLM = "llama-3.2-vision-90b"
MAVERICK = "llama4-maverick-400b-a17b"
T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)
ATOL = 1e-4
GATE, GATE_MLP = 0.7, -0.4     # tanh: 0.604, -0.380


def port_config(jcfg):
    """The port's ModelConfig of a JAX one without sub-configs."""
    return ModelConfig(**dataclasses.asdict(jcfg))


def set_gates(tree):
    """The numpy tree with every ``cross`` layer's gates non-zero."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATE if k == "gate" else GATE_MLP)
                    if k in ("gate", "gate_mlp") else set_gates(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(set_gates(v) for v in tree)
    return tree


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: T(np.array(a)), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def vlm_cfgs(**over):
    """``test_decode_parity.py::test_vlm_cross_attention``'s config (4
    layers, (dense, cross) x 2, 4 / 2 heads, 8 image tokens), with
    ``over`` replaced. Returns (JAX config, port config)."""
    kw = dict(name="p", family="vlm", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab=128, dtype="float32",
              block_pattern=jax_repeat_pattern(("dense", "cross"), 2),
              n_image_tokens=8, vocab_pad_multiple=8)
    kw.update(over)
    jcfg = JModelConfig(**kw)
    return jcfg, port_config(jcfg)


# the cross-attention cases: the smoke's heads, kv heads duplicated (8 / 2
# padded to 4: the map 0 0 1 1 2 2 3 3), q and kv heads padded (6 / 6 to 8)
HEADS = {"smoke": {},
         "dup": dict(n_heads=8, n_kv_heads=2, pad_heads_to_multiple=4),
         "padded": dict(n_heads=6, n_kv_heads=6, head_dim=16,
                        pad_heads_to_multiple=4)}


def _memory(cfg, B, M, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, M, cfg.d_model)) * 0.5).astype(
        np.float32)


# ------------------------------------------------------- cross-attention
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("heads", list(HEADS))
def test_cross_attention_matches_jax(heads, gated):
    """A (3, 5) query block over 11 memory rows: the cross cache's keys
    and values, and the attention's output, equal to the reference's."""
    jcfg, cfg = vlm_cfgs(**HEADS[heads])
    jp = JA.cross_attn_init(jax.random.PRNGKey(1), jcfg, gated=gated)
    np_p = set_gates(_np(jp))
    p = _torch(np_p)
    if gated:
        assert float(p["gate"]) == pytest.approx(GATE)
    if heads == "dup":
        assert cfg.n_kv_heads_padded == 4
        w = p["wk"].reshape(cfg.d_model, 2, 2, cfg.head_dim_)
        assert torch.equal(w[:, :, 0], w[:, :, 1])
    mem = _memory(cfg, 3, 11, seed=2)
    x = _memory(cfg, 3, 5, seed=3)
    jc = JA.build_cross_cache(_jax(np_p), jcfg, jnp.asarray(mem))
    c = TA.build_cross_cache(p, cfg, T(mem))
    for name in ("k", "v"):
        assert c[name].shape == (3, 11, cfg.n_kv_heads_padded,
                                 cfg.head_dim_)
        np.testing.assert_allclose(c[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    want = JA.cross_attention(_jax(np_p), jcfg, jnp.asarray(x), jc)
    got = TA.cross_attention(p, cfg, T(x), c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_zero_gate_multiplies_cross_attention_away():
    """The trap of the reference's init: with its zero gate the layer's
    cross-attention is exactly 0, whatever the memory."""
    _, cfg = vlm_cfgs()
    p = TA.cross_attn_init(torch.Generator().manual_seed(0), cfg, "cpu",
                           gated=True)
    assert p["gate"].shape == () and float(p["gate"]) == 0.0
    c = TA.build_cross_cache(p, cfg, T(_memory(cfg, 2, 8, seed=4)))
    out = TA.cross_attention(p, cfg, T(_memory(cfg, 2, 3, seed=5)), c)
    assert not out.any()


def _jctx(jcfg, mode, positions, memory=None):
    return JB.LayerCtx(cfg=jcfg, mode=mode, positions=jnp.asarray(positions),
                       memory=None if memory is None else jnp.asarray(memory))


def _tctx(cfg, mode, positions, memory=None):
    return TB.LayerCtx(cfg=cfg, mode=mode, positions=T(positions),
                       memory=None if memory is None else T(memory))


def test_cross_block_matches_jax_leaf_by_leaf():
    """A ``cross`` block: a prefill over 8 memory rows builds the cache
    (``k``, ``v``) and the block's output, then a decode step reads that
    cache; both equal to the reference's. The cache leaves are replaced
    whole, and follow the memory's M (here 8 against the 5 of the
    allocation)."""
    jcfg, cfg = vlm_cfgs(n_image_tokens=5)
    np_p = set_gates(_np(JB.block_init(jax.random.PRNGKey(2), jcfg,
                                       "cross")))
    p = _torch(np_p)
    B, S, M = 2, 6, 8
    x = _memory(cfg, B, S, seed=6)
    mem = _memory(cfg, B, M, seed=7)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    jcache = JB.block_cache_init(jcfg, "cross", B, 16)
    cache = TB.block_cache_init(cfg, "cross", B, 16, "cpu")
    assert cache["k"].shape == (B, 5, cfg.n_kv_heads_padded, cfg.head_dim_)
    allocated = cache["k"]
    want, jcache, _ = JB.block_apply(_jax(np_p), jcfg, "cross",
                                     _jctx(jcfg, "prefill", pos, mem),
                                     jnp.asarray(x), jcache)
    got, cache = TB.block_apply(p, cfg, "cross",
                                _tctx(cfg, "prefill", pos, mem), T(x), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(cache) == {"k", "v"} and cache["k"] is not allocated
    for name in ("k", "v"):
        assert cache[name].shape[1] == M
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    x1 = _memory(cfg, B, 1, seed=8)
    dpos = np.full((B, 1), S, np.int32)
    want, _, _ = JB.block_apply(_jax(np_p), jcfg, "cross",
                                _jctx(jcfg, "decode", dpos), jnp.asarray(x1),
                                jcache)
    got, _ = TB.block_apply(p, cfg, "cross", _tctx(cfg, "decode", dpos),
                            T(x1), cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------- model
def _models(jcfg, cfg, seed=0):
    jmodel = JModel(jcfg)
    np_tree = set_gates(_np(jmodel.init(jax.random.PRNGKey(seed))))
    return (jmodel, _jax(np_tree), Model(cfg, "cpu"),
            params_from_jax(np_tree, cfg, "cpu"))


def _images(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model))
            * 0.02).astype(np.float32)


def _prefill_decode_agree(jmodel, jparams, model, params, extras, S=12,
                          B=2, steps=6, max_len=24, seed=9):
    """Prefill (right-padded when B > 1) and ``steps`` decode steps of
    both models: logits within 1e-4. Returns the port's logits."""
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab
    tokens = rng.integers(2, vocab, (B, S)).astype(np.int32)
    lens = np.array([S] + [S - 4 - i for i in range(B - 1)])
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    jx = {k: jnp.asarray(v) for k, v in extras.items()}
    jx["mask"] = jnp.asarray(mask)
    want, jc = jmodel.prefill(jparams, jnp.asarray(tokens), jx,
                              max_len=max_len)
    got, c = model.prefill(params, T(tokens), T(mask), max_len=max_len,
                           extras={k: T(v) for k, v in extras.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    out = [got]
    step = jax.jit(jmodel.decode_step)
    for i in range(steps):
        tok = rng.integers(2, vocab, (B, 1)).astype(np.int32)
        want, jc = step(jparams, jc, jnp.asarray(tok))
        got, c = model.decode_step(params, c, T(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {i}")
        out.append(got)
    return out, c


@pytest.mark.parametrize("which", ["smoke", "parity"])
def test_vlm_prefill_and_decode_match_jax(which):
    """The VLM smoke config (dense, cross) and the reference parity test's
    ((dense, cross) x 2), gates non-zero: prefill with images and 6
    decode steps; then the same tokens without images differ."""
    if which == "smoke":
        jcfg, cfg = jax_get_config(VLM, "smoke"), get_config(VLM, "smoke")
    else:
        jcfg, cfg = vlm_cfgs()
    jmodel, jparams, model, params = _models(jcfg, cfg)
    extras = {"image_embeds": _images(cfg, 2, seed=10)}
    with_img, cache = _prefill_decode_agree(jmodel, jparams, model, params,
                                            extras)
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "cross":
            assert cache["layers"][i]["k"].shape[1] == cfg.n_image_tokens
            assert cache["layers"][i]["k"].any()
    text, _ = _prefill_decode_agree(jmodel, jparams, model, params, {})
    for a, b in zip(with_img, text):
        assert (a - b).abs().max() > 1e-3


def test_vlm_batch_one_unpadded_prefill():
    """One unpadded row, images of another M than ``n_image_tokens`` (12
    against 8): the cross caches take the memory's M."""
    jcfg, cfg = vlm_cfgs()
    jmodel, jparams, model, params = _models(jcfg, cfg, seed=3)
    rng = np.random.default_rng(11)
    img = (rng.standard_normal((1, 12, cfg.d_model)) * 0.02).astype(
        np.float32)
    _, cache = _prefill_decode_agree(jmodel, jparams, model, params,
                                     {"image_embeds": img}, B=1, steps=3)
    assert cache["layers"][1]["v"].shape == (1, 12, 2, cfg.head_dim_)


def test_vlm_params_from_jax_carry_every_leaf():
    """Every leaf of the reference's tree lands in the port's, the gates
    as 0-d tensors, and the port's tree has no other leaf."""
    jcfg, cfg = vlm_cfgs()
    np_tree = set_gates(_np(JModel(jcfg).init(jax.random.PRNGKey(0))))
    params = params_from_jax(np_tree, cfg, "cpu")
    n = 0
    prefix, unit, repeats = jcfg.grouping()
    for r in range(repeats):
        for i, kind in enumerate(unit):
            layer = params["layers"][len(prefix) + r * len(unit) + i]
            ref = jax.tree_util.tree_map(lambda a: a[r],
                                         np_tree["unit"][str(i)])
            got_l = jax.tree_util.tree_leaves_with_path(layer)
            ref_l = jax.tree_util.tree_leaves_with_path(ref)
            assert [k for k, _ in got_l] == [k for k, _ in ref_l]
            for (_, a), (_, b) in zip(got_l, ref_l):
                np.testing.assert_array_equal(a.numpy(), b)
                n += 1
            if kind == "cross":
                assert layer["attn"]["gate"].shape == ()
                assert float(layer["gate_mlp"]) == pytest.approx(GATE_MLP)
    assert n == sum(len(jax.tree_util.tree_leaves(p))
                    for p in params["layers"])
    assert "encoder" not in params
    model = Model(cfg, "meta")
    shapes = model.param_shapes()
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, shapes)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, params))


def test_early_fusion_matches_jax():
    """Llama-4's early fusion: ``image_embeds`` written over the token
    slots ``image_positions`` (the first 8) on the Maverick smoke config,
    as ``tests/conftest.py``'s extras make them; prefill and 3 decode
    steps against the JAX model, and the logits differ from the same
    tokens' without images."""
    jcfg, cfg = (jax_get_config(MAVERICK, "smoke"),
                 get_config(MAVERICK, "smoke"))
    assert cfg.n_image_tokens == 0 and cfg.attn_chunk is not None
    jmodel, jparams, model, params = _models(jcfg, cfg)
    B, S, n_img = 2, 12, 8
    rng = np.random.default_rng(12)
    img = (rng.standard_normal((B, n_img, cfg.d_model)) * 0.02).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(n_img, dtype=np.int32)[None],
                          (B, n_img)).copy()
    np.testing.assert_array_equal(
        FE.image_positions(B, n_img, S, device="cpu").numpy(), pos)
    fused, _ = _prefill_decode_agree(
        jmodel, jparams, model, params,
        {"image_embeds": img, "image_positions": pos}, B=B, S=S, steps=3)
    text, _ = _prefill_decode_agree(jmodel, jparams, model, params, {},
                                    B=B, S=S, steps=3)
    assert (fused[0] - text[0]).abs().max() > 1e-3


def test_frontend_stubs():
    """The port's stub frontends: shape, type, device and scale (0.02),
    deterministic in the generator; early-fusion slots clipped to the
    sequence."""
    gen = torch.Generator().manual_seed(0)
    v = FE.vision_embeddings(gen, 2, 300, 64, device="cpu")
    a = FE.audio_frames(torch.Generator().manual_seed(0), 2, 300, 64,
                        torch.float32, device="cpu")
    assert v.shape == (2, 300, 64) and v.dtype == torch.bfloat16
    assert a.dtype == torch.float32
    assert torch.equal(v, a.to(torch.bfloat16))
    assert 0.015 < float(a.std()) < 0.025
    assert FE.image_positions(3, 10, 4, device="cpu").tolist() == \
        [[0, 1, 2, 3]] * 3


# -------------------------------------------------- configs and costing
def _shapes(tree, path=()):
    """{leaf path: (shape, dtype name)} of a nested dict of arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, path + (key,)).items()}
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("kind", ["cross", "enc", "dec"])
def test_memory_kind_trees_match_reference(kind):
    """Each memory-conditioned kind's parameter tree, and the ``cross``
    and ``dec`` cache trees, hold the reference's leaves at its shapes and
    dtypes (the VLM smoke config for ``cross``, SeamlessM4T's for ``enc``
    and ``dec``). An ``enc`` layer keeps no cache in the port: the
    reference's is a KV cache its encoder never reads."""
    arch = VLM if kind == "cross" else "seamless-m4t-large-v2"
    cfg, jcfg = get_config(arch, "smoke"), jax_get_config(arch, "smoke")
    want = jax.eval_shape(
        lambda: JB.block_init(jax.random.PRNGKey(0), jcfg, kind))
    assert _shapes(TB.block_init(None, cfg, kind, "meta")) == _shapes(want)
    got = TB.block_cache_init(cfg, kind, 2, 16, "meta")
    if kind == "enc":
        assert got is None
        return
    want = jax.eval_shape(lambda: JB.block_cache_init(jcfg, kind, 2, 16))
    assert _shapes(got) == _shapes(want)


@pytest.mark.parametrize("variant", ["full", "smoke", "long"])
def test_all_configs_cover_the_reference(variant):
    ours, ref = all_configs(variant), jax_all_configs(variant)
    assert set(ref) <= set(ours)
    for arch, cfg in ref.items():
        assert dataclasses.asdict(ours[arch]) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", [VLM, "seamless-m4t-large-v2"])
def test_param_counts_match_reference(arch, variant):
    """Shapes only: ``eval_shape`` there, the meta device here. The full
    VLM has 89,344,516,136 parameters, the full SeamlessM4T
    2,034,886,656 (its encoder included)."""
    got = param_counts(get_config(arch, variant))
    assert got == jax_param_counts(jax_get_config(arch, variant))
    if variant == "full":
        assert got[0] == {VLM: 89_344_516_136,
                          "seamless-m4t-large-v2": 2_034_886_656}[arch]


def test_vlm_cut_to_depth_10_param_count():
    """The card's cut: full width, depth 10 (two (dense x 4, cross)
    units), 10,825,670,660 parameters in both packages."""
    full = get_config(VLM)
    cut = dataclasses.replace(full, n_layers=10,
                              block_pattern=full.block_pattern[:10])
    jfull = jax_get_config(VLM)
    jcut = dataclasses.replace(jfull, n_layers=10,
                               block_pattern=jfull.block_pattern[:10])
    assert param_counts(cut) == jax_param_counts(jcut)
    assert param_counts(cut)[0] == 10_825_670_660


# ---------------------------------------------------------------- engine
def test_vlm_smoke_engine_matches_jax_engine():
    """Text-only, as the reference's engine serves a VLM: exact-length
    prefill groups, the cross layers over their zeroed caches (the gates
    non-zero, so the gated MLP counts); tokens, modeled J and gCO2 to
    1e-12."""
    from test_torch_moe import _engines_agree
    jcfg, cfg = jax_get_config(VLM, "smoke"), get_config(VLM, "smoke")
    assert not Model(cfg, "cpu").supports_padded_prefill
    _engines_agree(jcfg, cfg, np_edit=set_gates)


def test_vlm_engine_refuses_paged_and_chunked_prefill():
    cfg = get_config(VLM, "smoke")
    model = Model(cfg, "cpu")
    assert not model.supports_paged_decode
    assert not model.supports_chunked_prefill
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="paged KV pool"):
        ServingEngine(model, params, EngineConfig(max_batch=2, max_len=32,
                                                  paged=True), device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(model, params, EngineConfig(max_batch=2, max_len=32,
                                                  prefill_chunk=8),
                      device="cpu")
