"""The port's encoder-decoder family (SeamlessM4T: bidirectional ``enc``
layers over stub audio frames, ``dec`` layers of self-attention,
cross-attention to the encoder output and SwiGLU) against the JAX
package, on the CPU in float32.

* the ``enc`` block with and without a frames mask, and the ``dec`` block
  leaf by leaf over a prefill (output, self-attention cache, the
  memory's ``xk``/``xv``) and two decode steps (rtol = atol = 1e-5);
* ``Model.prefill(extras)`` and 6 ``decode_step``s against the JAX model
  (1e-4) for the SeamlessM4T smoke config and ``tests/test_decode_parity.
  py::test_encdec_decoder``'s, with and without ``frames_mask``, and at
  GQA with the kv heads duplicated; the encoder runs in prefill only;
* ``params_from_jax`` carrying the stacked encoder; ``check_head_padding``
  reading ``xattn`` and the encoder's attention;
* RMSNorm once a norm: 2 an ``enc`` layer, ``enc_norm``, 3 a ``dec``
  layer and the final one in prefill, no encoder norm in decode;
* both engines refusing an encoder-decoder model, as neither serves it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.models import blocks as JB
from repro.models.config import repeat_pattern as jax_repeat_pattern
from repro_torch.configs import get_config
from repro_torch.kernels import ops as KOPS
from repro_torch.models import Model
from repro_torch.models import blocks as TB
from repro_torch.models import frontend as FE
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import check_head_padding
from repro_torch.serving import (EngineConfig, ServingEngine,
                                 ShardedServingEngine)

SEAMLESS = "seamless-m4t-large-v2"
T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)
ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: T(np.array(a)), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def encdec_cfgs(**over):
    """``test_decode_parity.py::test_encdec_decoder``'s config (3 ``dec``
    layers, 2 encoder layers over 10 frames, 4 / 4 heads), with ``over``
    replaced. Returns (JAX config, port config)."""
    kw = dict(name="p", family="audio", n_layers=3, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=128, dtype="float32",
              block_pattern=jax_repeat_pattern(("dec",), 3),
              n_encoder_layers=2, encoder_seq=10, vocab_pad_multiple=8)
    kw.update(over)
    jcfg = JModelConfig(**kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


# 8 q / 2 kv heads duplicated to 4: the map 0 0 1 1 2 2 3 3
GQA = dict(n_heads=8, n_kv_heads=2, pad_heads_to_multiple=4)


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _frames_mask(B, M):
    """Row 0 whole, the others with their last half (then a third, ...)
    masked."""
    m = np.ones((B, M), np.int32)
    for b in range(1, B):
        m[b, M - M // (b + 1):] = 0
    return m


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("heads", ["mha", "gqa"])
def test_enc_block_matches_jax(heads, masked):
    """One ``enc`` block over 10 frames at positions 0..9 (rope), every
    frame seeing every unmasked frame."""
    jcfg, cfg = encdec_cfgs(**(GQA if heads == "gqa" else {}))
    np_p = _np(JB.block_init(jax.random.PRNGKey(1), jcfg, "enc"))
    B, M = 3, 10
    x = _rand((B, M, cfg.d_model), seed=1)
    pos = np.arange(M, dtype=np.int32)[None].repeat(B, 0)
    mask = _frames_mask(B, M) if masked else None
    jctx = JB.LayerCtx(cfg=jcfg, mode="train", positions=jnp.asarray(pos),
                       mask=None if mask is None else jnp.asarray(mask))
    want, jcache, _ = JB.block_apply(_jax(np_p), jcfg, "enc", jctx,
                                     jnp.asarray(x), None)
    ctx = TB.LayerCtx(cfg=cfg, mode="prefill", positions=T(pos),
                      mask=None if mask is None else T(mask))
    got, cache = TB.block_apply(_torch(np_p), cfg, "enc", ctx, T(x), None)
    assert jcache is None and cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert TB.block_cache_init(cfg, "enc", B, 16, "cpu") is None


@pytest.mark.parametrize("heads", ["mha", "gqa"])
def test_dec_block_matches_jax_leaf_by_leaf(heads):
    """A ``dec`` block: a right-padded prefill over 10 memory rows (its
    output, the self-attention's k, v, pos_ids and length, and the
    memory's xk and xv, replaced whole), then two decode steps reading
    the cache."""
    jcfg, cfg = encdec_cfgs(**(GQA if heads == "gqa" else {}))
    np_p = _np(JB.block_init(jax.random.PRNGKey(2), jcfg, "dec"))
    p = _torch(np_p)
    B, S, M, W = 2, 7, 10, 12
    x = _rand((B, S, cfg.d_model), seed=2)
    mem = _rand((B, M, cfg.d_model), seed=3)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    pos[1, 4:] = -1
    jcache = JB.block_cache_init(jcfg, "dec", B, W)
    cache = TB.block_cache_init(cfg, "dec", B, W, "cpu")
    assert set(cache) == set(jcache)
    jctx = JB.LayerCtx(cfg=jcfg, mode="prefill", positions=jnp.asarray(pos),
                       memory=jnp.asarray(mem))
    want, jcache, _ = JB.block_apply(_jax(np_p), jcfg, "dec", jctx,
                                     jnp.asarray(x), jcache)
    ctx = TB.LayerCtx(cfg=cfg, mode="prefill", positions=T(pos),
                      memory=T(mem))
    got, cache = TB.block_apply(p, cfg, "dec", ctx, T(x), cache)
    rows = pos >= 0
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               **TOL)

    def same_cache():
        for name in ("pos_ids", "length"):
            np.testing.assert_array_equal(cache[name].numpy(),
                                          np.asarray(jcache[name]))
        for name in ("k", "v", "xk", "xv"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL,
                                       err_msg=name)
    same_cache()
    for step in range(2):
        x1 = _rand((B, 1, cfg.d_model), seed=10 + step)
        dpos = np.asarray(jcache["length"])[:, None].astype(np.int32)
        jctx = JB.LayerCtx(cfg=jcfg, mode="decode",
                           positions=jnp.asarray(dpos))
        want, jcache, _ = JB.block_apply(_jax(np_p), jcfg, "dec", jctx,
                                         jnp.asarray(x1), jcache)
        ctx = TB.LayerCtx(cfg=cfg, mode="decode", positions=T(dpos))
        got, cache = TB.block_apply(p, cfg, "dec", ctx, T(x1), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        same_cache()


# ----------------------------------------------------------------- model
def _models(jcfg, cfg, seed=0):
    jmodel = JModel(jcfg)
    np_tree = _np(jmodel.init(jax.random.PRNGKey(seed)))
    return (jmodel, _jax(np_tree), Model(cfg, "cpu"),
            params_from_jax(np_tree, cfg, "cpu"))


CASES = {"smoke": lambda: (jax_get_config(SEAMLESS, "smoke"),
                           get_config(SEAMLESS, "smoke")),
         "parity": encdec_cfgs,
         "gqa": lambda: encdec_cfgs(**GQA)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_encdec_prefill_and_decode_match_jax(case, masked):
    """A right-padded decoder prompt (12 and 8 tokens) over the encoder's
    output for frames of ``encoder_seq`` rows, the second row's later
    frames masked where ``masked``; 6 decode steps; logits within 1e-4."""
    jcfg, cfg = CASES[case]()
    jmodel, jparams, model, params = _models(jcfg, cfg)
    B, S, M = 2, 12, cfg.encoder_seq
    rng = np.random.default_rng(4)
    extras = {"frames": _rand((B, M, cfg.d_model), seed=5, scale=0.02)}
    if masked:
        extras["frames_mask"] = _frames_mask(B, M)
    tokens = rng.integers(2, cfg.vocab, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.array([[S], [8]])).astype(np.int32)
    jx = {k: jnp.asarray(v) for k, v in extras.items()}
    jx["mask"] = jnp.asarray(mask)
    want, jc = jmodel.prefill(jparams, jnp.asarray(tokens), jx, max_len=24)
    got, c = model.prefill(params, T(tokens), T(mask), max_len=24,
                           extras={k: T(v) for k, v in extras.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    step = jax.jit(jmodel.decode_step)
    for i in range(6):
        tok = rng.integers(2, cfg.vocab, (B, 1)).astype(np.int32)
        want, jc = step(jparams, jc, jnp.asarray(tok))
        got, c = model.decode_step(params, c, T(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {i}")


def test_frames_mask_changes_the_logits():
    """Masking the later half of a row's frames moves that row's logits
    and leaves the unmasked row's exactly as they were."""
    _, cfg = encdec_cfgs()
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    frames = FE.audio_frames(torch.Generator().manual_seed(1), 2,
                             cfg.encoder_seq, cfg.d_model, torch.float32,
                             device="cpu")
    tokens = torch.randint(2, cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(2))
    full, _ = model.prefill(params, tokens, extras={"frames": frames})
    fm = T(_frames_mask(2, cfg.encoder_seq))
    part, _ = model.prefill(params, tokens,
                            extras={"frames": frames, "frames_mask": fm})
    torch.testing.assert_close(part[0], full[0], rtol=0, atol=0)
    assert (part[1] - full[1]).abs().max() > 1e-4


def test_encoder_runs_in_prefill_only(monkeypatch):
    """RMSNorm once a norm: a prefill 2 an ``enc`` layer + ``enc_norm`` +
    3 a ``dec`` layer + the final norm (the card's 48 + 1 + 72 + 1 = 122
    at SeamlessM4T's 24 + 24 layers); a decode step 3 a ``dec`` layer + 1,
    no encoder; a prefill without frames refused."""
    cfg = get_config(SEAMLESS, "smoke")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    calls = []
    for name in ("rmsnorm", "add_rmsnorm"):
        fn = getattr(KOPS, name)

        def spy(*a, fn=fn, **kw):
            calls.append(1)
            return fn(*a, **kw)
        monkeypatch.setattr(KOPS, name, spy)
    encoded = []
    encode = model._encode
    monkeypatch.setattr(model, "_encode",
                        lambda *a: encoded.append(1) or encode(*a))
    frames = FE.audio_frames(torch.Generator().manual_seed(1), 2,
                             cfg.encoder_seq, cfg.d_model, torch.float32,
                             device="cpu")
    tokens = torch.randint(2, cfg.vocab, (2, 5),
                           generator=torch.Generator().manual_seed(3))
    _, caches = model.prefill(params, tokens, max_len=16,
                              extras={"frames": frames})
    L, E = cfg.n_layers, cfg.n_encoder_layers
    assert len(calls) == 2 * E + 1 + 3 * L + 1 and encoded == [1]
    model.decode_step(params, caches, tokens[:, :1])
    assert len(calls) == 2 * E + 1 + 3 * L + 1 + 3 * L + 1
    assert encoded == [1]
    assert caches["layers"][0]["xk"].shape == (
        2, cfg.encoder_seq, cfg.n_kv_heads_padded, cfg.head_dim_)
    with pytest.raises(ValueError, match="frames"):
        model.prefill(params, tokens, max_len=16)


def test_encdec_params_from_jax_carry_the_encoder():
    """The stacked encoder becomes a per-layer list, leaf for leaf, beside
    ``enc_norm``; every ``dec`` layer's ``xattn`` comes across."""
    jcfg, cfg = encdec_cfgs()
    np_tree = _np(JModel(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_jax(np_tree, cfg, "cpu")
    assert len(params["encoder"]) == cfg.n_encoder_layers
    for i, layer in enumerate(params["encoder"]):
        ref = jax.tree_util.tree_map(lambda a: a[i], np_tree["encoder"])
        got_l = jax.tree_util.tree_leaves_with_path(layer)
        ref_l = jax.tree_util.tree_leaves_with_path(ref)
        assert [k for k, _ in got_l] == [k for k, _ in ref_l]
        for (_, a), (_, b) in zip(got_l, ref_l):
            np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(params["enc_norm"]["scale"].numpy(),
                                  np_tree["enc_norm"]["scale"])
    for r, layer in enumerate(params["layers"]):
        np.testing.assert_array_equal(
            layer["xattn"]["wv"].numpy(),
            np_tree["unit"]["0"]["xattn"]["wv"][r])
    shapes = Model(cfg, "meta").param_shapes()
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, shapes)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, params))


@pytest.mark.parametrize("where", ["xattn", "encoder"])
def test_head_padding_check_reads_xattn_and_encoder(where):
    """Duplicated kv heads (8 / 2 to 4): unequal copies in a ``dec``
    layer's ``xattn`` or in an encoder layer's ``attn`` raise."""
    _, cfg = encdec_cfgs(**GQA)
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    check_head_padding(params, cfg)
    a = (params["layers"][1]["xattn"] if where == "xattn"
         else params["encoder"][1]["attn"])
    a["wk"][3, cfg.head_dim_ + 2] += 1.0            # copy 1 of kv head 0
    with pytest.raises(ValueError, match="copies"):
        check_head_padding(params, cfg)


def test_engines_refuse_encoder_decoder():
    """Neither engine serves an encoder-decoder model (a Request carries no
    frames; the reference's engine fails at its first prefill)."""
    cfg = get_config(SEAMLESS, "smoke")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="frames"):
        ServingEngine(model, params, EngineConfig(max_batch=2, max_len=32),
                      device="cpu")
    with pytest.raises(ValueError, match="frames"):
        ShardedServingEngine(model, params, EngineConfig(
            max_batch=2, max_len=32, shards=2, paged=True, prefill_chunk=8),
            device="cpu")
