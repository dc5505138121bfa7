"""The port's DeepSeek-V3 family (MLA's latent attention, the ``mla`` and
``mla_moe`` blocks, the MTP head) against the JAX package, on the CPU in
float32.

* ``mla_attention`` on the same parameters and inputs in both packages,
  at rtol = atol = 1e-5: the prefill on the direct path, on the two-level
  scan (``DIRECT_ATTN_MAX_SEQ``, ``Q_CHUNK`` and ``KV_CHUNK`` set low on
  both packages, as the reference's ``test_long_prefill_flash_path``
  does) and on the fused scan (``mla_fused_prefill``); the absorbed decode
  across a ring wrap and after a prompt longer than the ring; with padded
  heads and with a sliding window.
* ``tests/test_decode_parity.py::test_mla_absorbed_decode``'s config
  through the port's prefill and decode against the JAX model's (1e-4)
  and its full forward (3e-3, the reference's own tolerance).
* ``moe_ffn`` at top-8 of 16 experts (k > 2): routed ids, keep masks,
  renormalised gates and outputs equal to the reference's.
* Config, ``param_counts`` and ``workload_of`` equal to the reference's
  at smoke, at full width cut to depth 5 and at the full 61 layers, by
  shapes only (``eval_shape`` there, ``meta`` here); ``params_from_jax``
  carrying every leaf, the MTP head included.
* The norms of a forward (4 an MLA block and the final one, ``kv_norm``
  reading the latent through its row stride), no use of
  ``self_attention`` (so none of its pad-row fill), the paged, chunked and
  fleet refusals; every reference block kind ported, and a forward of
  a small model holding each memory-conditioned kind.

The engines (smoke, a top-8-of-16 config with padded heads at a tight
capacity, the scan path) are in ``tests/test_torch_mla_engine.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import MLAConfig as JMLAConfig
from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.models import MoEConfig as JMoEConfig
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models.config import BLOCK_KINDS as JAX_BLOCK_KINDS
from repro.models.config import repeat_pattern as jax_repeat_pattern
from repro.models.costing import param_counts as jax_param_counts
from repro.models.costing import workload_of as jax_workload_of
from repro_torch.configs import get_config
from repro_torch.kernels import ops as KOPS
from repro_torch.models import Model
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import moe as TM
from repro_torch.models.config import (BLOCK_KINDS, MLAConfig, ModelConfig,
                                       MoEConfig)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.costing import param_counts, workload_of
from repro_torch.serving import (EngineConfig, ServingEngine,
                                 ShardedServingEngine)

DEEPSEEK = "deepseek-v3-671b"
T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-5)


def port_config(jcfg):
    """The port's ModelConfig of a JAX one, field for field."""
    sub = {"mla": MLAConfig, "moe": MoEConfig}
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if f.name in sub and v is not None:
            v = sub[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    return ModelConfig(**kw)


def mla_cfgs(**over):
    """``test_decode_parity.py::test_mla_absorbed_decode``'s config (4
    heads, q_lora 32, kv_lora 16, nope 16, rope 8, v 16, E4 top-2, an MTP
    head), with ``over`` replaced. Returns (JAX config, port config)."""
    kw = dict(name="p", family="moe", n_layers=3, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=128, dtype="float32",
              block_pattern=("mla",) + jax_repeat_pattern(("mla_moe",), 2),
              mla=JMLAConfig(q_lora_rank=32, kv_lora_rank=16,
                             qk_nope_head_dim=16, qk_rope_head_dim=8,
                             v_head_dim=16),
              moe=JMoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                             capacity_factor=2.0),
              mtp=True, vocab_pad_multiple=8)
    kw.update(over)
    jcfg = JModelConfig(**kw)
    return jcfg, port_config(jcfg)


# the module cases: the reference's config, 6 heads padded to 8 (zero
# columns of w_uq / w_uk / w_uv, zero rows of wo), a sliding window of 6
VARIANTS = {"ref": {},
            "padded": dict(n_heads=6, n_kv_heads=6, pad_heads_to_multiple=4),
            "window": dict(sliding_window=6)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: T(np.array(a)), _np(tree))


def _inputs(cfg, B, S, lens, seed):
    """x (B, S, d) N(0, 1) and right-padded positions (-1 past ``lens``),
    as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    pos = np.where(pos < np.asarray(lens)[:, None], pos, -1).astype(np.int32)
    return x, pos


def _close_cache(cache, jcache):
    for name in ("pos_ids", "length"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(jcache[name]), err_msg=name)
    for name in ("ckv", "k_rope"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL,
                                   err_msg=name)


def _jit_mla(jcfg, window, mode):
    """The reference's ``mla_attention`` jitted for one config and mode.
    A new function each call: its trace reads the module's thresholds as
    they are now (a cached trace would keep an earlier test's)."""
    return jax.jit(lambda p, x, pos, cache: JA.mla_attention(
        p, jcfg, x, pos, window, cache, mode=mode))


def _low_scan(monkeypatch, direct, q_chunk=8, kv_chunk=16):
    """The scan's thresholds and block sizes set low on both packages, so
    a 20-token prompt takes several q and kv blocks."""
    for mod in (JA, TA):
        monkeypatch.setattr(mod, "DIRECT_ATTN_MAX_SEQ", direct)
        monkeypatch.setattr(mod, "Q_CHUNK", q_chunk)
        monkeypatch.setattr(mod, "KV_CHUNK", kv_chunk)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("path", ["direct", "scan", "fused"])
def test_mla_prefill_matches_jax(path, variant, monkeypatch):
    """A right-padded prefill (rows of 20, 11 and 1 tokens) through
    ``mla_attention``: output and latent cache equal to the reference's.
    The scan pads 20 queries to 24 and 20 keys to 32 (blocks of 8 and 16);
    the fused path expands the latent in each kv block."""
    over = dict(VARIANTS[variant])
    if path == "fused":
        over["mla_fused_prefill"] = True
    jcfg, cfg = mla_cfgs(**over)
    if path != "direct":
        _low_scan(monkeypatch, direct=8)
    jp = JA.mla_init(jax.random.PRNGKey(3), jcfg)
    p = _torch(jp)
    x, pos = _inputs(cfg, 3, 20, [20, 11, 1], seed=5)
    window = cfg.sliding_window
    jcache = JA.init_mla_cache(jcfg, 3, 24)
    want, jcache = _jit_mla(jcfg, window, "prefill")(
        jp, jnp.asarray(x), jnp.asarray(pos), jcache)
    cache = TA.init_mla_cache(cfg, 3, 24, "cpu")
    got, cache = TA.mla_attention(p, cfg, T(x), T(pos), window, cache,
                                  "prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_cache(cache, jcache)
    # a cache-less forward gives the same output
    alone, none = TA.mla_attention(p, cfg, T(x), T(pos), window, None,
                                   "prefill")
    assert none is None
    torch.testing.assert_close(alone, got, rtol=0, atol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("prompt", [6, 12])
def test_mla_absorbed_decode_matches_jax(prompt, variant):
    """Prefill into a ring of 8 (a 6-token prompt, or a 12-token one whose
    first 4 tokens are evicted at once), then 7 absorbed decode steps: the
    6-token row wraps the ring at its third step, the padded row (3
    tokens) at its sixth. Each step's output and the cache equal to the
    reference's."""
    jcfg, cfg = mla_cfgs(**VARIANTS[variant])
    jp = JA.mla_init(jax.random.PRNGKey(4), jcfg)
    p = _torch(jp)
    x, pos = _inputs(cfg, 2, prompt, [prompt, 3], seed=6)
    window = cfg.sliding_window
    jcache = JA.init_mla_cache(jcfg, 2, 8)
    _, jcache = _jit_mla(jcfg, window, "prefill")(
        jp, jnp.asarray(x), jnp.asarray(pos), jcache)
    decode = _jit_mla(jcfg, window, "decode")
    cache = TA.init_mla_cache(cfg, 2, 8, "cpu")
    TA.mla_attention(p, cfg, T(x), T(pos), window, cache, "prefill")
    _close_cache(cache, jcache)
    rng = np.random.default_rng(prompt)
    for step in range(7):
        x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        q_pos = np.asarray(jcache["length"])[:, None]
        want, jcache = decode(jp, jnp.asarray(x1), jnp.asarray(q_pos),
                              jcache)
        got, cache = TA.mla_attention(p, cfg, T(x1), T(q_pos.copy()),
                                      window, cache, "decode")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {step}")
        _close_cache(cache, jcache)
    # both rows wrapped: the ring holds positions past its width
    assert int(cache["pos_ids"].max()) >= 8


def test_mla_attention_has_no_chunk_mode():
    _, cfg = mla_cfgs()
    p = TA.mla_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="never paged"):
        TA.mla_attention(p, cfg, x, pos, None,
                         TA.init_mla_cache(cfg, 1, 8, "cpu"), "chunk")


# ------------------------------------------------- decode parity (models)
def _parity(jcfg, S=12, P=8, B=2):
    """tests/test_decode_parity.py's check on the port: prefill P tokens
    and decode the rest one by one, against the JAX model's prefill and
    decode (1e-4) and its full forward (3e-3)."""
    jm = JModel(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, jcfg.vocab)
    full, _, _ = jax.jit(lambda p, t: jm.forward(p, t, {}, mode="train"))(
        jp, tokens)
    prefill = jax.jit(lambda p, t: jm.prefill(p, t, {}, max_len=S))
    step = jax.jit(jm.decode_step)
    jlast, jc = prefill(jp, tokens[:, :P])
    cfg = port_config(jcfg)
    model = Model(cfg, "cpu")
    params = params_from_jax(_np(jp), cfg, "cpu")
    toks = T(np.asarray(tokens).astype(np.int32))
    last, cache = model.prefill(params, toks[:, :P], max_len=S)
    for i in range(S - P):
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(last.numpy(),
                                   np.asarray(full[:, P + i - 1]),
                                   rtol=3e-3, atol=3e-3)
        if i == S - P - 1:
            break
        last, cache = model.decode_step(params, cache,
                                        toks[:, P + i:P + i + 1])
        jlast, jc = step(jp, jc, tokens[:, P + i:P + i + 1])


@pytest.mark.parametrize("variant", ["ref", "padded"])
def test_mla_absorbed_decode(variant):
    """The reference's ``test_mla_absorbed_decode`` on the port (and with
    6 heads padded to 8)."""
    _parity(mla_cfgs(**VARIANTS[variant])[0])


# ---------------------------------------------------------------- moe k=8
def _moe_cfgs(E, k, cf):
    kw = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab=64, dtype="float32",
              vocab_pad_multiple=8)
    moe = dict(n_experts=E, top_k=k, d_ff_expert=16, n_shared_experts=1,
               capacity_factor=cf)
    jcfg = JModelConfig(**kw, block_pattern=("moe", "moe"),
                        moe=JMoEConfig(**moe))
    return jcfg, port_config(jcfg)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cf", [2.0, 1.25, 0.5])
def test_moe_top8_of_16_matches_jax(cf, seed):
    """k = 8 of E = 16 (DeepSeek-V3's top-8 at a narrow width): the
    routed ids, the gates renormalised over the 8 chosen (summing to 1),
    the keep mask (cf 0.5 drops pairs) and y equal to the reference's."""
    jcfg, cfg = _moe_cfgs(16, 8, cf)
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(seed + 10), (2, 24, 32))
    want, jaux = jax.jit(lambda p, x: JM.moe_ffn(p, jcfg, x))(jp, x)
    p = _torch(jp)
    got, aux = TM.moe_ffn(p, cfg, T(np.array(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("moe_aux", "moe_z", "moe_drop_frac"):
        assert float(aux[key]) == pytest.approx(float(jaux[key]), rel=1e-6,
                                                abs=1e-6), key
    xt = x.reshape(-1, 32)
    jgates, jids = JM.router_topk(jnp.einsum("td,de->te", xt, jp["router"]),
                                  8)
    gates, ids = TM.router_topk(T(np.array(xt)) @ p["router"], 8)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **TOL)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    C = TM.capacity(cfg, 48)
    _, _, keep, _ = TM.dispatch(ids, 16, C)
    flat = np.asarray(jids).reshape(-1)
    order = np.argsort(flat, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(flat,
                                                         minlength=16))[:-1]])
    assert np.array_equal(keep.numpy(),
                          np.arange(flat.size) - offsets[flat[order]] < C)
    if cf >= 2.0:
        assert bool(keep.all())
    if cf < 1.0:
        assert not bool(keep.all())


def test_deepseek_capacity():
    """max(8, ceil(T 8 1.25 / 256)) rounded to 8: 8 at a decode step of 8
    rows (64 pairs over 256 experts of 8 slots can drop), 160 at a
    4,096-token prefill."""
    cfg = get_config(DEEPSEEK)
    assert TM.capacity(cfg, 8) == 8 and TM.capacity(cfg, 4096) == 160
    assert TM.capacity(cfg, 3072) == 120
    assert TM.can_drop(cfg, 8) and TM.can_drop(cfg, 4096)


# ------------------------------------------------------ config and costing
@pytest.mark.parametrize("variant", ["full", "smoke", "long"])
def test_deepseek_config_matches_reference(variant):
    cfg, jcfg = get_config(DEEPSEEK, variant), jax_get_config(DEEPSEEK,
                                                              variant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.mla) == dataclasses.asdict(jcfg.mla)
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    assert cfg.grouping() == jcfg.grouping()


def _cut(get, depth=5):
    cfg = get(DEEPSEEK)
    return dataclasses.replace(cfg, n_layers=depth,
                               block_pattern=cfg.block_pattern[:depth])


# (total, active, kv bytes a token) of the reference's costing
COUNTS = {"smoke": (2_669_344.0, 2_276_128.0, 3 * (32 + 8) * 2),
          "depth5": (27_587_293_184.0, 5_743_357_952.0, 5 * 576 * 2),
          "full": (671_995_310_080.0, 38_521_188_352.0, 61 * 576 * 2)}


@pytest.mark.parametrize("which", list(COUNTS))
def test_deepseek_costing_matches_reference(which):
    """``param_counts`` from the port's meta-device shapes and
    ``workload_of`` (MLA caches kv_lora + rope values a token a layer)
    equal to the reference's from ``eval_shape``, field for field."""
    if which == "depth5":
        cfg, jcfg = _cut(get_config), _cut(jax_get_config)
        assert cfg.grouping() == (("mla",) * 3, ("mla_moe",), 2)
    else:
        cfg = get_config(DEEPSEEK, which)
        jcfg = jax_get_config(DEEPSEEK, which)
    assert param_counts(cfg) == jax_param_counts(jcfg)
    assert dataclasses.asdict(workload_of(cfg)) == \
        dataclasses.asdict(jax_workload_of(jcfg))
    total, active, kv = COUNTS[which]
    assert param_counts(cfg) == (total, active)
    assert workload_of(cfg).kv_bytes_per_token == kv


def test_mtp_head_is_held_and_counted():
    """The MTP head (``proj`` (2d, d), ``norm``, one ``dense`` block) is
    in the tree with the reference's shapes: 968,905,728 of depth 5's
    parameters."""
    cfg = _cut(get_config)
    shapes = Model(cfg, "meta").param_shapes()
    jshapes = JModel(_cut(jax_get_config)).param_shapes()
    got = {"/".join(str(getattr(k, "key", k)) for k in kp): tuple(v.shape)
           for kp, v in jax.tree_util.tree_flatten_with_path(
               shapes["mtp"])[0]}
    want = {"/".join(str(getattr(k, "key", k)) for k in kp): tuple(v.shape)
            for kp, v in jax.tree_util.tree_flatten_with_path(
                jshapes["mtp"])[0]}
    assert got == want
    assert got["proj"] == (2 * 7168, 7168)
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(
        shapes["mtp"])) == 968_905_728


def test_params_from_jax_carries_every_leaf():
    """The smoke tree's prefix ``mla`` layer, the stacked ``mla_moe`` unit
    at repeats 2 and the MTP head, leaf for leaf."""
    jcfg = jax_get_config(DEEPSEEK, "smoke")
    cfg = get_config(DEEPSEEK, "smoke")
    jp = _np(jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0)))
    params = params_from_jax(jp, cfg, "cpu")
    pairs = [(params["layers"][0], jp["prefix"][0])]
    pairs += [(params["layers"][1 + r],
               jax.tree_util.tree_map(lambda a, r=r: a[r], jp["unit"]["0"]))
              for r in range(2)]
    pairs += [(params["mtp"], jp["mtp"])]
    n = 0
    for mine, theirs in pairs:
        a, b = jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(
            theirs)
        assert jax.tree_util.tree_structure(_np(mine)) == \
            jax.tree_util.tree_structure(theirs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), y)
            n += 1
    assert set(params["layers"][0]["attn"]) == {
        "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}
    assert n > 40


# ------------------------------------------------------------ the forward
def test_forward_norms_and_no_self_attention(monkeypatch):
    """A DeepSeek smoke prefill and decode step: RMSNorm once per norm, 4
    an MLA block (ln1 and ln2 with their residual adds, q_norm, kv_norm)
    and the final one; ``kv_norm`` reads the latent ``dkv[..., :kvr]``
    through its row stride kvr + rope (no copy); ``self_attention``, and
    with it the card's pad-row fill, is never reached."""
    cfg = get_config(DEEPSEEK, "smoke")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    kvr, rope = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    calls = []
    for name in ("rmsnorm", "add_rmsnorm"):
        fn = getattr(KOPS, name)

        def spy(x, *a, fn=fn, **kw):
            calls.append((x.shape[-1], x.stride(-2)))
            return fn(x, *a, **kw)
        monkeypatch.setattr(KOPS, name, spy)

    def refuse(*a, **kw):
        raise AssertionError("self_attention reached on an MLA model")
    monkeypatch.setattr(TA, "self_attention", refuse)
    tokens = torch.randint(2, cfg.vocab, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(16)[None] < torch.tensor([[16], [5]])).int()
    _, caches = model.prefill(params, tokens, mask, max_len=32)
    norms = 4 * cfg.n_layers + 1
    assert len(calls) == norms
    assert calls.count((kvr, kvr + rope)) == cfg.n_layers
    model.decode_step(params, caches, tokens[:, :1])
    assert len(calls) == 2 * norms
    assert set(caches["layers"][0]) == {"ckv", "k_rope", "pos_ids",
                                        "length"}
    assert caches["layers"][2]["ckv"].shape == (2, 32, kvr)


def test_ported_kinds():
    """The port takes every kind of the reference's ``BLOCK_KINDS``, the
    memory-conditioned ones included."""
    assert set(BLOCK_KINDS) == set(JAX_BLOCK_KINDS)
    for kind in ("cross", "enc", "dec"):
        p = TB.block_init(None, _kind_config(kind), kind, "meta")
        assert {"ln1", "attn", "ln2", "mlp"} <= set(p)


def _kind_config(kind):
    """A two-layer config holding ``kind`` (``enc``: an encoder-decoder of
    two ``dec`` layers over a two-layer encoder)."""
    pattern = ("dec", "dec") if kind == "enc" else ("dense", kind)
    return ModelConfig(name="m", family="vlm", n_layers=2, d_model=32,
                       n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                       dtype="float32", block_pattern=pattern,
                       n_image_tokens=6 if kind == "cross" else 0,
                       n_encoder_layers=0 if kind == "cross" else 2,
                       encoder_seq=8, vocab_pad_multiple=8)


@pytest.mark.parametrize("kind", ["cross", "enc", "dec"])
def test_memory_conditioned_kinds_run_a_forward(kind):
    """A two-layer model holding ``kind`` builds on the CPU and runs one
    prefill over its memory and one decode step: finite logits."""
    cfg = _kind_config(kind)
    model = Model(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    memory = torch.randn((2, 8, cfg.d_model), generator=gen) * 0.02
    extras = ({"image_embeds": memory[:, :6]} if kind == "cross"
              else {"frames": memory})
    tokens = torch.randint(2, cfg.vocab, (2, 5), generator=gen)
    logits, caches = model.prefill(params, tokens, max_len=8, extras=extras)
    assert logits.shape == (2, cfg.padded_vocab)
    logits, _ = model.decode_step(params, caches, tokens[:, :1])
    assert torch.isfinite(logits).all()
    if kind == "enc":
        assert len(params["encoder"]) == 2


@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_config(DEEPSEEK, "smoke")
    model = Model(cfg, "cpu")
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("ecfg,match", [
    (dict(paged=True), "MLA's latent cache"),
    (dict(paged=True, prefill_chunk=16), "MLA's latent cache"),
    (dict(prefill_chunk=16), "chunked prefill requires the paged KV pool"),
])
def test_engine_refuses_paged_and_chunked(smoke_model, ecfg, match):
    """As the reference's engine: DeepSeek's latent cache has no paged
    layout, and chunked prefill needs the pool."""
    model, params = smoke_model
    assert not model.supports_paged_decode
    assert not model.supports_chunked_prefill
    assert model.supports_padded_prefill
    with pytest.raises(ValueError, match=match):
        ServingEngine(model, params,
                      EngineConfig(max_batch=2, max_len=64, **ecfg),
                      device="cpu")


def test_fleet_refuses_deepseek(smoke_model):
    """The fleet needs the paged pool, which MLA's cache does not take: a
    ValueError naming it, as the reference's fleet raises."""
    model, params = smoke_model
    with pytest.raises(ValueError, match="MLA's latent cache"):
        ShardedServingEngine(model, params,
                             EngineConfig(max_batch=2, max_len=64, shards=2,
                                          paged=True, prefill_chunk=16),
                             device="cpu")
