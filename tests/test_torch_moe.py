"""The port's MoE family (Llama-4 Maverick's ``moe`` blocks) against the
JAX package, on the CPU in float32.

* ``moe_ffn`` against the reference's on parameters carried across, over
  seeds and capacity factors (cf 0.25 at E4 k2 drops most tokens): the
  routed ids and keep masks equal, y to 1e-5, the aux losses to 1e-6; and
  the CPU cases of ``tests/test_moe_dispatch.py`` on the port.
* ``tests/test_decode_parity.py``'s chunked-ring, padded-heads and GQA
  cases (the last with ``moe`` blocks) through the port's prefill and
  decode against the JAX model's (1e-4) and its full forward (3e-3, the
  reference's own tolerance).
* Maverick smoke and two small configs with its head map (10 / 2 heads
  padded to 12 / 4, map ``[0 1 0 1 0 3 2 3 2 3 0 0]``), one with
  capacity factor 0.5 so prefill drops real tokens beside pad tokens,
  served on the contiguous engine token for token against the JAX
  engine, with every non-wall-clock ``stats()`` key and each request's
  modeled J to 1e-12; also through the card's head layout (the strided kv
  view at group 5) on the CPU's plain kernels.
* Maverick smoke with full attention (the reference's paged gate
  excludes chunk-local attention) on the paged pool with chunked prefill
  and prefix sharing, at a capacity factor where chunk launches drop real
  tokens and one where nothing drops, token for token against the JAX
  engine (modeled J and gCO2 to 1e-12), expanded and through the card's
  head layout.
* The card's pad-row fill (contiguous and paged), head layouts and
  parameter checks as pure functions; ``workload_of`` for Maverick full,
  smoke and its depth-4 cut; ``layers.normal``'s sliced draw.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import Model as JModel
from repro.models import MoEConfig as JMoEConfig
from repro.models import ModelConfig as JModelConfig
from repro.models import moe as JM
from repro.models.config import repeat_pattern as jax_repeat_pattern
from repro.models.costing import param_counts as jax_param_counts
from repro.models.costing import workload_of as jax_workload_of
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ref as KREF
from repro_torch.models import Model
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.costing import param_counts, workload_of
from repro_torch.models.model import check_head_padding
from repro_torch.serving import EngineConfig, Request, ServingEngine

MAVERICK = "llama4-maverick-400b-a17b"
T = torch.from_numpy
WALL_CLOCK = ("queue_wait_",)


# ---------------------------------------------------------------- moe_ffn
def _moe_cfgs(E, k, cf):
    """The reference dispatch test's config, in both packages."""
    kw = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab=64, dtype="float32",
              vocab_pad_multiple=8)
    moe = dict(n_experts=E, top_k=k, d_ff_expert=16, n_shared_experts=1,
               capacity_factor=cf)
    return (JModelConfig(**kw, block_pattern=jax_repeat_pattern(("moe",), 2),
                         moe=JMoEConfig(**moe)),
            ModelConfig(**kw, block_pattern=("moe", "moe"),
                        moe=MoEConfig(**moe)))


def _keep_reference(ids, E, C):
    """The reference's keep mask (``moe.py``'s sort and counts) in numpy."""
    flat = np.asarray(ids).reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=E)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (np.arange(flat.size) - offsets[flat[order]]) < C


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("E,k,cf", [(4, 2, 2.0), (4, 2, 0.25), (8, 1, 1.25),
                                    (4, 3, 0.5)])
def test_moe_ffn_matches_jax(E, k, cf, seed):
    jcfg, cfg = _moe_cfgs(E, k, cf)
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(seed + 10), (2, 32, 32))
    want, jaux = JM.moe_ffn(jp, jcfg, x)
    p = jax.tree_util.tree_map(lambda a: T(np.array(a)), jp)
    got, aux = TM.moe_ffn(p, cfg, T(np.array(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for key in ("moe_aux", "moe_z", "moe_drop_frac"):
        assert float(aux[key]) == pytest.approx(float(jaux[key]), rel=1e-6,
                                                abs=1e-6), key
    xt = x.reshape(-1, 32)
    _, jids = JM.router_topk(jnp.einsum("td,de->te", xt, jp["router"]), k)
    _, ids = TM.router_topk(T(np.array(xt)) @ p["router"], k)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    C = TM.capacity(cfg, 64)
    _, _, keep, _ = TM.dispatch(ids, E, C)
    assert np.array_equal(keep.numpy(), _keep_reference(jids, E, C))
    if cf < 1:
        assert not keep.all()


def test_capacity_rule_matches_reference():
    for E, k, cf in [(4, 2, 0.25), (128, 1, 1.25), (4, 1, 0.5), (8, 1, 1.25)]:
        _, cfg = _moe_cfgs(E, k, cf)
        for tokens in (1, 8, 64, 100, 4096, 8192):
            C = max(8, int(-(-tokens * k * cf // E)))
            assert TM.capacity(cfg, tokens) == -(-C // 8) * 8
    _, cfg = _moe_cfgs(128, 1, 1.25)
    assert TM.capacity(cfg, 4096) == 40 and TM.capacity(cfg, 8) == 8


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k,shape", [(1, (2, 4)), (2, (1, 4))])
def test_rows_independent_where_no_token_can_drop(k, shape, seed):
    """Where ``can_drop`` is False every (token, choice) pair keeps its
    slot, so a row's output does not move with the other rows' values:
    the card gives dead query rows no fill there (Maverick's decode, 8
    tokens top-1 on 128 experts of 8 slots)."""
    mav = get_config(MAVERICK)
    assert not TM.can_drop(mav, 8) and TM.can_drop(mav, 4096)
    _, cfg = _moe_cfgs(4, k, 2.0)
    assert not TM.can_drop(cfg, shape[0] * shape[1])
    assert TM.can_drop(cfg, 4 * shape[0] * shape[1])
    p = TM.moe_init(torch.Generator().manual_seed(seed), cfg, "cpu")
    g = torch.Generator().manual_seed(seed + 10)
    x = torch.randn(shape + (32,), generator=g)
    y, (_, _, keep) = TM.moe_apply(p, cfg, x)
    assert bool(keep.all())
    x2 = x.clone()
    x2[-1, 2:] = 100.0 * torch.randn(x2[-1, 2:].shape, generator=g)
    y2, _ = TM.moe_apply(p, cfg, x2)
    torch.testing.assert_close(y2.reshape(-1, 32)[:-2],
                               y.reshape(-1, 32)[:-2], atol=1e-6, rtol=1e-6)


# the CPU cases of tests/test_moe_dispatch.py, on the port
def test_router_topk_properties():
    rl = torch.randn((32, 8), generator=torch.Generator().manual_seed(0))
    gates, ids = TM.router_topk(rl, 3)
    assert gates.shape == (32, 3) and ids.shape == (32, 3)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert (gates >= 0).all()
    for row in ids.numpy():
        assert len(set(row)) == 3


def test_load_balance_loss_uniform_is_one():
    """Perfectly uniform routing gives aux loss ~= 1 (Switch convention)."""
    T_, E = 1024, 8
    rl = torch.zeros((T_, E))
    ids = (torch.arange(T_) % E)[:, None]
    assert float(TM.load_balance_loss(rl, ids, E)) == pytest.approx(
        1.0, rel=1e-3)


def test_capacity_drops_under_tight_capacity():
    _, cfg = _moe_cfgs(E=4, k=2, cf=0.25)          # intentionally tight
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 32, 32), generator=torch.Generator().manual_seed(1))
    _, aux = TM.moe_ffn(p, cfg, x)
    assert float(aux["moe_drop_frac"]) > 0


def _finite_and_shaped(seed):
    _, cfg = _moe_cfgs(4, 2, 2.0)
    p = TM.moe_init(torch.Generator().manual_seed(seed), cfg, "cpu")
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(
        seed + 1))
    y, aux = TM.moe_ffn(p, cfg, x)
    assert y.shape == x.shape
    assert torch.isfinite(y).all()
    assert 0.0 <= float(aux["moe_drop_frac"]) <= 1.0


try:
    from hypothesis import given, settings, strategies as st
except ImportError:                # the property test needs hypothesis
    given = None

if given is not None:
    @given(seed=st.integers(0, 20))
    @settings(max_examples=10, deadline=None)
    def test_moe_ffn_finite_and_shaped(seed):
        _finite_and_shaped(seed)
else:
    @pytest.mark.parametrize("seed", [0, 7, 20])
    def test_moe_ffn_finite_and_shaped(seed):
        _finite_and_shaped(seed)


# ------------------------------------------------- decode parity (models)
def _parity(jcfg, S=12, P=8, B=2):
    """tests/test_decode_parity.py's check on the port: prefill P tokens
    and decode the rest one by one, against the JAX model's prefill and
    decode (1e-4) and its full forward (3e-3)."""
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, jcfg.vocab)
    full, _, _ = jm.forward(jp, tokens, {}, mode="train")
    jlast, jc = jm.prefill(jp, tokens[:, :P], {}, max_len=S)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)
                         if f.name != "moe"},
                      moe=(None if jcfg.moe is None else
                           MoEConfig(**dataclasses.asdict(jcfg.moe))))
    model = Model(cfg, "cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                             "cpu")
    toks = T(np.asarray(tokens).astype(np.int32))
    last, cache = model.prefill(params, toks[:, :P], max_len=S)
    for i in range(S - P):
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(last.numpy(), np.asarray(full[:, P + i - 1]),
                                   rtol=3e-3, atol=3e-3)
        if i == S - P - 1:
            break
        last, cache = model.decode_step(params, cache,
                                        toks[:, P + i:P + i + 1])
        jlast, jc = jm.decode_step(jp, jc, tokens[:, P + i:P + i + 1])


def test_chunked_attention_ring_cache():
    _parity(JModelConfig(
        name="p", family="dense", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, dtype="float32",
        attn_chunk=4, global_attn_every=2,
        block_pattern=jax_repeat_pattern(("dense",), 4),
        vocab_pad_multiple=8), S=14)


def test_padded_heads_parity():
    """Head padding must be output-invariant (zeroed pad q heads)."""
    _parity(JModelConfig(
        name="p", family="dense", n_layers=2, d_model=60, n_heads=6,
        n_kv_heads=3, d_ff=128, vocab=128, dtype="float32", head_dim=10,
        rotary_pct=0.4, block_pattern=jax_repeat_pattern(("parallel",), 2),
        vocab_pad_multiple=8, pad_heads_to_multiple=4))


def test_moe_gqa():
    """``test_dense_gqa`` with ``moe`` blocks (E4 top-2 at cf 2.0: no
    expert can overflow, so the full forward's capacity agrees too)."""
    _parity(JModelConfig(
        name="p", family="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, dtype="float32",
        block_pattern=("dense", "moe", "moe"),
        moe=JMoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                       n_shared_experts=1, capacity_factor=2.0),
        vocab_pad_multiple=8))


# ---------------------------------------------------------------- engines
def small_configs(cf):
    """Maverick smoke with Maverick's head map at small size: 10 q / 2 kv
    heads padded to 12 / 4 (map [0 1 0 1 0 3 2 3 2 3 0 0]), head dim 32,
    (dense, moe) x 2, chunk 8 with a global layer every 2nd; ``cf`` the
    capacity factor. Returns (JAX config, port config)."""
    kw = dict(name=f"maverick-map-cf{cf}", n_heads=10, n_kv_heads=2,
              pad_heads_to_multiple=4, head_dim=32, attn_chunk=8,
              global_attn_every=2)
    j = jax_get_config(MAVERICK, "smoke")
    t = get_config(MAVERICK, "smoke")
    return (dataclasses.replace(j, **kw, moe=dataclasses.replace(
                j.moe, capacity_factor=cf)),
            dataclasses.replace(t, **kw, moe=dataclasses.replace(
                t.moe, capacity_factor=cf)))


ECFG = dict(max_batch=4, max_len=64, profile="h100_sxm", region="QC")


def _trace(vocab):
    """Ragged prompts of 3-30 tokens (most wrap the 8-slot rings), one
    prefill-only request, 1-12 new tokens."""
    rng = np.random.default_rng(13)
    lens = [5, 19, 30, 9, 3, 14, 27, 11, 8]
    news = rng.integers(1, 13, len(lens))
    news[4] = 1
    return [(i, rng.integers(2, vocab, L).tolist(), int(n))
            for i, (L, n) in enumerate(zip(lens, news))]


def _serve(engine, make_req, trace):
    for rid, prompt, n in trace:
        engine.submit(make_req(rid=rid, prompt=list(prompt),
                               max_new_tokens=n))
    return {r.rid: r for r in engine.run()}


def _engines_agree(jcfg, cfg, monkeypatch=None, np_edit=None):
    """The JAX engine and the port's on ``_trace``: tokens, finish
    reasons, modeled J, every stats() key but the wall-clock ones and the
    carbon report. ``np_edit`` maps the reference's parameters, as numpy,
    to the ones both engines serve (None: as drawn)."""
    jmodel = JModel(jcfg)
    np_tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    if np_edit is not None:
        np_tree = np_edit(np_tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    params = params_from_jax(np_tree, cfg, "cpu")
    if monkeypatch is not None:
        _card_layout(monkeypatch)
    trace = _trace(cfg.vocab)
    jeng = JServingEngine(jmodel, jparams, JEngineConfig(**ECFG))
    teng = ServingEngine(Model(cfg, "cpu"), params, EngineConfig(**ECFG),
                         device="cpu")
    want = _serve(jeng, JRequest, trace)
    got = _serve(teng, Request, trace)
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        assert got[rid].energy_j == pytest.approx(want[rid].energy_j,
                                                  rel=1e-12)
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key, val in js.items():
        if not key.startswith(WALL_CLOCK):
            assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
    assert teng.carbon_report() == jeng.carbon_report()
    assert teng.host_syncs == jeng.host_syncs
    return jparams, params


def _card_layout(monkeypatch):
    """Route the CPU through the card's head layout: the plain versions
    then run the real q heads over the strided kv view, as the kernels
    do."""
    layout = TA.kernel_head_group.__wrapped__
    monkeypatch.setattr(TA, "kernel_head_group",
                        lambda cfg, device_type: layout(cfg, "cuda"))


def test_maverick_smoke_engine_matches_jax_engine():
    _engines_agree(jax_get_config(MAVERICK, "smoke"),
                   get_config(MAVERICK, "smoke"))


@pytest.mark.parametrize("layout", ["expand", "card"])
@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_maverick_head_map_engine_matches_jax_engine(cf, layout, monkeypatch):
    """Maverick's head map at small size at cf 2.0 and cf 0.5 (every
    prefill launch drops real tokens), expanded as the CPU runs them and
    through the card's layout (group 5 over q heads :10 against kv heads
    ::2)."""
    jcfg, cfg = small_configs(cf)
    assert TA.kernel_head_group.__wrapped__(cfg, "cuda") == (5, 2, 10)
    _engines_agree(jcfg, cfg, monkeypatch if layout == "card" else None)


PAGED_MOE = dict(ECFG, max_len=128, paged=True, prefill_chunk=16,
                 prefill_pack=2, prefix_sharing=True)


def _full_attention(cfg, cf):
    """``cfg`` with full attention (no chunk-local layers) at capacity
    factor ``cf``: what the reference's paged gate admits."""
    return dataclasses.replace(cfg, attn_chunk=None, global_attn_every=0,
                               moe=dataclasses.replace(cfg.moe,
                                                       capacity_factor=cf))


def _count_drops(monkeypatch):
    """Spy on every serving moe call: the real tokens (mask 1, or a decode
    row) and the pad tokens each drops. Returns the (real, pad) list."""
    seen, masks = [], []
    block, apply = TB.block_apply_pending, TM.moe_apply

    def block_spy(p, cfg, kind, ctx, *a):
        masks.append(ctx.mask)
        return block(p, cfg, kind, ctx, *a)

    def moe_spy(p, cfg, x, *groups):
        y, (rl, ids, keep) = apply(p, cfg, x, *groups)
        k = ids.shape[-1]
        order = torch.argsort(ids.reshape(-1), stable=True)
        mask = masks[-1]
        real = (torch.ones(x.shape[:2], dtype=torch.bool) if mask is None
                else mask > 0).reshape(-1)[order // k]
        seen.append((int((~keep & real).sum()), int((~keep & ~real).sum())))
        return y, (rl, ids, keep)

    monkeypatch.setattr(TB, "block_apply_pending", block_spy)
    monkeypatch.setattr(TM, "moe_apply", moe_spy)
    return seen


@pytest.mark.parametrize("layout", ["expand", "card"])
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_paged_chunked_moe_engine_matches_jax_engine(cf, layout,
                                                     monkeypatch):
    """Maverick smoke with full attention on the paged pool, chunk 16
    packed 2, prefix sharing (``test_torch_engine``'s shared-prefix trace),
    against the JAX engine at cf 4 (no token dropped) and cf 0.5 (chunk
    launches drop real tokens), through the CPU's map and the card's head
    layout."""
    from test_torch_engine import _assert_engines_agree, _run, _shared_trace
    jcfg = _full_attention(jax_get_config(MAVERICK, "smoke"), cf)
    cfg = _full_attention(get_config(MAVERICK, "smoke"), cf)
    jmodel = JModel(jcfg)
    np_tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jeng = JServingEngine(jmodel, jparams, JEngineConfig(**PAGED_MOE))
    want = _run(jeng, JRequest, _shared_trace(), {})
    if layout == "card":
        _card_layout(monkeypatch)
    drops = _count_drops(monkeypatch)
    teng = ServingEngine(Model(cfg, "cpu"), params_from_jax(np_tree, cfg,
                                                            "cpu"),
                         EngineConfig(**PAGED_MOE), device="cpu")
    got = _run(teng, Request, _shared_trace(), {})
    _assert_engines_agree(jeng, teng, want, got)
    st = teng.stats()
    assert st["prefix_hit_tokens"] > 0 and teng.prefill_chunks > 0
    real = sum(r for r, _ in drops)
    assert (real > 0) == (cf < 1), drops
    if cf > 1:
        assert not any(p for _, p in drops)


def test_tight_capacity_drops_real_prefill_tokens():
    """The head-map config at cf 0.5 on a padded batch of 19 and 30
    tokens in a bucket of 32: 64 tokens on 4 experts of 8 slots drop at
    least 32, more than the 15 pad tokens, in both MoE layers."""
    _, cfg = small_configs(0.5)
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    seen = []
    apply = TM.moe_apply

    def spy(p, c, x, *groups):
        y, routing = apply(p, c, x, *groups)
        seen.append(float(TM.moe_aux(c, *routing)["moe_drop_frac"]))
        return y, routing

    tokens = torch.randint(2, 500, (2, 32), generator=torch.Generator()
                           .manual_seed(3), dtype=torch.int32)
    mask = (torch.arange(32)[None] < torch.tensor([[19], [30]])).int()
    TM.moe_apply = spy
    try:
        model.prefill(params, tokens, mask, max_len=64)
    finally:
        TM.moe_apply = apply
    # 64 tokens, 4 experts x 8 slots: at least half are dropped, more than
    # the 15 pads
    assert len(seen) == 2 and min(seen) >= 0.5


# ------------------------------------------------ pad rows, layouts, checks
def test_pad_row_fill_matches_plain():
    """The kernels write 0 in a query row that sees no key; the fill gives
    it the plain version's value (the mean of V over the key range)."""
    g = torch.Generator().manual_seed(4)
    B, Hq, Hkv, S, hd = 3, 10, 2, 20, 32
    q = torch.randn((B, S, Hq, hd), generator=g)
    kv = torch.randn((B, S, 2 * Hkv, hd), generator=g)
    k, v = kv[:, :, ::2], kv[:, :, 1::2]             # strided views
    lens = torch.tensor([20, 7, 12])
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    pos = torch.where(pos < lens[:, None], pos, torch.full_like(pos, -1))
    vt = v.transpose(1, 2)
    want = KREF.flash_attention(q.transpose(1, 2), k.transpose(1, 2), vt,
                                pos, pos, chunk=8).transpose(1, 2)
    dead = pos < 0
    kernel_like = torch.where(dead[..., None, None], 0.0, want)
    got = TA._fill_dead_rows(kernel_like, vt, dead)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    # decode: one slot's query at -1 (no key) and a ring past a chunk
    W = 16
    cache_v = torch.randn((B, Hkv, W, hd), generator=g)
    cache_k = torch.randn((B, Hkv, W, hd), generator=g)
    qd = torch.randn((B, Hq, hd), generator=g)
    k_pos = torch.stack([torch.arange(W), torch.arange(W) + 16,
                         torch.full((W,), -1)]).to(torch.int32)
    q_pos = torch.tensor([15, 31, -1], dtype=torch.int32)
    want = KREF.decode_attention(qd, cache_k, cache_v, q_pos, k_pos,
                                 chunk=8)
    dead = ~KREF.attention_mask(q_pos[:, None], k_pos, None, 8).any(-1)
    assert dead.tolist() == [False, False, True]
    got = TA._fill_dead_rows(torch.where(dead[:, None, None], 0.0, want),
                             cache_v, dead)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_paged_pad_row_fill_matches_plain():
    """The paged kernels also write 0 in a row that sees no key; the paged
    fill gives it the plain versions' value: the mean of V over the slot's
    logical view, unmapped pages read as the trash page. Maverick's
    layout at small size: 10 q heads at group 5 over the pool's kv heads
    ::2 (a strided view of 4 duplicated heads)."""
    g = torch.Generator().manual_seed(5)
    B, Hq, Hkv, ps, M, P, hd = 3, 10, 2, 4, 6, 9, 32
    pool = torch.randn((2 * Hkv, P + 1, ps, hd), generator=g)
    kp, vp = pool[::2], pool[1::2]                   # strided views
    tbl = torch.tensor([[0, 3, 5, -1, -1, -1], [1, 2, -1, -1, -1, -1],
                        [4, 6, 7, 8, -1, -1]], dtype=torch.int32)
    lens = torch.tensor([11, 6, 15])
    W = M * ps
    k_pos = torch.arange(W, dtype=torch.int32)[None].expand(B, W)
    k_pos = torch.where(k_pos < lens[:, None], k_pos,
                        torch.full_like(k_pos, -1))
    # chunk: S queries from each slot's cursor, the tail ones pads
    S = 5
    q = torch.randn((B, Hq, S, hd), generator=g)
    start = torch.tensor([[8], [4], [11]])
    q_pos = (start + torch.arange(S)).to(torch.int32)
    q_pos = torch.where(q_pos < lens[:, None], q_pos,
                        torch.full_like(q_pos, -1))
    want = KREF.chunked_prefill_attention(q, kp, vp, tbl, q_pos, k_pos)
    dead = q_pos < 0
    assert dead.any() and not dead.all()
    kernel_like = torch.where(dead[:, None, :, None], 0.0, want)
    got = TA._fill_dead_rows_paged(kernel_like.transpose(1, 2), vp, tbl,
                                   dead).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    # decode: slot 1's query at -1 sees no key
    qd = torch.randn((B, Hq, hd), generator=g)
    qd_pos = torch.tensor([10, -1, 14], dtype=torch.int32)
    want = KREF.paged_decode_attention(qd, kp, vp, tbl, qd_pos, k_pos)
    dead = ~KREF.attention_mask(qd_pos[:, None], k_pos, None, None).any(-1)
    assert dead.tolist() == [False, True, False]
    got = TA._fill_dead_rows_paged(
        torch.where(dead[:, None, None], 0.0, want), vp, tbl, dead)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_ordered_paged_writes_leave_the_last_value_in_the_trash_page():
    """Writes sharing a trash row: ``ordered`` writes store the last one's
    value in each, as a sequential write leaves it, whatever order the
    device commits them in; every other row is the unordered write's."""
    g = torch.Generator().manual_seed(6)
    H, P, ps, hd, B, S = 2, 6, 4, 8, 3, 5
    tbl = torch.tensor([[0, 2, -1], [1, -1, -1], [3, 4, -1]],
                       dtype=torch.int32)
    pos = torch.tensor([[4, 5, -1, -1, -1], [0, 1, 2, -1, -1],
                        [6, 7, 8, 9, -1]], dtype=torch.int32)
    k = torch.randn((B, S, H, hd), generator=g)
    v = torch.randn((B, S, H, hd), generator=g)

    def pool():
        return {"k_pages": torch.zeros((H, P + 1, ps, hd)),
                "v_pages": torch.zeros((H, P + 1, ps, hd)),
                "pos_ids": torch.full((B, 3 * ps), -1, dtype=torch.int32),
                "length": torch.zeros((B,), dtype=torch.int32)}

    plain, ordered = pool(), pool()
    TA.paged_chunk_write(plain, tbl, k, v, pos)
    TA.paged_chunk_write(ordered, tbl, k, v, pos, ordered=True)
    for name in ("k_pages", "v_pages"):
        torch.testing.assert_close(ordered[name][:, :P], plain[name][:, :P],
                                   rtol=0, atol=0)
    for name in ("pos_ids", "length"):
        torch.testing.assert_close(ordered[name], plain[name], rtol=0, atol=0)
    # every pad wrote trash row 0; the last pad is row 2's position 4
    assert torch.equal(ordered["k_pages"][:, P, 0], k[2, 4])
    rows = torch.tensor([0, P * ps, 3, P * ps + 1, P * ps, 5, P * ps + 1])
    assert TA._last_writes(rows, P, ps).tolist() == [0, 4, 2, 6, 4, 5, 6]
    # decode: all three slots past their one-page tables, onto trash row 1
    cache = pool()
    cache["length"] = torch.tensor([5, 13, 13], dtype=torch.int32)
    k1, v1 = torch.randn((B, 1, H, hd), generator=g), torch.randn(
        (B, 1, H, hd), generator=g)
    TA.paged_decode_write(cache, tbl[:, :1].contiguous(), k1, v1,
                          ordered=True)
    assert torch.equal(cache["k_pages"][:, P, 1], k1[2, 0])
    assert torch.equal(cache["v_pages"][:, 0, 1], torch.zeros((H, hd))) \
        and torch.equal(cache["v_pages"][:, P, 1], v1[2, 0])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kernel_head_layout_reads_the_reference_kv_head(arch):
    """For each real q head i the kernels' kv head (i // group) * kv_step
    is a copy of the original kv head the reference's map gives it."""
    for variant in ("full", "smoke"):
        cfg = get_config(arch, variant)
        if cfg.attention_free:
            continue
        group, step, n_q = TA.kernel_head_group(cfg, "cuda")
        n_kv, n_kvp = cfg.n_kv_heads, cfg.n_kv_heads_padded
        dup = n_kvp // n_kv if n_kvp % n_kv == 0 else 1
        idx = TA._kv_index_map(cfg.n_heads, n_kv, cfg.n_heads_padded, n_kvp)
        assert cfg.n_heads <= n_q <= cfg.n_heads_padded
        assert n_q == group * (n_kvp // step)
        for i in range(cfg.n_heads):
            phys = (i // group) * step
            assert phys // dup == idx[i] // dup, (arch, variant, i)


def test_maverick_head_layout():
    full = get_config(MAVERICK)
    assert (full.n_heads_padded, full.n_kv_heads_padded) == (48, 16)
    assert TA.uniform_gqa_group(full) is None
    assert TA.uniform_gqa_group(full, real_only=True) is None
    assert TA.kernel_head_group(full, "cuda") == (5, 2, 40)
    assert TA.kernel_head_group(full, "cpu") is None
    _, cfg = small_configs(2.0)
    assert list(TA._kv_index_map(10, 2, 12, 4)) == [0, 1, 0, 1, 0, 3, 2, 3,
                                                     2, 3, 0, 0]
    assert TA.kernel_head_group(cfg, "cuda") == (5, 2, 10)
    smoke = get_config(MAVERICK, "smoke")
    assert TA.kernel_head_group(smoke, "cuda") == (2, 1, 4)
    # a map none of the three layouts covers still raises on the card
    odd = dataclasses.replace(smoke, n_heads=10, n_kv_heads=5, head_dim=32,
                              pad_heads_to_multiple=4)
    with pytest.raises(ValueError, match="no kernel takes it"):
        TA.kernel_head_group(odd, "cuda")


def test_head_padding_check_raises_on_unequal_kv_copies():
    _, cfg = small_configs(2.0)
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    check_head_padding(params, cfg)                  # attn_init's copies
    hd = cfg.head_dim_
    params["layers"][1]["attn"]["wv"][3, 2 * hd + 5] += 1.0   # head 2
    with pytest.raises(ValueError, match="copies"):
        check_head_padding(params, cfg)


# ---------------------------------------------------------------- costing
def _cut(get, depth=4):
    cfg = get(MAVERICK)
    return dataclasses.replace(cfg, n_layers=depth,
                               block_pattern=cfg.block_pattern[:depth])


@pytest.mark.parametrize("which", ["full", "smoke", "depth4"])
def test_maverick_workload_matches_reference(which):
    if which == "depth4":
        cfg, jcfg = _cut(get_config), _cut(jax_get_config)
        assert cfg.block_pattern == ("dense", "moe", "dense", "moe")
        assert [cfg.layer_uses_chunked_attn(i) for i in range(4)] == \
            [True, True, True, False]
    else:
        cfg, jcfg = get_config(MAVERICK, which), jax_get_config(MAVERICK,
                                                                which)
    assert param_counts(cfg) == jax_param_counts(jcfg)
    assert dataclasses.asdict(workload_of(cfg)) == \
        dataclasses.asdict(jax_workload_of(jcfg))
    if which == "depth4":
        total, active = param_counts(cfg)
        assert (total, active) == (35_123_409_920.0, 3_162_813_440.0)
        # the global layer's KV only: (16 kv heads x 128) x K and V x bf16
        assert workload_of(cfg).kv_bytes_per_token == 2 * 16 * 128 * 2


# ---------------------------------------------------------------- weights
def test_large_normal_draws_in_slices(monkeypatch):
    """A draw is made slice by slice (SLICE_ELEMS elements at most) into
    the result: deterministic from the generator, the target dtype,
    N(0, scale^2)."""
    monkeypatch.setattr(TL, "SLICE_ELEMS", 4096)
    draw = lambda: TL.normal(torch.Generator().manual_seed(5),  # noqa: E731
                             (64, 48, 30), 0.5, torch.bfloat16, "cpu")
    a, b = draw(), draw()
    assert a.dtype == torch.bfloat16 and a.shape == (64, 48, 30)
    assert torch.equal(a, b)
    assert float(a.float().std()) == pytest.approx(0.5, rel=0.02)
    assert abs(float(a.float().mean())) < 0.01
    # a draw of one slice is the whole draw
    whole = TL.normal(torch.Generator().manual_seed(5), (8, 16), 0.5,
                      torch.float32, "cpu")
    ref = torch.randn((8, 16), generator=torch.Generator().manual_seed(5))
    assert torch.equal(whole, ref * 0.5)
