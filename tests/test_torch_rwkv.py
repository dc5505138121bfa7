"""The port's RWKV6 slice against the JAX package on the CPU: the plain WKV6
(the CPU path of ``ops.wkv6``) against the reference's oracle and its
Pallas kernel in interpret mode, on the reference's sweep and on the
decay the model makes; the model-layout scan; time-mix, channel-mix and
the block in prefill then decode, state leaf by leaf; smoke-model logits;
the full configuration's shapes and costing; the contiguous engine
against the JAX engine; and the rungs rwkv6 refuses. Inputs come from
numpy seeds.

Tolerances: float32 1e-5, relative and absolute against the largest
magnitude of the compared array (``_close``): f32 sums of hd terms taken
in another order round by a share of the terms' size, not the result's,
and under the model's decay the WKV state's terms reach ~100 while some
outputs cancel to ~0.1. bf16 inputs 5e-2 as the reference's sweep
(``tests/test_kernels.py``)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as JOPS
from repro.models import Model as JModel
from repro.models import rwkv as JRWKV
from repro.models.costing import workload_of as jax_workload_of
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TOPS
from repro_torch.models import Model
from repro_torch.models import blocks as TB
from repro_torch.models import rwkv as TRWKV
from repro_torch.models.convert import params_from_jax
from repro_torch.models.costing import param_counts, workload_of
from repro_torch.serving import EngineConfig, Request, ServingEngine

ARCH = "rwkv6-1.6b"
REL = {"float32": 1e-5, "bfloat16": 5e-2}
ECFG = dict(max_batch=8, max_len=64, profile="h100_sxm", region="QC")


def _close(got, want, dtype="float32", msg=""):
    """Relative ``REL[dtype]``, and absolute ``REL[dtype]`` times the
    largest magnitude of ``want`` (at least 1)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    rel = REL[dtype]
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def _np_tree(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


def _wkv_inputs(seed, B, H, T, hd, model_decay):
    """r, k, v ~ N(0, 1); u ~ N(0, 0.5); s0 ~ N(0, 0.1). The decay is the
    reference sweep's sigmoid(N(0, 1)), or with ``model_decay`` the one the
    model makes, exp(-exp(-6 + N(0, 0.1))) ~ 0.9975: the state then
    forgets over ~400 steps and grows to ~400 k (x) v terms."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, hd), dtype=np.float32)
               for _ in range(3))
    if model_decay:
        w = np.exp(-np.exp(-6.0 + 0.1 * rng.standard_normal((B, H, T, hd))))
    else:
        w = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, T, hd))))
    u = 0.5 * rng.standard_normal((H, hd))
    s0 = 0.1 * rng.standard_normal((B, H, hd, hd))
    return r, k, v, w.astype(np.float32), u.astype(np.float32), \
        s0.astype(np.float32)


# -------------------------------------------------------------- the WKV6


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,hd", [
    (1, 2, 8, 8),
    (2, 3, 23, 16),     # ragged time blocks in the Pallas kernel
    (1, 4, 64, 32),
])
def test_wkv6_plain_matches_jax(impl, dtype, B, H, T, hd):
    """The reference's sweep shapes, nonzero ``s0``; r/k/v in ``dtype``,
    w, u and s0 float32 (as the model passes them)."""
    r, k, v, w, u, s0 = _wkv_inputs(T * hd, B, H, T, hd, False)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jr, jk, jv = (jnp.asarray(a).astype(jdt) for a in (r, k, v))
    kw = dict(block_t=8) if impl == "pallas_interpret" else {}
    want_o, want_s = JOPS.wkv6(jr, jk, jv, jnp.asarray(w), jnp.asarray(u),
                               jnp.asarray(s0), impl=impl, **kw)
    tr, tk, tv = (torch.from_numpy(a).to(tdt) for a in (r, k, v))
    got_o, got_s = TOPS.wkv6(tr, tk, tv, torch.from_numpy(w),
                             torch.from_numpy(u), torch.from_numpy(s0))
    assert got_o.dtype == got_s.dtype == torch.float32
    _close(got_o, want_o, dtype)
    _close(got_s, want_s, dtype)


@pytest.mark.parametrize("impl,B,H,T,hd", [
    ("pallas_interpret", 2, 2, 96, 32),     # three 32-step time blocks
    ("ref", 1, 2, 1024, 32),                # the state's full growth
])
def test_wkv6_plain_matches_jax_on_model_decay(impl, B, H, T, hd):
    """w ~ 0.9975 as the model makes it: outputs and state grow far past
    the sweep's, and the tolerance stays float32's."""
    r, k, v, w, u, s0 = _wkv_inputs(T + hd, B, H, T, hd, True)
    kw = dict(block_t=32) if impl == "pallas_interpret" else {}
    want_o, want_s = JOPS.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u,
                                                          s0)),
                               impl=impl, **kw)
    got_o, got_s = TOPS.wkv6(*(torch.from_numpy(a) for a in (r, k, v, w, u,
                                                             s0)))
    assert float(np.abs(np.asarray(want_s)).max()) > 10 * float(
        np.abs(s0).max())
    _close(got_o, want_o)
    _close(got_s, want_s)


def test_wkv6_scan_on_model_layout_matches_jax():
    """``rwkv.wkv6_scan`` hands ``ops.wkv6`` transposed (B,T,H,hd) views
    and returns (B,T,H,hd); against the reference model's ``wkv6_scan``.
    With ``s_out = state0`` the state is advanced in place."""
    B, T, H, hd = 2, 37, 3, 16
    r, k, v, w, u, s0 = _wkv_inputs(5, B, H, T, hd, True)
    model = [np.ascontiguousarray(a.transpose(0, 2, 1, 3))
             for a in (r, k, v, w)]
    want_o, want_s = JRWKV.wkv6_scan(*(jnp.asarray(a) for a in model),
                                     jnp.asarray(u), jnp.asarray(s0))
    state = torch.from_numpy(s0.copy())
    got_o, got_s = TRWKV.wkv6_scan(*(torch.from_numpy(a) for a in model),
                                   torch.from_numpy(u), state, state)
    assert got_s is state
    assert got_o.shape == (B, T, H, hd)
    _close(got_o, want_o)
    _close(state, want_s)


def test_wkv6_plain_on_cpu_counts_no_launch():
    TOPS.reset_launches()
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in
                         _wkv_inputs(0, 1, 2, 5, 8, True))
    TOPS.wkv6(r, k, v, w, u, s0)
    TOPS.rmsnorm(r, torch.ones(8), 1e-5)
    assert TOPS.launch_counts()["wkv6"] == 0
    assert TOPS.launch_counts()["rmsnorm"] == 0


# ------------------------------------------------------------ the blocks


def _block_setup(seed=0, dtype=None):
    jcfg = jax_get_config(ARCH, "smoke")
    cfg = get_config(ARCH, "smoke")
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jp = JRWKV.rwkv_layer_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax({"prefix": [_np_tree(jp)], "embed": {},
                          "final_norm": {}},
                         dataclasses.replace(cfg, n_layers=1,
                                             block_pattern=("rwkv6",)),
                         "cpu")["layers"][0]
    return jcfg, cfg, jp, tp


def _state_close(state, jstate, msg):
    for name in ("att_shift", "ffn_shift", "wkv"):
        _close(state[name], jstate[name], msg=f"{msg} {name}")
    np.testing.assert_array_equal(state["length"].numpy(),
                                  np.asarray(jstate["length"]))


def test_time_mix_and_channel_mix_match_jax():
    """Each half of the block on a 20-token prefill from a fresh state,
    then 4 decode steps with the state carried: outputs, the new shifts
    and the WKV state (advanced in place in the port)."""
    jcfg, cfg, jp, tp = _block_setup(seed=1)
    rng = np.random.default_rng(1)
    B, T = 3, 20
    state = TRWKV.init_rwkv_state(cfg, B, "cpu")
    jstate = JRWKV.init_rwkv_state(jcfg, B)
    for step, n in enumerate([T, 1, 1, 1, 1]):
        mode = "prefill" if step == 0 else "decode"
        x = rng.standard_normal((B, n, cfg.d_model), dtype=np.float32)
        want, jshift, jS = JRWKV.time_mix(jp["tmix"], jcfg, jnp.asarray(x),
                                          jstate, mode)
        got, shift = TRWKV.time_mix(tp["tmix"], cfg, torch.from_numpy(x),
                                    state)
        _close(got, want, msg=f"time_mix step {step}")
        _close(state["wkv"], jS, msg=f"wkv step {step}")
        np.testing.assert_array_equal(shift.numpy(), np.asarray(jshift))
        want, jfshift = JRWKV.channel_mix(jp["tmix"], jcfg, jnp.asarray(x),
                                          jstate, mode)
        got, fshift = TRWKV.channel_mix(tp["tmix"], cfg, torch.from_numpy(x),
                                        state)
        _close(got, want, msg=f"channel_mix step {step}")
        np.testing.assert_array_equal(fshift.numpy(), np.asarray(jfshift))
        jstate = dict(jstate, att_shift=jshift, ffn_shift=jfshift, wkv=jS)
        state["att_shift"].copy_(shift)
        state["ffn_shift"].copy_(fshift)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_block_prefill_and_decode_match_jax(dtype):
    """The whole layer through ``blocks.block_apply``: a 20-token prefill
    into a fresh cache, then 4 decode steps; output and every state leaf
    (``att_shift``, ``ffn_shift``, ``wkv``, ``length``) against the
    reference's. bf16: the port's decay and WKV state stay float32 (the
    leaves' dtypes equal the reference's), compared at 5e-2 as the
    reference's bf16 sweeps."""
    jcfg, cfg, jp, tp = _block_setup(seed=2, dtype=dtype)
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    B, T = 2, 20
    jcache = JRWKV.init_rwkv_state(jcfg, B)
    cache = TB.block_cache_init(cfg, "rwkv6", B, 64, "cpu")
    assert {k: str(v.dtype) for k, v in cache.items()} == \
        {k: "torch." + str(v.dtype) for k, v in jcache.items()}
    for step, n in enumerate([T, 1, 1, 1, 1]):
        mode = "prefill" if step == 0 else "decode"
        x = rng.standard_normal((B, n, cfg.d_model), dtype=np.float32)
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        want, jcache = JRWKV.rwkv_block(jp, jcfg, jx, jcache, mode)
        ctx = TB.LayerCtx(cfg=cfg, mode=mode, positions=None)
        got, cache = TB.block_apply(tp, cfg, "rwkv6", ctx,
                                    torch.from_numpy(x).to(tdt), cache)
        _close(got, want, dtype, f"step {step}")
        for name in ("att_shift", "ffn_shift", "wkv"):
            _close(cache[name], jcache[name], dtype, f"step {step} {name}")
        np.testing.assert_array_equal(cache["length"].numpy(),
                                      np.asarray(jcache["length"]))
    assert cache["wkv"].dtype == torch.float32
    assert cache["length"].tolist() == [T + 4] * B


def test_params_from_jax_keeps_float32_leaves():
    """A bf16 configuration: the converted layer has the reference's
    dtypes leaf by leaf (mix, LoRA, w0, u and cmix leaves float32, the
    projections and norms bf16), equal values."""
    _, _, jp, tp = _block_setup(seed=3, dtype="bfloat16")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    f32 = set()
    for (path, j), (_, t) in zip(jl, tl):
        assert "torch." + str(j.dtype) == str(t.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
        if t.dtype == torch.float32:
            f32.add(jax.tree_util.keystr(path))
    assert f32 == {f"['tmix']['{k}']" for k in (
        "mix_x", "mix_base", "mix_lora_A", "mix_lora_B", "w0", "w_lora_A",
        "w_lora_B", "u", "cmix_k", "cmix_r")}


# ------------------------------------------------------------- the model


@functools.lru_cache(maxsize=None)
def _models():
    jmodel = JModel(jax_get_config(ARCH, "smoke"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, "smoke")
    return jmodel, jparams, Model(cfg, "cpu"), params_from_jax(
        _np_tree(jparams), cfg, "cpu")


def test_model_logits_match_jax():
    """An exact-length batch prefilled at once (rwkv6 takes no mask), then
    8 decode steps; logits against the JAX model's at every step, and the
    caches' leaves after the last."""
    jmodel, jparams, model, params = _models()
    rng = np.random.default_rng(7)
    B, S = 3, 20
    tokens = rng.integers(2, 500, (B, S)).astype(np.int32)
    want, jc = jmodel.prefill(jparams, jnp.asarray(tokens), max_len=32)
    got, cache = model.prefill(params, torch.from_numpy(tokens), max_len=32)
    _close(got, want)
    step = jax.jit(jmodel.decode_step)
    for i, tok in enumerate(rng.integers(2, 500, (8, B, 1)).astype(np.int32)):
        want, jc = step(jparams, jc, jnp.asarray(tok))
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        _close(got, want, msg=f"decode step {i}")
    np.testing.assert_array_equal(cache["t"].numpy(), np.asarray(jc["t"]))
    for i, layer in enumerate(cache["layers"]):
        jlayer = jax.tree_util.tree_map(lambda a, i=i: a[i],
                                        jc["unit"]["0"])
        _state_close(layer, jlayer, f"layer {i}")


def test_full_config_shapes_and_costing_match_jax():
    """rwkv6-1.6b at full size: the port's meta-device parameter tree
    equals the reference's leaf by leaf (shape and dtype), 1,599,866,880
    parameters, and ``workload_of`` equals the reference's field by field
    (state 12,779,520 bytes per sequence, no KV)."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    jshapes = JModel(jcfg).param_shapes()
    got = Model(cfg, "cpu").param_shapes()
    assert len(got["layers"]) == 24
    unit = jax.tree_util.tree_map(
        lambda s: (tuple(s.shape[1:]), "torch." + str(s.dtype)),
        jshapes["unit"]["0"])
    for i, layer in enumerate(got["layers"]):
        mine = jax.tree_util.tree_map(lambda t: (tuple(t.shape),
                                                 str(t.dtype)), layer)
        assert mine == unit, i
    for key in ("embed", "final_norm", "lm_head"):
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got[key]) == \
            jax.tree_util.tree_map(lambda s: tuple(s.shape), jshapes[key])
    assert param_counts(cfg) == (1_599_866_880.0, 1_599_866_880.0)
    want = jax_workload_of(jcfg)
    mine = workload_of(cfg)
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    assert mine.state_bytes == 12_779_520 and mine.kv_bytes_per_token == 0
    assert get_config(ARCH, "long") == cfg


# ------------------------------------------------------------ the engine


def _trace():
    """Ragged lengths on exact-length groups, six prefill launches: the
    first admission groups 12, 12 and 12 (three, padded to a batch of
    four) and 9 and 9 (two); 17 and 17 wait and share a group once slots
    free. Request 3 stops on an EOS the model emits, request 0 takes
    only its prefill token."""
    rng = np.random.default_rng(13)
    lens = [12, 9, 12, 9, 12, 30, 5, 3, 17, 17]
    news = [1, 6, 9, 12, 4, 7, 10, 5, 6, 3]
    return [(i, rng.integers(2, 512, L).tolist(), n)
            for i, (L, n) in enumerate(zip(lens, news))]


def _run(engine, make_req, trace, eos):
    for rid, prompt, n in trace:
        engine.submit(make_req(rid=rid, prompt=list(prompt),
                               max_new_tokens=n, eos_id=eos.get(rid)))
    return {r.rid: r for r in engine.run()}


def test_engine_matches_reference():
    """The contiguous engine against the JAX engine on the same (JAX-seeded)
    parameters: tokens, finish reasons, every ``stats()`` key that is not
    a wall-clock reading to 1e-12 relative, the carbon report and the host
    syncs."""
    jmodel, jparams, model, params = _models()
    trace = _trace()
    probe = ServingEngine(model, params, EngineConfig(**ECFG), device="cpu")
    toks = {r.rid: r.tokens for r in _run(probe, Request, trace, {}).values()}
    eos = {3: toks[3][4]}
    jeng = JServingEngine(jmodel, jparams, JEngineConfig(**ECFG))
    teng = ServingEngine(model, params, EngineConfig(**ECFG), device="cpu")
    want = _run(jeng, JRequest, trace, eos)
    got = _run(teng, Request, trace, eos)
    assert sorted(got) == sorted(want) == list(range(len(trace)))
    for rid in want:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid
        assert got[rid].energy_j == pytest.approx(want[rid].energy_j,
                                                  rel=1e-12)
    assert got[3].finish_reason == "eos" and len(got[3].tokens) < 12
    assert teng.prefill_batches == jeng.prefill_batches == 6
    js, ts = jeng.stats(), teng.stats()
    assert set(ts) == set(js)
    for key, val in js.items():
        if key.startswith("queue_wait_"):
            continue
        assert ts[key] == pytest.approx(val, rel=1e-12, abs=0.0), key
    assert teng.carbon_report() == jeng.carbon_report()
    assert teng.host_syncs == jeng.host_syncs


@pytest.mark.parametrize("knob", [
    dict(paged=True),
    dict(paged=True, prefill_chunk=16),
    dict(prefill_chunk=16),
], ids=["paged", "paged+chunk", "chunk"])
def test_rwkv6_refuses_paged_and_chunked_like_reference(knob):
    """rwkv6 is served on the contiguous engine only: the paged pool and
    chunked prefill raise at construction with the reference's message."""
    jmodel, jparams, model, params = _models()
    assert not (model.supports_padded_prefill or model.supports_paged_decode
                or model.supports_chunked_prefill)
    with pytest.raises(ValueError) as want:
        JServingEngine(jmodel, jparams, JEngineConfig(**ECFG, **knob))
    with pytest.raises(ValueError) as got:
        ServingEngine(model, params, EngineConfig(**ECFG, **knob),
                      device="cpu")
    assert str(got.value) == str(want.value)
