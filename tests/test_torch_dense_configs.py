"""The dense configurations the port added for the paper's LLaMA-3B and
-7B, InternLM2-20B, MiniCPM-2B and StableLM-2-12B, against the JAX package
on the CPU:

* head dim 100 (LLaMA-3B), GQA group 3 (InternLM2-20B) and head dim 160
  at group 2 (StableLM-2-12B) in the plain flash, decode, paged-decode
  and chunked-prefill attention (the CPU path of ``kernels/ops.py``)
  against the JAX ops through the Pallas kernels in interpret mode and
  through the jnp oracles: float32 atol/rtol 1e-4, bf16 2e-2 as the
  reference's sweep (``tests/test_kernels.py``);
* partial rotary (``rotary_pct`` 0.25 and 0.4) against the reference's
  ``apply_rope``;
* logits of two-layer models at head dim 100, at group 3 and of the
  ``parallel`` block at head dim 160 (qk-norm, 25% rotary, group 2)
  (prefill, decode around the ring, and chunk mode over a paged pool)
  against the JAX ``Model`` on its own parameters (``params_from_jax``),
  atol 1e-4;
* MiniCPM's padded head map: the card runs its 48 padded heads through
  the group-1 kernels with the identity map (``kernel_head_group``); run
  through the plain versions here, that path gives logits bit-identical
  to the reference's expanded map, and the check on the padded heads' wo
  rows raises on a tree where they are not zero;
* ``minicpm-2b``, ``internlm2-20b`` and ``stablelm-12b`` smoke served by
  the paged engine (chunked prefill and prefix sharing), and
  ``stablelm-12b`` by the contiguous engine, against the JAX engine:
  identical tokens, every non-wall-clock ``stats()`` key to 1e-12
  relative (modeled J and gCO2 included).

Inputs are made with numpy from a seed and handed to both packages."""
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
from repro.models import layers as JL
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving import paged as JPG
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TOPS
from repro_torch.models import Model
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import check_head_padding
from repro_torch.serving import EngineConfig, Request, ServingEngine
from repro_torch.serving import paged as TPG

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
ATOL = 1e-4
T = torch.from_numpy
WALL_CLOCK = ("queue_wait_",)


def _both(x, dtype):
    """x (numpy float32) as a JAX and a torch array of ``dtype``: both
    round to nearest even, so the two hold the same values."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            T(x).to(getattr(torch, dtype)))


def _close(got, want, dtype, rows=None):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, **TOL[dtype])


# ------------------------------------------------------------------ kernels
# (hd, group): LLaMA-3B's head dim on MHA, group 3 at a narrow head dim,
# both at once, and StableLM-2-12B's head dim 160 at its group 2
SHAPES = pytest.mark.parametrize("hd,group", [(100, 1), (32, 3), (100, 3),
                                              (160, 2)])
DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
IMPLS = pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])


@IMPLS
@DTYPES
@SHAPES
def test_flash_plain_matches_jax(impl, dtype, hd, group):
    rng = np.random.default_rng(hd * 10 + group)
    B, Hkv, S = 2, 2, 40
    Hq = Hkv * group
    xs = [rng.standard_normal((B, H, S, hd), dtype=np.float32)
          for H in (Hq, Hkv, Hkv)]
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1, 29:] = -1                                  # right padding
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in xs)
    want = jax.jit(functools.partial(JOPS.flash_attention, impl=impl))(
        jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos))
    got = TOPS.flash_attention(tq, tk, tv, T(pos), T(pos))
    rows = np.broadcast_to((pos >= 0)[:, None, :, None], got.shape)
    _close(got, want, dtype, rows)


@IMPLS
@DTYPES
@SHAPES
def test_decode_plain_matches_jax(impl, dtype, hd, group):
    rng = np.random.default_rng(hd * 10 + group + 1)
    B, Hkv, W = 3, 2, 48
    Hq = Hkv * group
    q = rng.standard_normal((B, Hq, hd), dtype=np.float32)
    k = rng.standard_normal((B, W, Hkv, hd), dtype=np.float32)
    v = rng.standard_normal((B, W, Hkv, hd), dtype=np.float32)
    k_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    for b, n in enumerate([7, W, W + 19]):           # partial, full, wrapped
        for t in range(max(0, n - W), n):
            k_pos[b, t % W] = t
        q_pos[b] = n - 1
    k_pos[0, 2] = -1                                  # a pad row
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    want = jax.jit(functools.partial(JOPS.decode_attention, impl=impl))(
        jq, jnp.moveaxis(jk, 1, 2), jnp.moveaxis(jv, 1, 2),
        jnp.asarray(q_pos), jnp.asarray(k_pos))
    got = TOPS.decode_attention(tq, tk.transpose(1, 2), tv.transpose(1, 2),
                                T(q_pos), T(k_pos))
    _close(got, want, dtype)


def _pool(rng, B, Hkv, hd, ps, M, lens, S=None):
    """A pool of B*M pages from a shuffled permutation, slot b holding
    lens[b] tokens, logical page 1 of slot 0 unmapped (-1) when it is
    long enough; with ``S`` the last min(S, len) tokens are the chunk."""
    P = B * M
    kp = rng.standard_normal((Hkv, P + 1, ps, hd), dtype=np.float32)
    vp = rng.standard_normal((Hkv, P + 1, ps, hd), dtype=np.float32)
    perm = rng.permutation(P)
    tbl = np.full((B, M), -1, np.int32)
    k_pos = np.full((B, M * ps), -1, np.int32)
    pi = 0
    for b, L in enumerate(lens):
        npg = -(-L // ps)
        tbl[b, :npg] = perm[pi:pi + npg]
        pi += npg
        k_pos[b, :L] = np.arange(L)
    if lens[0] > 2 * ps:
        tbl[0, 1] = -1
        k_pos[0, ps:2 * ps] = -1
    if S is None:
        q_pos = np.array([L - 1 for L in lens], np.int32)
    else:
        q_pos = np.full((B, S), -1, np.int32)
        for b, L in enumerate(lens):
            nv = min(S, L)
            q_pos[b, :nv] = np.arange(L - nv, L)
    return kp, vp, tbl, q_pos, k_pos


@IMPLS
@DTYPES
@SHAPES
def test_paged_decode_plain_matches_jax(impl, dtype, hd, group):
    rng = np.random.default_rng(hd * 10 + group + 2)
    B, Hkv, ps, M = 3, 2, 8, 5
    kp, vp, tbl, q_pos, k_pos = _pool(rng, B, Hkv, hd, ps, M, [37, 16, 3])
    q = rng.standard_normal((B, Hkv * group, hd), dtype=np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kp, vp))
    want = JOPS.paged_decode_attention(jq, jk, jv, jnp.asarray(tbl),
                                       jnp.asarray(q_pos),
                                       jnp.asarray(k_pos), impl=impl)
    got = TOPS.paged_decode_attention(tq, tk, tv, T(tbl), T(q_pos),
                                      T(k_pos))
    _close(got, want, dtype)


@IMPLS
@DTYPES
@SHAPES
def test_chunked_prefill_plain_matches_jax(impl, dtype, hd, group):
    rng = np.random.default_rng(hd * 10 + group + 3)
    B, Hkv, ps, M, S = 3, 2, 8, 5, 8
    kp, vp, tbl, q_pos, k_pos = _pool(rng, B, Hkv, hd, ps, M, [37, 5, 20],
                                      S=S)
    q = rng.standard_normal((B, Hkv * group, S, hd), dtype=np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kp, vp))
    want = JOPS.chunked_prefill_attention(jq, jk, jv, jnp.asarray(tbl),
                                          jnp.asarray(q_pos),
                                          jnp.asarray(k_pos), impl=impl)
    got = TOPS.chunked_prefill_attention(tq, tk, tv, T(tbl), T(q_pos),
                                         T(k_pos))
    rows = np.broadcast_to((q_pos >= 0)[:, None, :, None], got.shape)
    _close(got, want, dtype, rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rotary_pct", [0.25, 0.4])
def test_partial_rotary_matches_jax(rotary_pct, dtype):
    """Head dim 160: 40 rotated dims at 0.25 (StableLM-2), 64 at 0.4; the
    rest pass through unchanged."""
    rng = np.random.default_rng(int(rotary_pct * 100))
    x = rng.standard_normal((2, 9, 3, 160), dtype=np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    jx, tx = _both(x, dtype)
    want = JL.apply_rope(jx, jnp.asarray(pos), rotary_pct, 10000.0)
    got = TL.apply_rope(tx, T(pos), rotary_pct, 10000.0)
    _close(got, want, dtype)
    rot = int(160 * rotary_pct)
    assert torch.equal(got[..., rot:], tx[..., rot:])


# ------------------------------------------------------------------- models
# two-layer float32 models: head dim 100 (llama-paper-3b's, 2 heads of 100),
# group 3 (6 q heads over 2 kv heads of 32), and StableLM-2's parallel block
# at head dim 160 (4 q heads over 2 kv heads: qk-norm, 40 rotated dims)
SMALL = {
    "hd100": ("llama-paper-3b", dict(d_model=200, n_heads=2, n_kv_heads=2),
              100),
    "group3": ("internlm2-20b", dict(d_model=192, n_heads=6, n_kv_heads=2),
               32),
    "parallel160": ("stablelm-12b",
                    dict(d_model=640, n_heads=4, n_kv_heads=2), 160),
}


def _small(name, impl="ref"):
    arch, widths, hd = SMALL[name]
    jcfg = dataclasses.replace(jax_get_config(arch, "smoke"), attn_impl=impl,
                               **widths)
    cfg = dataclasses.replace(get_config(arch, "smoke"), **widths)
    assert cfg.head_dim_ == hd
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    return jmodel, jparams, Model(cfg, "cpu"), params


@pytest.mark.parametrize("impl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_model_logits_match_jax(name, impl):
    """Right-padded prefill, then 6 decode steps; max_len 20 < prompt + 6,
    so the ring wraps."""
    jmodel, jparams, model, params = _small(name, impl)
    rng = np.random.default_rng(4)
    B, S, max_len = 3, 18, 20
    tokens = rng.integers(2, 500, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.array([18, 9, 14])[:, None]).astype(
        np.int32)
    want, jcache = jax.jit(functools.partial(jmodel.prefill,
                                             max_len=max_len))(
        jparams, jnp.asarray(tokens), {"mask": jnp.asarray(mask)})
    got, cache = model.prefill(params, T(tokens), T(mask), max_len=max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    step = jax.jit(jmodel.decode_step)
    for i in range(6):
        tok = rng.integers(2, 500, (B, 1)).astype(np.int32)
        want, jcache = step(jparams, jcache, jnp.asarray(tok))
        got, cache = model.decode_step(params, cache, T(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {i}")


def _chunk_then_decode(model, params, jmodel=None, jparams=None, seed=8):
    """Two slots prefill prompts of 19 and 11 tokens in chunks of 8 over a
    paged pool (page 4), then decode 3 tokens. Returns the port's logits
    of the slots with tokens in each call, each checked against the JAX
    model's when it is given."""
    B, max_len, ps, P, C = 3, 32, 4, 20, 8
    tc = TPG.paginate_cache(model.init_cache(B, max_len), B, ps, P)
    jc = (JPG.paginate_cache(jmodel.init_cache(B, max_len), B, ps, P)
          if jmodel is not None else None)
    if jmodel is not None:
        jchunk = jax.jit(jmodel.prefill_chunk)
        jstep = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(seed)
    slots = np.array([2, 0], np.int32)
    prompts = [rng.integers(2, 500, 19), rng.integers(2, 500, 11)]
    out = []
    for c0 in range(0, 19, C):
        tokens = np.zeros((2, C), np.int32)
        mask = np.zeros((2, C), np.int32)
        for i, p in enumerate(prompts):
            piece = p[c0:c0 + C]
            tokens[i, :len(piece)] = piece
            mask[i, :len(piece)] = 1
        nv = mask.sum(1).astype(np.int32)
        t0 = np.array([min(c0, len(p)) for p in prompts], np.int32)
        start, end = (t0 + ps - 1) // ps, (t0 + nv + ps - 1) // ps
        tc["paged"] = TPG.alloc_chunk_pages(tc["paged"], T(slots), T(start),
                                            T(end))
        view = TPG.gather_slot_view(tc, T(slots))
        got, view = model.prefill_chunk(params, view, T(tokens), T(mask))
        TPG.scatter_slot_view(tc, view, T(slots))
        # a slot with no token in this chunk: its row is a pad query's,
        # unspecified (it averages the pool's trash page, whose content the
        # packages, and the CPU's parallel scatter, leave to chance)
        live = nv > 0
        out.append(got[T(live)])
        if jc is not None:
            jc = dict(jc, paged=JPG.alloc_chunk_pages(
                jc["paged"], *(jnp.asarray(x) for x in (slots, start, end))))
            jview = JPG.gather_slot_view(jc, jnp.asarray(slots))
            want, jview = jchunk(jparams, jview, jnp.asarray(tokens),
                                 jnp.asarray(mask))
            jc = JPG.scatter_slot_view(jc, jview, jnp.asarray(slots))
            np.testing.assert_allclose(got.numpy()[live],
                                       np.asarray(want)[live], atol=ATOL,
                                       rtol=0, err_msg=f"chunk at {c0}")
    active = np.zeros((B,), bool)
    active[slots] = True
    for i in range(3):
        tok = rng.integers(2, 500, (B, 1)).astype(np.int32)
        tc["paged"] = TPG.alloc_decode_pages(tc["paged"], tc["t"],
                                             T(active), ps)
        got, tc = model.decode_step(params, tc, T(tok))
        out.append(got[slots])
        if jc is not None:
            jc = dict(jc, paged=JPG.alloc_decode_pages(
                jc["paged"], jc["t"], jnp.asarray(active), ps))
            want, jc = jstep(jparams, jc, jnp.asarray(tok))
            np.testing.assert_allclose(got.numpy()[slots],
                                       np.asarray(want)[slots], atol=ATOL,
                                       rtol=0, err_msg=f"decode step {i}")
    return out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_model_chunk_mode_logits_match_jax(name):
    jmodel, jparams, model, params = _small(name)
    _chunk_then_decode(model, params, jmodel, jparams)


# --------------------------------------------------------- MiniCPM head map


def _minicpm():
    jmodel = JModel(jax_get_config("minicpm-2b", "smoke"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("minicpm-2b", "smoke")
    return jmodel, jparams, cfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")


def test_minicpm_maps():
    """6 heads padded to 8 (smoke; 36 to 48 full): not the uniform divide,
    but the real heads follow the padded counts' divide, group 1."""
    for variant in ("smoke", "full"):
        cfg = get_config("minicpm-2b", variant)
        assert cfg.n_heads_padded > cfg.n_heads
        assert TA.uniform_gqa_group(cfg) is None
        assert TA.uniform_gqa_group(cfg, real_only=True) == 1
        assert TA.kernel_head_group(cfg, "cuda") == (1, 1,
                                                      cfg.n_heads_padded)
        assert TA.kernel_head_group(cfg, "cpu") is None
    assert TA.kernel_head_group(get_config("internlm2-20b"), "cuda") == \
        (3, 1, 48)


def _padded_map(monkeypatch):
    """Route the CPU through the card's head map: the plain versions then
    run the padded heads with the identity map, as the kernels do."""
    monkeypatch.setattr(TA, "kernel_head_group",
                        lambda cfg, device_type:
                        (TA.uniform_gqa_group(cfg, real_only=True), 1,
                         cfg.n_heads_padded))


def test_minicpm_identity_map_is_bit_identical(monkeypatch):
    """Prefill, decode around the ring and chunk mode over a paged pool:
    the identity map's logits equal the expanded map's bit for bit (the
    padded heads' outputs meet zero rows of wo either way)."""
    _, _, cfg, params = _minicpm()
    model = Model(cfg, "cpu")
    rng = np.random.default_rng(2)
    tokens = T(rng.integers(2, 500, (3, 18)).astype(np.int32))
    mask = T((np.arange(18)[None] < np.array([18, 7, 12])[:, None])
             .astype(np.int32))
    steps = [T(rng.integers(2, 500, (3, 1)).astype(np.int32))
             for _ in range(5)]

    def contiguous():
        logits, cache = model.prefill(params, tokens, mask, max_len=20)
        out = [logits]
        for tok in steps:
            logits, cache = model.decode_step(params, cache, tok)
            out.append(logits)
        return out + _chunk_then_decode(model, params)

    want = contiguous()
    _padded_map(monkeypatch)
    got = contiguous()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_padded_heads_check_raises_on_nonzero_rows():
    jmodel, jparams, cfg, params = _minicpm()
    check_head_padding(params, cfg)                  # the reference's: zero
    hd = cfg.head_dim_
    bad = jax.tree_util.tree_map(np.array, jparams)
    bad["unit"]["0"]["attn"]["wo"][1, cfg.n_heads * hd + 3, 5] = 0.5
    with pytest.raises(ValueError, match="padded q heads"):
        params_from_jax(bad, cfg, "cpu")
    params["layers"][0]["attn"]["wo"][cfg.n_heads * hd, 0] = 1.0
    with pytest.raises(ValueError, match="padded q heads"):
        check_head_padding(params, cfg)
    own = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    check_head_padding(own, cfg)                     # attn_init's: zero


# ------------------------------------------------------------------ engines
# the paged ladder's top rung on tests/test_torch_engine.py's shared-prefix
# trace: page 16, chunks of 16, two slots a launch, prefix sharing
ECFG = dict(max_batch=4, max_len=128, profile="h100_sxm", region="QC",
            paged=True, page_size=16, prefill_chunk=16, prefill_pack=2,
            prefix_sharing=True)


def _trace(vocab):
    """tests/test_torch_engine.py's ``_shared_trace`` over ``vocab``: a
    long-lived donor (rid 0) opens with a 32-token system prompt; three
    unrelated requests hold the other slots until every prompt ahead of
    them has prefilled, so the rest queue and adopt the donor's pages: one
    IS the system prompt (copy-on-write; first of its wave, so its copy
    runs before any decode chunk: a whole-prompt adopter that waits
    through decode chunks meets the JAX engine's known fault, ROADMAP
    Queue 3), five add suffixes, one shares the first page only."""
    rng = np.random.default_rng(12)
    system = rng.integers(2, vocab, 32).tolist()
    trace = [(0, system + rng.integers(2, vocab, 5).tolist(), 60)]
    trace += [(rid, rng.integers(2, vocab, 7 + rid).tolist(), 24)
              for rid in (1, 2, 3)]
    trace.append((4, list(system), 6))
    for rid, n_suffix in zip(range(5, 10), [17, 9, 30, 1, 12]):
        trace.append((rid, system + rng.integers(2, vocab, n_suffix).tolist(),
                      int(rng.integers(4, 12))))
    trace.append((10, system[:16] + rng.integers(2, vocab, 11).tolist(), 5))
    return trace


def _serve(engine, make_req, trace):
    for rid, prompt, n in trace:
        engine.submit(make_req(rid=rid, prompt=list(prompt),
                               max_new_tokens=n))
    return {r.rid: r for r in engine.run()}


@pytest.mark.parametrize("arch,head_map", [
    ("minicpm-2b", "expand"), ("minicpm-2b", "padded"),
    ("internlm2-20b", "expand"), ("stablelm-12b", "expand"),
    ("stablelm-12b", "contiguous")])
def test_paged_engine_matches_jax_engine(arch, head_map, monkeypatch):
    """Chunked prefill in chunks of 16, two slots a launch, prefix sharing:
    tokens and every non-wall-clock stats() key as the JAX engine's.
    MiniCPM also through the card's padded-head map; StableLM-2 also on
    the contiguous engine (monolithic prefill, no pool)."""
    jmodel = JModel(jax_get_config(arch, "smoke"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, "smoke")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, "cpu")
    if head_map == "padded":
        _padded_map(monkeypatch)
    paged = head_map != "contiguous"
    ecfg = ECFG if paged else {k: v for k, v in ECFG.items()
                               if k in ("max_batch", "max_len", "profile",
                                        "region")}
    trace = _trace(cfg.vocab)
    jeng = JServingEngine(jmodel, jparams, JEngineConfig(**ecfg))
    teng = ServingEngine(Model(cfg, "cpu"), params, EngineConfig(**ecfg),
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
    assert teng.host_syncs == jeng.host_syncs
    if paged:
        assert ts["prefix_hit_tokens"] > 0
        assert teng.free_pages == teng.num_pages
