"""The port's Zamba2 slice against the JAX package on the CPU: the plain
SSD (the CPU path of ``ops.ssd_scan``) against the reference's Pallas
kernel in interpret mode, its jnp oracle and the model's ``ssd_chunked``;
the mamba2 and shared blocks and the whole model on carried parameters;
the tied shared block; the full configuration's shapes and costing; and
the conv state of a padded prefill. Inputs come from numpy seeds.

Tolerances: SSD f32 1e-4 and bf16 5e-2 (the reference's own sweep,
``tests/test_kernels.py``); blocks and models 1e-4 (f32 matmuls and
cumsums summed in another order over a few layers)."""
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
from repro.models import ModelConfig as JModelConfig
from repro.models import SSMConfig as JSSMConfig
from repro.models import blocks as JB
from repro.models import ssm as JSSM
from repro.models import repeat_pattern as j_repeat_pattern
from repro.models.costing import param_counts as jax_param_counts
from repro_torch.configs import get_config
from repro_torch.kernels import ops as TOPS
from repro_torch.models import Model
from repro_torch.models import blocks as TB
from repro_torch.models import ssm as TSSM
from repro_torch.models.config import ModelConfig, SSMConfig, repeat_pattern
from repro_torch.models.convert import params_from_jax
from repro_torch.models.costing import param_counts

ATOL = 1e-4
SSD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _tied(pkg_cfg, pkg_ssm, pattern):
    """The 9-layer tied config of ``tests/test_decode_parity.py``: unit
    (mamba2, mamba2, shared) x 3, one shared block at three sites."""
    return pkg_cfg(
        name="p", family="hybrid", n_layers=9, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=128, dtype="float32",
        block_pattern=pattern(("mamba2", "mamba2", "shared"), 3),
        ssm=pkg_ssm(state_dim=16, head_dim=16, chunk=4),
        vocab_pad_multiple=8)


CONFIGS = {
    "zamba2-7b-smoke": (lambda: jax_get_config("zamba2-7b", "smoke"),
                        lambda: get_config("zamba2-7b", "smoke")),
    "tied9": (lambda: _tied(JModelConfig, JSSMConfig, j_repeat_pattern),
              lambda: _tied(ModelConfig, SSMConfig, repeat_pattern)),
}


def _np_tree(jparams):
    return jax.tree_util.tree_map(np.asarray, jparams)


def _ssd_inputs(seed, B, T, H, P, N, G=None):
    """x, dt (softplus), A (< 0), B, C, h0 as float32 numpy; B/C carry
    ``G`` groups instead of H heads when given."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    g = H if G is None else G
    Bm = rng.standard_normal((B, T, g, N), dtype=np.float32)
    Cm = rng.standard_normal((B, T, g, N), dtype=np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


# --------------------------------------------------------------- the SSD


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,P,N,cl", [
    (1, 2, 16, 8, 4, 8),
    (2, 3, 21, 8, 4, 8),    # ragged chunks
    (1, 2, 64, 16, 16, 16),
])
def test_ssd_scan_plain_matches_jax(impl, dtype, B, H, T, P, N, cl):
    """``ops.ssd_scan`` on the CPU against the reference's, on the sweep of
    ``tests/test_kernels.py`` (with ``h0``)."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(T * P + N, B, T, H, P, N)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(a).astype(jdt) for a in (x, dt)]
    jb = [jnp.asarray(a).astype(jdt) for a in (Bm, Cm)]
    want_y, want_h = JOPS.ssd_scan(jx[0], jx[1], jnp.asarray(A), jb[0], jb[1],
                                   jnp.asarray(h0), chunk=cl, impl=impl)
    tx = [torch.from_numpy(a).to(tdt) for a in (x, dt, Bm, Cm)]
    got_y, got_h = TOPS.ssd_scan(tx[0], tx[1], torch.from_numpy(A), tx[2],
                                 tx[3], torch.from_numpy(h0), chunk=cl)
    assert got_y.dtype == got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               **SSD_TOL[dtype])
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               **SSD_TOL[dtype])


@pytest.mark.parametrize("B,T,H,G,P,N,chunk", [
    (2, 8, 4, 1, 32, 16, 8),      # the smoke config's block, one chunk
    (3, 21, 4, 1, 16, 16, 4),     # ragged: T pads to the chunk
    (2, 37, 6, 2, 8, 4, 16),      # two groups over six heads
    (1, 300, 2, 1, 16, 16, 256),  # min(chunk, T) = 256 against a fixed 256
])
def test_ssd_scan_matches_model_ssd_chunked(B, T, H, G, P, N, chunk):
    """The port's prefill SSD (``ops.ssd_scan`` on the groups broadcast to
    heads as the port's mamba2 block does) against the reference model's
    ``ssm.ssd_chunked``, which pads to a fixed chunk and broadcasts the
    groups itself: padded steps have dt = 0, so the functions agree."""
    x, dt, A, Bg, Cg, _ = _ssd_inputs(T + 10 * G, B, T, H, P, N, G=G)
    want_y, want_h = JSSM.ssd_chunked(jnp.asarray(x), jnp.asarray(dt),
                                      jnp.asarray(A), jnp.asarray(Bg),
                                      jnp.asarray(Cg), chunk)
    s = SSMConfig(state_dim=N, head_dim=P, n_groups=G, chunk=chunk)
    Bh = TSSM._heads(s, torch.from_numpy(Bg).reshape(B, T, G * N), H)
    Ch = TSSM._heads(s, torch.from_numpy(Cg).reshape(B, T, G * N), H)
    got_y, got_h = TOPS.ssd_scan(torch.from_numpy(x), torch.from_numpy(dt),
                                 torch.from_numpy(A), Bh, Ch, chunk=chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------ the blocks


def _block_setup(kind, seed=0):
    jcfg = jax_get_config("zamba2-7b", "smoke")
    cfg = get_config("zamba2-7b", "smoke")
    jp = JB.block_init(jax.random.PRNGKey(seed), jcfg, kind)
    tp = params_from_jax({"prefix": [_np_tree(jp)], "embed": {},
                          "final_norm": {}},
                         dataclasses.replace(cfg, n_layers=1,
                                             block_pattern=(kind,)),
                         "cpu")["layers"][0]
    return jcfg, cfg, jp, tp


def test_mamba2_block_prefill_and_decode_match_jax():
    """Right-padded prefill (outputs at real tokens, SSM state, lengths;
    the conv state on the full-length row only, where the reference's is
    right) and 4 decode steps from an exact-length prefill."""
    jcfg, cfg, jp, tp = _block_setup("mamba2")
    rng = np.random.default_rng(1)
    B, T = 3, 20
    x = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)
    lengths = np.array([20, 13, 2])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int32)
    want, jstate = JSSM.mamba2_block(jp["ssm"], jcfg, jnp.asarray(x), None,
                                     "prefill", jnp.asarray(mask))
    state = TSSM.init_ssm_state(cfg, B, "cpu")
    got = TSSM.mamba2_block(tp["ssm"], cfg, torch.from_numpy(x), state,
                            "prefill", torch.from_numpy(mask))
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(state["state"].numpy(),
                               np.asarray(jstate["state"]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(state["length"].numpy(), lengths)
    np.testing.assert_allclose(state["conv"].numpy()[0],
                               np.asarray(jstate["conv"])[0], atol=ATOL,
                               rtol=0)

    # decode from an exact-length prefill (no mask: the reference is right)
    _, jstate = JSSM.mamba2_block(jp["ssm"], jcfg, jnp.asarray(x), None,
                                  "prefill", None)
    state = TSSM.init_ssm_state(cfg, B, "cpu")
    TSSM.mamba2_block(tp["ssm"], cfg, torch.from_numpy(x), state, "prefill")
    for i in range(4):
        x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        want, jstate = JSSM.mamba2_block(jp["ssm"], jcfg, jnp.asarray(x1),
                                         jstate, "decode")
        got = TSSM.mamba2_block(tp["ssm"], cfg, torch.from_numpy(x1), state,
                                "decode")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {i}")
    for name in ("conv", "state", "length"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(jstate[name]), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_shared_block_matches_jax():
    """The weight-shared block on concat(h, emb): right-padded prefill
    (real rows, cache keys and positions) then 4 decode steps."""
    jcfg, cfg, jp, tp = _block_setup("shared", seed=3)
    rng = np.random.default_rng(2)
    B, T, max_len = 2, 12, 16
    x = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)
    emb = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)
    lengths = np.array([12, 7])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int32)
    pos = np.where(mask > 0, np.arange(T)[None], -1).astype(np.int32)
    jcache = JB.block_cache_init(jcfg, "shared", B, max_len)
    jctx = JB.LayerCtx(cfg=jcfg, mode="prefill", positions=jnp.asarray(pos),
                       mask=jnp.asarray(mask), emb_orig=jnp.asarray(emb))
    want, jcache, _ = JB.block_apply(jp, jcfg, "shared", jctx,
                                     jnp.asarray(x), jcache)
    cache = TB.block_cache_init(cfg, "shared", B, max_len, "cpu")
    ctx = TB.LayerCtx(cfg=cfg, mode="prefill",
                      positions=torch.from_numpy(pos),
                      mask=torch.from_numpy(mask),
                      emb_orig=torch.from_numpy(emb))
    got, cache = TB.block_apply(tp, cfg, "shared", ctx, torch.from_numpy(x),
                                cache)
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(cache["pos_ids"].numpy(),
                                  np.asarray(jcache["pos_ids"]))
    for i in range(4):
        x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        e1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        p1 = (lengths + i)[:, None].astype(np.int32)
        jctx = JB.LayerCtx(cfg=jcfg, mode="decode", positions=jnp.asarray(p1),
                           emb_orig=jnp.asarray(e1))
        want, jcache, _ = JB.block_apply(jp, jcfg, "shared", jctx,
                                         jnp.asarray(x1), jcache)
        ctx = TB.LayerCtx(cfg=cfg, mode="decode",
                          positions=torch.from_numpy(p1),
                          emb_orig=torch.from_numpy(e1))
        got, cache = TB.block_apply(tp, cfg, "shared", ctx,
                                    torch.from_numpy(x1), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=f"decode step {i}")
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=ATOL, rtol=0)


# ------------------------------------------------------------- the model


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, tcfg = (f() for f in CONFIGS[name])
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(tcfg, "cpu")
    return jmodel, jparams, model, params_from_jax(_np_tree(jparams), tcfg,
                                                   "cpu")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_logits_match_jax(name):
    """A right-padded batch prefilled at once, then 8 decode steps. Prefill
    logits against the JAX model's padded prefill; every decode step
    against the JAX model run per row at EXACT length (prefill of the
    row's real tokens, then ``decode_step``): the reference's own padded
    prefill decodes from a wrong conv state (ROADMAP Queue 3), so the
    exact-length run is the oracle."""
    jmodel, jparams, model, params = _models(name)
    rng = np.random.default_rng(7)
    B, S, max_len = 3, 20, 32
    tokens = rng.integers(2, 120, (B, S)).astype(np.int32)
    lengths = [20, 13, 6]
    mask = (np.arange(S)[None] < np.array(lengths)[:, None]).astype(np.int32)
    want, _ = jmodel.prefill(jparams, jnp.asarray(tokens),
                             {"mask": jnp.asarray(mask)}, max_len=max_len)
    got, cache = model.prefill(params, torch.from_numpy(tokens),
                               torch.from_numpy(mask), max_len=max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    steps = rng.integers(2, 120, (8, B, 1)).astype(np.int32)
    oracle = []
    step = jax.jit(jmodel.decode_step)
    for b, L in enumerate(lengths):
        _, jc = jmodel.prefill(jparams, jnp.asarray(tokens[b:b + 1, :L]),
                               max_len=max_len)
        row = []
        for tok in steps:
            lg, jc = step(jparams, jc, jnp.asarray(tok[b:b + 1]))
            row.append(np.asarray(lg)[0])
        oracle.append(row)
    for i, tok in enumerate(steps):
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok))
        want = np.stack([oracle[b][i] for b in range(B)])
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                                   err_msg=f"decode step {i}")


def test_params_from_jax_ties_the_shared_block():
    """One parameter dict at every shared site (the reference's one
    ``shared_block``), equal to it; the port's own ``init`` ties the same
    way, and each site keeps its own cache."""
    _, jparams, model, params = _models("tied9")
    sites = [i for i, k in enumerate(model.cfg.block_pattern)
             if k == "shared"]
    assert sites == [2, 5, 8]
    assert all(params["layers"][i] is params["layers"][2] for i in sites)
    np.testing.assert_array_equal(
        params["layers"][5]["attn"]["wq"].numpy(),
        np.asarray(jparams["shared_block"]["attn"]["wq"]))
    own = model.init(torch.Generator().manual_seed(0))
    assert all(own["layers"][i] is own["layers"][2] for i in sites)
    assert own["layers"][0] is not own["layers"][1]
    caches = model.init_cache(2, 16)["layers"]
    assert len({id(caches[i]["k"]) for i in sites}) == 3
    # the smoke variant has no repeated unit: its shared layer is untied
    smoke = get_config("zamba2-7b", "smoke")
    assert smoke.grouping()[2] == 0


def _shape_layers(jshapes, cfg):
    """The reference's (prefix, stacked unit, shared_block) shape tree
    flattened to the port's per-layer list."""
    prefix, unit, repeats = cfg.grouping()
    layers = list(jshapes["prefix"])
    for r in range(repeats):
        for i, kind in enumerate(unit):
            if kind == "shared":
                layers.append(jshapes["shared_block"])
            else:
                layers.append(jax.tree_util.tree_map(
                    lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
                    jshapes["unit"][str(i)]))
    return layers


def test_full_config_shapes_and_costing_match_jax():
    """zamba2-7b at full size: the port's meta-device parameter tree equals
    the reference's leaf by leaf (shape and dtype), and the tied block
    counts once: 5,878,718,784 parameters."""
    cfg = get_config("zamba2-7b")
    jcfg = jax_get_config("zamba2-7b")
    jshapes = JModel(jcfg).param_shapes()
    got = Model(cfg, "cpu").param_shapes()
    want_layers = _shape_layers(jshapes, cfg)
    assert len(got["layers"]) == len(want_layers) == 81
    for i, (g, w) in enumerate(zip(got["layers"], want_layers)):
        gl = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)),
                                   g))[0]
        wl = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(
                lambda s: (tuple(s.shape), "torch." + str(s.dtype)), w))[0]
        assert [p for p, _ in gl] == [p for p, _ in wl], i
        for (path, gv), (_, wv) in zip(gl, wl):
            assert gv == wv, (i, path)
    for key in ("embed", "final_norm", "lm_head"):
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got[key]) == \
            jax.tree_util.tree_map(lambda s: tuple(s.shape), jshapes[key])
    assert param_counts(cfg) == (5_878_718_784.0, 5_878_718_784.0)
    assert param_counts(cfg) == jax_param_counts(jcfg)


# ------------------------------------------------- the reference's fault


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_padded_prefill_equals_exact_length(name):
    """The port's right-padded prefill leaves each row the cache and the
    next-step logits of that row prefilled alone at its exact length.

    The reference does not: ``_causal_conv`` (``src/repro/models/ssm.py:68``)
    keeps ``xp[:, -(d_conv-1):]``, the padded tail, so a padded row's conv
    state holds pad tokens' projections, while the mask only freezes the
    SSM state (dt -> 0). The JAX model's next-step logits after such a
    prefill are off by about 1 on ``zamba2-7b`` smoke
    (``test_reference_padded_prefill_fault_and_the_port``)."""
    _, _, model, params = _models(name)
    rng = np.random.default_rng(5)
    B, S, max_len = 3, 16, 32
    lengths = [5, 16, 2]
    tokens = rng.integers(2, 120, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.array(lengths)[:, None]).astype(np.int32)
    _, cache = model.prefill(params, torch.from_numpy(tokens),
                             torch.from_numpy(mask), max_len=max_len)
    nxt = torch.from_numpy(rng.integers(2, 120, (B, 1)).astype(np.int32))
    got, _ = model.decode_step(params, cache, nxt)
    for b, L in enumerate(lengths):
        _, alone = model.prefill(params, torch.from_numpy(tokens[b:b + 1, :L]),
                                 max_len=max_len)
        want, _ = model.decode_step(params, alone, nxt[b:b + 1])
        np.testing.assert_allclose(got[b].numpy(), want[0].numpy(),
                                   atol=1e-5, rtol=0, err_msg=f"row {b}")
    # the recurrent leaves right after prefill equal the exact-length ones:
    # lengths exactly, conv and SSM state to 1e-5 (the layers before them
    # sum in another order at another batch shape; a conv state taken from
    # pad tokens is off by O(1))
    _, padded = model.prefill(params, torch.from_numpy(tokens),
                              torch.from_numpy(mask), max_len=max_len)
    for b, L in enumerate(lengths):
        _, alone = model.prefill(params, torch.from_numpy(tokens[b:b + 1, :L]),
                                 max_len=max_len)
        for i, kind in enumerate(model.cfg.block_pattern):
            if kind != "mamba2":
                continue
            got_l, want_l = padded["layers"][i], alone["layers"][i]
            assert int(got_l["length"][b]) == int(want_l["length"][0]) == L
            for leaf in ("conv", "state"):
                np.testing.assert_allclose(
                    got_l[leaf][b].numpy(), want_l[leaf][0].numpy(),
                    atol=1e-5, rtol=0, err_msg=f"row {b} layer {i} {leaf}")


def test_reference_padded_prefill_fault_and_the_port():
    """The reference fault above, measured: on ``zamba2-7b`` smoke (JAX
    weights from PRNGKey(0)), a 5-token prompt prefilled right-padded to
    width 16 and the same prompt prefilled alone, then one decode step of
    token 7. The JAX model's two next-step logits differ by 0.98 where
    the largest logit is 0.58; the port's, on the same weights, agree to
    1e-5."""
    jmodel, jparams, model, params = _models("zamba2-7b-smoke")
    prompt = np.random.default_rng(0).integers(2, 500, 5).astype(np.int32)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :5] = prompt
    mask = (np.arange(16) < 5).astype(np.int32)[None]
    nxt = np.array([[7]], np.int32)
    _, jpad = jmodel.prefill(jparams, jnp.asarray(tokens),
                             {"mask": jnp.asarray(mask)}, max_len=32)
    _, jalone = jmodel.prefill(jparams, jnp.asarray(prompt[None]),
                               max_len=32)
    jp, _ = jmodel.decode_step(jparams, jpad, jnp.asarray(nxt))
    ja, _ = jmodel.decode_step(jparams, jalone, jnp.asarray(nxt))
    assert float(jnp.abs(jp - ja).max()) > 0.5        # the reference's fault
    _, pad = model.prefill(params, torch.from_numpy(tokens),
                           torch.from_numpy(mask), max_len=32)
    _, alone = model.prefill(params, torch.from_numpy(prompt[None]),
                             max_len=32)
    tp, _ = model.decode_step(params, pad, torch.from_numpy(nxt))
    ta, _ = model.decode_step(params, alone, torch.from_numpy(nxt))
    np.testing.assert_allclose(tp.numpy(), ta.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=0)
