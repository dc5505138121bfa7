"""The port's training substrate against the JAX package's, on the CPU
in float32: every case of ``tests/test_training.py`` on the port
(optimizer, schedules, data, checkpoints, loss descent), then

* ``adamw_update`` against the reference's leaf for leaf over three
  steps (decay mask by leaf name, clipping, bf16 moments), 1e-6;
* both schedules at steps 0-100, 1e-6;
* ``MarkovLM``, ``lm_batches`` and ``padded_prompt_batch`` bit-identical;
* a checkpoint round trip of parameters and optimizer state (a shared
  block stays one object) and ``latest``;
* the port's ``Trainer`` on the tiny config, started from the reference's
  parameters: 20 steps of history (loss, lr, grad_norm and every other
  metric) within 1e-4 of the JAX ``Trainer``'s, and the metered J and
  gCO2 equal to 1e-12 relative; a restart from its checkpoint;
* ``remat=True`` equal to ``remat=False`` (loss and every gradient), 1e-6;
* ``examples/train_small_torch.py --preset tiny --steps 3 --device cpu``.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import Model as JModel
from repro.models import ModelConfig as JModelConfig
from repro.models.config import repeat_pattern as jax_repeat_pattern
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import Trainer as JTrainer
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro.training import cosine_schedule as jax_cosine_schedule
from repro.training import wsd_schedule as jax_wsd_schedule
from repro.training import data as JD
from repro_torch.configs import get_config
from repro_torch.models import Model, ModelConfig, repeat_pattern
from repro_torch.models.convert import params_from_jax
from repro_torch.training import (AdamWConfig, TrainConfig, Trainer,
                                  adamw_init, adamw_update, cosine_schedule,
                                  wsd_schedule)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import (MarkovLM, alpaca_like_prompts,
                                       lm_batches, padded_prompt_batch)
from repro_torch.models.costing import named_leaves
from repro_torch.training.optim import unique_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy
OPT_TOL = 1e-6
HIST_TOL = 1e-4
METER_RTOL = 1e-12
REMAT_TOL = 1e-6
FORMULA_TOL = 2e-5     # float32 sums in another order


def tiny_kw(**kw):
    args = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=128, vocab=128, dtype="float32",
                vocab_pad_multiple=8)
    args.update(kw)
    return args


def tiny_cfg(**kw):
    return ModelConfig(block_pattern=repeat_pattern(("dense",), 2),
                       **tiny_kw(**kw))


def jax_tiny_cfg(**kw):
    return JModelConfig(block_pattern=jax_repeat_pattern(("dense",), 2),
                        **tiny_kw(**kw))


def init(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return Model(cfg, "cpu").init(gen)


# --- the cases of tests/test_training.py, on the port -----------------------

def test_adamw_moves_params_and_decays():
    params = {"w": torch.ones((4, 4)), "ln1": {"scale": torch.ones((4,))}}
    grads = {"w": torch.ones((4, 4)), "ln1": {"scale": torch.zeros((4,))}}
    before = {"w": params["w"].clone(), "scale": params["ln1"]["scale"].clone()}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.1)
    st = adamw_init(params, cfg)
    p2, st2, m = adamw_update(params, grads, st, cfg, 1.0)
    assert float((p2["w"] - before["w"]).abs().max()) > 0
    # zero grad + no decay on norm scales -> unchanged
    np.testing.assert_allclose(p2["ln1"]["scale"].numpy(),
                               before["scale"].numpy())
    assert st2["step"] == 1 and float(m["grad_norm"]) > 0


def test_grad_clipping():
    params = {"w": torch.zeros((2,))}
    grads = {"w": torch.full((2,), 100.0)}
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    st = adamw_init(params, cfg)
    _, _, m = adamw_update(params, grads, st, cfg, 1.0)
    assert float(m["clip"]) < 0.05


def test_wsd_schedule_shape():
    f = wsd_schedule(warmup=10, stable=80, decay=10, final_frac=0.1)
    assert f(0) == 0.0
    assert f(10) == pytest.approx(1.0)
    assert f(50) == pytest.approx(1.0)
    assert f(100) == pytest.approx(0.1, rel=1e-3)


def test_cosine_schedule_shape():
    f = cosine_schedule(warmup=10, total=110, final_frac=0.1)
    assert f(10) == pytest.approx(1.0)
    assert f(110) == pytest.approx(0.1, abs=1e-3)


def test_alpaca_prompts_stats():
    ps = alpaca_like_prompts(0, 500, vocab=1000)
    lens = np.array([len(p) for p in ps])
    assert 30 < np.median(lens) < 65
    assert lens.max() > np.median(lens) * 3        # long tail
    assert all(p.min() >= 2 and p.max() < 1000 for p in ps)


def test_markov_lm_deterministic():
    a = MarkovLM(64, seed=3).sample(np.random.default_rng(0), 32)
    b = MarkovLM(64, seed=3).sample(np.random.default_rng(0), 32)
    np.testing.assert_array_equal(a, b)


def test_padded_prompt_batch():
    out = padded_prompt_batch([np.array([1, 2, 3]), np.array([4])])
    assert out["tokens"].shape == (2, 3)
    np.testing.assert_array_equal(out["mask"].sum(axis=1), [3, 1])


def test_checkpoint_roundtrip(tmp_path):
    params = init(tiny_cfg())
    path = str(tmp_path / f"ckpt_5{ckpt.SUFFIX}")
    ckpt.save(path, params, step=5)
    like = Model(tiny_cfg(), "cpu").param_shapes()
    restored, step = ckpt.restore(path, tree_on_cpu(like))
    assert step == 5
    for (pa, a), (pb, b) in zip(named_leaves(params),
                                named_leaves(restored)):
        assert pa == pb
        assert torch.equal(a, b)


def test_checkpoint_latest(tmp_path):
    for s in (3, 10, 7):
        ckpt.save(str(tmp_path / f"ckpt_{s}{ckpt.SUFFIX}"),
                  {"x": torch.ones(1)}, s)
    assert ckpt.latest(str(tmp_path)).endswith(f"ckpt_10{ckpt.SUFFIX}")


def test_loss_decreases():
    m = Model(tiny_cfg(), "cpu")
    tr = Trainer(m, TrainConfig(steps=80, log_every=20, warmup=5,
                                optim=AdamWConfig(lr=5e-3)),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    hist = tr.fit(lm_batches(0, 128, batch=16, seq=64, branching=4),
                  verbose=False)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.8
    # training carbon was metered
    assert tr.meter.totals.energy_j > 0


def test_wsd_used_by_minicpm_config():
    cfg = get_config("minicpm-2b", "smoke")
    m = Model(cfg, "cpu")
    tr = Trainer(m, TrainConfig(steps=6, warmup=2, schedule="wsd"),
                 generator=torch.Generator().manual_seed(0), device="cpu")
    hist = tr.fit(lm_batches(1, cfg.vocab, batch=2, seq=16), verbose=False)
    assert np.isfinite(hist[-1]["loss"])


def test_trainer_refuses_another_device():
    with pytest.raises(ValueError, match="the model is on"):
        Trainer(Model(tiny_cfg(), "meta"), TrainConfig(), device="cpu")


def tree_on_cpu(tree):
    """A meta-device parameter tree as CPU tensors (zeros), the structure
    and sharing kept."""
    from repro_torch.training.optim import tree_map
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), tree)


# --- against the reference -----------------------------------------------

def opt_tree(rng):
    """Parameters and two steps of gradients with names the decay mask
    reads (a norm's scale, a bias, ln1 / ln2 / q_norm subtrees, a
    scalar gate) and gradients large enough to clip."""
    def draw(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)
    params = {"embed": {"tok": draw(16, 8)},
              "layers": [{"ln1": {"scale": draw(8)}, "w": draw(8, 8),
                          "gate_mlp": draw(), "attn": {"q_norm": {
                              "scale": draw(4)}, "wq": draw(8, 8)}},
                         {"ln2": {"scale": draw(8)}, "b": {"bias": draw(8)},
                          "w": draw(8, 8)}]}
    grads = [jax.tree_util.tree_map(lambda a: 30.0 * draw(*a.shape), params),
             jax.tree_util.tree_map(lambda a: 0.01 * draw(*a.shape), params),
             jax.tree_util.tree_map(lambda a: draw(*a.shape), params)]
    return params, grads


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: T(np.array(a, np.float32)), tree,
                                  is_leaf=lambda x: isinstance(x, np.ndarray))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", [0.0, 0.1])
def test_adamw_update_matches_reference(moments, decay):
    rng = np.random.default_rng(0)
    params, grads = opt_tree(rng)
    jcfg = JAdamWConfig(lr=1e-2, weight_decay=decay, grad_clip=1.0,
                        moment_dtype=moments)
    cfg = AdamWConfig(lr=1e-2, weight_decay=decay, grad_clip=1.0,
                      moment_dtype=moments)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jax_adamw_init(jp, jcfg)
    tp = to_torch(params)
    tst = adamw_init(tp, cfg)
    for i, g in enumerate(grads):
        scale = [0.5, 1.0, 0.3][i]
        jp, jst, jm = jax_adamw_update(jp, jax.tree_util.tree_map(
            jnp.asarray, g), jst, jcfg, jnp.asarray(scale, jnp.float32))
        tp, tst, tm = adamw_update(tp, to_torch(g), tst, cfg, scale)
        for k in ("grad_norm", "lr", "clip"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=OPT_TOL, err_msg=k)
        assert tst["step"] == int(jst["step"])
        for name, jt, tt in (("params", jp, tp), ("m", jst["m"], tst["m"]),
                             ("v", jst["v"], tst["v"])):
            for (path, got), want in zip(named_leaves(tt),
                                         jax.tree_util.tree_leaves(jt)):
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=OPT_TOL, atol=OPT_TOL,
                    err_msg=f"{name} {'/'.join(path)} step {i + 1}")
    # the decay mask: with decay, the norms' scales and the bias moved by
    # Adam alone, the weights also by the decay
    if decay:
        assert not torch.equal(tp["layers"][0]["w"],
                               to_torch(params)["layers"][0]["w"])


def test_shared_leaf_updated_once():
    shared = {"w": torch.ones(3)}
    params = {"layers": [shared, shared]}
    grads = {"layers": [{"w": torch.ones(3)}, {"w": torch.ones(3)}]}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    st = adamw_init(params, cfg)
    assert st["m"]["layers"][0]["w"] is st["m"]["layers"][1]["w"]
    adamw_update(params, grads, st, cfg, 1.0)
    single = {"w": torch.ones(3)}
    adamw_update(single, {"w": torch.ones(3)}, adamw_init(single, cfg), cfg,
                 1.0)
    assert torch.equal(shared["w"], single["w"])


@pytest.mark.parametrize("kind", ["wsd", "cosine"])
def test_schedules_match_reference(kind):
    if kind == "wsd":
        f, jf = wsd_schedule(10, 70, 20), jax_wsd_schedule(10, 70, 20)
    else:
        f, jf = cosine_schedule(10, 100), jax_cosine_schedule(10, 100)
    for s in range(101):
        np.testing.assert_allclose(f(s), float(jf(jnp.asarray(s))),
                                   rtol=OPT_TOL, atol=1e-7, err_msg=str(s))


def test_data_bit_identical():
    for seed, vocab, branching in ((0, 128, 4), (3, 1000, 8)):
        a, b = MarkovLM(vocab, branching, seed), JD.MarkovLM(vocab, branching,
                                                              seed)
        np.testing.assert_array_equal(a.next_tokens, b.next_tokens)
        np.testing.assert_array_equal(a.next_probs, b.next_probs)
        ours = lm_batches(seed, vocab, 3, 17, branching)
        theirs = JD.lm_batches(seed, vocab, 3, 17, branching)
        for _ in range(3):
            x, y = next(ours), next(theirs)
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
    prompts = alpaca_like_prompts(5, 20, 500)
    for a, b in zip(prompts, JD.alpaca_like_prompts(5, 20, 500)):
        np.testing.assert_array_equal(a, b)
    for pad_to in (None, 30):
        x = padded_prompt_batch(prompts, pad_to)
        y = JD.padded_prompt_batch(prompts, pad_to)
        for k in ("tokens", "mask"):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def shared_params(seed):
    """The tiny model's parameters with layer 1 the same dict as layer 0
    (a weight-shared block, as Zamba2's)."""
    params = init(tiny_cfg(), seed)
    params["layers"][1] = params["layers"][0]
    return params


def test_checkpoint_state_and_shared_block(tmp_path):
    params = shared_params(0)
    state = adamw_init(params, AdamWConfig())
    state["step"] = 7
    for _, v in unique_leaves(state["m"]):
        v.normal_()
    path = str(tmp_path / f"ckpt_7{ckpt.SUFFIX}")
    ckpt.save(path, (params, state), step=7)
    assert not os.path.exists(path + ".tmp")
    like = (shared_params(1), adamw_init(params, AdamWConfig()))
    (p2, s2), step = ckpt.restore(path, like)
    assert step == 7 and s2["step"] == 7
    for (pa, a), (pb, b) in zip(named_leaves((params, state)),
                                named_leaves((p2, s2))):
        assert pa == pb
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    a, b = p2["layers"]
    assert all(x is y for (_, x), (_, y) in zip(named_leaves(a),
                                                named_leaves(b)))
    assert s2["m"]["layers"][0]["ln1"]["scale"] is \
        s2["m"]["layers"][1]["ln1"]["scale"]
    bad = {"x": torch.ones(2)}
    ckpt.save(str(tmp_path / "bad.pt"), bad)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path / "bad.pt"), {"x": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path / "bad.pt"), {"y": torch.ones(2)})


def run_both(tcfg_kw, steps, tmp_path=None):
    """The JAX Trainer and the port's on the tiny config from the same
    parameters and batches. Returns (JAX trainer, port trainer)."""
    jtr = JTrainer(JModel(jax_tiny_cfg()), JTrainConfig(
        steps=steps, **tcfg_kw, optim=JAdamWConfig(lr=5e-3)))
    np_params = jax.tree_util.tree_map(np.asarray, jtr.params)
    cfg = tiny_cfg()
    tr = Trainer(Model(cfg, "cpu"), TrainConfig(
        steps=steps, **tcfg_kw, optim=AdamWConfig(lr=5e-3)),
        device="cpu", params=params_from_jax(np_params, cfg, "cpu"))
    jtr.fit(JD.lm_batches(0, 128, batch=4, seq=32, branching=4),
            verbose=False)
    tr.fit(lm_batches(0, 128, batch=4, seq=32, branching=4), verbose=False)
    return jtr, tr


def test_trainer_matches_reference():
    kw = dict(log_every=1, warmup=5, profile="h100_sxm", region="CISO")
    jtr, tr = run_both(kw, 20)
    assert len(tr.history) == len(jtr.history) == 20
    for got, want in zip(tr.history, jtr.history):
        assert set(got) == set(want)
        for k in want:
            if k == "wall_s":
                continue
            np.testing.assert_allclose(got[k], want[k], rtol=HIST_TOL,
                                       atol=HIST_TOL,
                                       err_msg=f"{k} step {want['step']}")
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]
    a, b = tr.meter.totals, jtr.meter.totals
    assert a.steps == b.steps == 20
    for k in ("energy_j", "operational_g", "embodied_g", "time_s"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                   rtol=METER_RTOL, err_msg=k)


def test_trainer_restarts_from_checkpoint(tmp_path):
    kw = dict(log_every=1, warmup=2, ckpt_every=3, ckpt_dir=str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    tr = Trainer(Model(tiny_cfg(), "cpu"), TrainConfig(steps=3, **kw),
                 generator=gen, device="cpu")
    tr.fit(lm_batches(0, 128, batch=2, seq=16), verbose=False)
    assert ckpt.latest(str(tmp_path)).endswith(f"ckpt_3{ckpt.SUFFIX}")
    again = Trainer(Model(tiny_cfg(), "cpu"), TrainConfig(steps=5, **kw),
                    generator=torch.Generator().manual_seed(9), device="cpu")
    hist = again.fit(lm_batches(0, 128, batch=2, seq=16), verbose=False)
    assert [r["step"] for r in hist] == [4, 5]
    assert again.opt_state["step"] == 5
    assert ckpt.latest(str(tmp_path)).endswith(f"ckpt_3{ckpt.SUFFIX}")
    assert all(p.requires_grad for _, p in unique_leaves(again.params))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v3-671b",
                                  "zamba2-7b"])
def test_remat_equals_plain(arch):
    cfg = get_config(arch, "smoke")
    model = Model(cfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = T(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    out = []
    for remat in (False, True):
        params = init(cfg)
        for _, p in unique_leaves(params):
            p.requires_grad_(True)
        loss, metrics = model.train_loss(params, batch, remat=remat)
        loss.backward()
        out.append((loss.detach(), metrics,
                    [(path, p.grad) for path, p in unique_leaves(params)]))
    (l0, m0, g0), (l1, m1, g1) = out
    np.testing.assert_allclose(float(l1), float(l0), rtol=REMAT_TOL)
    for k in m0:
        np.testing.assert_allclose(float(m1[k].detach()),
                                   float(m0[k].detach()), rtol=REMAT_TOL,
                                   err_msg=k)
    for (path, a), (_, b) in zip(g0, g1):
        if a is None:
            assert b is None, path
            continue
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=REMAT_TOL,
                                   atol=REMAT_TOL, err_msg="/".join(path))


def test_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "train_small_torch.py"),
         "--preset", "tiny", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, check=True)
    assert "step     3" in out.stdout and "TOTAL" in out.stdout


# --- the card's backward formulas (kernels/autograd.py), on the CPU ---------

@pytest.mark.parametrize("group,kv_step,S,window,chunk,block", [
    (1, 1, 37, None, None, 1 << 30), (3, 1, 40, 8, None, 1 << 30),
    (5, 2, 33, None, 16, 1 << 30), (2, 1, 50, None, None, 2 * 2 * 50 * 4 * 7),
])
def test_flash_backward_formula_matches_autograd(group, kv_step, S, window,
                                                 chunk, block):
    """``autograd.flash_backward`` (the card's attention gradient, pure
    PyTorch) from a logsumexp made here, against autograd of the plain
    version in float32 (which computes in float32 whatever its inputs):
    every valid row, the GQA group summed over a strided kv view, tiled
    in query blocks (the last case: 7 rows a block), ``FORMULA_TOL``."""
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels import ref as KREF
    gen = torch.Generator().manual_seed(S)
    B, Hkv, hd = 2, 2, 16
    f32 = torch.float32
    q = torch.randn(B, S, Hkv * group, hd, generator=gen, dtype=f32)
    k = torch.randn(B, S, Hkv * kv_step, hd, generator=gen, dtype=f32)
    v = torch.randn(B, S, Hkv * kv_step, hd, generator=gen, dtype=f32)
    dout = torch.randn(B, Hkv * group, S, hd, generator=gen, dtype=f32)
    pos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qq, kk, vv = (leaves[0].transpose(1, 2),
                  leaves[1][:, :, ::kv_step].transpose(1, 2),
                  leaves[2][:, :, ::kv_step].transpose(1, 2))
    out = KREF.flash_attention(qq, kk, vv, pos, pos, window, chunk)
    out.backward(dout)
    s = (qq @ kk.repeat_interleave(group, 1).transpose(-1, -2)
         ) / math.sqrt(hd)
    ok = KREF.attention_mask(pos[:, None, :, None], pos[:, None, None, :],
                             window, chunk)
    lse = torch.logsumexp(torch.where(ok, s, -math.inf), -1).detach()
    dq, dk, dv = AG.flash_backward(qq.detach(), kk.detach(), vv.detach(),
                                   lse, dout, pos, pos, window, chunk,
                                   block_bytes=block)
    wants = (leaves[0].grad, leaves[1].grad[:, :, ::kv_step],
             leaves[2].grad[:, :, ::kv_step])
    for name, got, want in zip("qkv", (dq, dk, dv), wants):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                                   want.numpy(), rtol=FORMULA_TOL,
                                   atol=FORMULA_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("add", [False, True])
def test_rmsnorm_backward_formula_matches_autograd(add):
    """``autograd.rmsnorm_backward`` (the card's norm gradient) against
    autograd of the plain version in float32, ``FORMULA_TOL``."""
    from repro_torch.kernels import autograd as AG
    from repro_torch.kernels import ref as KREF
    gen = torch.Generator().manual_seed(1)
    f32 = torch.float32
    x, delta, dy, ds = (torch.randn(6, 40, generator=gen, dtype=f32)
                        for _ in range(4))
    scale = 1 + 0.1 * torch.randn(40, generator=gen, dtype=f32)
    leaves = [t.clone().requires_grad_(True) for t in (x, delta, scale)]
    if add:
        s, y = KREF.add_rmsnorm(leaves[0], leaves[1], leaves[2], 1e-5)
        ((s * ds).sum() + (y * dy).sum()).backward()
    else:
        s = leaves[0]
        (KREF.rmsnorm(leaves[0], leaves[2], 1e-5) * dy).sum().backward()
    dx, dscale = AG.rmsnorm_backward(s.detach(), scale, dy, 1e-5)
    if add:
        dx = dx + ds
    np.testing.assert_allclose(dx.numpy(), leaves[0].grad.numpy(),
                               rtol=FORMULA_TOL, atol=FORMULA_TOL)
    np.testing.assert_allclose(dscale.numpy(), leaves[2].grad.numpy(),
                               rtol=FORMULA_TOL, atol=FORMULA_TOL)
    if add:
        np.testing.assert_allclose(dx.numpy(), leaves[1].grad.numpy(),
                                   rtol=FORMULA_TOL, atol=FORMULA_TOL)
