"""The port calls ``shard()`` where the reference's model does: for each of
the 11 smoke configs (the reference's 10 ``ARCH_IDS`` and
``llama-paper-1b``) and each kind of step that the reference's dry-run
compiles under a mesh (``train_loss``, ``prefill``, ``decode_step`` on a
contiguous cache), the sequence of (logical axes, shape) that reaches
``shard`` is the same in both packages.

No mesh and no ranks: ``shard`` is replaced by a recorder in every module
that imports it, on both sides, with monkeypatch and only inside the test.
Only shapes matter, so the reference's step is traced abstractly
(``jax.eval_shape`` over its ``param_shapes()``) and the port's runs on
the ``meta`` device (its kernel ops take the plain versions there).
The reference scans its repeated unit and its attention blocks with
``jax.lax.scan`` / ``jax.lax.map``, which trace a body once; inside the
test both are a Python loop, so a body's sites are recorded once per
iteration, as the port's eager loops call them.

One difference is named: the port's prefill keeps each row's last token
before the vocab product (``Model.forward``'s ``last_index``), so its
logits site sees (B, 1, V) where the reference's sees (B, S, V).
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

ARCHS = list(JAX_ARCH_IDS) + ["llama-paper-1b"]
MODES = ("train", "prefill", "decode")
BATCH, SEQ = 2, 16
REF_MODULES = ("attention", "blocks", "layers", "model", "moe",
               "moe_sharded", "rwkv", "ssm")


def _py_scan(f, init, xs, length=None, reverse=False, **_):
    leaves = jax.tree_util.tree_leaves(xs)
    n = leaves[0].shape[0] if leaves else length
    carry, ys = init, []
    for i in (reversed(range(n)) if reverse else range(n)):
        carry, y = f(carry, jax.tree_util.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if reverse:
        ys = ys[::-1]
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


def _py_map(f, xs):
    return _py_scan(lambda c, x: (c, f(x)), (), xs)[1]


def _recorder(log):
    def shard(x, *axes):
        log.append((tuple(axes), tuple(x.shape)))
        return x
    return shard


def _record_jax(monkeypatch, arch, mode):
    import importlib
    log = []
    for name in REF_MODULES:
        mod = importlib.import_module(f"repro.models.{name}")
        monkeypatch.setattr(mod, "shard", _recorder(log))
    monkeypatch.setattr(jax.lax, "scan", _py_scan)
    monkeypatch.setattr(jax.lax, "map", _py_map)
    jcfg = jax_get_config(arch, "smoke")
    jm = JModel(jcfg)
    tokens, extras = _inputs(jcfg)
    if mode == "train":
        batch = {"tokens": tokens, "labels": tokens, **extras}
        jax.eval_shape(lambda p: jm.train_loss(p, batch, remat=False),
                       jm.param_shapes())
    elif mode == "prefill":
        jax.eval_shape(lambda p: jm.prefill(p, tokens, extras, max_len=SEQ),
                       jm.param_shapes())
    else:
        caches = jm.cache_shapes(BATCH, SEQ)
        jax.eval_shape(lambda p, c: jm.decode_step(p, c, tokens[:, :1]),
                       jm.param_shapes(), caches)
    return log


def _inputs(jcfg):
    rng = np.random.default_rng(1)
    tokens = jnp.asarray(
        rng.integers(0, jcfg.vocab, (BATCH, SEQ)).astype(np.int32))
    return tokens, make_extras(jcfg, BATCH, SEQ)


def _meta(x):
    return torch.empty(x.shape, dtype=getattr(torch, str(x.dtype)),
                       device="meta")


def _record_torch(monkeypatch, arch, mode):
    import importlib
    log = []
    for name in REF_MODULES:
        mod = importlib.import_module(f"repro_torch.models.{name}")
        monkeypatch.setattr(mod, "shard", _recorder(log))
    cfg = get_config(arch, "smoke")
    model = Model(cfg, "meta")
    params = model.param_shapes()
    tokens, extras = _inputs(jax_get_config(arch, "smoke"))
    tok = torch.zeros(tokens.shape, dtype=torch.int32, device="meta")
    ex = {k: _meta(v) for k, v in extras.items()}
    with torch.no_grad():
        if mode == "train":
            model.train_loss(params, {"tokens": tok, "labels": tok, **ex},
                             remat=False)
        elif mode == "prefill":
            model.prefill(params, tok, max_len=SEQ, extras=ex or None)
        else:
            caches = model.init_cache(BATCH, SEQ)
            model.decode_step(params, caches, tok[:, :1])
    return log


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_sites_match_the_reference(monkeypatch, arch, mode):
    ref = _record_jax(monkeypatch, arch, mode)
    port = _record_torch(monkeypatch, arch, mode)
    assert ref, "the reference recorded no site"
    if mode == "prefill":
        # the named difference: the port's logits site sees the kept rows
        (axes_r, shape_r), (axes_p, shape_p) = ref[-1], port[-1]
        assert axes_r == axes_p == ("batch", "seq", "vocab")
        assert shape_p == (shape_r[0], 1, shape_r[2])
        ref, port = ref[:-1], port[:-1]
    for i, (r, p) in enumerate(zip(ref, port)):
        assert r == p, f"site {i}: reference {r}, port {p}"
    assert len(ref) == len(port)
