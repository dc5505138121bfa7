"""The backward formulas of the recurrent kernels and the concat and gate
RMSNorms (``repro_torch.kernels.autograd``) against the JAX package's
gradients, on the CPU, from the same numpy inputs made from a seed.

* ``ssd_chunk_backward`` and ``wkv6_backward`` against ``jax.vjp`` of the
  JAX oracles ``repro.kernels.ref.ssd_chunk`` and ``ref.wkv6``, and against
  ``torch.autograd`` of the port's plain versions, on the reference sweeps
  of ``tests/test_kernels.py`` (``test_wkv6_sweep``, ``test_ssd_sweep``),
  float32 and bf16, every output's gradient given;
* ``cat_rmsnorm_backward`` (with and without the residual add) and
  ``gated_rmsnorm_backward`` against ``jax.vjp`` of the reference RMSNorm
  (``repro.kernels.ops.rmsnorm``, ``impl="ref"``) over the concatenated or
  gated row;
* the four ``autograd.Function``s routed on the CPU (``card_path``: the
  kernel ops take their card branch, each kernel's forward replaced by its
  plain version, in this file only), against autograd of the plain ops,
  and ``zamba2-7b`` and ``rwkv6-1.6b`` smoke ``train_loss`` and every
  gradient leaf through them against ``jax.grad``'s.

Tolerances: float32 1e-4 relative and absolute (float32 sums in another
order); bf16 2e-2 (a gradient rounded to bf16 once, at most an ulp
apart); the models at ``test_torch_train_parity.py``'s (loss 1e-5
relative, gradients rtol 1e-3 / atol 1e-5).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import autograd as AG
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as RMS
from repro_torch.kernels import ssd as SSD
from repro_torch.kernels import wkv6 as WKV
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax, tree_from_jax
from repro_torch.models.costing import named_leaves
from repro_torch.training.optim import unique_leaves
from test_torch_train_parity import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, case,
                                     grad_tree)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]
# tests/test_kernels.py's sweeps
WKV_SWEEP = [(1, 2, 8, 8), (2, 3, 23, 16), (1, 4, 64, 32)]      # B,H,T,hd
SSD_SWEEP = [(1, 2, 16, 8, 4, 8), (2, 3, 21, 8, 4, 8),         # B,H,T,P,N,cl
             (1, 2, 64, 16, 16, 16)]


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _softplus(a):
    return np.log1p(np.exp(a)).astype(np.float32)


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JNP[dtype])


def _close(got, want, dtype, what):
    """``got`` (torch) against ``want`` (torch or JAX) at ``TOL[dtype]``;
    both finite."""
    g = got.float().numpy()
    w = np.asarray(want.float() if isinstance(want, torch.Tensor)
                   else jnp.asarray(want, jnp.float32))
    assert np.isfinite(w).all(), f"{what}: the reference is not finite"
    np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=what)


def _autograd(fn, inputs, cotangents):
    """torch.autograd of ``fn`` (outputs a tuple or a tensor) at
    ``inputs`` against ``cotangents`` (None: that output takes none): the
    inputs' gradients."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(
        [o for o, c in zip(out, cotangents) if c is not None],
        [c for c in cotangents if c is not None])
    return [t.grad for t in leaves]


# --------------------------------------------------------------------------
# SSD chunk
# --------------------------------------------------------------------------


def _ssd_case(dtype, B, H, T, P, N, cl):
    """The sweep's inputs (``test_ssd_sweep``'s distributions, from numpy),
    padded to whole chunks with dt = 0 steps as ``ops.ssd_scan`` pads,
    in the kernel layout (B, H, nc, cl, *), and cotangents of y_intra,
    h_chunk and decay."""
    rng = np.random.default_rng(T * P + N)
    nc = -(-T // cl)
    pad = nc * cl - T
    x = np.pad(_np(rng, (B, T, H, P)), ((0, 0), (0, pad), (0, 0), (0, 0)))
    dt = np.pad(_softplus(_np(rng, (B, T, H))), ((0, 0), (0, pad), (0, 0)))
    A = -np.exp(_np(rng, (H,), 0.5))
    Bm, Cm = (np.pad(_np(rng, (B, T, H, N)), ((0, 0), (0, pad), (0, 0),
                                               (0, 0))) for _ in range(2))

    def layout(a):
        a = a.reshape(B, nc, cl, H, *a.shape[3:])
        return np.moveaxis(a, 3, 1)

    ins = [layout(x), layout(dt), A, layout(Bm), layout(Cm)]
    cots = [_np(rng, (B, H, nc, cl, P)), _np(rng, (B, H, nc, P, N)),
            _np(rng, (B, H, nc))]
    return ins, cots


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,T,P,N,cl", SSD_SWEEP)
def test_ssd_chunk_backward_matches_jax_vjp(dtype, B, H, T, P, N, cl):
    ins, cots = _ssd_case(dtype, B, H, T, P, N, cl)
    types = [dtype, dtype, torch.float32, dtype, dtype]
    t_ins = [_torch(a, t) for a, t in zip(ins, types)]
    t_cots = [_torch(c, torch.float32) for c in cots]
    got = AG.ssd_chunk_backward(*t_ins, *t_cots)
    _, vjp = jax.vjp(jref.ssd_chunk,
                     *[_jax(a, t) for a, t in zip(ins, types)])
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    plain = _autograd(ref.ssd_chunk, t_ins, t_cots)
    for name, g, w, p, t in zip(("x", "dt", "A", "Bm", "Cm"), got, want,
                                plain, types):
        assert g.dtype == t and g.shape == p.shape, name
        _close(g, w, t, f"d{name} vs jax.vjp")
        _close(g, p, t, f"d{name} vs torch.autograd")


def test_ssd_chunk_backward_skips_what_is_not_needed():
    """``needs`` False: no gradient for that input; the others unchanged;
    a missing cotangent is a zero one."""
    ins, cots = _ssd_case(torch.float32, *SSD_SWEEP[1])
    t_ins = [_torch(a, torch.float32) for a in ins]
    dy, dh, ddec = (_torch(c, torch.float32) for c in cots)
    full = AG.ssd_chunk_backward(*t_ins, dy, dh, ddec)
    part = AG.ssd_chunk_backward(*t_ins, dy, dh, ddec,
                                 needs=(True, False, False, True, False))
    assert part[1] is None and part[2] is None and part[4] is None
    torch.testing.assert_close(part[0], full[0], rtol=0, atol=0)
    torch.testing.assert_close(part[3], full[3], rtol=0, atol=0)
    no_dh = AG.ssd_chunk_backward(*t_ins, dy, None, ddec)
    zero_dh = AG.ssd_chunk_backward(*t_ins, dy, torch.zeros_like(dh), ddec)
    for a, b in zip(no_dh, zero_dh):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_ssd_chunk_backward_in_blocks_of_heads():
    """A block budget of one head's matrices gives what one block gives."""
    ins, cots = _ssd_case(torch.float32, *SSD_SWEEP[1])
    t_ins = [_torch(a, torch.float32) for a in ins]
    t_cots = [_torch(c, torch.float32) for c in cots]
    whole = AG.ssd_chunk_backward(*t_ins, *t_cots)
    B, H, nc, cl, _ = t_ins[0].shape
    heads = AG.ssd_chunk_backward(*t_ins, *t_cots,
                                  block_bytes=B * nc * cl * cl * 4)
    for a, b in zip(whole, heads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _long_chunk():
    """A 256-step chunk at the model's initial decay (dt ~ softplus(N(0, 1)
    - 4), A down to -16), where cum[t] - cum[s] above the diagonal passes
    88.7; float32 inputs and cotangents."""
    rng = np.random.default_rng(3)
    B, H, nc, cl, P, N = 1, 4, 2, 256, 8, 8
    x = torch.from_numpy(_np(rng, (B, H, nc, cl, P)))
    dt = torch.from_numpy(_softplus(_np(rng, (B, H, nc, cl)) - 4))
    A = -torch.linspace(1.0, 16.0, H)
    Bm, Cm = (torch.from_numpy(_np(rng, (B, H, nc, cl, N)))
              for _ in range(2))
    cum = torch.cumsum(dt * A[None, :, None, None], -1)
    assert float((cum[..., :1] - cum[..., -1:]).max()) > 88.7
    cots = [torch.from_numpy(_np(rng, s)) for s in
            ((B, H, nc, cl, P), (B, H, nc, P, N), (B, H, nc))]
    return [x, dt, A, Bm, Cm], cots


def test_ssd_chunk_gradients_finite_over_a_long_chunk():
    """At ``_long_chunk``: the backward formula and autograd of the plain
    version (which masks before its exp) stay finite and agree."""
    (x, dt, A, Bm, Cm), cots = _long_chunk()
    got = AG.ssd_chunk_backward(x, dt, A, Bm, Cm, *cots)
    want = _autograd(ref.ssd_chunk, [x, dt, A, Bm, Cm], cots)
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm"), got, want):
        assert torch.isfinite(g).all(), name
        _close(g, w, torch.float32, f"d{name}")


def test_reference_ssd_oracle_gradient_overflows_on_a_long_chunk():
    """The reference's fault on a run (ROADMAP Queue 3): at
    ``_long_chunk``, ``jax.grad`` of ``repro.kernels.ref.ssd_chunk``, which
    takes exp(cum[t] - cum[s]) before its mask, is non-finite, while the
    port's gradients there (the ``SSDChunk`` backward formula and
    autograd of the plain version) are finite."""
    ins, cots = _long_chunk()

    def loss(*args):
        outs = jref.ssd_chunk(*args)
        return sum(jnp.sum(o * jnp.asarray(c.numpy()))
                   for o, c in zip(outs, cots))

    want = jax.grad(loss, argnums=range(5))(
        *[jnp.asarray(a.numpy()) for a in ins])
    assert not all(bool(jnp.isfinite(g).all()) for g in want)
    assert not bool(jnp.isfinite(want[1]).all())        # d dt
    for got in (AG.ssd_chunk_backward(*ins, *cots),
                _autograd(ref.ssd_chunk, ins, cots)):
        for name, g in zip(("x", "dt", "A", "Bm", "Cm"), got):
            assert torch.isfinite(g).all(), name


# --------------------------------------------------------------------------
# WKV6
# --------------------------------------------------------------------------


def _wkv_case(B, H, T, hd):
    """``test_wkv6_sweep``'s distributions, from numpy: r, k, v, w =
    sigmoid(N(0, 1)), u, s0; cotangents of out and the final state."""
    rng = np.random.default_rng(T * hd)
    r, k, v = (_np(rng, (B, H, T, hd)) for _ in range(3))
    w = (1 / (1 + np.exp(-_np(rng, (B, H, T, hd))))).astype(np.float32)
    u = _np(rng, (H, hd), 0.5)
    s0 = _np(rng, (B, H, hd, hd), 0.1)
    cots = [_np(rng, (B, H, T, hd)), _np(rng, (B, H, hd, hd))]
    return [r, k, v, w, u, s0], cots


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,T,hd", WKV_SWEEP)
def test_wkv6_backward_matches_jax_vjp(dtype, B, H, T, hd):
    ins, cots = _wkv_case(B, H, T, hd)
    types = [dtype] * 5 + [torch.float32]
    t_ins = [_torch(a, t) for a, t in zip(ins, types)]
    t_cots = [_torch(c, torch.float32) for c in cots]
    got = AG.wkv6_backward(*t_ins, *t_cots)
    # u goes in as the float32 value of its rounded self: the oracle's scan
    # closes over u and would sum a bf16 u's cotangent step by step in
    # bf16; its forward widens u to float32 all the same
    j_ins = [_jax(a, t) for a, t in zip(ins, types)]
    j_ins[4] = j_ins[4].astype(jnp.float32)
    _, vjp = jax.vjp(jref.wkv6, *j_ins)
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    plain = _autograd(ref.wkv6, t_ins, t_cots)
    for name, g, w, p, t in zip(("r", "k", "v", "w", "u", "s0"), got, want,
                                plain, types):
        assert g.dtype == t and g.shape == p.shape, name
        _close(g, w, t, f"d{name} vs jax.vjp")
        _close(g, p, t, f"d{name} vs torch.autograd")


def test_wkv6_backward_in_blocks_of_time():
    """Blocks of 1 and 5 time steps give what one block gives; ds0 is
    skipped when not needed; no state gradient is a zero one."""
    ins, cots = _wkv_case(*WKV_SWEEP[1])
    t_ins = [_torch(a, torch.float32) for a in ins]
    dout, dS = (_torch(c, torch.float32) for c in cots)
    whole = AG.wkv6_backward(*t_ins, dout, dS)
    B, H, T, hd = t_ins[0].shape
    for steps in (1, 5):
        blocks = AG.wkv6_backward(*t_ins, dout, dS,
                                  block_bytes=steps * B * H * hd * hd * 4)
        for a, b in zip(whole, blocks):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    part = AG.wkv6_backward(*t_ins, dout, None, needs=(True,) * 5 + (False,))
    zero = AG.wkv6_backward(*t_ins, dout, torch.zeros_like(dS))
    assert part[5] is None
    for a, b in zip(part[:5], zero[:5]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_wkv6_backward_with_vanishing_decay():
    """w ~ 1e-10 in places (the model's exp(-exp(wlog)) at large wlog): the
    states are recomputed forward, never divided back by w, so every
    gradient stays finite and matches autograd of the plain version."""
    B, H, T, hd = 1, 2, 24, 8
    rng = np.random.default_rng(5)
    r, k, v = (torch.from_numpy(_np(rng, (B, H, T, hd))) for _ in range(3))
    w = torch.from_numpy((1 / (1 + np.exp(-_np(rng, (B, H, T, hd)))))
                         .astype(np.float32))
    w[..., ::3, :2] = 1e-10
    u = torch.from_numpy(_np(rng, (H, hd), 0.5))
    s0 = torch.zeros(B, H, hd, hd)
    dout = torch.from_numpy(_np(rng, (B, H, T, hd)))
    got = AG.wkv6_backward(r, k, v, w, u, s0, dout, None)
    want = _autograd(ref.wkv6, [r, k, v, w, u, s0], [dout, None])
    for name, g, p in zip(("r", "k", "v", "w", "u", "s0"), got, want):
        assert torch.isfinite(g).all(), name
        _close(g, p, torch.float32, f"d{name}")


# --------------------------------------------------------------------------
# the concat and gate RMSNorms
# --------------------------------------------------------------------------


def _jax_rmsnorm(x, scale, eps):
    return jops.rmsnorm(x, scale, eps, impl="ref")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("R,d1,d2", [(8, 64, 64), (37, 96, 32)])
def test_cat_rmsnorm_backward_matches_jax_vjp(dtype, add, R, d1, d2):
    """y = rmsnorm([x (+ delta) | e]); with the add, the residual sum s is
    an output too, and its gradient adds to x's and delta's."""
    rng = np.random.default_rng(R + d1 + d2)
    eps = 1e-5
    x, delta, e = _np(rng, (R, d1)), _np(rng, (R, d1)), _np(rng, (R, d2))
    scale = 1 + _np(rng, (d1 + d2,), 0.1)
    dy, ds = _np(rng, (R, d1 + d2)), _np(rng, (R, d1))
    # the outputs' gradients in their type, as the Function receives them
    t_dy, t_ds = _torch(dy, dtype), _torch(ds, dtype)
    j_dy, j_ds = _jax(dy, dtype), _jax(ds, dtype)

    def jfn(xx, ee, sc, dd):
        s = xx + dd if add else xx
        y = _jax_rmsnorm(jnp.concatenate([s, ee], axis=-1), sc, eps)
        return (s, y) if add else y

    jins = [_jax(a, dtype) for a in (x, e, scale, delta)]
    _, vjp = jax.vjp(jfn, *jins)
    want = vjp((j_ds, j_dy) if add else j_dy)
    tx, te, tsc, tdl = (_torch(a, dtype) for a in (x, e, scale, delta))
    s = (tx + tdl) if add else tx
    dx, de, dscale = AG.cat_rmsnorm_backward(s, te, tsc, t_dy, eps,
                                             t_ds if add else None)
    got = [dx.to(dtype), de.to(dtype), dscale] + ([dx.to(dtype)] if add
                                                  else [])
    for name, g, w in zip(("x", "e", "scale", "delta"), got, want):
        assert g.dtype == dtype, name
        _close(g, w, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,d", [(8, 64), (37, 128)])
def test_gated_rmsnorm_backward_matches_jax_vjp(dtype, R, d):
    """out = rmsnorm((y * silu(z)).astype(dtype)), y and z float32 (as
    Mamba2 holds them), scale in ``dtype``."""
    rng = np.random.default_rng(R + d)
    eps = 1e-5
    y, z = _np(rng, (R, d)), _np(rng, (R, d), 2.0)
    scale = 1 + _np(rng, (d,), 0.1)
    dout = _np(rng, (R, d))

    def jfn(yy, zz, sc):
        return _jax_rmsnorm((yy * jax.nn.silu(zz)).astype(JNP[dtype]), sc,
                            eps)

    _, vjp = jax.vjp(jfn, jnp.asarray(y), jnp.asarray(z),
                     _jax(scale, dtype))
    want = vjp(_jax(dout, dtype))
    dy, dz, dscale = AG.gated_rmsnorm_backward(
        torch.from_numpy(y), torch.from_numpy(z), _torch(scale, dtype),
        _torch(dout, dtype), eps, dtype)
    for name, g, w, t in zip(("y", "z", "scale"), (dy, dz, dscale), want,
                             (torch.float32, torch.float32, dtype)):
        assert g.dtype == t, name
        _close(g, w, dtype, f"d{name}")


# --------------------------------------------------------------------------
# the Functions, routed on the CPU
# --------------------------------------------------------------------------


def _flash_with_lse(q, k, v, q_pos, k_pos, window=None, chunk=None,
                    lse=None):
    """The plain flash attention, and each row's logsumexp of its valid
    scaled scores written into ``lse`` (+inf where it sees no key), as the
    kernel writes it."""
    if lse is not None:
        group = q.shape[1] // k.shape[1]
        kk = k.float().repeat_interleave(group, dim=1)
        s = q.float() @ kk.transpose(-1, -2) / math.sqrt(q.shape[-1])
        ok = ref.attention_mask(q_pos[:, None, :, None],
                                k_pos[:, None, None, :], window, chunk)
        m = torch.logsumexp(torch.where(ok, s, -math.inf), dim=-1)
        lse.copy_(torch.where(ok.any(-1), m, math.inf))
    return ref.flash_attention(q, k, v, q_pos, k_pos, window, chunk)


@pytest.fixture
def card_path(monkeypatch):
    """Within the test: the kernel ops take their card branch on CPU
    tensors, and each kernel's forward is its plain version, counting its
    calls in the kernel module's ``launches`` as the wrapper does, its
    output cut from the graph as a kernel's is: only a Function's backward
    gives its inputs a gradient."""
    monkeypatch.setattr(ops, "_on_cuda", lambda t: t.device.type == "cpu")

    def counted(mod, name, fn):
        def run(*a, **kw):
            mod.launches += 1
            with torch.no_grad():
                return fn(*a, **kw)
        monkeypatch.setattr(mod, name, run)

    counted(FA, "flash_attention", _flash_with_lse)
    counted(SSD, "ssd_chunk", ref.ssd_chunk)
    counted(WKV, "wkv6", ops._plain_wkv6)
    for name in ("rmsnorm", "add_rmsnorm", "cat_rmsnorm", "gated_rmsnorm"):
        counted(RMS, name, getattr(ref, name))
    ops.reset_launches()


@pytest.mark.parametrize("dtype", DTYPES)
def test_functions_on_the_card_path_match_plain_autograd(card_path, dtype):
    """Each Function (the card branch of its op) against autograd of the
    plain op on the same inputs: ``ops.ssd_scan`` (B/C a head-stride-0
    group broadcast, as Mamba2 passes them), ``ops.wkv6``,
    ``ops.cat_rmsnorm`` with and without the add and
    ``ops.gated_rmsnorm``; one forward launch each."""
    rng = np.random.default_rng(11)
    Bsz, T, H, P, N = 2, 21, 3, 8, 4
    x = _torch(_np(rng, (Bsz, T, H, P)), dtype)
    dt = _torch(_softplus(_np(rng, (Bsz, T, H))), dtype)
    A = _torch(-np.exp(_np(rng, (H,), 0.5)), torch.float32)
    Bg, Cg = (_torch(_np(rng, (Bsz, T, 1, N)), dtype) for _ in range(2))
    dy_ssd = _torch(_np(rng, (Bsz, T, H, P)), torch.float32)

    def scan(xx, dd, aa, bb, cc):
        y, _ = ops.ssd_scan(xx, dd, aa, bb.expand(-1, -1, H, -1),
                            cc.expand(-1, -1, H, -1), chunk=8)
        return y

    Bw, Hw, Tw, hd = 2, 3, 23, 16
    r, k, v = (_torch(_np(rng, (Bw, Tw, Hw, hd)), dtype).transpose(1, 2)
               for _ in range(3))
    w = torch.sigmoid(_torch(_np(rng, (Bw, Hw, Tw, hd)), torch.float32))
    u = _torch(_np(rng, (Hw, hd), 0.5), torch.float32)
    s0 = torch.zeros(Bw, Hw, hd, hd)
    dout = _torch(_np(rng, (Bw, Hw, Tw, hd)), torch.float32)

    R, d1, d2 = 12, 32, 32
    xs, dl, e = (_torch(_np(rng, (R, d1)), dtype) for _ in range(3))
    sc = _torch(1 + _np(rng, (d1 + d2,), 0.1), dtype)
    dyc = _torch(_np(rng, (R, d1 + d2)), dtype)
    dsc = _torch(_np(rng, (R, d1)), dtype)
    yg, zg = (_torch(_np(rng, (R, 64)), torch.float32) for _ in range(2))
    scg = _torch(1 + _np(rng, (64,), 0.1), dtype)
    dyg = _torch(_np(rng, (R, 64)), dtype)

    cases = {
        "ssd_chunk": (scan, [x, dt, A, Bg, Cg], [dy_ssd]),
        "wkv6": (lambda *a: ops.wkv6(*a)[0], [r, k, v, w, u, s0], [dout]),
        "cat": (lambda a, b, c: ops.cat_rmsnorm(a, b, c, 1e-5),
                [xs, e, sc], [dyc]),
        "add+cat": (lambda a, b, c, dd: ops.cat_rmsnorm(a, b, c, 1e-5, dd),
                    [xs, e, sc, dl], [dsc, dyc]),
        "gate": (lambda a, b, c: ops.gated_rmsnorm(a, b, c, 1e-5, dtype),
                 [yg, zg, scg], [dyg]),
    }
    for name, (fn, inputs, cots) in cases.items():
        before = sum(ops.launch_counts().values())
        got = _autograd(fn, inputs, cots)
        assert sum(ops.launch_counts().values()) == before + 1, name
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "_on_cuda", lambda t: False)
            want = _autograd(fn, inputs, cots)
        for i, (g, p) in enumerate(zip(got, want)):
            assert g is not None and g.dtype == inputs[i].dtype, (name, i)
            _close(g, p, dtype if dtype == torch.bfloat16 else torch.float32,
                   f"{name} input {i}")


def test_wkv6_function_refuses_s_out_under_grad(card_path):
    r = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    w, u = torch.rand(1, 2, 8, 16), torch.randn(2, 16)
    s0 = torch.zeros(1, 2, 16, 16)
    with pytest.raises(RuntimeError, match="training keeps no state"):
        ops.wkv6(r, k, v, w, u, s0, s0)
    with torch.no_grad():
        ops.wkv6(r, k, v, w, u, s0, s0)


# the kernel launches of a smoke train forward: {kernel: count}
SMOKE_LAUNCHES = {
    # 2 mamba2 (ssd, gate norm, ln1) and 1 shared (flash, 2 concat norms)
    # layers, the final norm
    "zamba2-7b": {"ssd_chunk": 2, "flash_attention": 1, "rmsnorm": 7},
    "rwkv6-1.6b": {"wkv6": 2, "rmsnorm": 1},
}


@pytest.mark.parametrize("arch", sorted(SMOKE_LAUNCHES))
def test_smoke_train_through_the_functions_matches_jax_grad(card_path,
                                                            arch):
    """``train_loss`` and every gradient leaf of the smoke config through
    the Functions against ``jax.value_and_grad`` of the JAX package's, at
    ``test_torch_train_parity.py``'s tolerance; the kernels launch in the
    forward only (the backward recomputes in PyTorch)."""
    cfg, jm, np_params, jbatch, tbatch = case(arch)

    def loss_fn(p):
        return jm.train_loss(p, {k: jnp.asarray(v) for k, v in
                                 jbatch.items()}, remat=False)

    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                       np_params))
    model = Model(cfg, "cpu")
    params = params_from_jax(np_params, cfg, "cpu")
    for _, p in unique_leaves(params):
        p.requires_grad_(True)
    ops.reset_launches()
    loss, met = model.train_loss(params, tbatch, remat=False)
    fwd = {k: v for k, v in ops.launch_counts().items() if v}
    loss.backward()
    assert {k: v for k, v in ops.launch_counts().items() if v} == fwd
    assert fwd == SMOKE_LAUNCHES[arch], fwd
    for k in jmet:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    want = tree_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg,
                         "cpu")
    got = grad_tree(params)
    n = 0
    for (path, g), (wpath, w) in zip(named_leaves(got), named_leaves(want)):
        assert path == wpath
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="/".join(path))
        n += 1
    assert n == sum(1 for _ in named_leaves(params))
