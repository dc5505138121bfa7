"""The arithmetic of the two scan kernels, ``csrc/wkv6.cu`` and
``csrc/ssd_chunk.cu``, emulated in float32 with plain PyTorch on the CPU
(the kernels themselves run only on the card), against the port's plain
versions (``kernels/ref.py``, the CPU path of ``kernels/ops.py``) and the
JAX package's kernels, both in Pallas interpret mode and through its jnp
oracles. Inputs are made with numpy from a seed and handed to both
packages.

WKV6: the time split of a thread-block cluster. Each of C blocks runs its
span of steps from a zero state (its local outputs and end state dS), the
decay products D_t = prod w from the span's start, then the prefix combine
S_in(i+1) = D_end(i) o S_in(i) + dS(i) and the cross term (r_t o D_t).S_in
added to the outputs; a T longer than C spans loops in rounds with the
state carried. Held at 1e-5 of the largest output, relative and absolute
(the tolerance of the card tests).

SSD: the chunk's three products as the tensor cores take them: bf16
inputs with the score and B's scaled rows entering as hi + lo bf16 terms
(x, B and C exact), float32 inputs as three TF32 terms (hi.hi + hi.lo +
lo.hi, TF32 emulated by cutting the mantissa to 10 bits, as the tensor
cores read a float32 register). Held at atol and rtol 1e-4 (the card
tests' tolerance in both input types).
"""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels import ssd as JSSD
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

@pytest.fixture(autouse=True)
def _one_thread():
    """The emulations run thousands of operations on tensors of a few KB:
    one intra-op thread, restored after each test, keeps them from
    contending with the other test processes of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WKV_REL = 1e-5
SSD_TOL = dict(atol=1e-4, rtol=1e-4)
SPAN = 192        # csrc/wkv6.cu: the most steps a block takes in one round
MIN_SPAN = 16     # ... one block per MIN_SPAN steps,
ONE_BLOCK = 32    # ... one block in all up to ONE_BLOCK steps,
MAX_C = 6         # ... and at most MAX_C blocks
TILE = 64         # csrc/ssd_chunk.cu: t and s rows per tile


# --------------------------------------------------------------------------
# WKV6
# --------------------------------------------------------------------------

def _cluster_size(T):
    """The kernel's blocks per (batch, head) for T steps."""
    if T <= ONE_BLOCK:
        return 1
    return max(2, min(MAX_C, -(-T // MIN_SPAN)))


def _split_wkv6(r, k, v, w, u, s0, C):
    """csrc/wkv6.cu's arithmetic in float32 for a cluster of C blocks.
    r/k/v/w: (B,H,T,hd); u: (H,hd); s0: (B,H,hd,hd). The output at step t
    is r_t.S_t + (r_t.(u o k_t)) v_t with S_t the state before the step's
    update. C = 1 runs the whole recurrence from s0 in one block; C > 1
    walks every block's span of every round at once (steps past T padded
    with r = k = v = 0, w = 1: no output, no change to the state)."""
    r, k, v, w = (a.float() for a in (r, k, v, w))
    B, H, T, hd = r.shape
    ruk = (r * u.float()[None, :, None, :] * k).sum(-1)        # (B,H,T)
    if C == 1:
        S, outs = s0.float(), []
        for t in range(T):
            outs.append(torch.einsum("bhi,bhij->bhj", r[:, :, t], S)
                        + v[:, :, t] * ruk[:, :, t, None])
            S = w[:, :, t, :, None] * S + \
                k[:, :, t, :, None] * v[:, :, t, None, :]
        return torch.stack(outs, 2), S
    rounds = -(-T // (C * SPAN))
    L = -(-T // (C * rounds))
    pad = rounds * C * L - T

    def spans(x, fill):   # (B,H,T,*) -> (rounds, C, B, H, L, *)
        x = torch.cat([x, torch.full((B, H, pad) + x.shape[3:], fill)], 2)
        return x.reshape(B, H, rounds, C, L, *x.shape[3:]).movedim(
            (2, 3), (0, 1))
    rs, ks, vs, ws = (spans(x, f) for x, f in ((r, 0.), (k, 0.), (v, 0.),
                                              (w, 1.)))
    rks = spans(ruk, 0.)
    # every span from a zero state: local outputs, rows r_t o D_t, dS, D_end
    S = torch.zeros(rounds, C, B, H, hd, hd)
    D = torch.ones(rounds, C, B, H, hd)
    outs, rd = [], []
    for t in range(L):
        outs.append(torch.einsum("...i,...ij->...j", rs[..., t, :], S)
                    + vs[..., t, :] * rks[..., t, None])
        rd.append(rs[..., t, :] * D)
        D = D * ws[..., t, :]
        S = ws[..., t, :, None] * S + ks[..., t, :, None] * vs[..., t, None, :]
    out, rd = torch.stack(outs, -2), torch.stack(rd, -2)   # (.., L, hd)
    # the prefix combine over each round's spans, rounds in order, and the
    # cross term (r_t o D_t).S_in
    S_round = s0.float()
    for i in range(rounds):
        for c in range(C):
            out[i, c] += rd[i, c] @ S_round
            S_round = D[i, c][..., :, None] * S_round + S[i, c]
    out = out.movedim((0, 1), (2, 3)).reshape(B, H, rounds * C * L, hd)
    return out[:, :, :T], S_round


def _wkv_inputs(seed, B, H, T, hd, decay):
    """r, k, v ~ N(0, 1); u ~ N(0, 0.5); s0 ~ N(0, 0.1). ``decay``: the
    model's exp(-exp(-6 + N(0, 0.1))) ~ 0.9975, the reference sweep's
    sigmoid(N(0, 1)), w near 0 (products underflow inside a span), or
    w = 1 (no decay: the state sums every k (x) v)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, hd), dtype=np.float32)
               for _ in range(3))
    z = rng.standard_normal((B, H, T, hd))
    w = {"model": np.exp(-np.exp(-6.0 + 0.1 * z)),
         "sweep": 1.0 / (1.0 + np.exp(-z)),
         "near0": 1e-3 / (1.0 + np.exp(-z)),
         "one": np.ones_like(z)}[decay]
    u = 0.5 * rng.standard_normal((H, hd))
    s0 = 0.1 * rng.standard_normal((B, H, hd, hd))
    return (r, k, v, w.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _wkv_plain(T, decay):
    """(inputs as tensors, ``ref.wkv6``'s out and final state) for one
    case: two heads of the smoke config's head dim 32; cached over the
    cluster sizes and the JAX paths."""
    t = [torch.tensor(x) for x in _wkv_inputs(T * 7 + len(decay), 1, 2, T,
                                              32, decay)]
    return (t, *TOPS.wkv6(*t))


@functools.lru_cache(maxsize=None)
def _wkv_jax(T, decay, impl):
    """The JAX op's out and final state on the same inputs."""
    kw = dict(block_t=32) if impl == "pallas_interpret" else {}
    want_o, want_s = JOPS.wkv6(*(jnp.asarray(x.numpy())
                                 for x in _wkv_plain(T, decay)[0]),
                               impl=impl, **kw)
    return np.asarray(want_o), np.asarray(want_s)


def _close_to_max(got, want, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=WKV_REL,
        atol=WKV_REL * max(1.0, float(np.abs(want).max())), err_msg=msg)


@pytest.mark.parametrize("decay", ["model", "sweep", "near0", "one"])
@pytest.mark.parametrize("T,impl", [
    (T, impl) for T in (1, 17, 23, 119) for impl in ("pallas_interpret",
                                                     "ref")]
    + [(1024, "ref"), (1500, "ref")])     # as test_torch_rwkv.py runs them
@pytest.mark.parametrize("C", [1, 2, 4, 6, 8])
def test_wkv6_span_split_matches_plain(C, T, impl, decay):
    """Spans from a zero state, decay products, prefix combine and cross
    term equal ``ref.wkv6`` and the JAX op (``impl``), output and final
    state, at 1e-5 of the largest; T 1,500 runs two rounds at C 2, 4 and
    6 (the kernel's C there), and a cluster wider than T leaves blocks
    with empty spans."""
    t, plain_o, plain_s = _wkv_plain(T, decay)
    want_o, want_s = _wkv_jax(T, decay, impl)
    got_o, got_s = _split_wkv6(*t, C)
    for name, got, plain, want in (("out", got_o, plain_o, want_o),
                                   ("state", got_s, plain_s, want_s)):
        assert torch.isfinite(got).all(), name
        _close_to_max(got.numpy(), plain.numpy(), f"{name} vs plain")
        _close_to_max(got.numpy(), want, f"{name} vs jax {impl}")


def test_wkv6_cluster_size_follows_t():
    """One block at decode and up to 32 steps, then one block per 16
    steps, two to six; rounds of at most 192 steps a block."""
    assert [_cluster_size(T) for T in (1, 16, 32, 33, 64, 96, 119, 1024)] \
        == [1, 1, 1, 3, 4, 6, 6, 6]
    assert [-(-T // (_cluster_size(T) * SPAN)) for T in (1024, 1152, 1500)] \
        == [1, 1, 2]
    for T in (33, 129, 1024, 1025, 1500):
        C = _cluster_size(T)
        rounds = -(-T // (C * SPAN))
        L = -(-T // (C * rounds))
        assert L <= SPAN and C * rounds * (L - 1) < T <= C * rounds * L


# --------------------------------------------------------------------------
# SSD
# --------------------------------------------------------------------------

def _tf32(x):
    """The TF32 value the tensor cores read from a float32 register: the
    mantissa cut to 10 bits."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _three_tf32(a, b):
    """a @ b as three TF32 products: hi.hi + hi.lo + lo.hi."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def _hi_lo_bf16(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _split_ssd(x, dt, A, Bm, Cm, bf16):
    """csrc/ssd_chunk.cu's products in float32 on (B,H,nc,cl,*) inputs
    holding float32 values (bf16-valued when ``bf16``): C.B^T, the score
    (C.B^T) dt_s exp(cum_t - cum_s) under s <= t times x, and x^T times
    B o dt emit summed over 64-row s tiles (one partial a block of the
    cluster)."""
    cl = x.shape[3]
    cum = torch.cumsum(dt * A[None, :, None, None], dim=-1)
    cb = Cm @ Bm.transpose(-1, -2) if bf16 else \
        _three_tf32(Cm, Bm.transpose(-1, -2))
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool))
    decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        torch.zeros(()))
    score = cb * (dt[..., None, :] * decay)
    if bf16:
        hi, lo = _hi_lo_bf16(score)
        y = hi @ x + lo @ x
    else:
        y = _three_tf32(score, x)
    bw = Bm * (dt * torch.exp(cum[..., -1:] - cum))[..., None]
    h = 0
    for s0 in range(0, cl, TILE):
        xt = x[..., s0:s0 + TILE, :].transpose(-1, -2)
        bt = bw[..., s0:s0 + TILE, :]
        if bf16:
            hi, lo = _hi_lo_bf16(bt)
            h = h + (xt @ hi + xt @ lo)
        else:
            h = h + _three_tf32(xt, bt)
    return y, h, torch.exp(cum[..., -1])


def _ssd_np(seed, B, H, nc, cl, P, N, dist):
    """x, B, C ~ N(0, 1). ``model``: dt = softplus(N(0, 1) - 4) ~ 0.01 and
    A = -[1 .. 16], as the mamba2 block starts (``tests/test_torch_cuda.py``);
    ``sweep``: dt = softplus(N(0, 1)), A = -exp(N(0, 0.5)), the reference
    sweep's (``tests/test_torch_ssm.py``)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, nc, cl, P), dtype=np.float32)
    z = rng.standard_normal((B, H, nc, cl))
    if dist == "model":
        dt = np.log1p(np.exp(z - 4.0))
        A = -np.linspace(1.0, 16.0, H)
    else:
        dt = np.log1p(np.exp(z))
        A = -np.exp(rng.standard_normal(H) * 0.5)
    Bm = rng.standard_normal((B, H, nc, cl, N), dtype=np.float32)
    Cm = rng.standard_normal((B, H, nc, cl, N), dtype=np.float32)
    return x, dt.astype(np.float32), A.astype(np.float32), Bm, Cm


@functools.lru_cache(maxsize=None)
def _ssd_case(shape, dist, dtype, impl):
    """(inputs rounded to ``dtype`` as float32, the JAX kernel's or
    oracle's outputs) for one case."""
    x, dt, A, Bm, Cm = _ssd_np(sum(shape) + len(dist), *shape, dist)
    jdt = getattr(jnp, dtype)
    jx = [jnp.asarray(a).astype(jdt) for a in (x, dt, Bm, Cm)]
    if impl == "ref":
        want = JREF.ssd_chunk(jx[0], jx[1], jnp.asarray(A), jx[2], jx[3])
    else:
        want = JSSD.ssd_chunk(jx[0], jx[1], jnp.asarray(A), jx[2], jx[3],
                              interpret=True)
    rounded = [np.asarray(a.astype(jnp.float32)) for a in jx]
    return (rounded[0], rounded[1], A, rounded[2], rounded[3]), \
        tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,dist", [
    ((1, 2, 1, 256, 64, 64), "model"),   # the full config's chunk: 4 tiles
    ((1, 2, 1, 119, 64, 64), "model"),   # ragged (an exact-length prompt)
    ((2, 3, 2, 64, 32, 16), "model"),    # one tile a chunk
    ((2, 3, 2, 64, 32, 16), "sweep"),
    ((1, 2, 2, 8, 8, 4), "model"),       # the reference sweep's P 8, N 4
    ((1, 2, 2, 8, 8, 4), "sweep"),
    ((1, 2, 4, 16, 16, 16), "sweep"),
])
def test_ssd_split_products_match_plain(shape, dist, dtype, impl):
    """hi + lo bf16 (bf16 inputs) and three-term TF32 (float32 inputs)
    products give y_intra, h_chunk and decay within atol and rtol 1e-4 of
    ``ref.ssd_chunk`` and of the JAX kernel (``impl``) on the same
    inputs. The sweep's dt (~1) only at its short chunks: over 256 steps
    its cum reaches the hundreds, where float32 rounding of the cumsum
    alone moves the plain versions apart by more than 1e-4."""
    args, want = _ssd_case(shape, dist, dtype, impl)
    t = [torch.tensor(a) for a in args]
    got = _split_ssd(*t, bf16=dtype == "bfloat16")
    tdt = getattr(torch, dtype)
    plain = TREF.ssd_chunk(t[0].to(tdt), t[1].to(tdt), t[2], t[3].to(tdt),
                           t[4].to(tdt))
    for name, g, p, w in zip(("y_intra", "h_chunk", "decay"), got, plain,
                             want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), p.numpy(), **SSD_TOL,
                                   err_msg=f"{name} vs plain")
        np.testing.assert_allclose(g.numpy(), w, **SSD_TOL,
                                   err_msg=f"{name} vs jax {impl}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_one_term_products_miss_the_tolerance(dtype):
    """Why the split terms: a single TF32 product (float32 inputs) or a
    single bf16 rounding of the score and of B's scaled rows (bf16 inputs)
    puts elements past 1e-4 at the full config's chunk."""
    args, _ = _ssd_case((1, 2, 1, 256, 64, 64), "model", dtype, "ref")
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in args)
    cl = x.shape[3]
    cum = torch.cumsum(dt * A[None, :, None, None], dim=-1)
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool))
    decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        torch.zeros(()))
    if dtype == "float32":
        score = _tf32(Cm) @ _tf32(Bm.transpose(-1, -2)) * \
            (dt[..., None, :] * decay)
        y = _tf32(score) @ _tf32(x)
    else:
        score = Cm @ Bm.transpose(-1, -2) * (dt[..., None, :] * decay)
        y = score.bfloat16().float() @ x
    want = TREF.ssd_chunk(x, dt, A, Bm, Cm)[0]
    bad = (y - want).abs() > SSD_TOL["atol"] + SSD_TOL["rtol"] * want.abs()
    assert int(bad.sum()) > 0
