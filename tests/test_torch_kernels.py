"""Plain PyTorch attention and RMSNorm (the CPU path of
``repro_torch.kernels.ops``) against the JAX ops, both through the Pallas
kernels in interpret mode and through the jnp oracles. Inputs are made
with numpy from a seed and handed to both packages; only valid query rows
are compared (a pad row's output is unspecified: the Pallas kernel's
block padding makes it differ from the oracle's). float32, atol/rtol
1e-5: the same f32 math in another order."""
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as JOPS
from repro_torch.kernels import ops as TOPS

TOL = dict(atol=1e-5, rtol=1e-5)


def _positions(rng, B, S, pad):
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    for b in range(B):
        n_pad = int(rng.integers(1, S // 3)) if pad else 0
        if n_pad:
            pos[b, S - n_pad:] = -1        # right padding
    return pos


FLASH_CASES = [
    # (group, S, window, chunk, pad)
    (1, 37, None, None, True),
    (2, 150, None, None, True),         # ragged past one 128 block
    (4, 64, None, None, False),
    (2, 96, 24, None, True),
    (1, 80, None, 32, False),
    (4, 45, 16, 16, True),
]


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("group,S,window,chunk,pad", FLASH_CASES)
def test_flash_plain_matches_jax(impl, group, S, window, chunk, pad):
    rng = np.random.default_rng(S * 10 + group)
    B, Hkv, hd = 2, 2, 16
    Hq = Hkv * group
    q = rng.standard_normal((B, Hq, S, hd), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, hd), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, hd), dtype=np.float32)
    pos = _positions(rng, B, S, pad)
    fa = jax.jit(functools.partial(JOPS.flash_attention, window=window,
                                   chunk=chunk, impl=impl))
    want = np.asarray(fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(pos), jnp.asarray(pos)))
    got = TOPS.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.from_numpy(pos), window=window,
        chunk=chunk).numpy()
    valid = pos >= 0                                   # (B, S) query rows
    for b in range(B):
        np.testing.assert_allclose(got[b][:, valid[b]], want[b][:, valid[b]],
                                   **TOL)
    assert np.isfinite(got).all()


DECODE_CASES = [
    # (group, W, window, chunk)
    (1, 96, None, None),
    (2, 130, None, None),
    (4, 64, None, None),
    (2, 96, 20, None),
    (1, 64, None, 16),
]


def _ring_positions(rng, B, W):
    """Per-slot (k_pos, q_pos) of a ring cache: some slots partly filled,
    some wrapped (k_pos not sorted), a few right-padded prompt rows -1."""
    k_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    for b in range(B):
        n = int(rng.integers(1, 2 * W))             # tokens written so far
        for t in range(n):
            k_pos[b, t % W] = t
        k_pos[b, rng.integers(0, W, 2)] = -1        # pad rows stay masked
        q_pos[b] = n - 1
        k_pos[b, (n - 1) % W] = n - 1               # the current token
    return q_pos, k_pos


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("group,W,window,chunk", DECODE_CASES)
def test_decode_plain_matches_jax(impl, group, W, window, chunk):
    rng = np.random.default_rng(W * 10 + group)
    B, Hkv, hd = 3, 2, 16
    Hq = Hkv * group
    q = rng.standard_normal((B, Hq, hd), dtype=np.float32)
    # the cache layout (B, W, Hkv, hd), passed as (B, Hkv, W, hd) views
    k = rng.standard_normal((B, W, Hkv, hd), dtype=np.float32)
    v = rng.standard_normal((B, W, Hkv, hd), dtype=np.float32)
    q_pos, k_pos = _ring_positions(rng, B, W)
    da = jax.jit(functools.partial(JOPS.decode_attention, window=window,
                                   chunk=chunk, impl=impl))
    want = np.asarray(da(jnp.asarray(q), jnp.moveaxis(jnp.asarray(k), 1, 2),
                         jnp.moveaxis(jnp.asarray(v), 1, 2),
                         jnp.asarray(q_pos), jnp.asarray(k_pos)))
    got = TOPS.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), torch.from_numpy(q_pos),
        torch.from_numpy(k_pos), window=window, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _mla_case(rng):
    """``tests/test_kernels.py::test_mla_decode_attention_matches_naive``'s
    case: B2, H4 over one latent head, W24, kvr 16 + rope 8, nope 12, 17
    valid keys; inputs from a numpy seed. Returns (q_nope, q_rope, ckv,
    k_rope, w_uk, q_pos, k_pos) as numpy."""
    B, H, W, kvr, rope, nope = 2, 4, 24, 16, 8, 12
    q_nope = rng.standard_normal((B, H, nope), dtype=np.float32)
    q_rope = rng.standard_normal((B, H, rope), dtype=np.float32)
    ckv = rng.standard_normal((B, W, kvr), dtype=np.float32)
    k_rope = rng.standard_normal((B, W, rope), dtype=np.float32)
    w_uk = rng.standard_normal((kvr, H, nope), dtype=np.float32) * 0.3
    n_valid = 17
    k_pos = np.tile(np.where(np.arange(W) < n_valid, np.arange(W), -1),
                    (B, 1)).astype(np.int32)
    q_pos = np.full((B,), n_valid - 1, np.int32)
    return q_nope, q_rope, ckv, k_rope, w_uk, q_pos, k_pos


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
def test_mla_decode_plain_matches_jax_and_naive(impl):
    """The port's plain ``ops.mla_decode_attention`` (the CPU path: the
    plain decode with hd 24, hd_v 16) against the JAX op (Pallas interpret
    at block_k 8 as the reference test, and its oracle) and against the
    naive expanded MLA: keys expanded per head through w_uk, softmax over
    the valid positions at 1/sqrt(nope + rope). float32, rtol = atol = 1e-4
    (the reference test's)."""
    q_nope, q_rope, ckv, k_rope, w_uk, q_pos, k_pos = _mla_case(
        np.random.default_rng(165))
    nope, rope = q_nope.shape[-1], q_rope.shape[-1]
    q_lat = np.einsum("bhn,rhn->bhr", q_nope, w_uk)
    kw = dict(block_k=8) if impl == "pallas_interpret" else {}
    want = np.asarray(JOPS.mla_decode_attention(
        jnp.asarray(q_lat), jnp.asarray(q_rope), jnp.asarray(ckv),
        jnp.asarray(k_rope), jnp.asarray(q_pos), jnp.asarray(k_pos),
        impl=impl, qk_dim=nope + rope, **kw))
    got = TOPS.mla_decode_attention(
        *(torch.from_numpy(x) for x in (q_lat, q_rope, ckv, k_rope, q_pos,
                                        k_pos)), qk_dim=nope + rope).numpy()
    assert got.shape == (2, 4, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    k_nope = np.einsum("bwr,rhn->bwhn", ckv, w_uk)
    s = (np.einsum("bhn,bwhn->bhw", q_nope, k_nope)
         + np.einsum("bhr,bwr->bhw", q_rope, k_rope)) / math.sqrt(nope + rope)
    s = np.where((k_pos >= 0)[:, None, :], s, -1e9)
    w = np.exp(s - s.max(-1, keepdims=True))
    naive = np.einsum("bhw,bwr->bhr", w / w.sum(-1, keepdims=True), ckv)
    np.testing.assert_allclose(got, naive, rtol=1e-4, atol=1e-4)


def test_fully_masked_rows_are_finite():
    """A pad query (q_pos = -1) masks every key; its row must stay finite."""
    q = torch.randn(1, 2, 5, 16)
    k = torch.randn(1, 2, 5, 16)
    pos = torch.full((1, 5), -1, dtype=torch.int32)
    out = TOPS.flash_attention(q, k, k, pos, pos)
    assert torch.isfinite(out).all()


def test_launch_counts_untouched_on_cpu():
    """The plain path never counts as a kernel launch."""
    TOPS.reset_launches()
    q = torch.randn(1, 2, 4, 16)
    pos = torch.arange(4, dtype=torch.int32)[None]
    TOPS.flash_attention(q, q, q, pos, pos)
    TOPS.decode_attention(q[:, :, 0], q, q, pos[:, 0], pos)
    pages = torch.randn(2, 3, 4, 16)                 # 2 pages + trash
    tbl = torch.tensor([[1, -1]], dtype=torch.int32)
    k_pos = torch.tensor([[0, 1, 2, 3, -1, -1, -1, -1]], dtype=torch.int32)
    TOPS.paged_decode_attention(q[:, :, 0], pages, pages, tbl, pos[:, 3],
                                k_pos)
    TOPS.chunked_prefill_attention(q, pages, pages, tbl, pos, k_pos)
    TOPS.mla_decode_attention(q[:, :, 0], q[:, :, 0, :8], q[:, 0], q[:, 1, :, :8],
                              pos[:, 3], pos, qk_dim=20)
    x = torch.randn(1, 8, 2, 16)                     # (B, T, H, P)
    TOPS.ssd_scan(x, torch.rand(1, 8, 2), -torch.rand(2), x, x, chunk=4)
    xt = x.transpose(1, 2)                           # (B, H, T, hd) views
    TOPS.wkv6(xt, xt, xt, torch.rand(1, 2, 8, 16), torch.rand(2, 16),
              torch.zeros(1, 2, 16, 16))
    TOPS.rmsnorm(x, torch.ones(16), 1e-5)
    TOPS.add_rmsnorm(x, x, torch.ones(16), 1e-5)
    TOPS.cat_rmsnorm(x, x, torch.ones(32), 1e-5, delta=x)
    TOPS.gated_rmsnorm(x, x, torch.ones(16), 1e-5, torch.bfloat16)
    assert TOPS.launch_counts() == {"flash_attention": 0,
                                    "decode_attention": 0,
                                    "paged_decode_attention": 0,
                                    "chunked_prefill_attention": 0,
                                    "ssd_chunk": 0, "wkv6": 0, "rmsnorm": 0}


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,d", [(8, 128), (37, 256), (5, 512)])
def test_rmsnorm_plain_matches_jax(impl, dtype, R, d):
    """The plain RMSNorm (the CPU path of ``ops.rmsnorm``) against the
    reference's on ``tests/test_kernels.py``'s sweep shapes, with a
    leading batch dim flattened into rows as the model passes it. float32
    1e-5; bf16 2e-2 (the reference sweep's: both compute in float32 and
    round once to bf16, so they differ by at most one bf16 ulp)."""
    rng = np.random.default_rng(R + d)
    x = rng.standard_normal((1, R, d), dtype=np.float32)
    scale = (rng.standard_normal(d) * 0.1 + 1.0).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(block_rows=16) if impl == "pallas_interpret" else {}
    want = JOPS.rmsnorm(jnp.asarray(x).astype(jdt),
                        jnp.asarray(scale).astype(jdt), impl=impl, **kw)
    got = TOPS.rmsnorm(torch.from_numpy(x).to(tdt),
                       torch.from_numpy(scale).to(tdt), 1e-5)
    assert got.dtype == tdt and got.shape == (1, R, d)
    t = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **t)


@pytest.mark.parametrize("impl", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["add", "cat", "add+cat", "gate"])
@pytest.mark.parametrize("R,d", [(8, 128), (37, 256), (5, 99)])
def test_fused_rmsnorm_plain_matches_jax(impl, dtype, op, R, d):
    """The plain versions of the fused RMSNorm ops (the CPU path of
    ``ops.add_rmsnorm``, ``ops.cat_rmsnorm`` and ``ops.gated_rmsnorm``)
    against the reference's composition on the same inputs: ``x + delta``,
    ``jnp.concatenate`` or Mamba2's ``(y * jax.nn.silu(z)).astype(dt)``
    (``repro/models/ssm.py``), then the reference's ``ops.rmsnorm``. The
    tolerance of ``test_rmsnorm_plain_matches_jax``; the residual stream
    x + delta equal to the reference's exactly. cat and add+cat: two
    segments of d (Zamba2's concat of the residual stream and the
    embedding output); gate: y and z float32, the row cast to dtype."""
    rng = np.random.default_rng(R * d + len(op))
    x, delta, e = (rng.standard_normal((1, R, d), dtype=np.float32)
                   for _ in range(3))
    width = 2 * d if "cat" in op else d
    scale = (rng.standard_normal(width) * 0.1 + 1.0).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(block_rows=16) if impl == "pallas_interpret" else {}
    jnorm = functools.partial(JOPS.rmsnorm, scale=jnp.asarray(scale).astype(
        jdt), impl=impl, **kw)
    tx, td, te = (torch.from_numpy(a).to(tdt) for a in (x, delta, e))
    jx, jd, je = (jnp.asarray(a).astype(jdt) for a in (x, delta, e))
    tscale = torch.from_numpy(scale).to(tdt)
    want_s = got_s = None
    if op == "add":
        want_s = jx + jd
        want = jnorm(want_s)
        got_s, got = TOPS.add_rmsnorm(tx, td, tscale, 1e-5)
    elif op == "cat":
        want = jnorm(jnp.concatenate([jx, je], axis=-1))
        got = TOPS.cat_rmsnorm(tx, te, tscale, 1e-5)
    elif op == "add+cat":
        want_s = jx + jd
        want = jnorm(jnp.concatenate([want_s, je], axis=-1))
        got_s, got = TOPS.cat_rmsnorm(tx, te, tscale, 1e-5, delta=td)
    else:
        want = jnorm((jnp.asarray(x) * jax.nn.silu(jnp.asarray(delta)))
                     .astype(jdt))
        got = TOPS.gated_rmsnorm(torch.from_numpy(x), torch.from_numpy(delta),
                                 tscale, 1e-5, tdt)
    assert got.dtype == tdt and got.shape == (1, R, width)
    t = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **t)
    if want_s is not None:
        assert got_s.dtype == tdt and got_s.shape == (1, R, d)
        np.testing.assert_array_equal(got_s.float().numpy(),
                                      np.asarray(want_s, np.float32))


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """A kernel library is keyed by its source and by every shared
    ``csrc/*.cuh`` header: an edited header changes the key of every
    source (a stale library is never reused), an unchanged tree keeps it.
    Hashing only; no ``nvcc``."""
    import shutil

    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["attention_tile.cuh",
                                         "decode_tile.cuh"]
    before = {n: build._target(n) for n in build.SOURCES}
    assert before == {n: build._target(n) for n in build.SOURCES}
    for header in headers:
        header.write_text(header.read_text() + "\n// edited\n")
        after = {n: build._target(n) for n in build.SOURCES}
        assert all(after[n] != before[n] for n in build.SOURCES)
        before = after
    (csrc / "flash_attention.cu").write_text("// edited source\n")
    again = {n: build._target(n) for n in build.SOURCES}
    assert again["flash_attention"] != after["flash_attention"]
    assert all(again[n] == after[n] for n in build.SOURCES
               if n != "flash_attention")


def test_build_key_follows_source_dir(tmp_path):
    """Sources of another directory (``build.build(..., csrc=DIR)``) are
    keyed by their own content into the same build directory: an identical
    copy shares this tree's library, an edited one gets its own. Hashing
    only; no ``nvcc``."""
    import shutil

    from repro_torch.kernels import build
    other = tmp_path / "other"
    shutil.copytree(build.CSRC, other)
    ours = {n: build._target(n) for n in build.SOURCES}
    assert ours == {n: build._target(n, other) for n in build.SOURCES}
    (other / "chunked_prefill_attention.cu").write_text("// variant\n")
    theirs = build._target("chunked_prefill_attention", other)
    assert theirs != ours["chunked_prefill_attention"]
    assert theirs.parent == build.BUILD_DIR


# --------------------------------------------------------------------------
# the split-KV arithmetic of csrc/decode_tile.cuh, emulated in float32
# --------------------------------------------------------------------------

def _first_key(qp, window, chunk):
    """The smallest valid key position of query position ``qp``: keys are
    valid iff first_key <= k_pos <= qp (the core's two compares)."""
    lo = 0
    if window is not None:
        lo = max(lo, qp - window + 1)
    if chunk is not None and qp >= 0:
        lo = max(lo, qp - qp % chunk)
    return lo


def _split_decode(q, k, v, q_pos, k_pos, window, chunk, C, tile):
    """The decode core's arithmetic in float32: the W keys of each (batch,
    kv head) cut into ``tile``-key tiles, the tiles into C contiguous spans
    of whole tiles (one per block of a cluster). A span whose positions
    prove every key masked contributes (m, l, o) = (-inf, 0, 0); any other
    scores a valid key q.k/sqrt(hd), a masked one -1e9 and one past the
    edge -inf, with the masked rows' V (of hd_v) zero-filled. The spans
    merge with
    weights exp(m - M), 0 where m is -inf, and the denominator is clamped
    at 1e-30, so a query with no valid key writes 0."""
    B, Hq, hd = q.shape
    Hkv, W, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    n_all = -(-W // tile)
    per = -(-n_all // C)
    out = torch.zeros(B, Hq, hd_v)
    for b in range(B):
        qp = int(q_pos[b])
        lo = _first_key(qp, window, chunk)
        for h in range(Hq):
            kk, vv = k[b, h // G], v[b, h // G]
            ms, ls, os_ = [], [], []
            for c in range(C):
                # a block past the last tile owns no keys at all
                idx = torch.arange(c * per * tile,
                                   max(c * per, min(n_all, (c + 1) * per))
                                   * tile)
                inside = idx < W
                kp = torch.where(inside, k_pos[b, idx.clamp(max=W - 1)],
                                 torch.full_like(idx, -1, dtype=k_pos.dtype))
                valid = inside & (kp >= lo) & (kp <= qp)
                if not bool(valid.any()):
                    ms.append(torch.tensor(-math.inf))
                    ls.append(torch.tensor(0.0))
                    os_.append(torch.zeros(hd_v))
                    continue
                rows = idx.clamp(max=W - 1)
                s = (kk[rows] @ q[b, h]) / math.sqrt(hd)
                s = torch.where(valid, s, torch.full_like(s, -1e9))
                s = torch.where(inside, s, torch.full_like(s, -math.inf))
                m = s.max()
                p = torch.exp(s - m)
                vz = torch.where(valid[:, None], vv[rows], torch.zeros(()))
                ms.append(m)
                ls.append(p.sum())
                os_.append(p @ vz)
            m_all = torch.stack(ms)
            M = m_all.max()
            f = torch.where(m_all == -math.inf, torch.zeros(()),
                            torch.exp(m_all - M))
            L = (f * torch.stack(ls)).sum()
            O = (f[:, None] * torch.stack(os_)).sum(0)
            out[b, h] = O / torch.clamp(L, min=1e-30)
    return out


def _has_valid(q_pos, k_pos, window, chunk):
    return [bool(((k_pos[b] >= _first_key(int(q_pos[b]), window, chunk))
                  & (k_pos[b] <= int(q_pos[b]))).any())
            for b in range(len(q_pos))]


@pytest.mark.parametrize("C,tile", [(1, 64), (3, 8), (8, 4)])
@pytest.mark.parametrize("fill", [0.6, 1.0])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("B,Hq,Hkv,W,hd", [
    (1, 2, 2, 16, 8), (2, 4, 2, 29, 16), (1, 8, 1, 130, 64),
])
def test_split_decode_arithmetic_matches_plain(B, Hq, Hkv, W, hd, window,
                                               fill, C, tile):
    """The core's span-and-merge arithmetic equals ``ref.decode_attention``
    on the reference's decode sweep shapes (``tests/test_kernels.py``),
    float32, atol/rtol 1e-5."""
    rng = np.random.default_rng(W * hd + C)
    q = torch.from_numpy(rng.standard_normal((B, Hq, hd), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, W, hd),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, W, hd),
                                             dtype=np.float32))
    n_valid = max(1, int(W * fill))
    kp = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    kp = torch.from_numpy(np.where(kp < n_valid, kp, -1).astype(np.int32))
    qp = torch.full((B,), n_valid - 1, dtype=torch.int32)
    got = _split_decode(q, k, v, qp, kp, window, None, C, tile)
    want = TOPS.decode_attention(q, k, v, qp, kp, window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("C,tile", [(1, 64), (3, 8), (8, 4)])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_split_paged_decode_arithmetic_matches_plain(group, page_size, C,
                                                     tile):
    """The same arithmetic on the logical view of a paged pool equals
    ``ref.paged_decode_attention`` on the reference's paged sweep
    (``tests/test_paged_kernel.py``: B 3, 2 kv heads, hd 16, 4 pages a slot,
    a partial page, an exact fill and a tiny slot, pages shared tighter than
    B x M), float32, atol/rtol 1e-5."""
    from repro_torch.kernels import ref as TREF
    B, Hkv, hd, M = 3, 2, 16, 4
    ps = page_size
    rng = np.random.default_rng(group * 17 + ps + C)
    num_pages = B * M - 2
    lens = [13, 3 * ps, 5]
    kp = rng.standard_normal((Hkv, num_pages + 1, ps, hd), dtype=np.float32)
    vp = rng.standard_normal((Hkv, num_pages + 1, ps, hd), dtype=np.float32)
    perm = rng.permutation(num_pages)
    tbl = np.full((B, M), -1, np.int32)
    k_pos = np.full((B, M * ps), -1, np.int32)
    pi = 0
    for b, L in enumerate(lens):
        npg = -(-L // ps)
        tbl[b, :npg] = perm[pi:pi + npg]
        pi += npg
        k_pos[b, :L] = np.arange(L)
    q_pos = np.asarray([L - 1 for L in lens], np.int32)
    q = torch.from_numpy(rng.standard_normal((B, group * Hkv, hd),
                                             dtype=np.float32))
    kp, vp, tbl, q_pos, k_pos = (torch.from_numpy(x) for x in
                                 (kp, vp, tbl, q_pos, k_pos))
    got = _split_decode(q, TREF.logical_view(kp, tbl),
                        TREF.logical_view(vp, tbl), q_pos, k_pos, None, None,
                        C, tile)
    want = TOPS.paged_decode_attention(q, kp, vp, tbl, q_pos, k_pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("case", ["last_span_only", "one_span",
                                  "all_empty", "wrapped", "chunk_window"])
def test_split_decode_arithmetic_with_empty_spans(case):
    """Spans with no valid key merge to nothing: one valid key in the last
    of eight spans of a 2,048-key cache, every span but one empty, a wrapped
    ring (positions unsorted), a chunk and window mask leaving most spans
    empty: equal to ``ref.decode_attention``, finite, no NaN. A row with no
    valid key at all (every span empty) writes 0 (the oracle averages the
    masked values instead: the documented difference)."""
    rng = np.random.default_rng(11)
    B, Hkv, G, hd, W = 3, 2, 2, 16, 2048
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, hd),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, W, hd),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, W, hd),
                                             dtype=np.float32))
    k_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros(B, np.int32)
    window = chunk = None
    for b in range(B):
        if case == "last_span_only":           # one key, at the very end
            k_pos[b, W - 1 - b] = 5
            q_pos[b] = 5
        elif case == "one_span":               # keys 700..899 only
            k_pos[b, 700:900] = np.arange(200)
            q_pos[b] = 199 - b
        elif case == "all_empty":
            q_pos[b] = [0, 10, -1][b]          # no row holds a valid key
        elif case == "wrapped":
            n = W + 300 + 97 * b               # the ring wrapped
            t = np.arange(n - W, n)
            k_pos[b, t % W] = t
            q_pos[b] = n - 1
        else:
            k_pos[b] = np.arange(W)
            q_pos[b] = 1500 + b
            window, chunk = 40, 512
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    got = _split_decode(q, k, v, qp, kp, window, chunk, 8, 64)
    assert torch.isfinite(got).all()
    valid = _has_valid(qp, kp, window, chunk)
    want = TOPS.decode_attention(q, k, v, qp, kp, window, chunk)
    for b in range(B):
        if valid[b]:
            np.testing.assert_allclose(got[b].numpy(), want[b].numpy(),
                                       **TOL)
        else:
            assert (got[b] == 0).all()
    assert any(valid) == (case != "all_empty")


@pytest.mark.parametrize("C,tile", [(1, 32), (1, 64), (3, 8)])
def test_split_decode_arithmetic_mla(C, tile):
    """The core at hd 24, hd_v 16, group 4 (MLA's instances: tiles of 32
    keys in float32, 64 in bf16, one block for W 24; and a split): q·k over
    24, p·V over the 16 latent dims, equal to the plain
    ``ops.mla_decode_attention`` on the reference's MLA case, float32,
    atol/rtol 1e-5."""
    q_nope, q_rope, ckv, k_rope, w_uk, q_pos, k_pos = _mla_case(
        np.random.default_rng(166))
    nope, rope = q_nope.shape[-1], q_rope.shape[-1]
    q_lat = torch.from_numpy(np.einsum("bhn,rhn->bhr", q_nope, w_uk))
    q_rope, ckv, k_rope, qp, kp = (torch.from_numpy(x) for x in
                                   (q_rope, ckv, k_rope, q_pos, k_pos))
    q = torch.cat([q_lat, q_rope], -1) * (math.sqrt(24) / math.sqrt(nope + rope))
    k = torch.cat([ckv, k_rope], -1)[:, None]
    got = _split_decode(q, k, ckv[:, None], qp, kp, None, None, C, tile)
    want = TOPS.mla_decode_attention(q_lat, q_rope, ckv, k_rope, qp, kp,
                                     qk_dim=nope + rope)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("hd,hd_v,Hq", [(24, 16, 2), (32, 16, 4), (24, 8, 4),
                                        (24, 24, 4)])
def test_decode_wrapper_refuses_head_dim_pairs_without_instance(hd, hd_v, Hq):
    """The CUDA wrapper takes hd_v != hd only where an instance exists, (24,
    16) at group 4, and raises before any build or launch on every other
    pair (and on hd 24 with hd_v == hd, which no instance has)."""
    from repro_torch.kernels import decode_attention as DA
    q = torch.randn(1, Hq, hd)
    k = torch.randn(1, 1, 8, hd)
    v = torch.randn(1, 1, 8, hd_v)
    pos = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="head dims"):
        DA.decode_attention(q, k, v, pos[:, 0], pos)
