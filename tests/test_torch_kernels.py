"""Plain PyTorch attention and RMSNorm (the CPU path of
``repro_torch.kernels.ops``) against the JAX ops, both through the Pallas
kernels in interpret mode and through the jnp oracles. Inputs are made
with numpy from a seed and handed to both packages; only valid query rows
are compared (a pad row's output is unspecified: the Pallas kernel's
block padding makes it differ from the oracle's). float32, atol/rtol
1e-5: the same f32 math in another order."""
import functools

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
    x = torch.randn(1, 8, 2, 16)                     # (B, T, H, P)
    TOPS.ssd_scan(x, torch.rand(1, 8, 2), -torch.rand(2), x, x, chunk=4)
    xt = x.transpose(1, 2)                           # (B, H, T, hd) views
    TOPS.wkv6(xt, xt, xt, torch.rand(1, 2, 8, 16), torch.rand(2, 16),
              torch.zeros(1, 2, 16, 16))
    TOPS.rmsnorm(x, torch.ones(16), 1e-5)
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
    assert [h.name for h in headers] == ["attention_tile.cuh"]
    before = {n: build._target(n) for n in build.SOURCES}
    assert before == {n: build._target(n) for n in build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: build._target(n) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)
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
