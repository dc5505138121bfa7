"""Plain PyTorch attention (the CPU path of ``repro_torch.kernels.ops``)
against the JAX ops, both through the Pallas kernels in interpret mode and
through the jnp oracles. Inputs are made with numpy from a seed and handed
to both packages; only valid query rows are compared (a pad row's output
is unspecified: the Pallas kernel's block padding makes it differ from the
oracle's). float32, atol/rtol 1e-5: the same f32 math in another order."""
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
    assert TOPS.launch_counts() == {"flash_attention": 0,
                                    "decode_attention": 0}
