"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: on a host without a card every test skips (the
``cuda_device`` fixture decides at run time, never at import).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (f32 FMA in another order); bf16 2e-2 abs and
rel (the kernel rounds once at its output, the plain version after an f32
softmax and product: one bf16 ulp apart at most)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pos(B, S, gen, pad):
    ar = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    if pad:
        lens = torch.randint(1, S + 1, (B,), generator=gen)
        ar = torch.where(ar < lens[:, None], ar, torch.full_like(ar, -1))
    return ar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,S,hd,window,chunk,pad", [
    (1, 37, 64, None, None, True), (2, 150, 64, None, None, True),
    (4, 64, 128, None, None, False), (2, 96, 64, 24, None, True),
    (1, 80, 64, None, 32, False), (1, 200, 128, None, None, True),
    (2, 33, 32, None, None, True),
])
def test_flash_kernel_matches_plain(cuda_device, dtype, group, S, hd,
                                    window, chunk, pad):
    gen = torch.Generator().manual_seed(S + group)
    B, Hkv = 2, 2
    Hq = Hkv * group
    # (B, S, H, hd) projections, seen through (B, H, S, hd) views
    q = torch.randn(B, S, Hq, hd, generator=gen).to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=gen).to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=gen).to(dtype)
    pos = _pos(B, S, gen, pad)
    args = [t.to(cuda_device) for t in (q, k, v)]
    args = [t.transpose(1, 2) for t in args]
    p = pos.to(cuda_device)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(*args, p, p, window=window, chunk=chunk)
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention(*args, p, p, window=window, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    rows = (p >= 0)[:, None, :, None].expand_as(want)
    torch.testing.assert_close(got.float()[rows], want.float()[rows],
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,W,hd,window,chunk", [
    (1, 96, 64, None, None), (2, 300, 64, None, None),
    (4, 64, 128, None, None), (2, 96, 64, 20, None), (1, 64, 64, None, 16),
    (8, 2048, 64, None, None), (2, 200, 32, None, None),
])
def test_decode_kernel_matches_plain(cuda_device, dtype, group, W, hd,
                                     window, chunk):
    rng = np.random.default_rng(W + group)
    B, Hkv = 3, 2
    Hq = Hkv * group
    q = torch.from_numpy(rng.standard_normal((B, Hq, hd), np.float32))
    ck = torch.from_numpy(rng.standard_normal((B, W, Hkv, hd), np.float32))
    cv = torch.from_numpy(rng.standard_normal((B, W, Hkv, hd), np.float32))
    k_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    for b in range(B):
        n = int(rng.integers(1, 2 * W))      # some slots wrap the ring
        for t in range(max(0, n - W), n):
            k_pos[b, t % W] = t
        k_pos[b, rng.integers(0, W, 2)] = -1
        k_pos[b, (n - 1) % W] = n - 1
        q_pos[b] = n - 1
    dev = cuda_device
    q, ck, cv = (t.to(dtype).to(dev) for t in (q, ck, cv))
    qp, kp = torch.from_numpy(q_pos).to(dev), torch.from_numpy(k_pos).to(dev)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)   # views, no copy
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, kt, vt, qp, kp, window=window, chunk=chunk)
    assert ops.launch_counts()["decode_attention"] == before + 1
    want = ref.decode_attention(q, kt, vt, qp, kp, window=window, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q = torch.randn(1, 2, 4, 48, device=cuda_device)     # hd 48: no kernel
    pos = torch.arange(4, dtype=torch.int32, device=cuda_device)[None]
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q, pos, pos)
