"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: on a host without a card every test skips (the
``cuda_device`` fixture decides at run time, never at import).

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (f32 FMA in another order); bf16 2e-2 abs and
rel (the kernel rounds once at its output, the plain version after an f32
softmax and product: one bf16 ulp apart at most); the bf16 tensor-core
prefill kernels also against the plain version run in float32 on the
same bf16 inputs, atol 2e-3 and rtol 1e-2 (``chip_smoke.py``'s check:
the kernels accumulate in float32 and round once at the store). WKV6:
float32 1e-5, relative and absolute against the largest magnitude of the
output, in either input type (both versions compute in float32; under
the model's decay the state's terms reach ~100 while some outputs cancel
to ~0.1)."""
import functools
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm
from repro_torch.kernels import ssd
from repro_torch.kernels import wkv6

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TOL_WIDE = (2e-3, 1e-2)   # bf16 kernel vs the float32 plain version


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
    (2, 33, 32, None, None, True), (1, 77, 112, None, None, True),
    (2, 130, 112, 40, None, True), (1, 150, 100, None, None, True),
    (2, 150, 100, None, None, True), (3, 150, 100, None, None, True),
    (3, 150, 32, None, None, True), (3, 150, 64, None, None, True),
    (3, 150, 128, None, None, True), (2, 150, 160, None, None, True),
    (1, 77, 160, None, None, True), (4, 96, 160, 40, None, True),
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
    (1, 300, 112, None, None), (2, 96, 112, 20, None),
    (2, 300, 160, None, None), (1, 96, 160, None, None),
    (4, 200, 160, 20, None),
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


def _paged_case(rng, B, Hkv, ps, M, hd, S=None, shared=True):
    """A pool with mixed fills, pages from a shuffled permutation, an
    unmapped (-1) logical page inside one slot, and one physical page
    mapped by two slots. With ``S``: the last min(S, len) tokens of each
    slot are its chunk (q_pos, pads -1)."""
    P = B * M
    perm = rng.permutation(P)
    tbl = np.full((B, M), -1, np.int32)
    k_pos = np.full((B, M * ps), -1, np.int32)
    lens = rng.integers(1, M * ps + 1, B)
    lens[0] = M * ps
    pi = 0
    for b, L in enumerate(lens):
        npg = -(-int(L) // ps)
        tbl[b, :npg] = perm[pi:pi + npg]
        pi += npg
        k_pos[b, :L] = np.arange(L)
    if B > 1 and M > 2:
        tbl[0, 1] = -1                     # unmapped page inside slot 0
        k_pos[0, ps:2 * ps] = -1
        if shared and lens[1] > ps:
            tbl[1, 0] = tbl[0, 0]          # one page mapped by two slots
    if S is None:
        q_pos = (lens - 1).astype(np.int32)
    else:
        q_pos = np.full((B, S), -1, np.int32)
        for b, L in enumerate(lens):
            nv = min(S, int(L))
            q_pos[b, :nv] = np.arange(L - nv, L)
    kp = rng.standard_normal((Hkv, P + 1, ps, hd), dtype=np.float32)
    vp = rng.standard_normal((Hkv, P + 1, ps, hd), dtype=np.float32)
    return kp, vp, tbl, q_pos, k_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,ps,M,hd", [
    (1, 16, 8, 64), (2, 16, 16, 64), (4, 8, 12, 128), (8, 16, 4, 32),
    (2, 8, 130, 64), (1, 16, 12, 112), (2, 16, 20, 112),
    (2, 16, 20, 160), (1, 16, 12, 160), (4, 8, 12, 160),
])
def test_paged_decode_kernel_matches_plain(cuda_device, dtype, group, ps, M,
                                           hd):
    rng = np.random.default_rng(group * 100 + ps + M)
    B, Hkv = 3, 2
    kp, vp, tbl, q_pos, k_pos = _paged_case(rng, B, Hkv, ps, M, hd)
    q = rng.standard_normal((B, Hkv * group, hd), dtype=np.float32)
    dev = cuda_device
    q, kp, vp = (torch.from_numpy(x).to(dtype).to(dev) for x in (q, kp, vp))
    tbl, qp, kpos = (torch.from_numpy(x).to(dev)
                     for x in (tbl, q_pos, k_pos))
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(q, kp, vp, tbl, qp, kpos)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    want = ref.paged_decode_attention(q, kp, vp, tbl, qp, kpos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,ps,M,S,hd,window", [
    (1, 16, 8, 64, 64, None), (2, 16, 20, 100, 64, None),
    (4, 8, 12, 16, 128, None), (8, 16, 6, 33, 32, None),
    (2, 16, 10, 48, 64, 40), (1, 16, 12, 77, 100, None),
    (3, 16, 12, 77, 100, None), (3, 16, 12, 77, 16, None),
    (3, 16, 12, 77, 32, None), (3, 16, 12, 77, 64, None),
    (3, 16, 12, 77, 128, None), (2, 16, 12, 77, 160, None),
    (1, 16, 12, 77, 160, None), (4, 16, 12, 77, 160, 40),
])
def test_chunked_prefill_kernel_matches_plain(cuda_device, dtype, group, ps,
                                              M, S, hd, window):
    rng = np.random.default_rng(group * 100 + ps + M + S)
    B, Hkv = 3, 2
    kp, vp, tbl, q_pos, k_pos = _paged_case(rng, B, Hkv, ps, M, hd, S=S)
    # the model's layout: a (B, S, Hq, hd) projection seen as (B, Hq, S, hd)
    q = rng.standard_normal((B, S, Hkv * group, hd), dtype=np.float32)
    dev = cuda_device
    q, kp, vp = (torch.from_numpy(x).to(dtype).to(dev) for x in (q, kp, vp))
    q = q.transpose(1, 2)
    tbl, qp, kpos = (torch.from_numpy(x).to(dev)
                     for x in (tbl, q_pos, k_pos))
    before = ops.launch_counts()["chunked_prefill_attention"]
    got = ops.chunked_prefill_attention(q, kp, vp, tbl, qp, kpos,
                                        window=window)
    assert ops.launch_counts()["chunked_prefill_attention"] == before + 1
    want = ref.chunked_prefill_attention(q, kp, vp, tbl, qp, kpos,
                                         window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    rows = (qp >= 0)[:, None, :, None].expand_as(want)
    torch.testing.assert_close(got.float()[rows], want.float()[rows],
                               atol=TOL[dtype], rtol=TOL[dtype])
    pads = (qp < 0)[:, None, :, None].expand_as(got)
    assert (got.float()[pads] == 0).all()          # pad queries write 0


def _check_bf16(got, plain, args, rows):
    """A bf16 kernel's output on ``rows``: within TOL of ``plain`` on the
    same bf16 inputs and within TOL_WIDE of ``plain`` run in float32 on
    them."""
    assert torch.isfinite(got.float()).all()
    want = plain(*args)
    torch.testing.assert_close(got.float()[rows], want.float()[rows],
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    wide = plain(*[a.float() if a.is_floating_point() else a for a in args])
    torch.testing.assert_close(got.float()[rows], wide[rows],
                               atol=TOL_WIDE[0], rtol=TOL_WIDE[1])


@pytest.mark.parametrize("group,S,hd,window,chunk,layout,pads", [
    (2, 77, 64, None, None, "heads", "ragged"),     # S % 16, S % 64 != 0
    (2, 190, 112, 40, None, "heads", "ragged"),     # hd 112 with a window
    (8, 150, 64, None, None, "heads", "ragged"),    # GQA group 8
    (1, 200, 128, None, 48, "heads", "none"),       # chunked local attention
    (2, 100, 64, None, None, "heads", "slot"),      # one slot all pads
    (4, 129, 112, None, None, "fused", "ragged"),   # rows of a fused qkv
    (1, 33, 32, 8, None, "heads", "ragged"),
    (1, 150, 100, None, None, "offset", "ragged"),  # rows 8 bytes off 16
    (3, 150, 100, None, None, "offset", "ragged"),  # GQA group 3
    (3, 150, 64, None, None, "heads", "ragged"),
    (3, 150, 128, None, None, "heads", "ragged"),
    (2, 150, 160, None, None, "heads", "ragged"),  # StableLM-2's hd 160
    (2, 129, 160, None, None, "fused", "ragged"),
    (1, 200, 160, None, 48, "heads", "none"),
])
def test_flash_bf16_tensor_core_cases(cuda_device, group, S, hd, window,
                                      chunk, layout, pads):
    """The bf16 tensor-core flash kernel on the shapes that reach its
    edges: ragged q and key tiles, hd 112, group 8, window and chunk masks,
    pad rows (0 out, a whole slot of them too), q/k/v read as column
    blocks of one fused (B, S, (Hq + 2 Hkv) hd) projection (row stride
    (Hq + 2 Hkv) hd), and hd 100 heads cut from wider rows 4 elements in
    (each row 8 bytes past a 16-byte boundary)."""
    gen = torch.Generator().manual_seed(S * 10 + group)
    B, Hkv = 3, 2
    Hq = Hkv * group
    dev = cuda_device
    if layout == "fused":
        buf = torch.randn(B, S, (Hq + 2 * Hkv) * hd, generator=gen).to(
            torch.bfloat16).to(dev)
        q, k, v = (t.unflatten(-1, (-1, hd)) for t in
                   buf.split([Hq * hd, Hkv * hd, Hkv * hd], dim=-1))
        assert q.stride(1) == (Hq + 2 * Hkv) * hd
    elif layout == "offset":
        rng = np.random.default_rng(S * 10 + group)
        q, k, v = (_fused_heads(rng, B, S, H, hd, torch.bfloat16, dev, 4)
                   for H in (Hq, Hkv, Hkv))
    else:
        q, k, v = (torch.randn(B, S, H, hd, generator=gen).to(
            torch.bfloat16).to(dev) for H in (Hq, Hkv, Hkv))
    pos = _pos(B, S, gen, pads == "ragged")
    if pads == "slot":
        pos[1] = -1
    p = pos.to(dev)
    args = [q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), p, p]
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(*args, window=window, chunk=chunk)
    assert ops.launch_counts()["flash_attention"] == before + 1
    torch.cuda.synchronize()
    rows = (p >= 0)[:, None, :, None].expand_as(got)
    plain = functools.partial(ref.flash_attention, window=window, chunk=chunk)
    _check_bf16(got, plain, args, rows)
    assert (got.float()[~rows] == 0).all()         # pad queries write 0


@pytest.mark.parametrize("group,ps,M,S,hd,window,chunk,case", [
    (2, 16, 12, 48, 64, None, None, "hole"),    # 64 unmapped keys: a tile
    (8, 8, 20, 77, 64, None, None, "ragged"),   # group 8, S % 16 != 0
    (1, 16, 10, 100, 128, 50, None, "ragged"),
    (2, 16, 8, 64, 32, None, 24, "ragged"),     # chunked local attention
    (2, 12, 10, 50, 64, None, None, "ragged"),  # page size not a power of 2
    (2, 16, 10, 40, 64, None, None, "slot"),    # one slot all pads
    (4, 16, 8, 40, 64, None, None, "fused"),    # q rows of a fused qkv
    (1, 16, 12, 77, 100, None, None, "offset"),  # rows 8 bytes off 16
    (3, 16, 12, 77, 100, None, None, "offset"),  # GQA group 3
    (3, 16, 12, 77, 64, None, None, "ragged"),
    (3, 16, 12, 77, 128, None, None, "ragged"),
    (2, 16, 12, 77, 160, None, None, "ragged"),  # StableLM-2's hd 160
    (2, 16, 12, 48, 160, None, None, "hole"),
    (2, 16, 10, 40, 160, None, None, "fused"),
])
def test_chunked_prefill_bf16_tensor_core_cases(cuda_device, group, ps, M,
                                                S, hd, window, chunk, case):
    """The bf16 tensor-core chunked-prefill kernel on the edges of the
    paged path: a whole 64-key tile of unmapped pages inside a slot's
    table, ragged chunks, group 8, window and chunk masks, a page size that
    is not a power of two, a slot whose
    queries are all pads (0 out), q read as a column block of a fused
    (B, S, (Hq + 2 Hkv) hd) projection, and hd 100 q heads cut from wider
    rows 4 elements in (each row 8 bytes past a 16-byte boundary)."""
    rng = np.random.default_rng(group * 1000 + ps + M + S)
    B, Hkv = 3, 2
    Hq = Hkv * group
    kp, vp, tbl, q_pos, k_pos = _paged_case(rng, B, Hkv, ps, M, hd, S=S)
    if case == "hole":
        tbl[0, 4:8] = -1                       # keys 64..127 of slot 0
        k_pos[0, 4 * ps:8 * ps] = -1
    if case == "slot":
        q_pos[2] = -1
    dev = cuda_device
    width = {"fused": (Hq + 2 * Hkv) * hd,
             "offset": Hq * hd + 8}.get(case, Hq * hd)
    off = 4 if case == "offset" else 0
    buf = rng.standard_normal((B, S, width), dtype=np.float32)
    buf = torch.from_numpy(buf).to(torch.bfloat16).to(dev)
    q = buf[..., off:off + Hq * hd].unflatten(-1, (Hq, hd)).transpose(1, 2)
    kp, vp = (torch.from_numpy(x).to(torch.bfloat16).to(dev)
              for x in (kp, vp))
    tbl, qp, kpos = (torch.from_numpy(x).to(dev)
                     for x in (tbl, q_pos, k_pos))
    args = [q, kp, vp, tbl, qp, kpos]
    before = ops.launch_counts()["chunked_prefill_attention"]
    got = ops.chunked_prefill_attention(*args, window=window, chunk=chunk)
    assert ops.launch_counts()["chunked_prefill_attention"] == before + 1
    torch.cuda.synchronize()
    rows = (qp >= 0)[:, None, :, None].expand_as(got)
    plain = functools.partial(ref.chunked_prefill_attention, window=window,
                              chunk=chunk)
    _check_bf16(got, plain, args, rows)
    assert (got.float()[~rows] == 0).all()         # pad queries write 0


def test_bf16_prefill_kernels_refuse_misaligned_rows(cuda_device):
    """cp.async copies 16-byte pieces of rows: a bf16 view whose rows start
    off a 16-byte boundary, or whose row stride is not a multiple of 16
    bytes, is refused before any launch; float32 takes both."""
    dev = cuda_device
    pos = torch.arange(8, dtype=torch.int32, device=dev)[None]
    pages = torch.zeros(2, 3, 4, 64, dtype=torch.bfloat16, device=dev)
    tbl = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    k_pos = torch.arange(8, dtype=torch.int32, device=dev)[None]
    before = ops.launch_counts()
    for width, start in ((2 * 64 + 8, 1), (2 * 64 + 4, 0)):
        buf = torch.randn(1, 8, width, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = buf.to(dtype)[..., start:start + 128].unflatten(-1, (2, 64))
            q = x.transpose(1, 2)
            if dtype == torch.float32:
                out = ops.flash_attention(q, q, q, pos, pos)
                torch.testing.assert_close(
                    out, ref.flash_attention(q, q, q, pos, pos),
                    atol=TOL[dtype], rtol=TOL[dtype])
                continue
            with pytest.raises(ValueError, match="16-byte aligned rows"):
                ops.flash_attention(q, q, q, pos, pos)
            with pytest.raises(ValueError, match="16-byte aligned rows"):
                ops.chunked_prefill_attention(q, pages, pages, tbl, pos,
                                              k_pos)
    after = ops.launch_counts()
    assert after["chunked_prefill_attention"] == \
        before["chunked_prefill_attention"]
    assert after["flash_attention"] == before["flash_attention"] + 2


def _fleet_pool(rng, S, B, Hkv, ps, M, hd, dtype, dev, Sq=None):
    """S shards' pools of ``_paged_case`` side by side, as the fleet holds
    them: (Hkv, S*P + 1, ps, hd), shard s's P pages at [s*P, (s+1)*P) and
    one trash page last; each shard's table of its own page ids (-1
    entries included, and in the last shard a slot with nothing mapped
    past its first page) made pool page ids by ``paged.model_table`` and
    flattened to (S*B, M)."""
    from repro_torch.serving import paged
    cases = [_paged_case(rng, B, Hkv, ps, M, hd, S=Sq) for _ in range(S)]
    P = B * M
    tbl = np.stack([c[2] for c in cases])                 # (S, B, M)
    tbl[-1, -1, 1:] = -1
    kpos = np.stack([c[4] for c in cases])                # (S, B, M*ps)
    kpos[-1, -1, ps:] = -1
    qpos = np.stack([c[3] for c in cases])
    qpos[-1, -1] = np.minimum(qpos[-1, -1], ps - 1)
    if Sq is not None:
        qpos[-1, -1, 1:] = -1
    kp, vp = (np.concatenate([c[i][:, :P] for c in cases]
                             + [cases[-1][i][:, P:]], axis=1)
              for i in (0, 1))                      # (Hkv, S*P + 1, ..)
    to = functools.partial(torch.as_tensor, device=dev)
    alloc = {"tbl": to(tbl), "free": to(np.zeros((S, P), np.int32))}
    flat = paged.model_table(alloc)
    kp, vp = (to(x).to(dtype) for x in (kp, vp))
    return (kp, vp, tbl, flat, to(qpos.reshape((S * B,) + qpos.shape[2:])),
            to(kpos.reshape(S * B, -1)), P)


def _shard_pool(pool, s, P):
    """Shard s's own (Hkv, P+1, ps, hd) pool: its pages and the trash."""
    return torch.cat([pool[:, s * P:(s + 1) * P], pool[:, -1:]], dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,ps,M,hd", [(2, 16, 8, 64), (4, 8, 12, 128),
                                           (1, 16, 6, 64)])
def test_paged_decode_kernel_over_a_fleet_pool(cuda_device, dtype, group, ps,
                                               M, hd):
    """The fleet's decode: ONE launch over S*B rows of a 4-shard pool
    through the translated table equals four per-shard launches on each
    shard's own pool and table, and the plain version."""
    S, B, Hkv = 4, 3, 2
    rng = np.random.default_rng(group * 10 + ps + M)
    pool_k, pool_v, tbl, flat, qp, kpos, P = _fleet_pool(
        rng, S, B, Hkv, ps, M, hd, dtype, cuda_device)
    q = torch.from_numpy(rng.standard_normal(
        (S * B, Hkv * group, hd), dtype=np.float32)).to(dtype).to(cuda_device)
    before = ops.launch_counts()["paged_decode_attention"]
    got = ops.paged_decode_attention(q, pool_k, pool_v, flat, qp, kpos)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    want = ref.paged_decode_attention(q, pool_k, pool_v, flat, qp, kpos)
    for s in range(S):
        r = slice(s * B, (s + 1) * B)
        own = ops.paged_decode_attention(
            q[r], _shard_pool(pool_k, s, P), _shard_pool(pool_v, s, P),
            torch.as_tensor(tbl[s], device=cuda_device), qp[r], kpos[r])
        torch.testing.assert_close(got[r].float(), own.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,ps,M,Sq,hd", [(2, 16, 8, 48, 64),
                                              (4, 8, 12, 33, 128)])
def test_chunked_prefill_kernel_over_a_fleet_pool(cuda_device, dtype, group,
                                                  ps, M, Sq, hd):
    """The fleet's chunk launch: ONE launch over the rows of a 4-shard
    pool through the translated table equals per-shard launches and the
    plain version (pad queries write 0)."""
    S, B, Hkv = 4, 3, 2
    rng = np.random.default_rng(group * 10 + ps + M + Sq)
    pool_k, pool_v, tbl, flat, qp, kpos, P = _fleet_pool(
        rng, S, B, Hkv, ps, M, hd, dtype, cuda_device, Sq=Sq)
    q = torch.from_numpy(rng.standard_normal(
        (S * B, Sq, Hkv * group, hd), dtype=np.float32)).to(dtype).to(
            cuda_device).transpose(1, 2)
    before = ops.launch_counts()["chunked_prefill_attention"]
    got = ops.chunked_prefill_attention(q, pool_k, pool_v, flat, qp, kpos)
    assert ops.launch_counts()["chunked_prefill_attention"] == before + 1
    want = ref.chunked_prefill_attention(q, pool_k, pool_v, flat, qp, kpos)
    for s in range(S):
        r = slice(s * B, (s + 1) * B)
        own = ops.chunked_prefill_attention(
            q[r], _shard_pool(pool_k, s, P), _shard_pool(pool_v, s, P),
            torch.as_tensor(tbl[s], device=cuda_device), qp[r], kpos[r])
        valid = (qp[r] >= 0)[:, None, :, None].expand_as(own)
        torch.testing.assert_close(got[r].float()[valid],
                                   own.float()[valid], atol=TOL[dtype],
                                   rtol=TOL[dtype])
    torch.cuda.synchronize()
    rows = (qp >= 0)[:, None, :, None].expand_as(want)
    torch.testing.assert_close(got.float()[rows], want.float()[rows],
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert (got.float()[~rows] == 0).all()


def test_fleet_on_card_matches_cpu(cuda_device):
    """The smoke config's fleet (4 shards of 2 slots, sharing, carbon
    routing) on the card and on the CPU from the same weights: identical
    tokens and placements; each micro-step launched the paged-decode
    kernel once per layer for every shard."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import (EngineConfig, Request,
                                     ShardedServingEngine)
    cfg = get_config("llama3.2-1b", "smoke")
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(6)
    system = rng.integers(2, cfg.vocab, 32).tolist()
    prompts = [system + rng.integers(2, cfg.vocab, n).tolist()
               for n in (3, 20, 0, 9)]
    prompts += [rng.integers(2, cfg.vocab, n).tolist() for n in (40, 7, 12)]
    ecfg = EngineConfig(max_batch=2, max_len=128, paged=True, page_size=16,
                        prefill_chunk=16, prefill_pack=2, prefix_sharing=True,
                        shards=4, routing="carbon",
                        shard_regions=("QC", "CISO", "PACE", "CISO"))
    got = {}
    for dev in ("cpu", cuda_device):
        eng = ShardedServingEngine(Model(cfg, dev), _to(cpu_params, dev),
                                   ecfg, device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
        ops.reset_launches()
        got[str(dev)] = ({r.rid: r.tokens for r in eng.run()},
                         dict(eng._req_shard))
        counts = ops.launch_counts()
        steps = eng.stats()["steps"]
    assert got["cpu"] == got[str(cuda_device)]
    assert counts["paged_decode_attention"] == cfg.n_layers * steps > 0
    assert counts["chunked_prefill_attention"] > 0


# the fleet's pool at full width (llama-paper-1b's 32 kv heads of 64, bf16):
# 4 shards of 8 slots, 1,024 pages of 16 a shard, 128 pages a slot
ADMIN = dict(S=4, B=8, P=1024, M=128, ps=16, Hkv=32, hd=64)


def _admin_pool(dev, seed=0):
    """A 4-shard fleet cache tree at ``ADMIN``'s shapes on ``dev``, two
    layers of random bf16 pages, built by the allocator's own functions:
    every slot holds 200-1,900 tokens on pages from LIFO pops but shard 0
    slot 5, which adopts slot 3's first 8 pages (refcount 2), and shard 2
    slot 4, which is free; each slot's cursor rows are its positions."""
    from repro_torch.serving import paged
    a = ADMIN
    S, B, P, M, ps = a["S"], a["B"], a["P"], a["M"], a["ps"]
    g = torch.Generator(device="cpu").manual_seed(seed)
    slots = torch.arange(B, dtype=torch.int32).repeat(S, 1)
    slots[0, 5] = slots[2, 4] = B                  # sentinel lanes
    lens = torch.randint(200, 1901, (S, B), generator=g)
    lens[slots == B] = 0
    alloc = paged.init_allocator(B, M, P, dev, shards=S)
    alloc = paged.alloc_prefill_pages(
        alloc, slots.to(dev),
        ((lens + ps - 1) // ps).to(torch.int32).to(dev))
    share = torch.full((S, M), -1, dtype=torch.int32, device=dev)
    share[0, :8] = alloc["tbl"][0, 3, :8]
    alloc = paged.map_shared_pages(
        alloc, torch.tensor([5, B, B, B], dtype=torch.int32, device=dev),
        share)
    lens[0, 5] = 8 * ps
    pos = torch.full((S * B, M * ps), -1, dtype=torch.int32)
    for r, n in enumerate(lens.reshape(-1).tolist()):
        pos[r, :n] = torch.arange(n)
    layers = [{"k_pages": torch.randn(a["Hkv"], S * P + 1, ps, a["hd"],
                                      generator=g).to(torch.bfloat16),
               "v_pages": torch.randn(a["Hkv"], S * P + 1, ps, a["hd"],
                                      generator=g).to(torch.bfloat16),
               "pos_ids": pos.clone(),
               "length": lens.reshape(-1).to(torch.int32)}
              for _ in range(2)]
    return {"t": layers[0]["length"].clone().to(dev),
            "layers": _to(layers, dev), "paged": alloc}


def _admin_state(dev):
    from repro_torch.serving import sampling
    n = ADMIN["S"] * ADMIN["B"]
    cur = torch.arange(n, dtype=torch.int32, device=dev)[:, None] + 7
    state = sampling.init_slot_state(n, dev)
    state["active"].fill_(True)
    state["budget"].fill_(9)
    return cur, state


def _admin_q(dev):
    """One bf16 decode query a row of the fleet."""
    g = torch.Generator(device="cpu").manual_seed(11)
    return torch.randn(ADMIN["S"] * ADMIN["B"], ADMIN["Hkv"], ADMIN["hd"],
                       generator=g).to(torch.bfloat16).to(dev)


def _admin_decode(pool, q):
    """Paged decode of every row of the fleet through its translated
    table (one launch of layer 0's pool), each row's query at its last
    position."""
    from repro_torch.serving import paged
    lay = pool["layers"][0]
    return ops.paged_decode_attention(
        q, lay["k_pages"], lay["v_pages"], paged.model_table(pool["paged"]),
        (lay["length"] - 1).clamp(min=0), lay["pos_ids"])


def test_fleet_admin_migrate_slot_card_equals_cpu(cuda_device):
    """``paged.migrate_slot`` of shard 0 slot 3 (whose first 8 pages slot
    5 shares) to shard 2 slot 4 on the card equals the same program on the
    CPU bit for bit: every pool page, cursor row, allocator leaf, decode
    row and the returned table row."""
    from repro_torch.serving import paged
    out = {}
    for dev in ("cpu", cuda_device):
        pool = _admin_pool(dev)
        cur, state = _admin_state(dev)
        src = pool["paged"]["tbl"][0, 3]
        n = int((src >= 0).sum())
        row = paged.migrate_slot(pool, cur, state, (0, 3), (2, 4), src[:n])
        out[str(dev)] = _to({"pool": pool, "cur": cur, "state": state,
                             "row": row}, "cpu")

    def walk(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert torch.equal(a, b), path

    walk(out["cpu"], out[str(cuda_device)])
    assert out["cpu"]["row"][:n].ge(0).all()


def test_fleet_admin_quarantine_and_scrub_leave_other_shards(cuda_device):
    """On the card, ``quarantine_table`` of shard 1 then ``scrub_pool`` of
    shards 1 and 3 change only those shards' allocator rows and cursor
    rows; every page of every pool and every other shard's rows stay
    bit-identical."""
    from repro_torch.serving import paged
    a = ADMIN
    S, B, P = a["S"], a["B"], a["P"]
    pool = _admin_pool(cuda_device, seed=1)
    old = _to(pool, "cpu")
    pool["paged"] = paged.quarantine_table(
        pool["paged"], torch.tensor([False, True, False, False],
                                    device=cuda_device))
    q = _to(pool["paged"], "cpu")
    assert (q["tbl"][1] == -1).all()
    for s in (0, 2, 3):
        assert torch.equal(q["tbl"][s], old["paged"]["tbl"][s])
    for k in ("free", "top", "ref"):
        assert torch.equal(q[k], old["paged"][k])
    do = torch.tensor([False, True, False, True], device=cuda_device)
    paged.scrub_pool(pool, do)
    new = _to(pool, "cpu")
    for s in range(S):
        rows = slice(s * B, (s + 1) * B)
        if s in (1, 3):
            assert (new["paged"]["tbl"][s] == -1).all()
            assert new["paged"]["free"][s].tolist() == list(range(P))
            assert int(new["paged"]["top"][s]) == P
            assert (new["paged"]["ref"][s] == 0).all()
            assert (new["t"][rows] == 0).all()
        else:
            for k in ("tbl", "free", "top", "ref"):
                assert torch.equal(new["paged"][k][s], old["paged"][k][s])
            assert torch.equal(new["t"][rows], old["t"][rows])
        for lay, ol in zip(new["layers"], old["layers"]):
            if s in (1, 3):
                assert (lay["pos_ids"][rows] == -1).all()
                assert (lay["length"][rows] == 0).all()
            else:
                assert torch.equal(lay["pos_ids"][rows], ol["pos_ids"][rows])
                assert torch.equal(lay["length"][rows], ol["length"][rows])
    for lay, ol in zip(new["layers"], old["layers"]):
        assert torch.equal(lay["k_pages"], ol["k_pages"])
        assert torch.equal(lay["v_pages"], ol["v_pages"])


def test_fleet_admin_migrated_slot_decodes_bit_identically(cuda_device):
    """The paged-decode kernel's output for a slot is bit-identical before
    the move (shard 0 slot 3, over pages it shares with slot 5) and after
    it (shard 2 slot 4, over its private copies): the same rows in other
    pages of the pool; every row the move did not touch is unchanged."""
    from repro_torch.serving import paged
    pool = _admin_pool(cuda_device, seed=2)
    cur, state = _admin_state(cuda_device)
    B = ADMIN["B"]
    q = _admin_q(cuda_device)
    before = _admin_decode(pool, q)
    src = pool["paged"]["tbl"][0, 3]
    n = int((src >= 0).sum())
    paged.migrate_slot(pool, cur, state, (0, 3), (2, 4), src[:n])
    q[2 * B + 4] = q[3]
    after = _admin_decode(pool, q)
    torch.cuda.synchronize()
    assert torch.equal(after[2 * B + 4], before[3])
    keep = [r for r in range(after.shape[0]) if r not in (3, 2 * B + 4)]
    assert torch.equal(after[keep], before[keep])


def test_fleet_admin_paged_kernel_with_a_dead_shard(cuda_device):
    """A quarantined shard's 8 rows ride the fleet's launch with their
    tables all -1 (every key page the trash page): the kernel over the
    4-shard pool equals its plain version within TOL on every row that
    holds a key, and every other shard's rows equal the launch before the
    quarantine bit for bit."""
    from repro_torch.serving import paged
    pool = _admin_pool(cuda_device, seed=3)
    B = ADMIN["B"]
    q = _admin_q(cuda_device)
    live = _admin_decode(pool, q)
    pool["paged"] = paged.quarantine_table(
        pool["paged"], torch.tensor([False, False, True, False],
                                    device=cuda_device))
    lay = pool["layers"][0]
    tbl = paged.model_table(pool["paged"])
    assert (tbl[2 * B:3 * B] == -1).all()
    got = _admin_decode(pool, q)
    want = ref.paged_decode_attention(q, lay["k_pages"], lay["v_pages"], tbl,
                                      (lay["length"] - 1).clamp(min=0),
                                      lay["pos_ids"])
    torch.cuda.synchronize()
    held = (lay["pos_ids"] >= 0).any(1)            # rows with a key
    torch.testing.assert_close(got[held].float(), want[held].float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    rows = [r for r in range(tbl.shape[0]) if not 2 * B <= r < 3 * B]
    assert torch.equal(got[rows], live[rows])


def test_paged_kernels_refuse_what_they_do_not_take(cuda_device):
    q = torch.randn(1, 2, 48, device=cuda_device)         # hd 48: no kernel
    pages = torch.randn(2, 3, 4, 48, device=cuda_device)
    tbl = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    k_pos = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    q_pos = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        ops.paged_decode_attention(q, pages, pages, tbl, q_pos, k_pos)
    with pytest.raises(TypeError, match="int32"):
        ops.paged_decode_attention(q[..., :32], pages[..., :32],
                                   pages[..., :32], tbl.long(), q_pos, k_pos)


def _ssd_inputs(gen, B, T, H, P, N, dtype, dev):
    """x, dt = softplus(N(0,1) - 4), A in [-16, -1], B, C: the model's
    (B, T, H, *) layout on the card. dt is the size the model's dt_bias
    starts it at (about 0.01): with dt near 1, cum = cumsum(dt*A) reaches
    thousands in a 256-step chunk and its float32 rounding alone moves
    exp(cum[t]-cum[s]) by more than 1e-4 in either version."""
    x = torch.randn(B, T, H, P, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(B, T, H, generator=gen) - 4)
    A = -torch.linspace(1.0, 16.0, H)
    Bm = torch.randn(B, T, H, N, generator=gen)
    Cm = torch.randn(B, T, H, N, generator=gen)
    return ([t.to(dtype).to(dev) for t in (x, dt)], A.to(dev),
            [t.to(dtype).to(dev) for t in (Bm, Cm)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,P,N,chunk,broadcast", [
    (2, 64, 4, 64, 64, 256, False),     # one chunk of 64
    (1, 300, 3, 64, 64, 256, False),    # 256 + a padded chunk
    (2, 8, 4, 32, 16, 8, True),         # the smoke config's block
    (1, 100, 2, 16, 32, 32, True),      # ragged, four chunks
    (2, 512, 2, 64, 64, 256, True),     # the full config's chunk, twice
    (8, 128, 112, 64, 64, 128, True),   # zamba2's prefill: B8 T128 cl128
])
def test_ssd_kernel_matches_plain(cuda_device, dtype, B, T, H, P, N, chunk,
                                  broadcast):
    """``ops.ssd_scan`` on the card (the kernel for the within-chunk part)
    against the plain version on the same inputs, on the card; also the
    kernel's three outputs directly. ``broadcast``: one B/C group seen by
    every head through a stride-0 view, as the mamba2 block passes it.
    float32 outputs either way: atol and rtol 1e-4 (sums in another
    order)."""
    gen = torch.Generator().manual_seed(T + P + N)
    (x, dt), A, (Bm, Cm) = _ssd_inputs(gen, B, T, H, P, N, dtype,
                                       cuda_device)
    if broadcast:
        Bm = Bm[:, :, :1].expand(B, T, H, N)
        Cm = Cm[:, :, :1].expand(B, T, H, N)
    h0 = torch.randn(B, H, P, N, generator=gen).to(cuda_device) * 0.1
    before = ops.launch_counts()["ssd_chunk"]
    got_y, got_h = ops.ssd_scan(x, dt, A, Bm, Cm, h0, chunk=chunk)
    assert ops.launch_counts()["ssd_chunk"] == before + 1
    cl = min(chunk, T)
    pad = (-T) % cl
    xs, dts, Bs, Cs = (torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    nc = (T + pad) // cl
    k = [t.reshape(B, nc, cl, H, -1).permute(0, 3, 1, 2, 4)
         for t in (xs, Bs, Cs)]
    dtk = dts.reshape(B, nc, cl, H).permute(0, 3, 1, 2)
    got = ssd.ssd_chunk(k[0], dtk, A, k[1], k[2])
    want = ref.ssd_chunk(k[0], dtk, A, k[1], k[2])
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("y_intra", "h_chunk", "decay")):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, name=name: f"{name}: {m}")
    # the whole scan: the plain version on the same inputs, on the card
    plain = [t.cpu() for t in (x, dt, A, Bm, Cm, h0)]
    want_y, want_h = ops.ssd_scan(*plain[:5], plain[5], chunk=chunk)
    torch.testing.assert_close(got_y.cpu(), want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_h.cpu(), want_h, atol=1e-4, rtol=1e-4)


def test_ssd_kernel_refuses_what_it_does_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    (x, dt), A, (Bm, Cm) = _ssd_inputs(gen, 1, 8, 2, 48, 16, torch.float32,
                                       cuda_device)
    k = lambda t: t.reshape(1, 1, 8, 2, -1).permute(0, 3, 1, 2, 4)
    dtk = dt.reshape(1, 1, 8, 2).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="head dim"):
        ssd.ssd_chunk(k(x), dtk, A, k(Bm), k(Cm))
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_chunk(k(x[..., :32]), dtk, A.double(), k(Bm), k(Cm))
    with pytest.raises(TypeError, match="one dtype"):
        ssd.ssd_chunk(k(x[..., :32]), dtk.bfloat16(), A, k(Bm), k(Cm))


def test_paged_engine_on_card_matches_cpu(cuda_device):
    """The smoke config served on the paged + chunked + prefix-sharing rung
    on the card (kernels) and on the CPU (plain versions), from the same
    weights: identical tokens, and the new kernels really ran."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("llama3.2-1b", "smoke")
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(5)
    system = rng.integers(2, cfg.vocab, 32).tolist()
    prompts = [system + rng.integers(2, cfg.vocab, n).tolist()
               for n in (3, 20, 0, 9)]
    prompts += [rng.integers(2, cfg.vocab, n).tolist() for n in (40, 7)]
    ecfg = EngineConfig(max_batch=4, max_len=128, paged=True, page_size=16,
                        prefill_chunk=16, prefill_pack=2,
                        prefix_sharing=True)
    toks = {}
    for dev in ("cpu", cuda_device):
        params = _to(cpu_params, dev)
        eng = ServingEngine(Model(cfg, dev), params, ecfg, device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
        ops.reset_launches()
        toks[str(dev)] = {r.rid: r.tokens for r in eng.run()}
        counts = ops.launch_counts()
    assert toks["cpu"] == toks[str(cuda_device)]
    assert counts["paged_decode_attention"] > 0
    assert counts["chunked_prefill_attention"] > 0
    assert counts["decode_attention"] == counts["flash_attention"] == 0


@pytest.mark.parametrize("rung", ["contiguous", "paged"])
def test_zamba2_engine_on_card_matches_cpu(cuda_device, rung):
    """zamba2-7b smoke (float32) served on the card (SSD, flash and decode
    kernels) and on the CPU (plain versions), from the same weights:
    identical tokens on ragged prompts, every kernel of the path ran, and
    the paged run returns every page."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("zamba2-7b", "smoke")
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, cfg.vocab, n).tolist()
               for n in (5, 40, 17, 64, 3, 29)]
    ecfg = EngineConfig(max_batch=4, max_len=128, paged=rung == "paged")
    toks = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(Model(cfg, dev), _to(cpu_params, dev), ecfg,
                            device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
        ops.reset_launches()
        toks[str(dev)] = {r.rid: r.tokens for r in eng.run()}
        counts = ops.launch_counts()
    assert toks["cpu"] == toks[str(cuda_device)]
    assert counts["ssd_chunk"] == 2 * eng.prefill_batches
    assert counts["flash_attention"] == eng.prefill_batches
    decode = "paged_decode_attention" if ecfg.paged else "decode_attention"
    assert counts[decode] == eng.stats()["steps"]
    if ecfg.paged:
        assert eng.free_pages == eng.num_pages
        assert int(eng.caches["paged"]["top"]) == eng.num_pages


@pytest.mark.parametrize("rung", ["contiguous", "paged+chunk+sharing",
                                  "zamba2-paged"])
def test_engine_waits_for_the_card_only_at_host_syncs(cuda_device, rung):
    """Under CUDA's sync debug mode every point where the host waits for
    the stream warns: a served trace waits exactly ``host_syncs`` times
    (its token fetches), never for a host-to-device copy or a tensor
    index read on the host."""
    import traceback
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("zamba2-7b" if rung == "zamba2-paged"
                     else "llama3.2-1b", "smoke")
    model = Model(cfg, cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(1))
    rng = np.random.default_rng(5)
    system = rng.integers(2, cfg.vocab, 32).tolist()
    prompts = [system + rng.integers(2, cfg.vocab, n).tolist()
               for n in (3, 20, 0, 9)]
    prompts += [rng.integers(2, cfg.vocab, n).tolist() for n in (40, 7)]
    ecfg = {"contiguous": EngineConfig(max_batch=4, max_len=128),
            "paged+chunk+sharing": EngineConfig(
                max_batch=4, max_len=128, paged=True, page_size=16,
                prefill_chunk=16, prefill_pack=2, prefix_sharing=True),
            "zamba2-paged": EngineConfig(max_batch=4, max_len=128,
                                         paged=True)}[rung]
    eng = ServingEngine(model, params, ecfg, device=cuda_device)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
    waits = []

    def record(message, *_):
        if "called a synchronizing CUDA operation" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            waits.append("".join(traceback.format_list(stack[-4:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert eng.host_syncs > 0
    assert len(waits) == eng.host_syncs, "\n".join(waits)


def _wkv_inputs(gen, B, H, T, hd, dtype, dev):
    """r, k, v ~ N(0, 1) in ``dtype`` and the model's layout (B, T, H, hd)
    seen as (B, H, T, hd) views; w = exp(-exp(-6 + N(0, 0.1))) ~ 0.9975
    float32, as the model makes it; u ~ N(0, 0.5); s0 ~ N(0, 0.1)."""
    r, k, v = (torch.randn(B, T, H, hd, generator=gen).to(dtype).to(dev)
               .transpose(1, 2) for _ in range(3))
    w = torch.exp(-torch.exp(-6 + 0.1 * torch.randn(B, T, H, hd,
                                                    generator=gen)))
    u = 0.5 * torch.randn(H, hd, generator=gen)
    s0 = 0.1 * torch.randn(B, H, hd, hd, generator=gen)
    return r, k, v, w.to(dev).transpose(1, 2), u.to(dev), s0.to(dev)


def _close_to_max(got, want, rel=1e-5):
    torch.testing.assert_close(got, want, rtol=rel,
                               atol=rel * max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,hd", [
    (8, 32, 1, 64),       # a decode step of the full config
    (2, 3, 23, 32),       # ragged tile of the smoke config's head dim
    (1, 32, 1024, 64),    # a full-config prefill
    (2, 4, 1024, 32),
    (1, 32, 16, 64),      # the engine's prefills: one block a head
    (2, 32, 64, 64),      # four blocks a head
    (1, 32, 119, 64),     # eight blocks, a ragged last span
    (1, 32, 1500, 64),    # past eight spans of 128: two rounds
])
def test_wkv6_kernel_matches_plain(cuda_device, dtype, B, H, T, hd):
    """``ops.wkv6`` on the card against the plain version on the same
    inputs, on the card: the output, and the final state written in place
    over ``s0`` (as decode updates the cache)."""
    gen = torch.Generator().manual_seed(T + hd)
    r, k, v, w, u, s0 = _wkv_inputs(gen, B, H, T, hd, dtype, cuda_device)
    want_o, want_s = ref.wkv6(r, k, v, w, u, s0)
    state = s0.clone()
    before = ops.launch_counts()["wkv6"]
    got_o, got_s = ops.wkv6(r, k, v, w, u, state, state)
    assert ops.launch_counts()["wkv6"] == before + 1
    torch.cuda.synchronize()
    assert got_s is state and got_o.shape == (B, H, T, hd)
    assert got_o.dtype == torch.float32 and torch.isfinite(got_o).all()
    _close_to_max(got_o, want_o)
    _close_to_max(state, want_s)
    # a fresh state buffer gives the same result
    got_o2, got_s2 = wkv6.wkv6(r, k, v, w, u, s0)
    torch.testing.assert_close(got_o2, got_o, rtol=0, atol=0)
    torch.testing.assert_close(got_s2, state, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d,strided", [
    (37, 64, False), (37, 2048, False), (8, 3584, False), (37, 7168, False),
    (1030, 2048, False),   # a 1024-token prefill's rows, and some
    (19, 100, False),      # d not a multiple of the 16-byte vector
    (1230, 160, False),    # qk-norm: (B S H, head dim 160) rows
    (21, 2048, True),      # rows of a wider tensor (row stride != d)
])
def test_rmsnorm_kernel_matches_plain(cuda_device, dtype, R, d, strided):
    gen = torch.Generator().manual_seed(R + d)
    base = torch.randn(R, d + (8 if strided else 0), generator=gen)
    x = base.to(dtype).to(cuda_device)[:, :d]
    scale = (torch.randn(d, generator=gen) * 0.1 + 1).to(dtype).to(
        cuda_device)
    before = ops.launch_counts()["rmsnorm"]
    got = ops.rmsnorm(x, scale, 1e-5)
    assert ops.launch_counts()["rmsnorm"] == before + 1
    want = ref.rmsnorm(x, scale, 1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (R, d)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # leading dims flatten into rows, as the model passes (B, T, d)
    x3 = x.reshape(1, R, d) if not strided else x[None]
    torch.testing.assert_close(ops.rmsnorm(x3, scale, 1e-5)[0].float(),
                               got.float(), rtol=0, atol=0)


def _fused_case(variant, R, d, dtype, dev, gen, extra=8):
    """Inputs of one fused RMSNorm variant in the model's layouts: x rows of
    a wider tensor (row stride d + extra), delta and the second segment e
    contiguous, Mamba2's y contiguous float32 and z float32 rows of its
    wider projection; scale ~ 1 + N(0, 0.1). Returns (kernel call, plain
    call, the row the kernel forms, as PyTorch forms it in memory,
    scale)."""
    def rows(width, stride, dt):
        base = torch.randn(R, stride, generator=gen).to(dt).to(dev)
        return base[:, :width]
    x = rows(d, d + extra, dtype)
    delta, e = rows(d, d, dtype), rows(d, d, dtype)
    width = 2 * d if "cat" in variant else d
    scale = (torch.randn(width, generator=gen) * 0.1 + 1).to(dtype).to(dev)
    if variant == "add":
        return (lambda: rmsnorm.add_rmsnorm(x, delta, scale),
                lambda: ref.add_rmsnorm(x, delta, scale, 1e-5), x + delta,
                scale)
    if variant == "cat":
        return (lambda: rmsnorm.cat_rmsnorm(x, e, scale),
                lambda: ref.cat_rmsnorm(x, e, scale, 1e-5),
                torch.cat([x, e], dim=-1), scale)
    if variant == "add+cat":
        return (lambda: rmsnorm.cat_rmsnorm(x, e, scale, delta=delta),
                lambda: ref.cat_rmsnorm(x, e, scale, 1e-5, delta),
                torch.cat([x + delta, e], dim=-1), scale)
    y = rows(d, d, torch.float32)
    z = rows(d, 2 * d + extra, torch.float32)
    return (lambda: rmsnorm.gated_rmsnorm(y, z, scale, 1e-5, dtype),
            lambda: ref.gated_rmsnorm(y, z, scale, 1e-5, dtype),
            (y * torch.nn.functional.silu(z)).to(dtype), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 8, 1024])
@pytest.mark.parametrize("d", [64, 100, 160, 2048, 3584, 7168])
@pytest.mark.parametrize("variant", ["add", "cat", "add+cat", "gate"])
def test_fused_rmsnorm_kernel_matches_plain(cuda_device, variant, d, R,
                                            dtype):
    """Each prologue of ``csrc/rmsnorm.cu`` against its plain (unfused)
    version on the same inputs, at the tolerance of the plain RMSNorm
    case; x + delta bit-identical to PyTorch's; one launch a call. Where
    the rows are 16-byte aligned (d % 8 == 0), the norm of the formed row
    is also bit-identical to the plain kernel's on the row PyTorch forms
    in memory: the same vectors in the same threads, summed in the same
    order, and (gate) silu, product and cast in PyTorch's order."""
    gen = torch.Generator().manual_seed(R * d + len(variant))
    call, plain, formed, scale = _fused_case(variant, R, d, dtype,
                                             cuda_device, gen)
    before = ops.launch_counts()["rmsnorm"]
    got = call()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    want = plain()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        assert got[0].dtype == dtype and got[0].shape == (R, d)
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    assert got.dtype == dtype and got.shape == formed.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if d % 8 == 0:
        assert torch.equal(got, rmsnorm.rmsnorm(formed, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["add", "cat", "add+cat", "gate"])
@pytest.mark.parametrize("R,d,extra", [
    (3, 40000, 8),     # wider than the register path: the two-pass loop
    (5, 2048, 1),      # rows not 16-byte aligned: one element at a time
])
def test_fused_rmsnorm_kernel_wide_and_unaligned_rows(cuda_device, variant,
                                                      R, d, extra, dtype):
    """The two-pass loop of each prologue against its plain version: a row
    of more vectors than the register path holds, and rows whose stride
    is not a multiple of 16 bytes; x + delta bit-identical."""
    gen = torch.Generator().manual_seed(d + extra)
    call, plain, formed, _ = _fused_case(variant, R, d, dtype, cuda_device,
                                         gen, extra)
    got, want = call(), plain()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_fused_rmsnorm_refuses_what_it_does_not_take(cuda_device):
    dev = cuda_device
    x = torch.randn(4, 64, device=dev)
    one = torch.ones(64, device=dev)
    with pytest.raises(TypeError, match="delta in torch.float32"):
        rmsnorm.add_rmsnorm(x, x.bfloat16(), one)
    with pytest.raises(TypeError, match="rmsnorm takes"):
        rmsnorm.add_rmsnorm(x.half(), x.half(), one)
    with pytest.raises(ValueError, match="must be"):
        rmsnorm.add_rmsnorm(x, x[:3], one)
    with pytest.raises(ValueError, match="must be"):
        rmsnorm.add_rmsnorm(x, x[:, :32], one)
    with pytest.raises(ValueError, match="unit stride"):
        rmsnorm.add_rmsnorm(x, torch.randn(64, 4, device=dev).t(), one)
    with pytest.raises(ValueError, match="scale"):
        rmsnorm.cat_rmsnorm(x, x, one)                  # scale of d1 only
    with pytest.raises(TypeError, match="e in torch.float32"):
        rmsnorm.cat_rmsnorm(x, x.bfloat16(), torch.ones(128, device=dev))
    with pytest.raises(ValueError, match="must be"):
        rmsnorm.cat_rmsnorm(x, x[:2], torch.ones(128, device=dev))
    with pytest.raises(TypeError, match="y in torch.float32"):
        rmsnorm.gated_rmsnorm(x.bfloat16(), x, one, 1e-5, torch.bfloat16)
    with pytest.raises(TypeError, match="rmsnorm takes"):
        rmsnorm.gated_rmsnorm(x, x, one, 1e-5, torch.float16)
    with pytest.raises(ValueError, match="must be"):
        rmsnorm.gated_rmsnorm(x, x[:, :63], one, 1e-5, torch.float32)
    with pytest.raises(ValueError, match="is on"):
        rmsnorm.add_rmsnorm(x, x.cpu(), one)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-7b"])
def test_smoke_forward_on_card_matches_cpu(cuda_device, arch):
    """The smoke config (float32) forward on the card (every norm one
    kernel launch with its residual add, concat or gate) and on the CPU
    (the unfused plain sequences), from the same weights: a ragged prefill
    and two decode steps, logits within 1e-3 (the float32 kernels sum in
    another order than the plain versions; the norms' rows agree to ~1e-6
    and the attention kernels to 1e-4), the same greedy tokens, and
    RMSNorm launched once per norm of the forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch, "smoke")
    kinds = cfg.block_pattern
    norms = 2 * len(kinds) + 1       # two per dense, mamba2, shared block
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (3, 24)))
    mask = torch.ones(3, 24, dtype=torch.int32)
    mask[1, 15:] = 0
    mask[2, 6:] = 0
    out = {}
    for dev in ("cpu", cuda_device):
        model = Model(cfg, dev)
        params = _to(cpu_params, dev)
        ops.reset_launches()
        logits, caches = model.prefill(params, toks.to(dev), mask.to(dev),
                                       max_len=48)
        steps = [logits]
        for _ in range(2):
            cur = steps[-1].argmax(-1)[:, None]
            logits, caches = model.decode_step(params, caches, cur)
            steps.append(logits)
        out[str(dev)] = [t.cpu() for t in steps]
        counts = ops.launch_counts()
    assert counts["rmsnorm"] == 3 * norms
    for i, (got, want) in enumerate(zip(out[str(cuda_device)], out["cpu"])):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3,
                                   msg=f"forward {i}")
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_wkv6_and_rmsnorm_refuse_what_they_do_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    r, k, v, w, u, s0 = _wkv_inputs(gen, 1, 2, 8, 64, torch.bfloat16,
                                    cuda_device)
    # w and u in the type of r/k/v are taken (widened to float32 on load)
    # and match the plain version on the same inputs; float16 is not
    for wt, ut in ((w.bfloat16(), u), (w, u.bfloat16()),
                   (w.bfloat16(), u.bfloat16())):
        got_o, got_s = wkv6.wkv6(r, k, v, wt, ut, s0)
        want_o, want_s = ref.wkv6(r, k, v, wt, ut, s0)
        torch.cuda.synchronize()
        _close_to_max(got_o, want_o)
        _close_to_max(got_s, want_s)
    with pytest.raises(TypeError, match="w must be float32 or"):
        wkv6.wkv6(r, k, v, w.half(), u, s0)
    with pytest.raises(TypeError, match="u must be float32 or"):
        wkv6.wkv6(r, k, v, w, u.half(), s0)
    r48, k48, v48, w48, u48, s48 = _wkv_inputs(gen, 1, 2, 8, 48,
                                               torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        wkv6.wkv6(r48, k48, v48, w48, u48, s48)
    spaced = torch.zeros(1, 2, 8, 128, dtype=r.dtype,
                         device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        wkv6.wkv6(spaced, k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6.wkv6(r, k, v, w, u, s0.transpose(2, 3))
    x = torch.randn(4, 64, device=cuda_device)
    with pytest.raises(ValueError, match="unit stride"):
        rmsnorm.rmsnorm(x.t(), torch.ones(4, device=cuda_device))
    with pytest.raises(TypeError, match="rmsnorm takes"):
        rmsnorm.rmsnorm(x.half(), torch.ones(64, device=cuda_device))


def test_rwkv6_engine_on_card_matches_cpu(cuda_device):
    """rwkv6-1.6b smoke (float32) on the contiguous engine, on the card
    (wkv6 and rmsnorm kernels) and on the CPU (plain versions), from the
    same weights: identical tokens on ragged prompts (two of one length
    share a prefill group), wkv6 launched in both layers of every prefill
    launch and micro-step, rmsnorm once per forward, and no attention
    kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("rwkv6-1.6b", "smoke")
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab, n).tolist()
               for n in (5, 40, 17, 40, 3, 64)]
    ecfg = EngineConfig(max_batch=4, max_len=128)
    toks = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(Model(cfg, dev), _to(cpu_params, dev), ecfg,
                            device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
        ops.reset_launches()
        toks[str(dev)] = {r.rid: r.tokens for r in eng.run()}
        counts = ops.launch_counts()
    assert toks["cpu"] == toks[str(cuda_device)]
    forwards = eng.prefill_batches + eng.stats()["steps"]
    assert counts["wkv6"] == cfg.n_layers * forwards
    assert counts["rmsnorm"] == forwards
    assert sum(counts[k] for k in ("flash_attention", "decode_attention",
                                   "paged_decode_attention",
                                   "chunked_prefill_attention",
                                   "ssd_chunk")) == 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# --------------------------------------------------------------------------
# the reference's own kernel sweeps: tests/test_kernels.py,
# tests/test_paged_kernel.py and tests/test_chunked_prefill_kernel.py, their
# parameter lists verbatim (bq/bk/bt: the Pallas block sizes, unused here)
# at their tolerances, each CUDA kernel against its plain version on the
# same inputs; inputs from numpy
# --------------------------------------------------------------------------

SWEEP_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}     # attention
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}      # SSD and WKV6


def _normal(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        dtype).to(dev)


def _launched(name, call):
    before = ops.launch_counts()[name]
    out = call()
    assert ops.launch_counts()[name] == before + 1
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,hd,bq,bk", [
    (1, 2, 2, 16, 16, 8, 16, 16),      # MHA, exact blocks
    (2, 4, 2, 37, 37, 16, 16, 16),     # GQA 2x, ragged blocks
    (1, 8, 2, 33, 65, 32, 8, 32),      # GQA 4x, Sq != Sk
    (2, 4, 1, 7, 130, 64, 4, 64),      # MQA, tiny q block
])
@pytest.mark.parametrize("window,chunk", [(None, None), (8, None), (None, 8)])
def test_flash_kernel_reference_sweep(cuda_device, dtype, B, Hq, Hkv, Sq, Sk,
                                      hd, bq, bk, window, chunk):
    """``tests/test_kernels.py::test_flash_attention_sweep``'s shapes: hd 8
    (bf16: the tensor-core core with rows zero-filled to 16), 16, 32, 64."""
    rng = np.random.default_rng(Sq + Sk + hd)
    dev = cuda_device
    q = _normal(rng, (B, Hq, Sq, hd), dtype, dev)
    k = _normal(rng, (B, Hkv, Sk, hd), dtype, dev)
    v = _normal(rng, (B, Hkv, Sk, hd), dtype, dev)
    qpos = torch.arange(Sk - Sq, Sk, dtype=torch.int32,
                        device=dev)[None].repeat(B, 1)
    kpos = torch.arange(Sk, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, qpos, kpos, window, chunk))
    want = ref.flash_attention(q, k, v, qpos, kpos, window, chunk)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=SWEEP_TOL[dtype], rtol=SWEEP_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,W,hd,bk", [
    (1, 2, 2, 16, 8, 8),
    (2, 4, 2, 29, 16, 8),
    (1, 8, 1, 130, 64, 64),
])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("fill", [0.6, 1.0])
def test_decode_kernel_reference_sweep(cuda_device, dtype, B, Hq, Hkv, W, hd,
                                       bk, window, fill):
    """``tests/test_kernels.py::test_decode_attention_sweep``'s shapes."""
    rng = np.random.default_rng(W * hd)
    dev = cuda_device
    q = _normal(rng, (B, Hq, hd), dtype, dev)
    k = _normal(rng, (B, Hkv, W, hd), dtype, dev)
    v = _normal(rng, (B, Hkv, W, hd), dtype, dev)
    n_valid = max(1, int(W * fill))
    kp = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    kpos = torch.from_numpy(np.where(kp < n_valid, kp, -1).astype(
        np.int32)).to(dev)
    qpos = torch.full((B,), n_valid - 1, dtype=torch.int32, device=dev)
    got = _launched("decode_attention", lambda: ops.decode_attention(
        q, k, v, qpos, kpos, window))
    want = ref.decode_attention(q, k, v, qpos, kpos, window)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=SWEEP_TOL[dtype], rtol=SWEEP_TOL[dtype])


def _reference_pool(rng, B, Hkv, hd, ps, num_pages, lens, M, S=None):
    """The reference sweeps' pool (``make_pool`` / ``make_case``): pages
    from a permutation of ``num_pages``, slot b holding lens[b] tokens;
    with ``S`` the last min(S, len) tokens are its chunk (pads -1)."""
    kp = rng.normal(size=(Hkv, num_pages + 1, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(Hkv, num_pages + 1, ps, hd)).astype(np.float32)
    perm = rng.permutation(num_pages)
    tbl = np.full((B, M), -1, np.int32)
    kpos = np.full((B, M * ps), -1, np.int32)
    qpos = np.full((B, S or 1), -1, np.int32)
    pi = 0
    for b, L in enumerate(lens):
        npg = -(-L // ps)
        tbl[b, :npg] = perm[pi:pi + npg]
        pi += npg
        kpos[b, :L] = np.arange(L)
        nv = min(S or 1, L)
        qpos[b, :nv] = np.arange(L - nv, L)
    if S is None:
        qpos = qpos[:, 0]
    return kp, vp, tbl, qpos, kpos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("page_size", [8, 16])
def test_paged_decode_kernel_reference_sweep(cuda_device, dtype, group,
                                             page_size):
    """``tests/test_paged_kernel.py::test_paged_kernel_matches_ref``: hd
    16, a partial page, an exact fill and a tiny slot, pages shared tighter
    than B x M (float32 there; bf16 beside it)."""
    B, Hkv, hd, M = 3, 2, 16, 4
    Hq = group * Hkv
    num_pages = B * M - 2
    lens = [13, 3 * page_size, 5]
    rng = np.random.default_rng(group * 17 + page_size)
    kp, vp, tbl, qpos, kpos = _reference_pool(rng, B, Hkv, hd, page_size,
                                              num_pages, lens, M)
    q = rng.normal(size=(B, Hq, hd)).astype(np.float32)
    dev = cuda_device
    q, kp, vp = (torch.from_numpy(x).to(dtype).to(dev) for x in (q, kp, vp))
    tbl, qpos, kpos = (torch.from_numpy(x).to(dev) for x in (tbl, qpos, kpos))
    got = _launched("paged_decode_attention", lambda: ops.paged_decode_attention(
        q, kp, vp, tbl, qpos, kpos))
    want = ref.paged_decode_attention(q, kp, vp, tbl, qpos, kpos)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=SWEEP_TOL[dtype], rtol=SWEEP_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("chunk_len", [4, 8, 16])
def test_chunked_prefill_kernel_reference_sweep(cuda_device, dtype, group,
                                                page_size, chunk_len):
    """``tests/test_chunked_prefill_kernel.py``'s sweep at hd 16: history
    and a partial chunk, a chunk that is the whole short prompt, a chunk
    across a page boundary; valid query rows compared, pads write 0
    (float32 there; bf16 beside it)."""
    B, Hkv, hd, M = 3, 2, 16, 4
    Hq = group * Hkv
    num_pages = B * M - 2
    lens = [2 * page_size + 5, 3, min(chunk_len + page_size - 1,
                                      M * page_size)]
    rng = np.random.default_rng(group * 31 + page_size * 7 + chunk_len)
    kp, vp, tbl, qpos, kpos = _reference_pool(rng, B, Hkv, hd, page_size,
                                              num_pages, lens, M, chunk_len)
    q = rng.normal(size=(B, Hq, chunk_len, hd)).astype(np.float32)
    dev = cuda_device
    q, kp, vp = (torch.from_numpy(x).to(dtype).to(dev) for x in (q, kp, vp))
    tbl, qpos, kpos = (torch.from_numpy(x).to(dev) for x in (tbl, qpos, kpos))
    got = _launched("chunked_prefill_attention",
                    lambda: ops.chunked_prefill_attention(q, kp, vp, tbl,
                                                          qpos, kpos))
    want = ref.chunked_prefill_attention(q, kp, vp, tbl, qpos, kpos)
    rows = (qpos >= 0)[:, None, :, None].expand_as(want)
    torch.testing.assert_close(got.float()[rows], want.float()[rows],
                               atol=SWEEP_TOL[dtype], rtol=SWEEP_TOL[dtype])
    assert (got.float()[~rows] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,hd,bt", [
    (1, 2, 8, 8, 8),
    (2, 3, 23, 16, 8),     # ragged time blocks
    (1, 4, 64, 32, 16),
])
def test_wkv6_kernel_reference_sweep(cuda_device, dtype, B, H, T, hd, bt):
    """``tests/test_kernels.py::test_wkv6_sweep``: hd 8 and 16 (a block is
    part of one warp), w = sigmoid(N(0, 1)) and u in the dtype of r/k/v."""
    rng = np.random.default_rng(T * hd)
    dev = cuda_device
    r, k, v = (_normal(rng, (B, H, T, hd), dtype, dev) for _ in range(3))
    w = torch.sigmoid(_normal(rng, (B, H, T, hd), torch.float32, dev)).to(
        dtype)
    u = (_normal(rng, (H, hd), torch.float32, dev) * 0.5).to(dtype)
    s0 = _normal(rng, (B, H, hd, hd), torch.float32, dev) * 0.1
    got_o, got_s = _launched("wkv6", lambda: ops.wkv6(r, k, v, w, u, s0))
    want_o, want_s = ref.wkv6(r, k, v, w, u, s0)
    t = SCAN_TOL[dtype]
    torch.testing.assert_close(got_o, want_o, atol=t, rtol=t)
    torch.testing.assert_close(got_s, want_s, atol=t, rtol=t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,P,N,cl", [
    (1, 2, 16, 8, 4, 8),
    (2, 3, 21, 8, 4, 8),    # ragged chunks
    (1, 2, 64, 16, 16, 16),
])
def test_ssd_kernel_reference_sweep(cuda_device, dtype, B, H, T, P, N, cl):
    """``tests/test_kernels.py::test_ssd_sweep``: P 8 and N 4 leave column
    lanes of the kernel idle; the whole scan on the card against the plain
    version on the same inputs."""
    rng = np.random.default_rng(T * P + N)
    dev = cuda_device
    x = _normal(rng, (B, T, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(
        _normal(rng, (B, T, H), torch.float32, dev)).to(dtype)
    A = -torch.exp(_normal(rng, (H,), torch.float32, dev) * 0.5)
    Bm = _normal(rng, (B, T, H, N), dtype, dev)
    Cm = _normal(rng, (B, T, H, N), dtype, dev)
    h0 = _normal(rng, (B, H, P, N), torch.float32, dev) * 0.1
    got_y, got_h = _launched("ssd_chunk", lambda: ops.ssd_scan(
        x, dt, A, Bm, Cm, h0, chunk=cl))
    plain = [t.cpu() for t in (x, dt, A, Bm, Cm, h0)]
    want_y, want_h = ops.ssd_scan(*plain, chunk=cl)
    t = SCAN_TOL[dtype]
    torch.testing.assert_close(got_y.cpu(), want_y, atol=t, rtol=t)
    torch.testing.assert_close(got_h.cpu(), want_h, atol=t, rtol=t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 100, 112, 160])
@pytest.mark.parametrize("case", ["last_span", "one_span", "wrapped",
                                  "shared_page", "no_valid_key"])
def test_decode_kernels_split_cases(cuda_device, dtype, hd, case):
    """The split across a cluster of blocks on its edges, W 4,096 (a cluster
    of eight blocks): one valid key, in the last span only; every span but
    one empty;
    a wrapped ring (positions unsorted); a page mapped by two slots that
    holds rows valid for one and -1 for the other; a slot with no valid key
    (writes 0, finite: the documented difference from the oracle). Both
    decode kernels, GQA group 2; rows with a valid key against the plain
    version at the sweep tolerances."""
    rng = np.random.default_rng(hd + len(case))
    B, Hkv, G, W, ps = 3, 2, 2, 4096, 16
    M = W // ps
    dev = cuda_device
    k_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros(B, np.int32)
    for b in range(B):
        if case == "last_span":
            k_pos[b, W - 1 - 3 * b] = 9
            q_pos[b] = 9 + b
        elif case == "one_span":
            k_pos[b, 1900:2100] = np.arange(200)
            q_pos[b] = 150 + b
        elif case == "wrapped":
            n = W + 300 + 517 * b
            t = np.arange(n - W, n)
            k_pos[b, t % W] = t
            q_pos[b] = n - 1
        elif case == "shared_page":
            k_pos[b, :1000 + 7 * b] = np.arange(1000 + 7 * b)
            q_pos[b] = 999 + 7 * b
        else:
            k_pos[b, :300] = np.arange(300)
            q_pos[b] = [299, -1, 299][b]       # slot 1: no valid key
            if b == 2:
                k_pos[b] = -1                  # slot 2: an empty cache
    if case == "shared_page":
        k_pos[1, 8:16] = -1                    # half of slot 0's page 0
    q = _normal(rng, (B, Hkv * G, hd), dtype, dev)
    valid = [bool(((k_pos[b] >= 0) & (k_pos[b] <= q_pos[b])).any())
             for b in range(B)]
    qp, kp = (torch.from_numpy(x).to(dev) for x in (q_pos, k_pos))
    # contiguous: the (B, W, Hkv, hd) ring seen as (B, Hkv, W, hd)
    ck = _normal(rng, (B, W, Hkv, hd), dtype, dev).transpose(1, 2)
    cv = _normal(rng, (B, W, Hkv, hd), dtype, dev).transpose(1, 2)
    # paged: slot b's logical page lp at physical page b * M + lp, except
    # that slot 1 maps slot 0's page 0 (shared_page)
    tbl = np.arange(B * M, dtype=np.int32).reshape(B, M)
    if case == "shared_page":
        tbl[1, 0] = tbl[0, 0]
    tbl = torch.from_numpy(tbl).to(dev)
    pk = _normal(rng, (Hkv, B * M + 1, ps, hd), dtype, dev)
    pv = _normal(rng, (Hkv, B * M + 1, ps, hd), dtype, dev)
    runs = [("decode_attention",
             lambda: ops.decode_attention(q, ck, cv, qp, kp),
             lambda: ref.decode_attention(q, ck, cv, qp, kp)),
            ("paged_decode_attention",
             lambda: ops.paged_decode_attention(q, pk, pv, tbl, qp, kp),
             lambda: ref.paged_decode_attention(q, pk, pv, tbl, qp, kp))]
    for name, kernel, plain in runs:
        got = _launched(name, kernel)
        want = plain()
        assert torch.isfinite(got.float()).all(), name
        for b in range(B):
            if valid[b]:
                torch.testing.assert_close(
                    got[b].float(), want[b].float(), atol=SWEEP_TOL[dtype],
                    rtol=SWEEP_TOL[dtype], msg=lambda m, n=name: f"{n}: {m}")
            else:
                assert (got[b] == 0).all(), name
    assert valid == ([True, False, False] if case == "no_valid_key"
                     else [True] * B)


# ---------------------------------------------------------------------------
# head dim 100 (LLaMA-3B), GQA group 3 (InternLM2-20B) and head dim 160
# (StableLM-2-12B): every new instance
# ---------------------------------------------------------------------------
# decode cores: hd 100 and hd 160 (StableLM-2-12B) at every group, groups 3
# and 5 (Llama-4 Maverick) at every other head dim
NEW_DECODE = ([(hd, g) for hd in (100, 160) for g in (1, 2, 3, 4, 5, 8)]
              + [(hd, g) for hd in (8, 16, 32, 64, 112, 128) for g in (3, 5)])


def _fused_heads(rng, B, S, H, hd, dtype, dev, offset):
    """(B, S, H, hd) heads cut from a wider (B, S, H hd + 8) row starting
    ``offset`` (<= 8) elements in: with bf16 hd 100 and offset 4 every
    head's row starts on an 8-byte, not a 16-byte, boundary."""
    buf = _normal(rng, (B, S, H * hd + 8), dtype, dev)
    return buf[..., offset:offset + H * hd].unflatten(-1, (H, hd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,group", NEW_DECODE)
def test_decode_new_instances_match_plain(cuda_device, dtype, hd, group):
    """A ring of 1,100 rows (a cluster of three blocks) seen through
    (B, Hkv, W, hd) views of a cache whose rows start 8 bytes past a
    16-byte boundary at bf16 hd 100; ragged fills, one slot wrapped, pad
    rows -1. bf16 also against the plain version in float32."""
    rng = np.random.default_rng(hd * 10 + group)
    B, Hkv, W = 3, 2, 1100
    dev = cuda_device
    q = _normal(rng, (B, Hkv * group, hd), dtype, dev)
    off = 4 if hd == 100 else 0
    ck = _fused_heads(rng, B, W, Hkv, hd, dtype, dev, off).transpose(1, 2)
    cv = _fused_heads(rng, B, W, Hkv, hd, dtype, dev, off).transpose(1, 2)
    if dtype == torch.bfloat16 and hd == 100:
        assert ck.data_ptr() % 16 == 8
    k_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    for b, n in enumerate([37, 900, W + 413]):
        t = np.arange(max(0, n - W), n)
        k_pos[b, t % W] = t
        k_pos[b, 5:9] = -1
        q_pos[b] = n - 1
    qp, kp = (torch.from_numpy(x).to(dev) for x in (q_pos, k_pos))
    args = (q, ck, cv, qp, kp)
    got = _launched("decode_attention", lambda: ops.decode_attention(*args))
    rows = torch.ones_like(got, dtype=torch.bool)
    if dtype == torch.bfloat16:
        _check_bf16(got, ref.decode_attention, args, rows)
    else:
        torch.testing.assert_close(got, ref.decode_attention(*args),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,group", NEW_DECODE)
def test_paged_decode_new_instances_match_plain(cuda_device, dtype, hd,
                                                group):
    """A table of 40 pages of 16 (a cluster of two blocks), mixed fills,
    an unmapped (-1) page inside slot 0 and a page mapped by two slots;
    the pool's rows start on 8-byte boundaries at bf16 hd 100."""
    rng = np.random.default_rng(hd * 10 + group + 1)
    B, Hkv, ps, M = 3, 2, 16, 40
    kp, vp, tbl, q_pos, k_pos = _paged_case(rng, B, Hkv, ps, M, hd)
    q = rng.standard_normal((B, Hkv * group, hd), dtype=np.float32)
    dev = cuda_device
    q, kp, vp = (torch.from_numpy(x).to(dtype).to(dev) for x in (q, kp, vp))
    tbl, qp, kpos = (torch.from_numpy(x).to(dev)
                     for x in (tbl, q_pos, k_pos))
    assert (tbl == -1).any()
    args = (q, kp, vp, tbl, qp, kpos)
    got = _launched("paged_decode_attention",
                    lambda: ops.paged_decode_attention(*args))
    rows = torch.ones_like(got, dtype=torch.bool)
    if dtype == torch.bfloat16:
        _check_bf16(got, ref.paged_decode_attention, args, rows)
    else:
        torch.testing.assert_close(got, ref.paged_decode_attention(*args),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_hd100_bf16_rows_need_8_byte_alignment(cuda_device):
    """bf16 hd 100 copies 8-byte pieces: rows 8 bytes past a 16-byte
    boundary run (above); rows 2 bytes off are refused before any launch,
    by all four kernels."""
    dev = cuda_device
    before = ops.launch_counts()
    buf = torch.randn(1, 8, 2 * 100 + 8, device=dev).to(torch.bfloat16)
    x = buf[..., 1:201].unflatten(-1, (2, 100))           # 2-byte offset
    q = x.transpose(1, 2)
    pos = torch.arange(8, dtype=torch.int32, device=dev)[None]
    pages = torch.zeros(2, 3, 4, 100, dtype=torch.bfloat16, device=dev)
    tbl = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="8-byte aligned rows"):
        ops.flash_attention(q, q, q, pos, pos)
    with pytest.raises(ValueError, match="8-byte aligned rows"):
        ops.chunked_prefill_attention(q, pages, pages, tbl, pos, pos)
    with pytest.raises(ValueError, match="8-byte aligned rows"):
        ops.decode_attention(q[:, :, 0], q, q, pos[:, 0], pos)
    bad_pages = torch.zeros(2, 3, 4, 101, dtype=torch.bfloat16,
                            device=dev)[..., 1:]
    with pytest.raises(ValueError, match="8-byte aligned rows"):
        ops.paged_decode_attention(q[:, :, 0], bad_pages, bad_pages, tbl,
                                   pos[:, 0], pos)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("arch", ["minicpm-2b", "internlm2-20b",
                                  "stablelm-12b"])
def test_dense_smoke_engine_on_card_matches_cpu(cuda_device, arch):
    """minicpm-2b (the padded heads through the group-1 kernels with the
    identity map), internlm2-20b and stablelm-12b (the parallel block with
    qk-norm and 25% rotary) smoke at head dim 32 (MiniCPM's own 24 has no
    kernel: widths changed to 4 heads of 32 for MiniCPM), float32
    on the paged + chunked + prefix-sharing rung: the card's tokens equal
    the CPU's (the expanded map), every kernel of the path ran."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config(arch, "smoke")
    if arch == "minicpm-2b":
        cfg = dataclasses.replace(cfg, d_model=192, n_heads=6, n_kv_heads=6)
        assert cfg.n_heads_padded == 8 and cfg.head_dim_ == 32
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(5)
    system = rng.integers(2, cfg.vocab, 32).tolist()
    prompts = [system + rng.integers(2, cfg.vocab, n).tolist()
               for n in (3, 20, 0, 9)]
    prompts += [rng.integers(2, cfg.vocab, n).tolist() for n in (40, 7)]
    ecfg = EngineConfig(max_batch=4, max_len=128, paged=True, page_size=16,
                        prefill_chunk=16, prefill_pack=2,
                        prefix_sharing=True)
    toks = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(Model(cfg, dev), _to(cpu_params, dev), ecfg,
                            device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
        ops.reset_launches()
        toks[str(dev)] = {r.rid: r.tokens for r in eng.run()}
        counts = ops.launch_counts()
    assert toks["cpu"] == toks[str(cuda_device)]
    assert counts["paged_decode_attention"] > 0
    assert counts["chunked_prefill_attention"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_kernel_matches_plain(cuda_device, dtype):
    """``tests/test_kernels.py::test_mla_decode_attention_matches_naive``'s
    case (B2, H4 over one latent head, W24, kvr 16 + rope 8, nope 12, 17
    valid keys) through the decode kernel's (24, 16) group-4 instance,
    against the plain version on the same card tensors: float32 at the
    reference test's rtol = atol = 1e-4, bf16 under ``TOL``."""
    B, H, W, kvr, rope, nope = 2, 4, 24, 16, 8, 12
    rng = np.random.default_rng(165)
    dev = cuda_device
    q_lat = _normal(rng, (B, H, kvr), dtype, dev)
    q_rope = _normal(rng, (B, H, rope), dtype, dev)
    ckv = _normal(rng, (B, W, kvr), dtype, dev)
    k_rope = _normal(rng, (B, W, rope), dtype, dev)
    kp = np.tile(np.where(np.arange(W) < 17, np.arange(W), -1), (B, 1))
    kpos = torch.from_numpy(kp.astype(np.int32)).to(dev)
    qpos = torch.full((B,), 16, dtype=torch.int32, device=dev)
    args = (q_lat, q_rope, ckv, k_rope, qpos, kpos)
    got = _launched("decode_attention", lambda: ops.mla_decode_attention(
        *args, qk_dim=nope + rope))
    assert got.shape == (B, H, kvr) and got.dtype == dtype
    q = torch.cat([q_lat, q_rope], -1) * (math.sqrt(kvr + rope)
                                          / math.sqrt(nope + rope))
    want = ref.decode_attention(q, torch.cat([ckv, k_rope], -1)[:, None],
                                ckv[:, None], qpos, kpos)
    tol = 1e-4 if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_decode_kernel_refuses_other_head_dim_pairs(cuda_device):
    """hd_v != hd only where an instance exists: (24, 16) at group 4."""
    dev = cuda_device
    qpos = torch.zeros((1,), dtype=torch.int32, device=dev)
    kpos = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    for hd, hd_v, Hq in ((24, 16, 2), (32, 16, 4), (24, 8, 4), (24, 24, 4)):
        q = torch.randn(1, Hq, hd, device=dev)
        k = torch.randn(1, 1, 8, hd, device=dev)
        v = torch.randn(1, 1, 8, hd_v, device=dev)
        with pytest.raises(ValueError, match="head dims"):
            ops.decode_attention(q, k, v, qpos, kpos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d", [(8, 128), (37, 256), (5, 512)])
def test_rmsnorm_kernel_reference_sweep(cuda_device, dtype, R, d):
    """``tests/test_kernels.py::test_rmsnorm_kernel_sweep``'s shapes: x ~
    N(0, 1), scale ~ 1 + N(0, 0.1), both in the working type, against the
    plain version (statistics in float32) at the reference's tolerance."""
    rng = np.random.default_rng(R + d)
    dev = cuda_device
    x = _normal(rng, (R, d), dtype, dev)
    scale = (torch.from_numpy(rng.standard_normal(d, dtype=np.float32))
             * 0.1 + 1.0).to(dtype).to(dev)
    got = _launched("rmsnorm", lambda: ops.rmsnorm(x, scale))
    want = ref.rmsnorm(x, scale, 1e-5)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=SWEEP_TOL[dtype], rtol=SWEEP_TOL[dtype])


# --------------------------------------------------------------------------
# Llama-4 Maverick: 40 real q heads at group 5 over one copy of each of its
# 8 kv heads (the strided view kv[:, :, ::2] of 16 duplicated heads),
# chunk-local rings, and the pad-row fill of a model with moe blocks
# --------------------------------------------------------------------------


def _dup_heads(rng, B, S, Hkv, hd, dtype, dev):
    """(B, S, 2 Hkv, hd) with heads 2c and 2c + 1 equal (the duplicated kv
    heads of the model) and its view of copy 0 of each, (B, S, Hkv, hd)."""
    x = _normal(rng, (B, S, Hkv, 1, hd), dtype, dev).expand(
        B, S, Hkv, 2, hd).reshape(B, S, 2 * Hkv, hd)
    return x, x[:, :, ::2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,Hkv,W,chunk", [(32, 2, 24, 8), (128, 8, 8192,
                                                             8192),
                                            (128, 8, 300, 128)])
def test_decode_group5_over_a_strided_kv_view(cuda_device, dtype, hd, Hkv,
                                              W, chunk):
    """Group 5 over the strided view of a ring cache of duplicated heads,
    fills crossing a chunk boundary (the ring evicting the last chunk's
    keys), against the plain version; the same with the global layer's
    full window (no chunk)."""
    rng = np.random.default_rng(hd + W)
    B, dev = 4, cuda_device
    q = _normal(rng, (B, 5 * Hkv, hd), dtype, dev)
    ck, kview = _dup_heads(rng, B, W, Hkv, hd, dtype, dev)
    cv, vview = _dup_heads(rng, B, W, Hkv, hd, dtype, dev)
    k_pos = np.full((B, W), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    for b, n in enumerate([chunk - 3, chunk + 1, chunk + W // 2, 3]):
        t = np.arange(max(0, n - W), n)
        k_pos[b, t % W] = t
        q_pos[b] = n - 1
    qp, kp = (torch.from_numpy(x).to(dev) for x in (q_pos, k_pos))
    kt, vt = kview.transpose(1, 2), vview.transpose(1, 2)
    assert kt.stride(1) == 2 * hd
    for c in (chunk, None):
        args = (q, kt, vt, qp, kp)
        plain = functools.partial(ref.decode_attention, chunk=c)
        got = _launched("decode_attention",
                        lambda: ops.decode_attention(*args, chunk=c))
        rows = torch.ones_like(got, dtype=torch.bool)
        if dtype == torch.bfloat16:
            _check_bf16(got, plain, args, rows)
        else:
            torch.testing.assert_close(got, plain(*args), atol=TOL[dtype],
                                       rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hkv,S,hd,chunk", [(3, 2, 30, 32, 8),
                                              (1, 8, 8192, 128, 8192),
                                              (2, 8, 600, 128, 256)])
def test_flash_h40_over_a_strided_kv_view(cuda_device, dtype, B, Hkv, S, hd,
                                          chunk):
    """Maverick's prefill: 5 Hkv q heads (40 at full width) cut from the
    model's padded projection against the strided view of duplicated kv
    heads, chunk-local, right-padded rows (pad queries write 0)."""
    rng = np.random.default_rng(S + hd)
    dev = cuda_device
    q = _normal(rng, (B, S, 6 * Hkv, hd), dtype, dev)[:, :, :5 * Hkv]
    _, k = _dup_heads(rng, B, S, Hkv, hd, dtype, dev)
    _, v = _dup_heads(rng, B, S, Hkv, hd, dtype, dev)
    lens = [S, S // 3, S - 5][:B]
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    pos = np.where(pos < np.array(lens)[:, None], pos, -1).astype(np.int32)
    p = torch.from_numpy(pos).to(dev)
    args = [q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), p, p]
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(*args, chunk=chunk))
    rows = (p >= 0)[:, None, :, None].expand_as(got)
    plain = functools.partial(ref.flash_attention, chunk=chunk)
    if dtype == torch.bfloat16:
        _check_bf16(got, plain, args, rows)
    else:
        torch.testing.assert_close(got[rows], plain(*args)[rows],
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert (got.float()[~rows] == 0).all()


def test_decode_and_chunk_kernels_refuse_groups_they_lack(cuda_device):
    """Group 5 is an instance of the decode and chunk kernels; group 6 is
    none."""
    dev = cuda_device
    q6 = torch.randn(1, 12, 32, device=dev)
    kv = torch.randn(1, 2, 8, 32, device=dev)
    pos = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="GQA group"):
        ops.decode_attention(q6, kv, kv, pos, pos.expand(1, 8).contiguous())
    pages = torch.randn(2, 3, 4, 32, device=dev)
    tbl = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    k_pos = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    q6 = torch.randn(1, 12, 3, 32, device=dev)
    with pytest.raises(ValueError, match="GQA group"):
        ops.chunked_prefill_attention(q6, pages, pages, tbl,
                                      torch.zeros((1, 3), dtype=torch.int32,
                                                  device=dev), k_pos)


@pytest.mark.parametrize("group", [1, 2, 5])
def test_float32_head_dim_20_kernels_match_plain(cuda_device, group):
    """Head dim 20 in float32 (``examples/serve_e2e_torch.py``: d_model
    160 over 8 heads): flash over right-padded rows and decode over a
    half-filled cache, against the plain versions; bf16 has no hd 20
    instance and is refused."""
    rng = np.random.default_rng(20 + group)
    B, Hkv, S, hd, dev = 3, 4, 37, 20, cuda_device
    f32 = torch.float32
    q = _normal(rng, (B, S, group * Hkv, hd), f32, dev).transpose(1, 2)
    k = _normal(rng, (B, S, Hkv, hd), f32, dev).transpose(1, 2)
    v = _normal(rng, (B, S, Hkv, hd), f32, dev).transpose(1, 2)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    pos = np.where(pos < np.array([[S], [11], [30]]), pos, -1).astype(
        np.int32)
    p = torch.from_numpy(pos).to(dev)
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, p, p))
    rows = (p >= 0)[:, None, :, None].expand_as(got)
    torch.testing.assert_close(got[rows], ref.flash_attention(
        q, k, v, p, p)[rows], atol=TOL[f32], rtol=TOL[f32])
    qd = _normal(rng, (B, group * Hkv, hd), f32, dev)
    qp = torch.tensor([S - 1, 10, 29], dtype=torch.int32, device=dev)
    got = _launched("decode_attention",
                    lambda: ops.decode_attention(qd, k, v, qp, p))
    torch.testing.assert_close(got, ref.decode_attention(qd, k, v, qp, p),
                               atol=TOL[f32], rtol=TOL[f32])
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), p, p)


def _dup_pool(x, dev, dtype):
    """A (Hkv, P+1, ps, hd) numpy pool as the model's pool of duplicated
    kv heads, (2 Hkv, P+1, ps, hd) with heads 2c and 2c + 1 equal, on the
    card; returns the kernels' operand, its view ::2."""
    t = torch.from_numpy(x).to(dtype).to(dev)
    return t[:, None].expand(t.shape[0], 2, *t.shape[1:]).reshape(
        2 * t.shape[0], *t.shape[1:])[::2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hkv,ps,M,S,hd,window", [
    (2, 8, 12, 33, 32, None), (8, 16, 20, 256, 128, None),
    (2, 16, 10, 48, 128, 40),
])
def test_paged_kernels_group5_over_a_strided_pool_view(cuda_device, dtype,
                                                       Hkv, ps, M, S, hd,
                                                       window):
    """Maverick's paged path: 5 Hkv q heads cut from the padded projection
    at group 5 over the view ::2 of a pool of duplicated kv heads, in the
    chunk kernel (its group-5 instance: pad queries write 0) and in paged
    decode, against the plain versions."""
    rng = np.random.default_rng(Hkv * 1000 + S + hd)
    B, dev = 3, cuda_device
    kp, vp, tbl, q_pos, k_pos = _paged_case(rng, B, Hkv, ps, M, hd, S=S)
    kv, vv = _dup_pool(kp, dev, dtype), _dup_pool(vp, dev, dtype)
    assert kv.stride(0) == 2 * (B * M + 1) * ps * hd
    tbl, qp, kpos = (torch.from_numpy(x).to(dev)
                     for x in (tbl, q_pos, k_pos))
    q = _normal(rng, (B, S, 6 * Hkv, hd), dtype, dev)[:, :, :5 * Hkv]
    args = (q.transpose(1, 2), kv, vv, tbl, qp, kpos)
    plain = functools.partial(ref.chunked_prefill_attention, window=window)
    got = _launched("chunked_prefill_attention",
                    lambda: ops.chunked_prefill_attention(*args,
                                                          window=window))
    rows = (qp >= 0)[:, None, :, None].expand_as(got)
    if dtype == torch.bfloat16:
        _check_bf16(got, plain, args, rows)
    else:
        torch.testing.assert_close(got[rows], plain(*args)[rows],
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert (got.float()[~rows] == 0).all()
    qd = _normal(rng, (B, 6 * Hkv, hd), dtype, dev)[:, :5 * Hkv]
    dpos = qp.max(dim=1).values.contiguous()
    args = (qd, kv, vv, tbl, dpos, kpos)
    plain = functools.partial(ref.paged_decode_attention, window=window)
    got = _launched("paged_decode_attention",
                    lambda: ops.paged_decode_attention(*args, window=window))
    rows = torch.ones_like(got, dtype=torch.bool)
    if dtype == torch.bfloat16:
        _check_bf16(got, plain, args, rows)
    else:
        torch.testing.assert_close(got, plain(*args), atol=TOL[dtype],
                                   rtol=TOL[dtype])


def _maverick_map(cf):
    """Maverick smoke with its head map at small size: 10 q / 2 kv heads
    padded to 12 / 4, head dim 32, (dense, moe) x 2, chunk 8, a global
    layer every 2nd, capacity factor ``cf`` (test_torch_moe.py's
    ``small_configs``)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("llama4-maverick-400b-a17b", "smoke")
    return dataclasses.replace(
        cfg, name=f"maverick-map-cf{cf}", n_heads=10, n_kv_heads=2,
        pad_heads_to_multiple=4, head_dim=32, attn_chunk=8,
        global_attn_every=2,
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_pad_row_fill_on_card_matches_cpu(cuda_device, cf):
    """A right-padded prefill of a model with moe blocks: each attention
    block's output on the card (group 5 over the strided kv view, the pad
    rows filled after the kernel) equals the CPU's plain path (expanded kv
    heads, the pad rows the plain version's mean of V), pad rows
    included, in float32; the prefill's last logits too."""
    from repro_torch.models import Model
    from repro_torch.models import attention as A
    cfg = _maverick_map(cf)
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(2))
    assert A.kernel_head_group(cfg, "cuda") == (5, 2, 10)
    tokens = torch.randint(2, cfg.vocab, (3, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    mask = (torch.arange(32)[None] < torch.tensor([[32], [9], [20]])).int()
    outs, logits = {}, {}
    attn = A.self_attention

    def spy(*a, **kw):
        out, cache = attn(*a, **kw)
        outs.setdefault(out.device.type, []).append(out.cpu())
        return out, cache

    A.self_attention = spy
    try:
        for dev in ("cpu", cuda_device):
            model = Model(cfg, dev)
            last, _ = model.prefill(_to(cpu_params, dev), tokens.to(dev),
                                    mask.to(dev), max_len=64)
            logits[str(dev)] = last.cpu()
    finally:
        A.self_attention = attn
    assert len(outs["cpu"]) == len(outs["cuda"]) == cfg.n_layers
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_paged_moe_dead_rows_on_card_match_cpu(cuda_device, cf):
    """The paged + chunked + prefix-sharing engine on a full-attention moe
    model (Maverick's head map at small size, float32): every chunk
    launch's attention output on the card (the chunk kernel at group 5
    over the pool's kv heads ::2, the dead rows filled over the gathered
    logical view) equals the CPU's plain path, dead rows included; the
    same tokens, with every decode step graphed on the card."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.models import attention as A
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = dataclasses.replace(_maverick_map(cf), attn_chunk=None,
                              global_attn_every=0)
    assert A.kernel_head_group(cfg, "cuda") == (5, 2, 10)
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(11)
    system = rng.integers(2, cfg.vocab, 16).tolist()
    prompts = [system + rng.integers(2, cfg.vocab, n).tolist()
               if i % 2 else rng.integers(2, cfg.vocab, n).tolist()
               for i, n in enumerate((5, 19, 30, 9, 3, 14, 27, 40))]
    ecfg = EngineConfig(max_batch=4, max_len=96, paged=True, page_size=8,
                        prefill_chunk=16, prefill_pack=2,
                        prefix_sharing=True)
    outs, toks = {}, {}
    attn = A.self_attention

    def spy(*a, **kw):
        out, cache = attn(*a, **kw)
        if a[7] == "chunk":
            outs.setdefault(out.device.type, []).append(out.cpu())
        return out, cache

    A.self_attention = spy
    try:
        for dev in ("cpu", cuda_device):
            eng = ServingEngine(Model(cfg, dev), _to(cpu_params, dev), ecfg,
                                device=dev)
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_new_tokens=8))
            ops.reset_launches()
            toks[str(dev)] = {r.rid: r.tokens for r in eng.run()}
            counts = ops.launch_counts()
    finally:
        A.self_attention = attn
    assert toks["cpu"] == toks[str(cuda_device)]
    assert len(outs["cpu"]) == len(outs["cuda"]) > 0
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    L = cfg.n_layers
    assert counts["chunked_prefill_attention"] == L * eng.prefill_chunks
    assert counts["paged_decode_attention"] == L * eng.stats()["steps"]
    assert eng.graphs.replays == eng.decode_chunks


@pytest.mark.parametrize("arch", ["smoke", "map-cf2.0", "map-cf0.5"])
def test_maverick_engine_on_card_matches_cpu(cuda_device, arch):
    """Maverick smoke and the two head-map configs (float32) on the
    contiguous engine, on the card and on the CPU from the same weights:
    identical tokens on ragged prompts that wrap the 8-slot rings; flash
    and decode in every layer of every prefill launch and micro-step."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = (get_config("llama4-maverick-400b-a17b", "smoke") if arch == "smoke"
           else _maverick_map(float(arch.split("cf")[1])))
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, cfg.vocab, n).tolist()
               for n in (5, 19, 30, 9, 3, 14, 27)]
    ecfg = EngineConfig(max_batch=4, max_len=64)
    toks = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(Model(cfg, dev), _to(cpu_params, dev), ecfg,
                            device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
        ops.reset_launches()
        toks[str(dev)] = {r.rid: r.tokens for r in eng.run()}
        counts = ops.launch_counts()
    assert toks["cpu"] == toks[str(cuda_device)]
    L = cfg.n_layers
    assert counts["flash_attention"] == L * eng.prefill_batches
    assert counts["decode_attention"] >= L * eng.stats()["steps"]
    assert counts["decode_attention"] % L == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d,stride,variant", [
    (8, 1536, 1536, "plain"),      # q_norm at a decode step: q_lora 1,536
    (4096, 1536, 1536, "plain"),   # and at a 4,096-token prefill
    (8, 512, 576, "plain"),        # kv_norm: the latent 512 of dkv's 576
    (4096, 512, 576, "plain"),
    (8, 7168, 7168, "add"),        # ln1 / ln2 with the residual add
])
def test_rmsnorm_kernel_at_deepseek_shapes(cuda_device, dtype, R, d, stride,
                                           variant):
    """RMSNorm at DeepSeek-V3's new row widths against its plain version;
    ``kv_norm`` reads ``dkv[..., :512]`` through its row stride of 576
    (no copy: the kernel's 16-byte vectors, 1,152-byte rows), also as the
    (B, S, 512) view the model passes; one launch a call."""
    gen = torch.Generator().manual_seed(R + d)
    x = torch.randn(R, stride, generator=gen).to(dtype).to(
        cuda_device)[:, :d]
    scale = (torch.randn(d, generator=gen) * 0.1 + 1).to(dtype).to(
        cuda_device)
    before = ops.launch_counts()["rmsnorm"]
    if variant == "add":
        delta = torch.randn(R, d, generator=gen).to(dtype).to(cuda_device)
        s, got = ops.add_rmsnorm(x, delta, scale, 1e-6)
        ws, want = ref.add_rmsnorm(x, delta, scale, 1e-6)
        assert torch.equal(s, ws)
    else:
        got = ops.rmsnorm(x, scale, 1e-6)
        want = ref.rmsnorm(x, scale, 1e-6)
    assert ops.launch_counts()["rmsnorm"] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (R, d)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    if stride != d:
        B = 2 if R % 2 == 0 else 1
        x3 = x.view(B, R // B, d)
        assert x3.stride() == (R // B * stride, stride, 1)
        torch.testing.assert_close(ops.rmsnorm(x3, scale, 1e-6).reshape(
            R, d), got, rtol=0, atol=0)


def test_mla_forward_on_card_matches_cpu(cuda_device):
    """DeepSeek-V3 smoke (float32: one ``mla`` and two ``mla_moe`` blocks)
    on the card, every norm on the RMSNorm kernel, and on the CPU's plain
    path from the same weights: a ragged prefill and two decode steps,
    logits within 1e-3 and the same greedy tokens, RMSNorm launched 4
    times a block and once more a forward, no other kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("deepseek-v3-671b", "smoke")
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab, (3, 24)))
    mask = torch.ones(3, 24, dtype=torch.int32)
    mask[1, 15:] = 0
    mask[2, 6:] = 0
    out = {}
    for dev in ("cpu", cuda_device):
        model = Model(cfg, dev)
        params = _to(cpu_params, dev)
        ops.reset_launches()
        logits, caches = model.prefill(params, toks.to(dev), mask.to(dev),
                                       max_len=48)
        steps = [logits]
        for _ in range(2):
            cur = steps[-1].argmax(-1)[:, None]
            logits, caches = model.decode_step(params, caches, cur)
            steps.append(logits)
        out[str(dev)] = [t.cpu() for t in steps]
        counts = ops.launch_counts()
    assert counts.pop("rmsnorm") == 3 * (4 * cfg.n_layers + 1)
    assert not any(counts.values()), counts
    for i, (got, want) in enumerate(zip(out[str(cuda_device)], out["cpu"])):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3,
                                   msg=f"forward {i}")
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_deepseek_engine_on_card_matches_cpu(cuda_device):
    """DeepSeek-V3 smoke (float32) on the contiguous engine, on the card
    and on the CPU from the same weights: identical tokens on ragged
    prompts in padded prefill buckets."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg = get_config("deepseek-v3-671b", "smoke")
    cpu_params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, cfg.vocab, n).tolist()
               for n in (5, 19, 30, 9, 3, 14, 27)]
    ecfg = EngineConfig(max_batch=4, max_len=64)
    toks = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(Model(cfg, dev), _to(cpu_params, dev), ecfg,
                            device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
        toks[str(dev)] = {r.rid: r.tokens for r in eng.run()}
    assert toks["cpu"] == toks[str(cuda_device)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_top8_combine_is_deterministic_on_card(cuda_device, dtype):
    """Top-8 of 16 experts: each token sums 8 expert rows, one add at a
    time in the reference's order, so two calls on the card give the same
    bits (an index_add_ of 8 rows into one is not deterministic there);
    in float32 the result also equals the CPU's to 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    base = get_config("deepseek-v3-671b", "smoke")
    cfg = dataclasses.replace(
        base, dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
        moe=dataclasses.replace(base.moe, n_experts=16, top_k=8,
                                capacity_factor=1.25))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((4, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    pc = _to(p, cuda_device)
    a, _ = moe.moe_apply(pc, cfg, x.to(cuda_device))
    b, _ = moe.moe_apply(pc, cfg, x.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    if dtype == torch.float32:
        want, _ = moe.moe_apply(p, cfg, x)
        torch.testing.assert_close(a.cpu(), want, atol=1e-4, rtol=1e-4)


def _memory_model(arch, dtype):
    """The smoke config of ``arch`` in ``dtype`` (llama-3.2-vision: dense
    and gated cross, 4 / 2 heads of 32; seamless-m4t: two ``dec`` layers
    over a two-layer encoder, 4 / 4 heads of 32), CPU weights from a seed
    with every gate set to 0.5 (the reference's init leaves them 0, which
    multiplies the cross-attention away), and its memory: 16 image
    embeddings, or 24 frames with the second row's later half masked."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import frontend
    cfg = get_config(arch, "smoke")
    cfg = dataclasses.replace(
        cfg, dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    for p in params["layers"]:
        if "gate_mlp" in p:
            p["gate_mlp"].fill_(0.5)
            p["attn"]["gate"].fill_(0.5)
    gen = torch.Generator().manual_seed(2)
    if cfg.n_image_tokens:
        extras = {"image_embeds": frontend.vision_embeddings(
            gen, 3, cfg.n_image_tokens, cfg.d_model, dtype, "cpu")}
    else:
        fm = torch.ones(3, cfg.encoder_seq, dtype=torch.int32)
        fm[1, cfg.encoder_seq // 2:] = 0
        extras = {"frames": frontend.audio_frames(
            gen, 3, cfg.encoder_seq, cfg.d_model, dtype, "cpu"),
            "frames_mask": fm}
    return cfg, params, extras


def _memory_forwards(cfg, params, extras, dev, steps=3):
    """A prefill of 3 x 24 tokens over the memory (unpadded: neither
    family takes padded prefill), then ``steps`` greedy decode steps;
    every forward's logits and the launch counts."""
    from repro_torch.models import Model
    model = Model(cfg, dev)
    params = _to(params, dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        2, cfg.vocab, (3, 24)))
    ops.reset_launches()
    logits, caches = model.prefill(
        params, toks.to(dev), max_len=48,
        extras={k: v.to(dev) for k, v in extras.items()})
    out = [logits]
    for _ in range(steps):
        cur = out[-1][:, :cfg.vocab].argmax(-1)[:, None].to(torch.int32)
        logits, caches = model.decode_step(params, caches, cur)
        out.append(logits)
    return [t.float().cpu() for t in out], ops.launch_counts()


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_memory_conditioned_kernels_match_plain_on_card(cuda_device, arch):
    """bf16 on the card: the prefill over the memory and 3 decode steps
    with the flash, decode and RMSNorm kernels, against the same forwards
    with their plain versions on the card (2e-2); the launches: flash in
    every self-attention layer of the prefill, decode in every one of each
    step, RMSNorm once a norm (an encoder-decoder's prefill adds 2 an
    encoder layer and ``enc_norm``)."""
    cfg, params, extras = _memory_model(arch, torch.bfloat16)
    got, counts = _memory_forwards(cfg, params, extras, cuda_device)
    with ops.swapped(lambda name, op, plain: plain):
        want, plain = _memory_forwards(cfg, params, extras, cuda_device)
    assert not any(plain.values())
    attn = sum(k in ("dense", "dec") for k in cfg.block_pattern)
    norms = 1 + sum(3 if k == "dec" else 2 for k in cfg.block_pattern)
    enc = 2 * cfg.n_encoder_layers + 1 if cfg.n_encoder_layers else 0
    assert counts.pop("flash_attention") == attn
    assert counts.pop("decode_attention") == 3 * attn
    assert counts.pop("rmsnorm") == 4 * norms + enc
    assert not any(counts.values()), counts
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=TOL[torch.bfloat16],
                                   rtol=TOL[torch.bfloat16],
                                   msg=f"forward {i}")


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_memory_conditioned_forward_on_card_matches_cpu(cuda_device, arch):
    """float32: the card (kernels) and the CPU (plain path) from the same
    weights and memory, logits within 1e-3 and the same greedy tokens."""
    cfg, params, extras = _memory_model(arch, torch.float32)
    got, _ = _memory_forwards(cfg, params, extras, cuda_device)
    want, _ = _memory_forwards(cfg, params, extras, "cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-3,
                                   msg=f"forward {i}")
        assert torch.equal(g.argmax(-1), w.argmax(-1))


def test_vlm_engine_on_card_matches_cpu(cuda_device):
    """llama-3.2-vision smoke (float32, gates 0.5) on the contiguous engine,
    text-only, on the card and on the CPU: identical tokens."""
    from repro_torch.models import Model
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    cfg, params, _ = _memory_model("llama-3.2-vision-90b", torch.float32)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, cfg.vocab, n).tolist()
               for n in (5, 19, 30, 9, 3, 14, 27)]
    toks = {}
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(Model(cfg, dev), _to(params, dev),
                            EngineConfig(max_batch=4, max_len=64), device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=10))
        toks[str(dev)] = {r.rid: r.tokens for r in eng.run()}
    assert toks["cpu"] == toks[str(cuda_device)]


# --------------------------------------------------------------------------
# training: the flash and RMSNorm kernels under autograd
# (kernels/autograd.py), each gradient against autograd of the float32
# plain version on the same inputs (float32 at TOL[float32], bf16 at
# TOL_WIDE); the row logsumexp; the ops without a gradient refusing one
# --------------------------------------------------------------------------


def _grad_leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def _close_wide(got, want, tol, what):
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bad = int((err > atol + rtol * want.float().abs()).sum())
    assert bad == 0, f"{what}: {bad} past atol {atol} rtol {rtol}, " \
        f"max abs err {float(err.max()):.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,kv_step,S,hd,window,chunk,pad", [
    (1, 1, 150, 64, None, None, False), (3, 1, 96, 128, None, None, False),
    (4, 1, 130, 100, None, None, False), (5, 2, 80, 128, None, None, False),
    (2, 1, 128, 160, None, None, False), (1, 1, 96, 64, 24, None, False),
    (4, 1, 100, 64, None, 32, False), (5, 2, 64, 64, None, 16, False),
    (2, 1, 77, 64, None, None, True), (1, 1, 64, 112, None, None, True),
])
def test_flash_autograd_matches_plain(cuda_device, dtype, group, kv_step, S,
                                      hd, window, chunk, pad):
    """q heads at ``group`` over ``Hkv`` kv heads, read (``kv_step`` 2) as
    the strided view ``::2`` of duplicated heads, as Maverick's layout;
    pad queries (position -1) take no gradient from either side (their
    output gradient is 0, as a masked label gives)."""
    gen = torch.Generator().manual_seed(S + hd + group)
    B, Hkv = 2, 2
    Hq = Hkv * group
    q = torch.randn(B, S, Hq, hd, generator=gen)
    k = torch.randn(B, S, Hkv * kv_step, hd, generator=gen)
    v = torch.randn(B, S, Hkv * kv_step, hd, generator=gen)
    pos = _pos(B, S, gen, pad).to(cuda_device)
    # the output's gradient as the kernel path receives it: in the
    # output's type (autograd casts it), so both sides start from it
    dout = torch.randn(B, S, Hq, hd, generator=gen).to(dtype).float().to(
        cuda_device)
    dout = torch.where(pos[:, :, None, None] >= 0, dout, 0.0)
    q, k, v = (t.to(dtype).to(cuda_device) for t in (q, k, v))

    def run(fn, leaves):
        qq, kk, vv = leaves
        out = fn(qq.transpose(1, 2), kk[:, :, ::kv_step].transpose(1, 2),
                 vv[:, :, ::kv_step].transpose(1, 2), pos, pos, window, chunk)
        (out.transpose(1, 2).float() * dout).sum().backward()
        return out, [t.grad for t in leaves]

    leaves = _grad_leaves(q, k, v)
    before = ops.launch_counts()["flash_attention"]
    out, got = run(ops.flash_attention, leaves)
    assert out.grad_fn is not None
    assert ops.launch_counts()["flash_attention"] == before + 1
    _, want = run(ref.flash_attention,
                  _grad_leaves(*(t.float() for t in (q, k, v))))
    torch.cuda.synchronize()
    tol = ((TOL[torch.float32],) * 2 if dtype == torch.float32 else TOL_WIDE)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        _close_wide(g, w, tol, f"d{name}")
    if pad:
        assert not got[0][pos < 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,S,hd,window,chunk,pad", [
    (1, 150, 64, None, None, True), (4, 130, 100, 24, None, True),
    (2, 96, 160, None, 32, False), (3, 64, 128, None, None, True),
])
def test_flash_lse_matches_logsumexp(cuda_device, dtype, group, S, hd,
                                     window, chunk, pad):
    """The kernel's row logsumexp against ``torch.logsumexp`` of the valid
    scaled scores in float32; +inf where a row sees no key; the output the
    same bits as the call without lse."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator().manual_seed(S + hd)
    B, Hkv = 2, 2
    Hq = Hkv * group
    q, k, v = (torch.randn(B, S, H, hd, generator=gen).to(dtype).to(
        cuda_device).transpose(1, 2) for H in (Hq, Hkv, Hkv))
    pos = _pos(B, S, gen, pad).to(cuda_device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=cuda_device)
    with_lse = FA.flash_attention(q, k, v, pos, pos, window, chunk, lse=lse)
    without = FA.flash_attention(q, k, v, pos, pos, window, chunk)
    assert torch.equal(with_lse, without)
    kk = k.float().repeat_interleave(group, dim=1)
    s = q.float() @ kk.transpose(-1, -2) / math.sqrt(hd)
    ok = ref.attention_mask(pos[:, None, :, None], pos[:, None, None, :],
                            window, chunk)
    want = torch.logsumexp(torch.where(ok, s, -math.inf), dim=-1)
    live = ok.any(-1).expand_as(want)
    assert torch.isinf(lse[~live]).all() and (lse[~live] > 0).all()
    torch.testing.assert_close(lse[live], want[live], atol=1e-4 if
                               dtype == torch.float32 else 2e-3, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d", [(8, 64), (300, 2048), (33, 160)])
@pytest.mark.parametrize("add", [False, True])
def test_rmsnorm_autograd_matches_plain(cuda_device, dtype, R, d, add):
    gen = torch.Generator().manual_seed(R + d)
    x = torch.randn(R, d, generator=gen).to(dtype).to(cuda_device)
    delta = torch.randn(R, d, generator=gen).to(dtype).to(cuda_device)
    scale = (1 + 0.1 * torch.randn(d, generator=gen)).to(dtype).to(
        cuda_device)
    # the outputs' gradients in their type, as the kernel path gets them
    dy = torch.randn(R, d, generator=gen).to(dtype).float().to(cuda_device)
    ds = torch.randn(R, d, generator=gen).to(dtype).float().to(cuda_device)

    def run(norm, add_norm, leaves):
        xx, dd, sc = leaves
        if add:
            s, y = add_norm(xx, dd, sc, 1e-5)
            ((s.float() * ds).sum() + (y.float() * dy).sum()).backward()
        else:
            y = norm(xx, sc, 1e-5)
            (y.float() * dy).sum().backward()
        return y, [t.grad for t in leaves]

    def plain_add(xx, dd, sc, eps):
        # the residual sum rounded once to the row type, as the kernel's
        # (bit-identical to PyTorch's x + delta), the norm in float32
        s = (xx + dd).to(dtype).float()
        return s, ref.rmsnorm(s, sc, eps)

    y, got = run(ops.rmsnorm, ops.add_rmsnorm, _grad_leaves(x, delta, scale))
    assert y.grad_fn is not None
    _, want = run(ref.rmsnorm, plain_add,
                  _grad_leaves(*(t.float() for t in (x, delta, scale))))
    torch.cuda.synchronize()
    tol = ((TOL[torch.float32],) * 2 if dtype == torch.float32 else TOL_WIDE)
    for name, g, w in zip(("x", "delta", "scale"), got, want):
        if name == "delta" and not add:
            assert g is None
            continue
        assert g.dtype == dtype
        _close_wide(g, w, tol, f"d{name}")


def test_kernel_ops_without_a_gradient_refuse_one(cuda_device):
    """The serving kernels (both decode kernels, MLA decode through the
    contiguous one, and chunked prefill) raise when grad mode is on and an
    input requires grad, and run under torch.no_grad(); the SSD chunk,
    WKV6 and the concat and gate norms run through their Functions
    (a ``grad_fn``), and WKV6 refuses ``s_out`` under grad."""
    dev = cuda_device
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    B, H, W, hd, ps, M = 2, 2, 32, 64, 8, 4
    q1 = rnd(B, H, hd).requires_grad_(True)
    k, v = rnd(B, H, W, hd), rnd(B, H, W, hd)
    pos = torch.arange(W, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    qp = torch.full((B,), W - 1, dtype=torch.int32, device=dev)
    pages = rnd(H, B * M + 1, ps, hd)
    tbl = torch.arange(B * M, dtype=torch.int32, device=dev).view(B, M)
    qs = rnd(B, H, 4, hd).requires_grad_(True)
    qsp = torch.arange(W - 4, W, dtype=torch.int32, device=dev)[None].repeat(
        B, 1)
    x = rnd(B, 16, 2, 8).requires_grad_(True)
    r = rnd(1, 2, 8, 16).requires_grad_(True)
    y = rnd(4, 32).requires_grad_(True)
    refused = {
        "decode_attention": lambda: ops.decode_attention(q1, k, v, qp, pos),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q1, pages, pages, tbl, qp, pos),
        "chunked_prefill_attention": lambda: ops.chunked_prefill_attention(
            qs, pages, pages, tbl, qsp, pos),
        "mla_decode_attention": lambda: ops.mla_decode_attention(
            rnd(B, 4, 16).requires_grad_(True), rnd(B, 4, 8), rnd(B, W, 16),
            rnd(B, W, 8), qp, pos),
    }
    trained = {
        "ssd_chunk": lambda: ops.ssd_scan(
            x, torch.rand(B, 16, 2, device=dev), -torch.rand(2, device=dev),
            rnd(B, 16, 2, 4), rnd(B, 16, 2, 4), chunk=8),
        "wkv6": lambda: ops.wkv6(
            r, rnd(1, 2, 8, 16), rnd(1, 2, 8, 16),
            torch.rand(1, 2, 8, 16, device=dev), rnd(2, 16),
            torch.zeros(1, 2, 16, 16, device=dev)),
        "cat_rmsnorm": lambda: ops.cat_rmsnorm(y, rnd(4, 32),
                                               torch.ones(64, device=dev)),
        "gated_rmsnorm": lambda: ops.gated_rmsnorm(
            y, rnd(4, 32), torch.ones(32, device=dev), 1e-5, torch.float32),
    }
    for name, call in {**refused, **trained}.items():
        if name in refused:
            with pytest.raises(RuntimeError, match="has no backward"):
                call()
        else:
            out = call()
            first = out[0] if isinstance(out, tuple) else out
            assert first.grad_fn is not None, name
        with torch.no_grad():
            out = call()
        torch.cuda.synchronize()
        for t in out if isinstance(out, tuple) else (out,):
            assert torch.isfinite(t).all(), name
    with pytest.raises(RuntimeError, match="training keeps no state"):
        s0 = torch.zeros(1, 2, 16, 16, device=dev)
        ops.wkv6(r, rnd(1, 2, 8, 16), rnd(1, 2, 8, 16),
                 torch.rand(1, 2, 8, 16, device=dev), rnd(2, 16), s0, s0)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_card_matches_cpu(cuda_device, remat):
    """llama3.2-1b smoke in float32: ``train_loss`` and every gradient on
    the card (flash and RMSNorm kernels under autograd) against the CPU's
    plain path from the same weights, 1e-3; every parameter takes a
    gradient; flash L and RMSNorm 2 L + 1 forward launches a step, and
    under remat the backward runs each layer's again."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training.optim import unique_leaves
    cfg = get_config("llama3.2-1b", "smoke")
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)).astype(
        np.int32))
    out = {}
    for dev in ("cpu", cuda_device):
        p = _to(params, dev)
        for _, t in unique_leaves(p):
            t.detach_().requires_grad_(True)
        batch = {"tokens": tokens.to(dev),
                 "labels": torch.roll(tokens, -1, dims=1).to(dev)}
        ops.reset_launches()
        loss, _ = Model(cfg, dev).train_loss(p, batch, remat=remat)
        fwd = ops.launch_counts()
        loss.backward()
        bwd = ops.launch_counts()
        out[str(dev)] = (loss.detach().cpu(),
                         [(path, t.grad) for path, t in unique_leaves(p)],
                         fwd, bwd)
    L = cfg.n_layers
    l_cpu, g_cpu, _, _ = out["cpu"]
    l_card, g_card, fwd, bwd = out[str(cuda_device)]
    assert (fwd["flash_attention"], fwd["rmsnorm"]) == (L, 2 * L + 1)
    assert bwd["flash_attention"] == L * (2 if remat else 1)
    torch.testing.assert_close(l_card, l_cpu, atol=1e-4, rtol=1e-4)
    for (path, gc), (_, gg) in zip(g_cpu, g_card):
        assert gg is not None, path
        torch.testing.assert_close(gg.cpu(), gc, atol=1e-3, rtol=1e-3,
                                   msg="/".join(path))


# --------------------------------------------------------------------------
# the recurrent kernels and the concat and gate norms under autograd: each
# Function's forward bit-identical to its bare kernel, its gradients against
# autograd of the plain version (bf16 gradients at TOL[bf16]; float32 ones
# at TOL_WIDE, the scans' at SCAN_REL relative and absolute against the
# gradient's largest magnitude, as chip_smoke.py holds WKV6's outputs:
# SSD's ddt and dA are reverse cumulative sums over the chunk and WKV6's
# dw a row of G ∘ S, terms that cancel, where two float32 orders differ by
# ~1e-7 of the largest term); on the reference sweeps and at a train
# step's shape; every registered family's smoke train step on the card
# --------------------------------------------------------------------------


SCAN_REL = 1e-5


def _function_matches_plain(function, bare, plain, leaves, cots, scan):
    """Run ``function`` forward and backward: its outputs equal ``bare``'s
    bit for bit (one launch, none in the backward) and each leaf's gradient
    is close to autograd of ``plain`` on the same leaves (``scan``: float32
    gradients at ``SCAN_REL`` of their largest magnitude)."""
    with torch.no_grad():
        want_out = bare(*leaves)
    want_out = want_out if isinstance(want_out, tuple) else (want_out,)

    def grads(fn):
        for t in leaves:
            t.grad = None
        out = fn(*leaves)
        out = out if isinstance(out, tuple) else (out,)
        torch.autograd.backward(
            [o for o, c in zip(out, cots) if c is not None],
            [c for c in cots if c is not None])
        return out, [t.grad for t in leaves]

    before = sum(ops.launch_counts().values())
    out, got = grads(function)
    assert sum(ops.launch_counts().values()) == before + 1
    for g, w in zip(out, want_out):
        assert torch.equal(g, w)
    _, want = grads(plain)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        assert g.dtype == leaves[i].dtype and torch.isfinite(g.float()).all()
        big = max(1.0, float(w.float().abs().max()))
        tol = ((TOL[torch.bfloat16],) * 2 if g.dtype == torch.bfloat16 else
               (SCAN_REL * big, SCAN_REL) if scan else TOL_WIDE)
        _close_wide(g, w, tol, f"input {i}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,P,N,cl", [
    (1, 2, 16, 8, 4, 8), (2, 3, 24, 8, 4, 8), (1, 2, 64, 16, 16, 16),
    (4, 112, 1024, 64, 64, 256),          # zamba2-7b's train step
])
def test_ssd_chunk_autograd_matches_plain(cuda_device, dtype, B, H, T, P, N,
                                          cl):
    """The chunk layout of ``ops.ssd_scan``: (B, T, H, *) projections seen
    as (B, H, nc, cl, *) views, B and C one group broadcast over the heads
    (stride 0), as Mamba2 passes them; dt = softplus(N(0, 1) - 4) and A =
    -[1 .. 16] as the model starts; every output's gradient given."""
    from repro_torch.kernels import autograd as AG
    rng = np.random.default_rng(T + H)
    dev = cuda_device
    nc = T // cl
    x = _normal(rng, (B, T, H, P), dtype, dev)
    dt = torch.nn.functional.softplus(
        _normal(rng, (B, T, H), torch.float32, dev) - 4).to(dtype)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    bc = _normal(rng, (2, B, T, 1, N), dtype, dev)

    def view(t):
        return t.reshape(B, nc, cl, H, -1).permute(0, 3, 1, 2, 4)

    leaves = [t.detach().requires_grad_(True) for t in (
        view(x), dt.reshape(B, nc, cl, H).permute(0, 3, 1, 2), A,
        view(bc[0].expand(B, T, H, N)), view(bc[1].expand(B, T, H, N)))]
    cots = [_normal(rng, s, torch.float32, dev) for s in
            ((B, H, nc, cl, P), (B, H, nc, P, N), (B, H, nc))]
    _function_matches_plain(AG.SSDChunk.apply, ssd.ssd_chunk, ref.ssd_chunk,
                            leaves, cots, scan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,hd,train", [
    (1, 2, 8, 8, False), (2, 3, 23, 16, False), (1, 4, 64, 32, False),
    (4, 32, 1024, 64, True),              # rwkv6-1.6b's train step
])
def test_wkv6_autograd_matches_plain(cuda_device, dtype, B, H, T, hd, train):
    """r, k, v in ``dtype`` as transposed views of (B, T, H, hd); the
    sweeps: w = sigmoid(N(0, 1)) and u in ``dtype``, s0 ~ N(0, 0.1) and
    both outputs' gradients; the train step: the model's w = exp(-exp(-6 +
    N(0, 0.1))) and u in float32, s0 zeros taking no gradient, and no
    state gradient."""
    from repro_torch.kernels import autograd as AG
    rng = np.random.default_rng(T * hd)
    dev = cuda_device
    r, k, v = (_normal(rng, (B, T, H, hd), dtype, dev).transpose(1, 2)
               for _ in range(3))
    if train:
        w = torch.exp(-torch.exp(-6 + 0.1 * _normal(
            rng, (B, T, H, hd), torch.float32, dev))).transpose(1, 2)
        u = 0.5 * _normal(rng, (H, hd), torch.float32, dev)
        s0 = torch.zeros(B, H, hd, hd, device=dev)
    else:
        w = torch.sigmoid(_normal(rng, (B, H, T, hd), torch.float32,
                                  dev)).to(dtype)
        u = (0.5 * _normal(rng, (H, hd), torch.float32, dev)).to(dtype)
        s0 = (0.1 * _normal(rng, (B, H, hd, hd), torch.float32,
                            dev)).requires_grad_(True)
    leaves = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
    leaves.append(s0)
    cots = [_normal(rng, (B, H, T, hd), torch.float32, dev),
            None if train else _normal(rng, (B, H, hd, hd), torch.float32,
                                       dev)]
    _function_matches_plain(AG.WKV6.apply, wkv6.wkv6, ref.wkv6, leaves,
                            cots, scan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("R,d1,d2", [(8, 64, 64), (37, 96, 32),
                                     (4096, 3584, 3584)])   # zamba2's shared
def test_cat_rmsnorm_autograd_matches_plain(cuda_device, dtype, add, R, d1,
                                            d2):
    from repro_torch.kernels import autograd as AG
    gen = torch.Generator().manual_seed(R + d1 + d2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).to(cuda_device)

    x, delta, e = rnd(R, d1), rnd(R, d1), rnd(R, d2)
    scale = (1 + 0.1 * torch.randn(d1 + d2, generator=gen)).to(dtype).to(
        cuda_device)
    dy = rnd(R, d1 + d2)
    if add:
        leaves = [t.requires_grad_(True) for t in (x, e, scale, delta)]
        _function_matches_plain(
            lambda a, b, c, dd: AG.CatRMSNorm.apply(a, b, c, 1e-5, dd),
            lambda a, b, c, dd: rmsnorm.cat_rmsnorm(a, b, c, 1e-5, dd),
            lambda a, b, c, dd: ref.cat_rmsnorm(a, b, c, 1e-5, dd),
            leaves, [rnd(R, d1), dy], scan=False)
    else:
        leaves = [t.requires_grad_(True) for t in (x, e, scale)]
        _function_matches_plain(
            lambda a, b, c: AG.CatRMSNorm.apply(a, b, c, 1e-5),
            lambda a, b, c: rmsnorm.cat_rmsnorm(a, b, c, 1e-5),
            lambda a, b, c: ref.cat_rmsnorm(a, b, c, 1e-5),
            leaves, [dy], scan=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d", [(8, 64), (37, 128),
                                 (4096, 7168)])       # zamba2's mamba2 gate
def test_gated_rmsnorm_autograd_matches_plain(cuda_device, dtype, R, d):
    """y and z float32, as Mamba2 holds them; the row cast to ``dtype``."""
    from repro_torch.kernels import autograd as AG
    gen = torch.Generator().manual_seed(R + d)
    y, z = (torch.randn(R, d, generator=gen).to(cuda_device)
            for _ in range(2))
    scale = (1 + 0.1 * torch.randn(d, generator=gen)).to(dtype).to(
        cuda_device)
    leaves = [t.requires_grad_(True) for t in (y, z, scale)]
    _function_matches_plain(
        lambda a, b, c: AG.GatedRMSNorm.apply(a, b, c, 1e-5, dtype),
        lambda a, b, c: rmsnorm.gated_rmsnorm(a, b, c, 1e-5, dtype),
        lambda a, b, c: ref.gated_rmsnorm(a, b, c, 1e-5, dtype),
        leaves, [torch.randn(R, d, generator=gen).to(dtype).to(cuda_device)],
        scan=False)


def _train_extras(cfg, B, S, dev):
    """The memory a smoke train batch of ``cfg`` needs: image embeddings
    (the VLM's cross layers) or encoder frames (SeamlessM4T), else none."""
    from repro_torch.models import frontend
    gen = torch.Generator().manual_seed(3)
    dtype = getattr(torch, cfg.dtype)
    if cfg.n_image_tokens:
        return {"image_embeds": frontend.vision_embeddings(
            gen, B, cfg.n_image_tokens, cfg.d_model, dtype, "cpu")}
    if cfg.is_encdec:
        return {"frames": frontend.audio_frames(
                    gen, B, cfg.encoder_seq, cfg.d_model, dtype, "cpu"),
                "frames_mask": torch.ones(B, cfg.encoder_seq,
                                          dtype=torch.int32)}
    return {}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_family_trains_on_card(cuda_device, arch):
    """Each registered family's smoke config in float32 (the VLM's gates
    at 0.5; MiniCPM at 6 heads of 32, as the dense engine test widens it):
    ``train_loss`` and every gradient on the card, every kernel op
    of its train forward under autograd, against the CPU's plain path from
    the same weights (1e-3); no kernel launches in the backward and none
    of the serving kernels in the forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.training.optim import unique_leaves
    import dataclasses
    cfg = get_config(arch, "smoke")
    if arch == "minicpm-2b":      # its smoke head dim 24 is no kernel's
        cfg = dataclasses.replace(cfg, d_model=192, n_heads=6, n_kv_heads=6)
        assert cfg.head_dim_ == 32
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    for p in params["layers"]:
        if "gate_mlp" in p:
            p["gate_mlp"].fill_(0.5)
            p["attn"]["gate"].fill_(0.5)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 32)).astype(np.int32))
    extras = _train_extras(cfg, 2, 32, "cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        p = _to(params, dev)
        for _, t in unique_leaves(p):
            t.detach_().requires_grad_(t.is_floating_point())
        batch = {"tokens": tokens.to(dev),
                 "labels": torch.roll(tokens, -1, dims=1).to(dev),
                 **{k: v.to(dev) for k, v in extras.items()}}
        ops.reset_launches()
        loss, _ = Model(cfg, dev).train_loss(p, batch, remat=False)
        fwd = ops.launch_counts()
        loss.backward()
        out[str(dev)] = (loss.detach().cpu(),
                         [(path, t.grad) for path, t in unique_leaves(p)],
                         fwd, ops.launch_counts())
    l_cpu, g_cpu, _, _ = out["cpu"]
    l_card, g_card, fwd, total = out[str(cuda_device)]
    assert total == fwd
    assert not any(fwd[k] for k in ("decode_attention",
                                    "paged_decode_attention",
                                    "chunked_prefill_attention")), fwd
    torch.testing.assert_close(l_card, l_cpu, atol=1e-4, rtol=1e-4)
    for (path, gc), (_, gg) in zip(g_cpu, g_card):
        assert (gg is None) == (gc is None), path
        if gc is not None:
            torch.testing.assert_close(gg.cpu(), gc, atol=1e-3, rtol=1e-3,
                                       msg="/".join(path))


def test_moe_sharded_one_nccl_rank_matches_moe_ffn(cuda_device, tmp_path):
    """``moe_ffn_sharded`` on an NCCL group of one rank ((1, 1) mesh: the
    FFN axes' all-gathers and reduce-scatters, the final all-gather, the
    aux mean) against ``moe_ffn`` at E 8, top-2, d 256, bf16: y within the
    bf16 tolerance, no drop on either path, aux equal, every gradient of
    a backward finite."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.models import moe_sharded as MOES
    from repro_torch.models.config import ModelConfig, MoEConfig, \
        repeat_pattern
    cfg = ModelConfig(
        name="moe-card", family="moe", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab=64, dtype="bfloat16",
        block_pattern=repeat_pattern(("moe",), 2),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=512,
                      n_shared_experts=1, capacity_factor=4.0),
        vocab_pad_multiple=8)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        p = MOE.moe_init(gen, cfg, cuda_device)
        x = torch.randn((4, 64, 256), generator=gen, device=cuda_device,
                        dtype=torch.bfloat16)
        with torch.no_grad():
            y_d, aux_d = MOE.moe_ffn(p, cfg, x)
            y_s, aux_s = MOES.moe_ffn_sharded(p, cfg, x, mesh=mesh)
        assert float(aux_d["moe_drop_frac"]) == 0.0
        assert float(aux_s["moe_drop_frac"]) == 0.0
        tol = TOL[torch.bfloat16]
        torch.testing.assert_close(y_s.float(), y_d.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(aux_s["moe_aux"], aux_d["moe_aux"])
        leaves = [p["router"], p["experts_gate"], p["experts_up"],
                  p["experts_down"], *p["shared"].values(), x]
        for w in leaves:
            w.requires_grad_(True)
        y, aux = MOES.moe_ffn_sharded(p, cfg, x, mesh=mesh)
        (y.float().square().mean() + aux["moe_aux"]).backward()
        torch.cuda.synchronize()
        assert all(torch.isfinite(w.grad).all() for w in leaves)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the fused decode step as one CUDA graph (serving/graphs.py): graph against
# eager on the same state for every family the engines serve, launches
# counted once a replay, one capture for each chunk length, sampling
# --------------------------------------------------------------------------

GRAPH_FAMILIES = {
    "dense-contiguous": ("llama3.2-1b", {}),
    "dense-paged-chunk-sharing": ("llama3.2-1b", dict(
        paged=True, page_size=16, prefill_chunk=16, prefill_pack=2,
        prefix_sharing=True)),
    "zamba2-paged": ("zamba2-7b", dict(paged=True)),
    "rwkv6-contiguous": ("rwkv6-1.6b", {}),
    "maverick-contiguous": ("llama4-maverick-400b-a17b", {}),
    "deepseek-contiguous": ("deepseek-v3-671b", {}),
    "vlm-contiguous": ("llama-3.2-vision-90b", {}),
    "fleet": ("llama3.2-1b", dict(
        paged=True, page_size=16, prefill_chunk=16, prefill_pack=2,
        prefix_sharing=True, shards=2)),
}


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def _graph_engine(family, dev, sync_every=4):
    """A smoke engine of ``family`` on ``dev`` with decode under way: some
    slots armed mid-decode and, on the paged rungs, some mid-prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import (EngineConfig, Request, ServingEngine,
                                     ShardedServingEngine)
    arch, kw = GRAPH_FAMILIES[family]
    if arch == "llama-3.2-vision-90b":
        cfg, params, _ = _memory_model(arch, torch.float32)
        params = _to(params, dev)
    else:
        cfg = get_config(arch, "smoke")
        params = _to(Model(cfg, "cpu").init(torch.Generator().manual_seed(1)),
                     dev)
    model = Model(cfg, dev)
    ecfg = EngineConfig(max_batch=4, max_len=128 if kw else 64,
                        sync_every=sync_every, **kw)
    cls = ShardedServingEngine if kw.get("shards", 1) > 1 else ServingEngine
    eng = cls(model, params, ecfg, device=dev)
    rng = np.random.default_rng(10)
    system = rng.integers(2, cfg.vocab, 32).tolist()
    for rid, n in enumerate((5, 19, 30, 9, 3, 14, 27, 40)):
        prompt = rng.integers(2, cfg.vocab, n).tolist()
        if ecfg.prefix_sharing and rid % 2:
            prompt = system + prompt
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=12 + rid))
    while eng.decode_chunks < 2:
        eng.step()
    return model, params, eng


@pytest.mark.parametrize("family", sorted(GRAPH_FAMILIES))
def test_decode_graph_equals_eager(cuda_device, family):
    """From one engine state, on clones: a chunk of ``sync_every`` greedy
    micro-steps through a captured graph and through an eager call of
    ``sampling.fused_decode_steps``: tok_mat, emit_mat, every cache leaf
    (a pool's pages but its trash page) and the allocator equal bit for
    bit."""
    from repro_torch.serving import graphs, sampling
    model, params, eng = _graph_engine(family, cuda_device)
    assert eng.graphs.captured >= 1 and eng.graphs.replays >= 2
    page_size = eng.cfg.page_size if eng.cfg.paged else 0
    freeze = eng.cfg.prefill_chunk is not None
    n = eng.cfg.sync_every
    runs = []
    for graphed in (False, True):
        caches = _clone_tree(eng.caches)
        cur, state = eng.cur_tokens.clone(), _clone_tree(eng.state)
        if graphed:
            step = graphs.DecodeGraphs(model, params, cur, state, None)
            out = step.step(caches, n_steps=n, temperature=0.0,
                            page_size=page_size, freeze_inactive=freeze)
            assert step.captured == step.replays == 1
        else:
            out = sampling.fused_decode_steps(model, params, caches, cur,
                                              state, None, n, 0.0, page_size,
                                              freeze)
        runs.append([t.clone() for t in out] + [cur] + list(
            _leaves_of(state)) + list(_leaves_of(caches)))
    assert bool(runs[0][1].any()), "no slot was decoding"
    assert len(runs[0]) == len(runs[1])
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), i


def _leaves_of(tree, name=None):
    """A tree's tensors in a fixed order; a page pool without its trash
    page (the last), which several writes of one call may hit (its winner
    is undefined on CUDA) and no read sees unmasked."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_of(tree[k], k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves_of(v)
    elif name in ("k_pages", "v_pages"):
        yield tree[:, :-1]
    else:
        yield tree


def test_decode_graph_counts_launches_once_per_replay(cuda_device):
    """A capture counts nothing; each replay adds the launches it makes:
    one paged decode a layer a micro-step, one RMSNorm a norm."""
    from repro_torch.serving import graphs
    model, params, eng = _graph_engine("dense-paged-chunk-sharing",
                                       cuda_device)
    L, n = model.cfg.n_layers, 4
    step = graphs.DecodeGraphs(model, params, eng.cur_tokens.clone(),
                               _clone_tree(eng.state), None)
    caches = _clone_tree(eng.caches)
    ops.reset_launches()
    for replays in (1, 2, 3):
        step.step(caches, n_steps=n, temperature=0.0, page_size=16,
                  freeze_inactive=True)
        counts = ops.launch_counts()
        assert counts["paged_decode_attention"] == replays * L * n
        assert counts["rmsnorm"] == replays * (2 * L + 1) * n
        assert counts["flash_attention"] == 0
    assert step.captured == 1 and step.replays == 3
    (key, rec), = step.launches.items()
    assert key == (n, 0.0, 16, True)
    assert rec["paged_decode_attention"] == L * n


@pytest.mark.parametrize("family", ["dense-contiguous",
                                    "dense-paged-chunk-sharing", "fleet"])
def test_decode_graph_one_capture_per_chunk_length(cuda_device, family,
                                                   monkeypatch):
    """Budgets of 12-19 at ``sync_every`` 8 make chunks of several lengths:
    one graph is captured for each distinct length, and every chunk is a
    replay."""
    model, params, eng = _graph_engine(family, cuda_device, sync_every=8)
    lengths = []
    step = eng.graphs.step

    def logged(caches, n_steps, *args, **kw):
        lengths.append(n_steps)
        return step(caches, n_steps, *args, **kw)

    monkeypatch.setattr(eng.graphs, "step", logged)
    eng.run()
    keys = {k[0] for k in eng.graphs.launches}
    assert len(set(lengths)) >= 2, lengths
    assert set(lengths) <= keys and eng.graphs.captured == len(keys)
    assert eng.graphs.replays == eng.decode_chunks


# sampling at T > 0 through ``DecodeGraphs`` (also the CPU test's, in
# tests/test_torch_decode_graph.py): the chi-square threshold is the
# 1 - 1e-4 quantile of chi-square with V - 1 degrees of freedom
V, T_SAMPLE, SLOTS, N_STEPS, CHUNKS = 16, 0.7, 64, 16, 20
CHI2_Q = 1 - 1e-4


class FixedLogits:
    """A model whose every decode step gives every slot the same logits."""

    def __init__(self, logits):
        self.logits = logits
        self.cfg = types.SimpleNamespace(vocab=logits.shape[-1])

    def decode_step(self, params, caches, tokens):
        caches["t"] += 1
        return self.logits.expand(tokens.shape[0], -1), caches


def sample_counts(device, generator):
    """Draw ``CHUNKS`` chunks of ``N_STEPS`` tokens in ``SLOTS`` slots
    through ``DecodeGraphs`` at ``T_SAMPLE``; returns (counts, the token
    matrices of the first two chunks, the step wrapper)."""
    from repro_torch.serving import graphs, sampling
    logits = torch.linspace(-2.0, 2.0, V, device=device)
    cur = torch.zeros((SLOTS, 1), dtype=torch.int32, device=device)
    state = sampling.init_slot_state(SLOTS, device)
    state["active"].fill_(True)
    state["budget"].fill_(2**30)
    step = graphs.DecodeGraphs(FixedLogits(logits), None, cur, state,
                               generator)
    caches = {"t": torch.zeros((SLOTS,), dtype=torch.int32, device=device),
              "layers": []}
    counts = torch.zeros((V,), dtype=torch.int64, device=device)
    firsts = []
    for _ in range(CHUNKS):
        tok, emit = step.step(caches, n_steps=N_STEPS, temperature=T_SAMPLE)
        assert bool(emit.all())
        counts += torch.bincount(tok.reshape(-1).long(), minlength=V)
        if len(firsts) < 2:
            firsts.append(tok.clone())
    return counts.cpu().numpy(), firsts, step


def chi_square(counts):
    """(statistic, threshold) of the counts against softmax(logits / T)."""
    import scipy.stats
    logits = np.linspace(-2.0, 2.0, V)
    p = np.exp(logits / T_SAMPLE)
    p /= p.sum()
    n = counts.sum()
    stat = float(((counts - n * p) ** 2 / (n * p)).sum())
    return stat, float(scipy.stats.chi2.ppf(CHI2_Q, V - 1))


def test_decode_graph_samples_at_temperature(cuda_device):
    """At T > 0 the engine's generator is registered with the graph: two
    replays of one graph draw different tokens, and 20,480 draws pass the
    CPU test's chi-square test against softmax(logits / T)."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    counts, firsts, step = sample_counts(cuda_device, gen)
    assert step.captured == 1 and step.replays == 20
    assert not torch.equal(firsts[0], firsts[1])
    stat, threshold = chi_square(counts)
    assert stat < threshold, (stat, threshold, counts.tolist())


# --------------------------------------------------------------------------
# the kernels on local shards (sharding.api.local_op) under a mesh: on a
# one-rank NCCL (1, 1) mesh each kernel of the mesh path launches on the
# DTensors' local tensors and equals the bare kernel bit for bit, forward
# and under grad; the paged kernels refuse a DTensor
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """An NCCL group of one rank and its (1, 1) ("data", "model") mesh,
    destroyed (and DTensor's caches cleared) after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    import torch.distributed as dist
    from repro_torch.launch.mesh import forget_groups, make_mesh
    forget_groups()
    store = dist.FileStore(str(tmp_path_factory.mktemp("mesh") / "store"), 1)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()
        forget_groups()


def _local_case(name, dev):
    """(op, arguments, in_axes, out_axes, the kernel's launch count name,
    whether a gradient is taken) for each kernel of the mesh path, at a
    model's layout."""
    rng = np.random.default_rng(7)
    bf16, f32 = torch.bfloat16, torch.float32
    ax4 = ("batch", "heads", None, None)
    kv4 = ("batch", "kv_heads", None, None)
    if name == "flash_attention":
        B, H, Hkv, S, hd = 2, 4, 2, 128, 64
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(
            B, 1)
        args = [_normal(rng, (B, H, S, hd), bf16, dev),
                _normal(rng, (B, Hkv, S, hd), bf16, dev),
                _normal(rng, (B, Hkv, S, hd), bf16, dev), pos, pos]
        return (ops.flash_attention, args,
                [ax4, kv4, kv4, ("batch", None), ("batch", None)], ax4,
                "flash_attention", True)
    if name == "decode_attention":
        B, H, Hkv, W, hd = 4, 8, 2, 96, 64
        k_pos = torch.arange(W, dtype=torch.int32, device=dev)[None].repeat(
            B, 1)
        args = [_normal(rng, (B, H, hd), bf16, dev),
                _normal(rng, (B, Hkv, W, hd), bf16, dev),
                _normal(rng, (B, Hkv, W, hd), bf16, dev),
                torch.full((B,), W - 1, dtype=torch.int32, device=dev),
                k_pos]
        return (ops.decode_attention, args,
                [("batch", "heads", None), kv4, kv4, ("batch",),
                 ("batch", None)], ("batch", "heads", None),
                "decode_attention", False)
    if name in ("rmsnorm", "add_rmsnorm"):
        rows = ("batch", "seq", None)
        x = _normal(rng, (2, 64, 256), bf16, dev)
        scale = 1 + 0.1 * _normal(rng, (256,), bf16, dev)
        if name == "rmsnorm":
            return (lambda x, s: ops.rmsnorm(x, s, 1e-5), [x, scale],
                    [rows, (None,)], rows, "rmsnorm", True)
        d = _normal(rng, (2, 64, 256), bf16, dev)
        return (lambda x, d, s: ops.add_rmsnorm(x, d, s, 1e-5),
                [x, d, scale], [rows, rows, (None,)], (rows, rows),
                "rmsnorm", True)
    if name == "ssd_chunk":
        B, H, nc, cl, P, N = 2, 4, 2, 64, 32, 16
        x = _normal(rng, (B, H, nc, cl, P), f32, dev)
        dt = torch.nn.functional.softplus(
            _normal(rng, (B, H, nc, cl), f32, dev) - 4)
        A = -torch.linspace(1.0, 16.0, H, device=dev)
        bm = _normal(rng, (B, H, nc, cl, N), f32, dev)
        cm = _normal(rng, (B, H, nc, cl, N), f32, dev)
        h5 = ("batch", "heads", None, None, None)
        return (ops.ssd_chunk, [x, dt, A, bm, cm],
                [h5, ("batch", "heads", None, None), ("heads",), h5, h5],
                (h5, h5, ("batch", "heads", None)), "ssd_chunk", True)
    if name == "wkv6":
        B, H, T, hd = 2, 4, 64, 32
        r, k, v = (_normal(rng, (B, H, T, hd), bf16, dev) for _ in range(3))
        w = torch.exp(-torch.exp(-6 + 0.1 * _normal(rng, (B, H, T, hd), f32,
                                                    dev)))
        u = 0.5 * _normal(rng, (H, hd), f32, dev)
        s0 = torch.zeros(B, H, hd, hd, device=dev)
        return (lambda *a: ops.wkv6(*a), [r, k, v, w, u, s0],
                [ax4] * 4 + [("heads", None), ax4], (ax4, ax4), "wkv6",
                True)
    raise KeyError(name)


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "rmsnorm", "add_rmsnorm", "ssd_chunk",
                                  "wkv6"])
def test_local_op_runs_the_kernel_on_the_local_shard(cuda_device,
                                                     one_rank_mesh, name):
    """The kernel through ``sharding.api.local_op`` on (1, 1)-mesh
    DTensors under ``use_sharding``: one launch a call, the DTensor
    result's local tensor bit for bit the bare kernel's, and, where the
    mesh path trains through it, each input's gradient bit for bit the
    bare kernel Function's (the backward on the local shards)."""
    from repro_torch.sharding.api import DTensor, local_op, use_sharding
    from repro_torch.sharding.rules import DEFAULT_RULES
    try:
        from torch.distributed.tensor import Replicate, distribute_tensor
    except ImportError:
        from torch.distributed._tensor import Replicate, distribute_tensor
    mesh = one_rank_mesh
    op, args, in_axes, out_axes, kernel, grad = _local_case(name,
                                                            cuda_device)
    floats = [a.is_floating_point() for a in args]
    bare = [a.detach().clone().requires_grad_(grad and f)
            for a, f in zip(args, floats)]
    dts = [distribute_tensor(a.detach().clone(), mesh,
                             [Replicate(), Replicate()], src_data_rank=None)
           .requires_grad_(grad and f) for a, f in zip(args, floats)]
    with torch.set_grad_enabled(grad):
        want = _outputs(_launched(kernel, lambda: op(*bare)))
        with use_sharding(mesh, DEFAULT_RULES):
            got = _outputs(_launched(
                kernel, lambda: local_op(op, in_axes, out_axes)(*dts)))
    assert all(isinstance(t, DTensor) for t in got)
    for g, w in zip(got, want):
        assert torch.equal(g.to_local(), w)
    if not grad:
        return
    rng = np.random.default_rng(11)
    cots = [_normal(rng, tuple(w.shape), torch.float32, cuda_device)
            for w in want]
    sum((w.float() * c).sum() for w, c in zip(want, cots)).backward()
    with use_sharding(mesh, DEFAULT_RULES):
        sum((g.to_local().float() * c).sum()
            for g, c in zip(got, cots)).backward()
    for a, d, f in zip(bare, dts, floats):
        if f:
            assert d.grad is not None and a.grad is not None
            assert torch.equal(d.grad.to_local(), a.grad), name


def test_paged_kernels_refuse_a_dtensor(cuda_device, one_rank_mesh):
    """The paged decode and chunked prefill kernels (no paged pool runs
    under a mesh) raise on a DTensor operand, as every kernel op does:
    only a ``local_op`` hands a kernel its local tensors."""
    try:
        from torch.distributed.tensor import Replicate, distribute_tensor
    except ImportError:
        from torch.distributed._tensor import Replicate, distribute_tensor
    dev, mesh = cuda_device, one_rank_mesh
    B, H, Hkv, hd, P, ps, M = 2, 4, 2, 64, 8, 16, 4
    q = distribute_tensor(torch.zeros(B, H, hd, dtype=torch.bfloat16,
                                      device=dev), mesh,
                          [Replicate(), Replicate()], src_data_rank=None)
    pages = torch.zeros(Hkv, P + 1, ps, hd, dtype=torch.bfloat16, device=dev)
    tbl = torch.zeros(B, M, dtype=torch.int32, device=dev)
    pos = torch.zeros(B, M * ps, dtype=torch.int32, device=dev)
    before = ops.launch_counts()
    with pytest.raises(TypeError, match="local_op"):
        ops.paged_decode_attention(q, pages, pages, tbl, pos[:, 0], pos)
    q4 = distribute_tensor(torch.zeros(B, H, ps, hd, dtype=torch.bfloat16,
                                       device=dev), mesh,
                           [Replicate(), Replicate()], src_data_rank=None)
    with pytest.raises(TypeError, match="local_op"):
        ops.chunked_prefill_attention(q4, pages, pages, tbl, pos[:, :ps],
                                      pos)
    assert ops.launch_counts() == before
