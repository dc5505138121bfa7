"""Kernel ops with device dispatch: a tensor on the CPU goes to the plain
PyTorch version (``kernels/ref.py``), as does one on the ``meta`` device
(shapes only: ``launch/dryrun.py`` counts the plain path's ops), a tensor
on a CUDA device to the
hand-written kernel — which launches or raises. There is no fallback
from the kernel to the plain version.

Each kernel module keeps a plain-integer launch count (``launches``),
incremented where the kernel is launched and nowhere else, so a run can
show that its main path went through the kernels. A CUDA graph's capture
calls the wrappers but launches nothing, and its replay launches without
calling them: ``recorded_launches`` takes a capture's counts out of the
running count, and ``add_launches`` adds them back once per replay
(``serving/graphs.py``).

Training on the card (``kernels/autograd.py``): a call that needs a
gradient (grad mode on, an input that requires grad) runs
``flash_attention``, the four RMSNorm forms, the SSD chunk and ``wkv6``
through ``torch.autograd.Function``s (the kernel forward, a PyTorch
backward); the serving kernels (``decode_attention``,
``paged_decode_attention``, ``chunked_prefill_attention``) raise there,
never returning a tensor cut from the graph, as does ``wkv6`` asked to
write its state into ``s_out`` (training keeps no state). On the CPU the
plain versions go through autograd as they are.

A DTensor is refused by every op here (``TypeError``): under a sharding
context the models call an op through ``sharding.api.local_op``, which
hands it the local shards and wraps its outputs back.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

try:                                    # torch >= 2.5: public module
    from torch.distributed.tensor import DTensor
except ImportError:                     # older torch
    from torch.distributed._tensor import DTensor

from repro_torch.kernels import autograd as _ag
from repro_torch.kernels import chunked_prefill as _cp
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import wkv6 as _wkv

_KERNELS = {"flash_attention": _fa, "decode_attention": _dec,
            "paged_decode_attention": _pdec,
            "chunked_prefill_attention": _cp, "ssd_chunk": _ssd,
            "wkv6": _wkv, "rmsnorm": _rms}


def _on_cuda(t: torch.Tensor) -> bool:
    if isinstance(t, DTensor):
        # a kernel reads raw pointers: a DTensor's storage is its local
        # shard, so it goes through ``sharding.api.local_op``, never here
        raise TypeError("a kernel op takes the local tensors of a DTensor "
                        "(sharding.api.local_op), not the DTensor")
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):      # meta: shapes only (dry-run)
        return False
    raise ValueError(f"kernel ops run on cpu, meta or cuda, not {t.device}")


def flash_attention(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                    chunk: Optional[int] = None):
    """Prefill attention. q: (B,Hq,Sq,hd); k/v: (B,Hkv,Sk,hd);
    q_pos: (B,Sq); k_pos: (B,Sk). -> (B,Hq,Sq,hd)."""
    if _on_cuda(q):
        if _ag.needs_grad(q, k, v):
            return _ag.FlashAttention.apply(q, k, v, q_pos, k_pos, window,
                                            chunk)
        return _fa.flash_attention(q, k, v, q_pos, k_pos, window, chunk)
    return _ref.flash_attention(q, k, v, q_pos, k_pos, window, chunk)


def decode_attention(q, k, v, q_pos, k_pos, window: Optional[int] = None,
                     chunk: Optional[int] = None):
    """Single-token decode attention over a (B, Hkv, W, *) KV cache view.
    q: (B,Hq,hd); q_pos: (B,); k_pos: (B,W). -> (B,Hq,hd_v)."""
    if _on_cuda(q):
        _ag.refuse_grad("decode_attention", q, k, v)
        return _dec.decode_attention(q, k, v, q_pos, k_pos, window, chunk)
    return _ref.decode_attention(q, k, v, q_pos, k_pos, window, chunk)


def paged_decode_attention(q, k_pages, v_pages, block_tbl, q_pos, k_pos,
                           window: Optional[int] = None,
                           chunk: Optional[int] = None):
    """Single-token decode attention over a paged KV pool.
    q: (B,Hq,hd); k_pages/v_pages: (Hkv,P+1,ps,*) (last page = trash);
    block_tbl: (B,M) int32 (-1 = unmapped); q_pos: (B,); k_pos: (B,M*ps)
    logical. -> (B,Hq,hd_v)."""
    if _on_cuda(q):
        _ag.refuse_grad("paged_decode_attention", q, k_pages, v_pages)
        return _pdec.paged_decode_attention(q, k_pages, v_pages, block_tbl,
                                            q_pos, k_pos, window, chunk)
    return _ref.paged_decode_attention(q, k_pages, v_pages, block_tbl,
                                       q_pos, k_pos, window, chunk)


def chunked_prefill_attention(q, k_pages, v_pages, block_tbl, q_pos, k_pos,
                              window: Optional[int] = None,
                              chunk: Optional[int] = None):
    """A chunk of S prompt queries per slot over its paged history (the
    chunk's keys already written). q: (B,Hq,S,hd); q_pos: (B,S) (-1 =
    pad); the pool, table and k_pos as ``paged_decode_attention``.
    -> (B,Hq,S,hd_v)."""
    if _on_cuda(q):
        _ag.refuse_grad("chunked_prefill_attention", q, k_pages, v_pages)
        return _cp.chunked_prefill_attention(q, k_pages, v_pages, block_tbl,
                                             q_pos, k_pos, window, chunk)
    return _ref.chunked_prefill_attention(q, k_pages, v_pages, block_tbl,
                                          q_pos, k_pos, window, chunk)


def mla_decode_attention(q_lat, q_rope, ckv, k_rope, q_pos, k_pos,
                         window: Optional[int] = None,
                         chunk: Optional[int] = None,
                         qk_dim: Optional[int] = None):
    """MLA-absorbed decode as MQA decode over the latent cache (the port of
    the reference's ``ops.mla_decode_attention``).

    q_lat: (B,H,kvr) latent queries (q_nope @ w_uk); q_rope: (B,H,r);
    ckv: (B,W,kvr); k_rope: (B,W,r). Returns o_lat (B,H,kvr), the latent
    attention output (the caller applies w_uv). Exact: scores = q_lat.ckv
    + q_rope.k_rope, softmax, value = ckv, i.e. one kv head of dim kvr+r
    with a kvr-dim value. ``decode_attention`` scales by 1/sqrt(kvr+r);
    MLA wants 1/sqrt(``qk_dim``) (nope + rope), so q is pre-scaled by
    sqrt(kvr+r)/sqrt(qk_dim)."""
    q = torch.cat([q_lat, q_rope], dim=-1)                # (B,H,kvr+r)
    k = torch.cat([ckv, k_rope], dim=-1)[:, None]         # (B,1,W,kvr+r)
    v = ckv[:, None]                                      # (B,1,W,kvr)
    d = q.shape[-1]
    q = q * (math.sqrt(d) / math.sqrt(d if qk_dim is None else qk_dim))
    return decode_attention(q, k, v, q_pos, k_pos, window, chunk)


def ssd_chunk(x, dt, A, Bm, Cm
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD within-chunk outputs (y_intra, h_chunk, decay), float32, in
    the kernel layout: x (B,H,nc,cl,P), dt (B,H,nc,cl), A (H,), Bm/Cm
    (B,H,nc,cl,N) (``ssd.ssd_chunk``)."""
    if _on_cuda(x):
        if _ag.needs_grad(x, dt, A, Bm, Cm):
            return _ag.SSDChunk.apply(x, dt, A, Bm, Cm)
        return _ssd.ssd_chunk(x, dt, A, Bm, Cm)
    return _ref.ssd_chunk(x, dt, A, Bm, Cm)


def ssd_scan(x, dt, A, Bm, Cm, h0: Optional[torch.Tensor] = None,
             chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Mamba2 SSD over a sequence (the port of the reference's
    ``ops.ssd_scan``). x: (B,T,H,P); dt: (B,T,H); A: (H,) float32;
    Bm/Cm: (B,T,H,N) (a head stride of 0 broadcasts one group); h0:
    (B,H,P,N) or None. Returns y (B,T,H,P) and the final state (B,H,P,N),
    float32.

    The chunk length is ``min(chunk, T)``; T is padded to a multiple of it
    with dt = 0 steps, which change nothing. The within-chunk part runs in
    the kernel layout (B,H,nc,cl,*) — permuted views, no copies — through
    ``ssd_chunk``; the cross-chunk recurrence and ``y_cross`` run here."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    cl = min(chunk, T)
    pad = (-T) % cl
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (T + pad) // cl
    xk = x.reshape(B, nc, cl, H, P).permute(0, 3, 1, 2, 4)
    dtk = dt.reshape(B, nc, cl, H).permute(0, 3, 1, 2)
    Bk = Bm.reshape(B, nc, cl, H, N).permute(0, 3, 1, 2, 4)
    Ck = Cm.reshape(B, nc, cl, H, N).permute(0, 3, 1, 2, 4)
    y_intra, h_chunk, dec = ssd_chunk(xk, dtk, A, Bk, Ck)

    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for c in range(nc):                 # state entering each chunk
        h_in.append(h)
        h = dec[:, :, c, None, None] * h + h_chunk[:, :, c]
    h_in = torch.stack(h_in, dim=2)                       # (B,H,nc,P,N)
    cum = torch.cumsum(dtk.float() * A.float()[None, :, None, None], dim=-1)
    y_cross = (Ck.float() * torch.exp(cum)[..., None]) @ \
        h_in.transpose(-1, -2)                            # (B,H,nc,cl,P)
    y = (y_intra + y_cross).permute(0, 2, 3, 1, 4).reshape(B, T + pad, H, P)
    return y[:, :T], h


def wkv6(r, k, v, w, u, s0, s_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence (the port of the reference's ``ops.wkv6``).
    r/k/v/w: (B,H,T,hd), any (b, h, t) strides; u: (H,hd); s0:
    (B,H,hd,hd) float32. Returns (out (B,H,T,hd), s_final (B,H,hd,hd)),
    float32. ``s_out``, if given, receives the final state (it may be
    ``s0``: the state is updated in place) and is returned. On the card
    ``s0`` must be float32, and ``w`` and ``u`` float32 or the type of
    ``r``: the kernel widens them on load and never casts the decay down."""
    if _on_cuda(r):
        if _ag.needs_grad(r, k, v, w, u, s0):
            if s_out is not None:
                raise RuntimeError(
                    "wkv6: an input requires grad and s_out is given; "
                    "training keeps no state (pass s_out=None)")
            return _ag.WKV6.apply(r, k, v, w, u, s0)
        return _wkv.wkv6(r, k, v, w, u, s0, s_out)
    return _plain_wkv6(r, k, v, w, u, s0, s_out)


def _plain_wkv6(r, k, v, w, u, s0, s_out=None):
    """``ref.wkv6`` with ``ops.wkv6``'s ``s_out``."""
    out, S = _ref.wkv6(r, k, v, w, u, s0)
    if s_out is None:
        return out, S
    return out, s_out.copy_(S)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim (the port of the reference's
    ``ops.rmsnorm``): leading dims are flattened into rows, statistics in
    float32, output in ``x.dtype``."""
    if _on_cuda(x):
        if _ag.needs_grad(x, scale):
            return _ag.RMSNorm.apply(x, scale, eps)
        return _rms.rmsnorm(x.reshape(-1, x.shape[-1]), scale,
                            eps).reshape(x.shape)
    return _ref.rmsnorm(x, scale, eps)


def add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the RMSNorm of its result, one kernel launch
    on the card: returns (s, y) with s = x + delta (in ``x.dtype``) and y =
    rmsnorm(s), both of x's shape."""
    if _on_cuda(x):
        if _ag.needs_grad(x, delta, scale):
            return _ag.AddRMSNorm.apply(x, delta, scale, eps)
        d = x.shape[-1]
        s, y = _rms.add_rmsnorm(x.reshape(-1, d), delta.reshape(-1, d),
                                scale, eps)
        return s.view(x.shape), y.view(x.shape)
    return _ref.add_rmsnorm(x, delta, scale, eps)


def cat_rmsnorm(x: torch.Tensor, e: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5, delta: Optional[torch.Tensor] = None):
    """RMSNorm of concat([x, e], -1) without forming it in memory on the
    card; with ``delta``, of concat([x + delta, e]), returning (x + delta,
    y). y has x's leading dims and width d1 + d2."""
    if not _on_cuda(x):
        return _ref.cat_rmsnorm(x, e, scale, eps, delta)
    if _ag.needs_grad(x, e, scale, delta):
        return _ag.CatRMSNorm.apply(x, e, scale, eps, delta)
    d1, d2 = x.shape[-1], e.shape[-1]
    shape = x.shape[:-1] + (d1 + d2,)
    rows = (x.reshape(-1, d1), e.reshape(-1, d2), scale, eps)
    if delta is None:
        return _rms.cat_rmsnorm(*rows).view(shape)
    s, y = _rms.cat_rmsnorm(*rows, delta.reshape(-1, d1))
    return s.view(x.shape), y.view(shape)


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float, dtype: torch.dtype) -> torch.Tensor:
    """Mamba2's gated RMSNorm: rmsnorm((y * silu(z)).to(dtype)), one
    kernel launch on the card (y and z float32 there)."""
    if _on_cuda(y):
        if _ag.needs_grad(y, z, scale):
            return _ag.GatedRMSNorm.apply(y, z, scale, eps, dtype)
        d = y.shape[-1]
        return _rms.gated_rmsnorm(y.reshape(-1, d), z.reshape(-1, d), scale,
                                  eps, dtype).view(y.shape)
    return _ref.gated_rmsnorm(y, z, scale, eps, dtype)


# the ops a card check swaps (``swapped``): the memory-conditioned
# families' path runs these four and no other kernel; the recurrent
# families' train path adds these four (``ssd_scan`` calls ``ssd_chunk``)
SWAPPABLE = ("flash_attention", "decode_attention", "rmsnorm", "add_rmsnorm")
RECURRENT = ("ssd_chunk", "wkv6", "cat_rmsnorm", "gated_rmsnorm")


@contextlib.contextmanager
def swapped(make, names=SWAPPABLE):
    """Within: each op ``name`` of ``names`` is ``make(name, op, plain)``,
    ``op`` the dispatching op above and ``plain`` its plain version
    (``kernels/ref.py``); restored on exit. The models look these ops up
    here at each call, so a check can run the plain versions on the card,
    or hold each kernel call against its plain version on the same
    inputs."""
    saved = {n: globals()[n] for n in names}
    for n in names:
        plain = _plain_wkv6 if n == "wkv6" else getattr(_ref, n)
        globals()[n] = make(n, saved[n], plain)
    try:
        yield
    finally:
        globals().update(saved)


def reset_launches() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


@contextlib.contextmanager
def recorded_launches():
    """Within: the launches counted are taken out of the running count on
    exit and left in the yielded dict, kernel name -> launches (a CUDA
    graph's capture, whose kernels run at each replay)."""
    before = launch_counts()
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        for name, mod in _KERNELS.items():
            recorded[name] = mod.launches - before[name]
            mod.launches = before[name]


def add_launches(recorded: Dict[str, int]) -> None:
    """Count ``recorded`` launches (one replay of a captured graph)."""
    for name, n in recorded.items():
        _KERNELS[name].launches += n


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}
