"""The kernels' gradients on the card: ``torch.autograd.Function``s whose
forward is the hand-written CUDA kernel and whose backward is PyTorch.

Every kernel is launched through ``ctypes`` on raw pointers, so its
output carries no ``grad_fn``: a train step through the bare kernels
would cut the gradient at each attention call, norm and scan without an
error. ``kernels/ops.py`` therefore sends a call on the card that needs a
gradient (grad mode on, an input that requires grad) here. Every kernel
on a ``train`` forward has a Function; the three serving kernels (both
decode kernels and chunked prefill) raise in that case.

* ``FlashAttention``: the flash kernel, asked for each query row's
  logsumexp (``lse``); its backward is FlashAttention-2's gradient from
  the saved q, k, v and lse: ``P = exp(S * scale - lse)`` on the valid
  pairs (the kernel's window, chunk and ``-1`` positions), ``dV = Pᵀ
  dO``, ``D = rowsum(dO ∘ O)``, ``dS = P ∘ (dO Vᵀ - D)``, ``dQ = dS K *
  scale``, ``dK = dSᵀ Q * scale``, in float32, summed over each kv
  head's group of q heads. O in ``D`` is ``P V`` recomputed in float32,
  not the kernel's bf16 output: the rounded output moves ``D`` of the
  rows with few keys (|O| ~ |V|) by a bf16 ulp of a sum of hd terms,
  which put dQ past ``TOL_WIDE`` against the float32 plain version. A row that sees no key has lse = +inf and
  takes no gradient (the kernel's output there is 0). The products run
  in blocks of query rows, each block's float32 scores at most
  ``BWD_BLOCK_BYTES``. A strided kv view (``attention.kernel_head_group``)
  is an input as it is: autograd carries its gradient into the tensor it
  views.
* ``RMSNorm`` and ``AddRMSNorm``: the norm kernel (with the residual add
  in the same launch); the backward recomputes each row's rstd in
  float32 from the saved row: with n = x * rstd and g = dy * scale,
  ``dx = rstd * (g - n * mean(g * n))`` and ``dscale = sum_rows(dy *
  n)``; the residual sum's gradient adds to dx and passes to both of
  ``add_rmsnorm``'s inputs.
* ``CatRMSNorm`` and ``GatedRMSNorm``: the norm kernel over the row it
  forms, [x (+ delta) | e] (Zamba2's shared block) or (y * silu(z)) cast
  to ``dtype`` (Mamba2's gate); the backward is ``rmsnorm_backward`` over
  that row, recomputed: the concat's gradient splits into x and e (the
  residual sum's gradient added to x's, as ``AddRMSNorm``), the gate's
  passes the cast (rounded to the row's type, as autograd keeps a
  gradient) into y and, through silu's derivative, z.
* ``SSDChunk``: the Mamba2 SSD chunk kernel (``y_intra``, ``h_chunk``,
  ``decay``); ``ssd_chunk_backward`` recomputes each chunk's float32
  cumsum, decay matrix and C·Bᵀ and takes the gradient of all three
  outputs (``ops.ssd_scan``'s cross-chunk recurrence reads the state and
  decay), chunk by chunk in parallel, in blocks of heads.
* ``WKV6``: the RWKV6 recurrence kernel; ``wkv6_backward`` recomputes the
  states S_{t-1} forward from ``s0`` (never back from S_t: w_t may be
  ~1e-10), then walks time backward with the state's gradient G_{t-1} =
  w_t ∘ G_t + r_t do_tᵀ, and forms dr, dk, dv, dw and du from S and G
  in batched products, a block of time steps at once. Each walk is one
  ``addcmul`` launch a time step, onto the step's outer products formed
  in one launch beforehand.

Why these backwards stay PyTorch: the JAX package has no backward
kernel (no ``custom_vjp`` in it); XLA derives its gradients outside any
Pallas kernel, so there is no TPU kernel here to port. Hand-written
backward kernels (attention's needs exactly this saved lse; WKV6's walks
launch per time step) are queued (ROADMAP Queue 2).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import wkv6 as _wkv

# float32 scores of one block of query rows (attention), float32 (cl, cl)
# matrices of one block of heads (SSD), float32 states of one block of
# time steps (WKV6)
BWD_BLOCK_BYTES = 1 << 30


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Grad mode is on and some input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where the kernel ``name`` would be asked for a gradient it
    does not have, instead of returning a detached tensor."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            "grad; train through ops that have one (flash_attention, "
            "rmsnorm, add_rmsnorm, cat_rmsnorm, gated_rmsnorm, ssd_scan, "
            "wkv6) or run under torch.no_grad()")


def flash_backward(q, k, v, lse, dout, q_pos, k_pos,
                   window: Optional[int], chunk: Optional[int],
                   block_bytes: int = BWD_BLOCK_BYTES
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of flash attention from the forward's
    inputs and row logsumexp; shapes and types of q, k, v."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)                           # (B,Hkv,Sk,hd)
    qf = q.to(f32).reshape(B, Hkv, G, Sq, hd)
    dof = dout.to(f32).reshape(B, Hkv, G, Sq, hd)
    lse = lse.reshape(B, Hkv, G, Sq)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    n = max(1, min(Sq, block_bytes // max(1, B * Hq * Sk * 4)))
    for s0 in range(0, Sq, n):
        sl = slice(s0, min(Sq, s0 + n))
        m = sl.stop - sl.start
        qb = qf[:, :, :, sl].reshape(B, Hkv, G * m, hd)
        dob = dof[:, :, :, sl].reshape(B, Hkv, G * m, hd)
        ok = _ref.attention_mask(q_pos[:, None, None, sl, None],
                                 k_pos[:, None, None, None, :], window, chunk)
        # P in place over the scores: each pass over (B, Hq, m, Sk) float32
        # is the backward's largest cost after the products
        p = (qb @ kf.transpose(-1, -2)).view(B, Hkv, G, m, Sk)
        p.mul_(scale).sub_(lse[..., sl, None]).exp_().masked_fill_(~ok, 0.0)
        p = p.view(B, Hkv, G * m, Sk)
        D = (dob * (p @ vf)).sum(-1, keepdim=True)          # rowsum(dO ∘ O)
        ds = (dob @ vf.transpose(-1, -2)).sub_(D).mul_(p)
        dq[:, :, :, sl] = (ds @ kf).view(B, Hkv, G, m, hd) * scale
        dk += (ds.transpose(-1, -2) @ qb) * scale
        dv += p.transpose(-1, -2) @ dob
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """The flash kernel with a gradient (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, window, chunk):
        B, Hq, Sq, _ = q.shape
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        out = _fa.flash_attention(q, k, v, q_pos, k_pos, window, chunk,
                                  lse=lse)
        ctx.save_for_backward(q, k, v, lse, q_pos, k_pos)
        ctx.window, ctx.chunk = window, chunk
        ctx.mark_non_differentiable(lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse, q_pos, k_pos = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, lse, dout, q_pos, k_pos,
                                    ctx.window, ctx.chunk)
        return dq, dk, dv, None, None, None, None


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx float32, dscale in scale's type) of y = rmsnorm(x) * scale
    over the last dim, rstd recomputed in float32 from the row x."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    nrm = xf * rstd
    dyf = dy.float()
    g = dyf * scale.float()
    dx = rstd * (g - nrm * torch.mean(g * nrm, dim=-1, keepdim=True))
    dscale = (dyf * nrm).reshape(-1, x.shape[-1]).sum(0)
    return dx, dscale.to(scale.dtype)


class RMSNorm(torch.autograd.Function):
    """The norm kernel over the rows of x (..., d), with a gradient."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        y = _rms.rmsnorm(x.reshape(-1, x.shape[-1]), scale, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, dy, ctx.eps)
        return dx.to(x.dtype), dscale, None


class AddRMSNorm(torch.autograd.Function):
    """The residual add and the norm of its sum in one kernel launch:
    (s, y) = (x + delta, rmsnorm(x + delta)), with a gradient."""

    @staticmethod
    def forward(ctx, x, delta, scale, eps):
        d = x.shape[-1]
        s, y = _rms.add_rmsnorm(x.reshape(-1, d), delta.reshape(-1, d),
                                scale, eps)
        s, y = s.view(x.shape), y.view(x.shape)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        ctx.dtypes = (x.dtype, delta.dtype)
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(s, scale, dy, ctx.eps)
        dx = dx + ds.float()
        return (dx.to(ctx.dtypes[0]), dx.to(ctx.dtypes[1]), dscale, None)


def cat_rmsnorm_backward(x: torch.Tensor, e: torch.Tensor,
                         scale: torch.Tensor, dy: torch.Tensor, eps: float,
                         ds: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx float32, de float32, dscale in scale's type) of y =
    rmsnorm([x | e]) * scale: ``rmsnorm_backward`` over the concatenated
    row, its gradient in the row's type (as autograd keeps it), split.
    ``x`` is the row's first segment as the norm read it (x + delta in the
    add form), and ``ds``, the gradient of that residual sum where it is
    an output too, adds to dx."""
    row = torch.cat([x, e], dim=-1)
    drow, dscale = rmsnorm_backward(row, scale, dy, eps)
    drow = drow.to(row.dtype).float()
    d1 = x.shape[-1]
    dx, de = drow[..., :d1], drow[..., d1:]
    if ds is not None:
        dx = dx + ds.float()
    return dx, de, dscale


def gated_rmsnorm_backward(y: torch.Tensor, z: torch.Tensor,
                           scale: torch.Tensor, dout: torch.Tensor,
                           eps: float, dtype: torch.dtype
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dy, dz float32, dscale in scale's type) of out = rmsnorm((y *
    silu(z)).to(dtype)) * scale, y and z float32: ``rmsnorm_backward``
    over the recomputed row g; g's gradient in g's type (``dtype``, as
    autograd keeps it), then through the product and silu'(z) = σ(z) (1 +
    z (1 - σ(z)))."""
    sig = torch.sigmoid(z)
    g = (y * (z * sig)).to(dtype)
    dg, dscale = rmsnorm_backward(g, scale, dout, eps)
    dg = dg.to(dtype).float()
    return (dg * z * sig, dg * y * sig * (1 + z * (1 - sig)), dscale)


class CatRMSNorm(torch.autograd.Function):
    """The norm kernel over [x | e] (rows of x (..., d1), e (..., d2)), or
    with ``delta`` over [x + delta | e] returning (x + delta, y), with a
    gradient."""

    @staticmethod
    def forward(ctx, x, e, scale, eps, delta=None):
        d1, d2 = x.shape[-1], e.shape[-1]
        shape = x.shape[:-1] + (d1 + d2,)
        rows = (x.reshape(-1, d1), e.reshape(-1, d2), scale, eps)
        ctx.eps = eps
        ctx.dtypes = (x.dtype, e.dtype,
                      None if delta is None else delta.dtype)
        if delta is None:
            y = _rms.cat_rmsnorm(*rows).view(shape)
            ctx.save_for_backward(x, e, scale)
            return y
        s, y = _rms.cat_rmsnorm(*rows, delta.reshape(-1, d1))
        s = s.view(x.shape)
        ctx.save_for_backward(s, e, scale)
        return s, y.view(shape)

    @staticmethod
    def backward(ctx, *grads):
        s, e, scale = ctx.saved_tensors
        ds, dy = (None, grads[0]) if len(grads) == 1 else grads
        dx, de, dscale = cat_rmsnorm_backward(s, e, scale, dy, ctx.eps, ds)
        tx, te, td = ctx.dtypes
        return (dx.to(tx), de.to(te), dscale, None,
                None if td is None else dx.to(td))


class GatedRMSNorm(torch.autograd.Function):
    """The norm kernel over (y * silu(z)) cast to ``dtype`` (rows of y, z
    (..., d) float32), with a gradient."""

    @staticmethod
    def forward(ctx, y, z, scale, eps, dtype):
        d = y.shape[-1]
        out = _rms.gated_rmsnorm(y.reshape(-1, d), z.reshape(-1, d), scale,
                                 eps, dtype).view(y.shape)
        ctx.save_for_backward(y, z, scale)
        ctx.eps, ctx.dtype = eps, dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        y, z, scale = ctx.saved_tensors
        dy, dz, dscale = gated_rmsnorm_backward(y, z, scale, dout, ctx.eps,
                                                ctx.dtype)
        return dy.to(y.dtype), dz.to(z.dtype), dscale, None, None


def ssd_chunk_backward(x, dt, A, Bm, Cm, dy, dh, ddec,
                       needs=(True,) * 5,
                       block_bytes: int = BWD_BLOCK_BYTES):
    """The gradients (dx, ddt, dA, dB, dC) of ``ssd_chunk``'s three outputs
    (y_intra, h_chunk, decay; any of dy, dh, ddec None: no gradient) from
    its inputs, in their types (None where ``needs`` is False). Per chunk,
    with cum the prefix sum of a = dt A, W[t, s] = exp(cum_t - cum_s) for
    s <= t (0 above), M = C Bᵀ ∘ W, xdt = x dt and emit_s = exp(cum_last -
    cum_s): dM = dy xdtᵀ; dxdt = Mᵀ dy + emit ∘ (B dhᵀ); dC = (dM ∘ W) B;
    dB = (dM ∘ W)ᵀ C + emit ∘ (xdt dh); dcum = rowsum(dM ∘ M) -
    colsum(dM ∘ M) - emit ∘ rowsum(xdt ∘ B dhᵀ), plus that sum and ddec ·
    decay at the last step; da = the reverse cumulative sum of dcum; ddt =
    da A + rowsum(dxdt ∘ x), dA = the sum of da dt, dx = dxdt dt. All in
    float32, in blocks of heads whose (cl, cl) matrices are at most
    ``block_bytes`` each."""
    B, H, nc, cl, P = x.shape
    f32 = torch.float32
    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    per_head = B * nc * cl * cl * 4
    n = max(1, min(H, block_bytes // per_head))
    outs = [[] for _ in range(5)]
    for h0 in range(0, H, n):
        hs = slice(h0, min(H, h0 + n))
        xf, dtf, Bf, Cf = (t[:, hs].to(f32) for t in (x, dt, Bm, Cm))
        a = dtf * A[hs].to(f32)[None, :, None, None]
        cum = torch.cumsum(a, dim=-1)                      # (B,h,nc,cl)
        xdt = xf * dtf[..., None]
        W = (cum[..., :, None] - cum[..., None, :]).masked_fill_(
            ~tri, -math.inf).exp_()                        # (B,h,nc,t,s)
        M = (Cf @ Bf.transpose(-1, -2)).mul_(W)
        dxdt = torch.zeros_like(xf)
        dBf = torch.zeros_like(Bf)
        dcum = torch.zeros_like(cum)
        dC = None
        if dy is not None:
            dyf = dy[:, hs].to(f32)
            dM = dyf @ xdt.transpose(-1, -2)
            dxdt += M.transpose(-1, -2) @ dyf
            Q = dM * M
            dcum += Q.sum(-1) - Q.sum(-2)
            Q = None
            dM.mul_(W)                                     # d(C Bᵀ)
            if needs[4]:
                dC = dM @ Bf
            dBf += dM.transpose(-1, -2) @ Cf
            dM = None
        W = M = None
        if dh is not None:
            dhf = dh[:, hs].to(f32)                        # (B,h,nc,P,N)
            emit = torch.exp(cum[..., -1:] - cum)          # (B,h,nc,cl)
            Bdh = Bf @ dhf.transpose(-1, -2)               # (B,h,nc,cl,P)
            dxdt += emit[..., None] * Bdh
            dBf += emit[..., None] * (xdt @ dhf)
            demit = (xdt * Bdh).sum(-1) * emit
            dcum -= demit
            dcum[..., -1] += demit.sum(-1)
        if ddec is not None:
            dcum[..., -1] += ddec[:, hs].to(f32) * torch.exp(cum[..., -1])
        da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
        grads = (dxdt * dtf[..., None],
                 da * A[hs].to(f32)[None, :, None, None]
                 + (dxdt * xf).sum(-1),
                 (da * dtf).sum((0, 2, 3)), dBf,
                 torch.zeros_like(Cf) if dC is None else dC)
        for out, g, need in zip(outs, grads, needs):
            if need:
                out.append(g)
    return tuple(
        torch.cat(out, dim=0 if i == 2 else 1).to(t.dtype) if need else None
        for i, (out, t, need) in enumerate(zip(outs, (x, dt, A, Bm, Cm),
                                               needs)))


class SSDChunk(torch.autograd.Function):
    """The SSD chunk kernel (x, dt, A, Bm, Cm in ``ssd.ssd_chunk``'s
    layout) -> (y_intra, h_chunk, decay), with a gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        out = _ssd.ssd_chunk(x, dt, A, Bm, Cm)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy, dh, ddec):
        return ssd_chunk_backward(*ctx.saved_tensors, dy, dh, ddec,
                                  needs=ctx.needs_input_grad)


def wkv6_backward(r, k, v, w, u, s0, dout, dS, needs=(True,) * 6,
                  block_bytes: int = BWD_BLOCK_BYTES):
    """The gradients (dr, dk, dv, dw, du, ds0) of ``wkv6``'s (out, S_final)
    (dout or dS None: no gradient) in the inputs' types (None where
    ``needs`` is False). With S_{t-1} the state entering step t (S_{-1} =
    s0) and G_t the gradient of S_t (G_{T-1} = dS, G_{t-1} = w_t ∘ G_t +
    r_t do_tᵀ): dr_t = S_{t-1} do_t + u ∘ k_t (v_t · do_t); dk_t = G_t v_t
    + r_t ∘ u (v_t · do_t); dv_t = G_tᵀ k_t + do_t (Σ r_t ∘ u ∘ k_t); dw_t
    = rowsum(G_t ∘ S_{t-1}); du = Σ_{b,t} r_t ∘ k_t (v_t · do_t); ds0 =
    G_{-1}. Float32; the states are recomputed forward from s0 and held
    for the whole sequence (T (B, H, hd, hd) float32), G a block of at most
    ``block_bytes`` of time steps at once."""
    B, H, T, hd = r.shape
    f32 = torch.float32
    # time-major float32 copies: (T, B, H, hd)
    rt, kt, vt, wt = (a.to(f32).permute(2, 0, 1, 3).contiguous()
                      for a in (r, k, v, w))
    dot = (torch.zeros_like(rt) if dout is None else
           dout.to(f32).permute(2, 0, 1, 3).contiguous())
    uf = u.to(f32)
    w4 = wt.unsqueeze(-1).unbind(0)                        # (B,H,hd,1) a step
    # S[t] = S_{t-1}: the products k_t v_tᵀ in one launch, then one
    # addcmul a step adds w_t ∘ S_{t-1} to them
    S = torch.empty((T, B, H, hd, hd), dtype=f32, device=r.device)
    S[0] = s0
    torch.mul(kt[:-1, ..., None], vt[:-1, :, :, None, :], out=S[1:])
    Ss = S.unbind(0)
    for t in range(T - 1):
        Ss[t + 1].addcmul_(w4[t], Ss[t])
    vdo = (vt * dot).sum(-1, keepdim=True)                 # (T,B,H,1)
    ruk = rt * uf * kt
    dr = (S @ dot[..., None])[..., 0] + uf * kt * vdo
    dk = rt * uf * vdo
    dv = dot * ruk.sum(-1, keepdim=True)
    dw = torch.empty_like(wt)
    du = (rt * kt * vdo).sum((0, 1))                       # (H,hd)
    G = (torch.zeros_like(S[0]) if dS is None else
         dS.to(f32).clone())                               # G_{T-1}
    n = max(1, min(T, block_bytes // (B * H * hd * hd * 4)))
    for t1 in range(T, 0, -n):
        t0 = max(0, t1 - n)
        # Gb[j] = G_{t0+j}: the products r_t do_tᵀ (t = t0+1 .. t1-1) in one
        # launch, then one addcmul a step adds w_t ∘ G_t to them
        Gb = torch.empty((t1 - t0,) + G.shape, dtype=f32, device=r.device)
        torch.mul(rt[t0 + 1:t1, ..., None], dot[t0 + 1:t1, :, :, None, :],
                  out=Gb[:-1])
        Gb[-1] = G
        Gs = Gb.unbind(0)
        for j in range(t1 - t0 - 2, -1, -1):
            Gs[j].addcmul_(w4[t0 + j + 1], Gs[j + 1])
        if t0 or needs[5]:                                 # G_{t0-1}
            G = torch.addcmul(rt[t0, ..., None] * dot[t0, :, :, None, :],
                              w4[t0], Gb[0])
        dk[t0:t1] += (Gb @ vt[t0:t1, ..., None])[..., 0]
        dv[t0:t1] += (Gb.transpose(-1, -2) @ kt[t0:t1, ..., None])[..., 0]
        dw[t0:t1] = (Gb * S[t0:t1]).sum(-1)
        Gb = None

    def back(g, like):
        return g.permute(1, 2, 0, 3).to(like.dtype)

    grads = (back(dr, r), back(dk, k), back(dv, v), back(dw, w),
             du.to(u.dtype), G.to(s0.dtype) if needs[5] else None)
    return tuple(g if need else None for g, need in zip(grads, needs))


class WKV6(torch.autograd.Function):
    """The WKV6 kernel (``wkv6.wkv6``'s inputs, no ``s_out``) -> (out,
    S_final), with a gradient."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        out, S = _wkv.wkv6(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return out, S

    @staticmethod
    def backward(ctx, dout, dS):
        return wkv6_backward(*ctx.saved_tensors, dout, dS,
                             needs=ctx.needs_input_grad)
