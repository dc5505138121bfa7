"""The kernels' gradients on the card: ``torch.autograd.Function``s whose
forward is the hand-written CUDA kernel and whose backward is PyTorch.

Every kernel is launched through ``ctypes`` on raw pointers, so its
output carries no ``grad_fn``: a train step through the bare kernels
would cut the gradient at each attention call and each norm without an
error. ``kernels/ops.py`` therefore sends a call on the card that needs a
gradient (grad mode on, an input that requires grad) here, and makes
every other kernel op raise in that case.

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

Why these products stay ``torch.matmul``: the JAX package has no
backward kernel (no ``custom_vjp`` in it); XLA derives its gradients
outside any Pallas kernel, so there is no TPU kernel here to port. A
hand-written backward kernel (which needs exactly this saved lse) is
queued (ROADMAP Queue 2).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rms

BWD_BLOCK_BYTES = 1 << 30      # float32 scores of one block of query rows


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
            "rmsnorm, add_rmsnorm) or run under torch.no_grad()")


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
