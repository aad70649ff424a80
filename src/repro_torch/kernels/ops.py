"""Public kernel entry points — the names of ``repro/kernels/ops.py``, on
top of the hand-written Hopper kernels (``block_gemm``, ``trsm``,
``rmsnorm``, ``flash_attention``, and the backward kernels
``rmsnorm_bwd`` and ``flash_attention_bwd``).

Every op takes leading batch dims. A CPU tensor runs the kernel's plain
PyTorch version, a CUDA tensor the kernel; the JAX package's
interpret-mode switch has no counterpart, because the tensor's device
decides.

:func:`rmsnorm` and :func:`flash_attention` are differentiable. When an
input needs a gradient they run as ``torch.autograd.Function`` objects: the
forward kernel (flash with its log-sum-exp output on), and the backward
kernel in the backward pass — on a CPU tensor the plain versions of
both. When none does (serving, ``torch.no_grad``) they call the forward
kernel exactly as before, and the log-sum-exp is not written."""
from __future__ import annotations

import torch

from .block_gemm import block_gemm as _block_gemm
from .block_gemm import blocked_gemm
from .flash_attention import flash_attention as _flash_attention
from .flash_attention_bwd import flash_attention_bwd as _flash_attention_bwd
from .rmsnorm import rmsnorm as _rmsnorm
from .rmsnorm_bwd import rmsnorm_bwd as _rmsnorm_bwd
from .trsm import trsm as _trsm

__all__ = ["block_gemm", "block_gemm_acc", "flash_attention", "rmsnorm",
           "trsm", "pselinv_level_gemm", "pselinv_round_gemm"]


def block_gemm(a, b):
    return _block_gemm(a, b)


def block_gemm_acc(acc, a, b, alpha=-1.0):
    """acc + alpha·(a@b) — the Schur-update form used by supernodal LU."""
    return acc + _block_gemm(a, b, alpha=alpha)


def pselinv_level_gemm(Ainv, Uh_m, out=None):
    """The sweep's masked block-GEMM for one elimination-tree level:
    ``partial[…, k, i] = Σ_j Ainv[…, i, j] @ Uh_m[…, k, j]ᵀ`` — all of a
    level's supernodes, for every leading (batch, rank) index, in one
    kernel launch.

    Ainv: (…, nbr, nbc, b, b) local A⁻¹ block grids; Uh_m: (…, nk, nbc,
    b, b) struct-masked Û stacks. Returns (…, nk, nbr, b, b) partial
    products, written into ``out`` when given (e.g. a view of the sweep's
    arena). The leading dims are flattened into the kernel's batch index
    as views, so a strided arena slice is read where it lies."""
    lead = Ainv.shape[:-4]
    nbr, nbc, b = Ainv.shape[-4], Ainv.shape[-3], Ainv.shape[-1]
    nk = Uh_m.shape[-4]
    if Uh_m.shape[:-4] != lead:
        raise ValueError(f"batch dims differ: {tuple(Ainv.shape)} vs "
                         f"{tuple(Uh_m.shape)}")
    a = Ainv.reshape((-1, nbr, nbc, b, b))
    u = Uh_m.reshape((-1, nk, nbc, b, b))
    o = None if out is None else out.view((-1, nk, nbr, b, b))
    p = blocked_gemm(a, u, out=o)
    return p.view(lead + (nk, nbr, b, b)) if out is None else out


def pselinv_round_gemm(Ainv, Uh, cmask, out=None):
    """Masked sweep GEMM keyed by a *round* of the overlapped stream: the
    struct mask arrives per round boundary (whatever elimination-tree
    level fires there).

    Ainv: (…, nbr, nbc, b, b) local A⁻¹ grids; Uh: (…, nk, nbc, b, b) raw
    Û stacks straight out of the comm arena; cmask: (…, nk, nbc) struct
    mask of the firing level, bool or 0/1 values. Returns (…, nk, nbr, b,
    b) partial products through :func:`pselinv_level_gemm`."""
    if cmask.dtype == torch.bool:
        Uh_m = torch.where(cmask[..., None, None], Uh, 0.0)
    else:
        Uh_m = Uh * cmask[..., None, None].to(Uh.dtype)
    return pselinv_level_gemm(Ainv, Uh_m, out=out)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward kernel: the forward saves q, k,
    v, the output and the f32 log-sum-exp, and the backward recomputes
    the probabilities tile by tile from them (no S×S tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_attention(q, k, v, causal=causal, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                          lse, ctx.causal)
        return dq, dk, dv, None


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with its backward kernel: the forward saves x and the
    scale, the backward recomputes each row's statistic from x."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = _rmsnorm_bwd(x, scale, dy.contiguous(), ctx.eps)
        return dx, ds.to(scale.dtype), None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, causal=True):
    """Softmax attention over (B, S, H, hd) tensors, same H for q, k, v."""
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _flash_attention(q, k, v, causal=causal)


def rmsnorm(x, scale, eps=1e-5):
    if _needs_grad(x, scale):
        return RMSNormFn.apply(x, scale, eps)
    return _rmsnorm(x, scale, eps=eps)


def trsm(b, u):
    """Solve X·U = B with U upper triangular (right side)."""
    return _trsm(b, u)
